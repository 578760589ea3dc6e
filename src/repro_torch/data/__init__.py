"""Input data of the port (numpy, bit-identical to ``repro.data``): the
graph builders of ``graphs.py``, the CTR batches of ``recsys.py``, the LM
token stream of ``lm.py`` and its prefetching iterator
(``pipeline.py``)."""
