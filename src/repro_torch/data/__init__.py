"""Input data of the port (numpy, bit-identical to ``repro.data``): the
graph builders of ``graphs.py`` and the CTR batches of ``recsys.py``."""
