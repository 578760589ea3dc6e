"""Input data of the port (numpy, bit-identical to ``repro.data``)."""
