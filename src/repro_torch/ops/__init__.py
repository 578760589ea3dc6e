"""Input generators of the port (numpy, bit-identical to ``repro.ops.kiss``)."""
