"""Ops substrate of the port: KISS and the paper's input generators
(numpy, bit-identical to ``repro.ops.kiss``), the neighbor sampler,
segment reductions, gathers and scatters, embedding bags and the sorted
dispatch."""
