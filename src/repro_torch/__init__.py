"""repro_torch -- the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout (``core/``, ``configs/``,
``kernels/``, ``models/``, ``obs/``, ``ops/``, ``serve/``) so each
module's counterpart is easy to find. It imports torch and numpy, never
jax, and nothing of ``repro``. Its entry points are
``repro_torch.core.connected_components`` and
``repro_torch.core.list_rank`` (graphs), and, for the dense decoder LMs
of ``repro_torch.configs.get_arch``,
``repro_torch.models.transformer.forward`` (prefill) and
``repro_torch.serve.ServeEngine`` (wave-batched decode). They run on the
CUDA card unless the caller passes ``device="cpu"`` (tensor inputs stay
on their own device; the LM runs where its parameters live). The four
Pallas kernels on their paths (``edge_hook``, ``pointer_jump``,
``splitter_aggregate``, ``flash_attention``) are CUDA C++ kernels for
``sm_90a`` in ``kernels/csrc``, built at first use.

What is carried across. For the graph algorithms, what crosses between
the two packages is the input -- edge lists, successor
arrays and splitters, made with numpy from a seed. The port's KISS
generators (``ops/kiss.py``) and ``select_splitters`` give output
bit-identical to ``repro``'s, so the same seed gives both packages the
same graph, list and splitters, and their integer results (labels,
rounds, hook forests, ranks, counters) are compared bit for bit.
"""
