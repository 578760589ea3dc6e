"""CUDA C++ kernels for Hopper (``sm_90a``), the port's counterparts of
the Pallas TPU kernels in ``repro.kernels``: ``edge_hook``,
``pointer_jump``, ``splitter_aggregate``, ``flash_attention`` and
``segment_sum``; ``ordered_fold``, which has no Pallas counterpart
(the slot-order fold of the ``ADD`` monoid, which XLA's scatter-add gives
the reference for free); and ``flash_attention``'s backward
(``csrc/flash_attention_bwd.cu``), which has none either (the reference
takes that VJP by autodiff).

Each kernel directory holds:
  ops.py  -- the wrapper: checks its inputs, launches the kernel on a
             CUDA tensor, counts the launch
  ref.py  -- the plain PyTorch version of the same function, which the
             wrapper runs for CPU tensors and the card check compares
             the kernel with

The CUDA sources live in ``csrc/`` and are built at first use by
``kernels.build`` (``nvcc`` into one shared library per source, loaded
with ``ctypes``).

``impl=`` of every wrapper is one of ``IMPLS``: ``"auto"`` launches the
kernel for CUDA tensors and runs the plain version for CPU tensors and
for meta tensors (where it computes shapes and nothing else: the dry
run, ``launch/dryrun.py``), ``"cuda"`` insists on the kernel (and
raises on CPU and meta tensors), and ``"torch"`` runs the plain version
wherever the tensors are -- on the card only when a caller asks for it
by name, as the card check does. There is no fallback: a kernel that
fails to build or launch raises, and a CUDA tensor never reaches the
plain version unasked.
"""
from __future__ import annotations

import torch

IMPLS = ("auto", "torch", "cuda")

# One plain integer per kernel entry point, raised by the wrapper where
# it launches the kernel and nowhere else, so a run can show that its
# main path went through the kernels.
launch_counts = {
    "edge_hook.sv2": 0,
    "edge_hook.sv3": 0,
    "pointer_jump": 0,
    "splitter_aggregate": 0,
    "flash_attention": 0,
    "flash_attention.bwd": 0,  # the backward's wgmma design
    "flash_attention.bwd.wmma": 0,  # its wmma design (ops.py::bwd_design)
    "segment_sum": 0,
    "ordered_fold": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``"torch"`` or ``"cuda"`` for a call on tensors placed like ``x``:
    under ``"auto"`` the kernel for a CUDA tensor, the plain version for
    a CPU or meta tensor (shapes only on meta)."""
    if impl not in IMPLS:
        raise ValueError(
            f"unknown impl {impl!r}; valid choices: "
            + ", ".join(repr(c) for c in IMPLS)
        )
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got a tensor on {x.device}"
        )
    return impl


def check_int32(name: str, x: torch.Tensor, device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous int32 tensor on ``device``."""
    if x.dtype != torch.int32 or not x.is_contiguous() or x.device != device:
        raise ValueError(
            f"{name} must be a contiguous int32 tensor on {device}; got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )


def check_status(kernel: str, status: int) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status}")
