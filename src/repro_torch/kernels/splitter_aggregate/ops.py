"""Wrapper of the RS5 aggregation kernel (``csrc/splitter_aggregate.cu``).

Replaces ``repro/kernels/splitter_aggregate/splitter_aggregate.py::_agg_kernel``
(wrapper ``repro/kernels/splitter_aggregate/ops.py::splitter_aggregate``).
What bounds it on the H100 is memory: ``12*n + 4*p`` bytes per call.
The rows stream in order as one 8-byte load each, and each block keeps
the p-entry splitter table in shared memory, so the only irregular
access stays on the SM.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (
    check_int32,
    check_status,
    launch_counts,
    resolve_impl,
)
from repro_torch.kernels.splitter_aggregate.ref import splitter_aggregate_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def splitter_aggregate(
    packed: torch.Tensor, sprank: torch.Tensor, *, impl: str = "auto"
) -> torch.Tensor:
    """``rank[j] = sprank[owner[j]] - local[j]`` over the ``(n, 2)``
    int32 rows ``[local, owner]``."""
    if resolve_impl(impl, packed) == "torch":
        return splitter_aggregate_ref(packed, sprank)
    from repro_torch.kernels.build import function

    dev = packed.device
    check_int32("packed", packed, dev)
    check_int32("sprank", sprank, dev)
    if packed.dim() != 2 or packed.shape[1] != 2:
        raise ValueError(f"packed must be (n, 2), got {tuple(packed.shape)}")
    if packed.data_ptr() % 8:
        raise ValueError("packed must be 8-byte aligned (one int2 per row)")
    n, p = packed.shape[0], sprank.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"splitter_aggregate takes fewer than 2**31 rows, got {n}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    if p == 0:
        raise ValueError("splitter_aggregate needs a nonempty splitter table")
    fn = function("splitter_aggregate", "splitter_aggregate_run",
                  (_P, _P, _P, _I, _I, _P))
    check_status("splitter_aggregate", fn(
        packed.data_ptr(), sprank.data_ptr(), out.data_ptr(), n, p,
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    launch_counts["splitter_aggregate"] += 1
    return out
