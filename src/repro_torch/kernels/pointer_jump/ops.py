"""Wrapper of the pointer-jumping kernel (``csrc/pointer_jump.cu``).

Replaces ``repro/kernels/pointer_jump/pointer_jump.py::_pointer_jump_kernel``
(wrapper ``repro/kernels/pointer_jump/ops.py::pointer_jump``), RS4 of
the random-splitter list ranking. What bounds it on the H100 is
latency: it moves only ``16*p`` bytes, but ``iters`` dependent gather
steps with a barrier between each. Up to the library's shared-memory
limit (4096 nodes, the default splitter count) one block keeps the list
in shared memory and runs every step in one launch; above it this
wrapper launches one global-memory step per iteration, ping-ponging
between two buffer pairs so every step reads the previous one's state.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (
    check_int32,
    check_status,
    launch_counts,
    resolve_impl,
)
from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def default_iters(p: int) -> int:
    """ceil(log2 p), at least 1: enough steps for any p-node list."""
    return max(1, math.ceil(math.log2(max(p, 2))))


# The largest p the one-launch shared-memory path takes: kSharedLimit
# of csrc/pointer_jump.cu, whose launch rejects a larger p.
SHARED_LIMIT = 4096


def pointer_jump(
    nxt: torch.Tensor,
    w: torch.Tensor,
    *,
    iters: int | None = None,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Jump ``iters`` times; returns ``(suffix_sums, final_pointers)``."""
    p = nxt.shape[0]
    iters = iters if iters is not None else default_iters(p)
    if resolve_impl(impl, nxt) == "torch":
        return pointer_jump_ref(nxt, w, iters=iters)
    from repro_torch.kernels.build import function

    dev = nxt.device
    check_int32("nxt", nxt, dev)
    check_int32("w", w, dev)
    if w.shape[0] != p:
        raise ValueError(f"pointer_jump: nxt has {p} nodes, w {w.shape[0]}")
    if p == 0 or iters == 0:
        return w.clone(), nxt.clone()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rank_out = torch.empty_like(w)
    nxt_out = torch.empty_like(nxt)
    if p <= SHARED_LIMIT:
        fn = function("pointer_jump", "pointer_jump_shared",
                      (_P, _P, _P, _P, _I, _I, _P))
        check_status("pointer_jump", fn(
            nxt.data_ptr(), w.data_ptr(), rank_out.data_ptr(),
            nxt_out.data_ptr(), p, iters, stream,
        ))
        launch_counts["pointer_jump"] += 1
        return rank_out, nxt_out
    step = function("pointer_jump", "pointer_jump_step",
                    (_P, _P, _P, _P, _I, _P))
    spare = (torch.empty_like(w), torch.empty_like(nxt))
    src = (w, nxt)
    for k in range(iters):
        # The last step writes (rank_out, nxt_out); the ones before
        # alternate between that pair and the spare one.
        dst = (rank_out, nxt_out) if (iters - 1 - k) % 2 == 0 else spare
        check_status("pointer_jump step", step(
            src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
            dst[1].data_ptr(), p, stream,
        ))
        launch_counts["pointer_jump"] += 1
        src = dst
    return rank_out, nxt_out
