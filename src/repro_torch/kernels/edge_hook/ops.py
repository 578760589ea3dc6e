"""Wrapper of the fused SV2/SV3 hook kernel (``csrc/edge_hook.cu``).

Replaces ``repro/kernels/edge_hook/edge_hook.py::_edge_hook_kernel``
(wrapper ``repro/kernels/edge_hook/ops.py::edge_hook``). What bounds it
on the H100 is memory: sv2 moves ``8*m2 + 20*n`` bytes and sv3
``9*m2 + 12*n`` per call, with random label gathers. The kernel runs
one thread per edge in a grid-stride loop, gathers from the input
labels and ``atomicMin``-scatters into a copy made here before the
launch, so its labels equal the plain version's bit for bit whatever
the thread order. Unlike the TPU kernel's VMEM limit, it takes any
``n``.

sv3 also returns the per-edge mask ``labels[a] != labels[b]``, the
frontier mask of the round body, so a round needs no extra pass over
the edges to compute it.
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
from repro_torch.kernels.edge_hook.ref import edge_hook_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _P)


def edge_hook(
    a: torch.Tensor,
    b: torch.Tensor,
    labels: torch.Tensor,
    stamps: torch.Tensor,
    s: int,
    *,
    labels_prev: torch.Tensor | None = None,
    mode: str = "sv2",
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused hook phase over all edges ``(a[e], b[e])``.

    ``mode="sv2"`` returns ``(labels_out, stamps_out)`` and needs
    ``labels_prev`` (the labels before this round's short-cut; it
    defaults to ``labels``). ``mode="sv3"`` returns ``(labels_out,
    live)``, where ``live`` is the bool mask ``labels[a] != labels[b]``;
    its stamps pass through unchanged, so they are not returned.
    """
    if mode not in ("sv2", "sv3"):
        raise ValueError(f"unknown mode {mode!r}")
    prev = labels if labels_prev is None else labels_prev
    if resolve_impl(impl, labels) == "torch":
        return edge_hook_ref(a, b, labels, prev, stamps, s, mode=mode)
    from repro_torch.kernels.build import function

    dev = labels.device
    for name, x in (("a", a), ("b", b), ("labels", labels),
                    ("labels_prev", prev), ("stamps", stamps)):
        check_int32(name, x, dev)
    n, m2 = labels.shape[0], a.shape[0]
    if b.shape[0] != m2 or prev.shape[0] != n or stamps.shape[0] != n:
        raise ValueError("edge_hook: a/b or labels/labels_prev/stamps "
                         "lengths differ")
    if m2 >= 1 << 31:
        raise ValueError(f"edge_hook takes fewer than 2**31 edges, got {m2}")
    out = labels.clone()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mode == "sv2":
        q_out = stamps.clone()
        if m2:
            fn = function("edge_hook", "edge_hook_sv2", _ARGTYPES)
            check_status("edge_hook sv2", fn(
                a.data_ptr(), b.data_ptr(), labels.data_ptr(),
                prev.data_ptr(), out.data_ptr(), q_out.data_ptr(),
                m2, int(s), stream,
            ))
            launch_counts["edge_hook.sv2"] += 1
        return out, q_out
    live = torch.empty(m2, dtype=torch.bool, device=dev)
    if m2:
        fn = function("edge_hook", "edge_hook_sv3", _ARGTYPES)
        check_status("edge_hook sv3", fn(
            a.data_ptr(), b.data_ptr(), labels.data_ptr(),
            stamps.data_ptr(), out.data_ptr(), live.data_ptr(),
            m2, int(s), stream,
        ))
        launch_counts["edge_hook.sv3"] += 1
    return out, live
