"""Wrapper of the fused SV2/SV3 hook kernel (``csrc/edge_hook.cu``).

Replaces ``repro/kernels/edge_hook/edge_hook.py::_edge_hook_kernel``
(wrapper ``repro/kernels/edge_hook/ops.py::edge_hook``). What bounds it
on the H100 is memory: sv2 moves ``8*m2 + 20*n`` bytes and sv3
``9*m2 + 12*n`` per call, with random label gathers. A call takes one
of two paths (``packed_path``). On the packed path a node pass writes,
for sv2, one word a node that holds the label and the stagnant test
(``ref.py::stagnant_words``), and for sv3 one bit a node for the root
test (``ref.py::root_bits``); the edge pass gathers those in place of
the arrays they summarise, and sv2 sets a byte a node for the stamps,
which a last pass writes into the output stamps
(``ref.py::stamp_bytes``, ``stamps_from_bytes``).
``ref.py::edge_hook_packed_ref`` states that layout plainly. The
direct path copies the labels (and stamps) and gathers the labels
themselves. Either way the labels equal the plain
version's bit for bit whatever the thread order, and unlike the TPU
kernel's VMEM limit the kernel takes any ``n``. Labels must lie in
``[0, n)``.

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
_SV2_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_SV3_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)


def packed_path(m2: int, n: int) -> bool:
    """Whether a call of ``m2`` edges on ``n`` nodes takes the packed
    path. Its node pass reads and writes more than the plain copy (sv2
    writes a packed word a node, sv3 reads the stamps), which the edge
    pass pays back where the edges outnumber the nodes: from m2 = 3n/2
    on, between the CC cells' calls at m2 = n (direct faster) and
    m2 = 1.8n (packed faster; PERF.md section 6)."""
    return 2 * m2 >= 3 * n


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where its address is not a multiple of 16
    bytes (the kernel's node passes take four nodes at a time)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    if m2 == 0:
        out = labels.clone()
        return (out, stamps.clone()) if mode == "sv2" else (
            out, torch.empty(0, dtype=torch.bool, device=dev))
    labels, prev, stamps = _aligned(labels), _aligned(prev), _aligned(stamps)
    packed = packed_path(m2, n)
    out = torch.empty_like(labels)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mode == "sv2":
        words = torch.empty(n if packed else 0, dtype=torch.int32, device=dev)
        q_out = torch.empty_like(stamps)
        stamped = torch.empty(n if packed else 0, dtype=torch.uint8, device=dev)
        fn = function("edge_hook", "edge_hook_sv2", _SV2_ARGS)
        check_status("edge_hook sv2", fn(
            a.data_ptr(), b.data_ptr(), labels.data_ptr(), prev.data_ptr(),
            stamps.data_ptr(), out.data_ptr(), q_out.data_ptr(),
            words.data_ptr(), stamped.data_ptr(), m2, n, int(s), int(packed),
            stream,
        ))
        launch_counts["edge_hook.sv2"] += 1
        return out, q_out
    live = torch.empty(m2, dtype=torch.bool, device=dev)
    bits = torch.empty((n + 31) // 32 if packed else 0, dtype=torch.int32,
                       device=dev)
    fn = function("edge_hook", "edge_hook_sv3", _SV3_ARGS)
    check_status("edge_hook sv3", fn(
        a.data_ptr(), b.data_ptr(), labels.data_ptr(), stamps.data_ptr(),
        out.data_ptr(), live.data_ptr(), bits.data_ptr(), m2, n, int(s),
        int(packed), stream,
    ))
    launch_counts["edge_hook.sv3"] += 1
    return out, live
