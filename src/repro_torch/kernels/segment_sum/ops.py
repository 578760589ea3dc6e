"""Wrapper of the sorted segment sum kernel (``csrc/segment_sum.cu``).

Replaces ``repro/kernels/segment_sum/segment_sum.py::_segsum_kernel``
(wrapper ``repro/kernels/segment_sum/ops.py::segment_sum_sorted``).
What bounds it on the H100 is memory: ``m*d*itemsize + 4*m +
n*d*itemsize + 4*(n + 1)`` bytes per call. The wrapper finds the row
pointers of the sorted ids with ``torch.searchsorted`` (the Pallas
wrapper's block tables are the same search at block granularity), and
the kernel sums each segment's contiguous rows with one warp, in
float32, without atomics.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import check_int32, check_status, launch_counts, resolve_impl
from repro_torch.kernels.segment_sum.ref import segment_sum_sorted_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def segment_sum_sorted(
    data: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    *,
    impl: str = "auto",
    block_e: int = 512,
    block_s: int = 256,
    max_steps: int | None = None,
) -> torch.Tensor:
    """Segment sum over rows already sorted by ``seg_ids``.

    ``data`` is ``(m, *feature_dims)`` float32 or bfloat16 (any dtype
    on the plain path), summed in float32 and returned in its own dtype,
    shape ``(num_segments, *feature_dims)``. ``seg_ids`` is ``(m,)``
    int32, sorted ascending; ids outside ``[0, num_segments)`` (the
    reference's padding ids included) contribute nothing, and an empty
    segment sums to 0. ``block_e``, ``block_s`` and ``max_steps`` are the
    TPU kernel's tiling parameters: accepted, so a call reads as the
    reference's, and ignored.

    This slice is inference: a ``data`` that requires grad, with grad
    mode on, raises (the kernel's launch would cut the autograd graph).
    """
    del block_e, block_s, max_steps
    if data.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "segment_sum_sorted has no backward yet (ROADMAP queue 1, item "
            "16): call it under torch.no_grad() or on a tensor that does "
            "not require grad"
        )
    if data.dim() < 1 or seg_ids.dim() != 1 or seg_ids.shape[0] != data.shape[0]:
        raise ValueError(
            f"data (m, ...) and seg_ids (m,) disagree: {tuple(data.shape)} "
            f"vs {tuple(seg_ids.shape)}"
        )
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if resolve_impl(impl, data) == "torch":
        return segment_sum_sorted_ref(data, seg_ids, num_segments)
    from repro_torch.kernels.build import function

    dev = data.device
    check_int32("seg_ids", seg_ids, dev)
    if data.dtype not in _DTYPES or not data.is_contiguous():
        raise ValueError(
            "segment_sum_sorted's kernel takes contiguous float32 or bfloat16 "
            f"data; got {data.dtype} (contiguous={data.is_contiguous()})"
        )
    m, feat = data.shape[0], tuple(data.shape[1:])
    d = math.prod(feat)
    if m >= 1 << 31 or d >= 1 << 31 or num_segments >= (1 << 31) - 1:
        raise ValueError(
            f"segment_sum_sorted takes fewer than 2**31 rows, columns and "
            f"segments; got m={m} d={d} num_segments={num_segments}"
        )
    out = torch.empty((num_segments, *feat), dtype=data.dtype, device=dev)
    if num_segments == 0 or d == 0:
        return out
    if m == 0:
        return out.zero_()
    ptr = torch.searchsorted(
        seg_ids,
        torch.arange(num_segments + 1, dtype=torch.int32, device=dev),
        out_int32=True,
    )
    fn = function("segment_sum", "segment_sum_run", (_P, _P, _P, _L, _I, _I, _P))
    check_status("segment_sum", fn(
        data.data_ptr(), ptr.data_ptr(), out.data_ptr(), num_segments, d,
        _DTYPES[data.dtype], torch.cuda.current_stream(dev).cuda_stream,
    ))
    launch_counts["segment_sum"] += 1
    return out
