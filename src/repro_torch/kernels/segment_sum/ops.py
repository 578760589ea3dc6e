"""Wrapper of the sorted segment sum kernel (``csrc/segment_sum.cu``).

Replaces ``repro/kernels/segment_sum/segment_sum.py::_segsum_kernel``
(wrapper ``repro/kernels/segment_sum/ops.py::segment_sum_sorted``).
What bounds it on the H100 is memory: ``m*d*itemsize + 4*m +
n*d*itemsize + 4*(n + 1)`` bytes per call. The work is split by rows:
``row_pointers_ref`` states the row pointers the kernel's first pass
writes, ``row_tiles`` the split into tiles (and ``copy_path`` how the
tile pass reads the rows), and
``segment_sum_tiled_ref`` sums by that split in the kernel's order of
passes (tile partials first, then the carries of segments that cross
tiles, in tile order). It does not follow the kernel's order of sums
inside a tile, so it equals the kernel only where every order gives the
same sum. The kernel sums in float32, without atomics, so two calls
give bit-equal outputs.

Gradients: on the card, ``data`` that requires grad goes through
``_SegmentSum``, a ``torch.autograd.Function`` around the same launch
whose backward is ``segment_sum_vjp``: the gather ``grad_out[ids]``
(zero rows for ids outside ``[0, n)``), which the reference gets from
XLA's autodiff and not from a Pallas kernel. It is a PyTorch gather, and
deterministic.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import check_int32, check_status, launch_counts, resolve_impl
from repro_torch.kernels.segment_sum.ref import segment_sum_sorted_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The plan's limits and choices. csrc/segment_sum.cu refuses a plan that
# does not fit its own: a stage's rows and ids fit a STAGE_BYTES slot, a
# warp sums at most MAX_COLS columns, the path follows its rule
# (``copy_path``), the wide path's block, slice and rows in flight are
# its WIDE_THREADS, 16 bytes and WIDE_ROWS, and FOLD_TILES (one a lane)
# and the carry's rows are checked against its fold pass. A tile's least
# stages and rows, and the wide path's tile, are this plan's choice.
STAGE_BYTES = 4096
MAX_COLS = 128
FOLD_TILES = 32
TILE_STAGES = 8
TILE_ROWS = 512
WIDE_THREADS = 128
WIDE_ROWS = 8
WIDE_TILE_ROWS = 128
# How pass 1 reads a tile's rows (the .cu's codes in order).
COPY_PATHS = ("stream", "wide", "rows")


class RowTiles(NamedTuple):
    """How the kernel splits ``m`` rows of ``d`` columns: tiles of
    ``tile_rows`` rows (``tiles`` of them), each summed by one warp per
    block of ``col_block`` columns in stages of ``stage_rows`` rows;
    ``lanes`` lanes spread over the columns and ``32 // lanes`` walkers
    over the rows of a stage, ``walker_rows`` each. On the wide path a
    block of ``lanes`` threads sums a tile's ``col_block`` columns, each
    thread ``walker_rows`` rows at a time. ``carry_rows`` rows of two
    ``d``-float partials (head and tail) hold the carries: one row a
    tile, then one a group of ``FOLD_TILES`` tiles. ``copy`` is the
    path (``copy_path``)."""

    tile_rows: int
    tiles: int
    stage_rows: int
    walker_rows: int
    lanes: int
    col_block: int
    carry_rows: int
    copy: str


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def copy_path(d: int, itemsize: int) -> str:
    """How the kernel's tile pass reads the rows. Rows of at most
    ``MAX_COLS`` columns: ``"stream"``, a stage of rows is one contiguous
    bulk copy into shared memory. Wider rows whose stride (``d *
    itemsize``) is a multiple of 16 bytes: ``"wide"``, each thread of a
    block loads one 16-byte column slice of every row of the tile into
    registers (the MoE combines, MACE's messages). Other wide rows:
    ``"rows"``, one bulk copy a row and column block of ``MAX_COLS``."""
    if d <= MAX_COLS:
        return "stream"
    return "wide" if d * itemsize % 16 == 0 else "rows"


def row_tiles(m: int, d: int, itemsize: int) -> RowTiles:
    """The kernel's split of ``m`` sorted rows of ``d`` columns of
    ``itemsize`` bytes. On the wide path: tiles of ``WIDE_TILE_ROWS``
    rows, blocks of ``WIDE_THREADS`` threads over ``WIDE_THREADS * 16``
    bytes of columns, ``WIDE_ROWS`` rows in flight a thread. Otherwise a
    stage is as many rows (a multiple of the walkers, an odd number a
    walker when there are several, so walkers read distinct
    shared-memory banks) as fit a ``STAGE_BYTES`` slot with their ids and
    16 bytes of alignment slack for each; a tile is at least
    ``TILE_STAGES`` stages and ``TILE_ROWS`` rows."""
    path = copy_path(d, itemsize)
    if path == "wide":
        tiles = -(-m // WIDE_TILE_ROWS)
        return RowTiles(WIDE_TILE_ROWS, tiles, WIDE_ROWS, WIDE_ROWS, WIDE_THREADS,
                        WIDE_THREADS * 16 // itemsize, tiles + -(-tiles // FOLD_TILES), path)
    col_block = min(d, MAX_COLS)
    lanes = 32 if col_block > 16 else 1 << (col_block - 1).bit_length()
    walkers = 32 // lanes
    slot = _round16(col_block * itemsize) + 16 if col_block < d else 0

    def fits(rows: int) -> bool:
        data = rows * slot if slot else _round16(rows * d * itemsize) + 16
        return data + _round16(rows * 4) + 16 <= STAGE_BYTES

    q = 1
    while fits(walkers * (q + 1)):
        q += 1
    if walkers > 1 and q % 2 == 0:
        q -= 1
    stage = walkers * q
    tile = stage * max(TILE_STAGES, -(-TILE_ROWS // stage))
    tiles = -(-m // tile)
    return RowTiles(tile, tiles, stage, q, lanes, col_block, tiles + -(-tiles // FOLD_TILES),
                    path)


def row_pointers_ref(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The kernel's first pass, plainly: for each row boundary ``i`` in
    ``[0, m]``, ``ptr[s] = i`` for every ``s`` in ``(ids[i-1], ids[i]]``
    clamped to ``[0, n]``, with ``ids[-1] = -1`` and ``ids[m] = n``. For
    sorted ids this is ``torch.searchsorted(ids, arange(n + 1))``: the
    first row with id >= s. ``(n + 1,)`` int32."""
    n = num_segments
    ids = seg_ids.long()
    lo = torch.cat([ids.new_tensor([-1]), ids]) + 1
    hi = torch.cat([ids, ids.new_tensor([n])])
    count = (hi.clamp(-1, n) - lo.clamp(0, n + 1) + 1).clamp(min=0)
    rows = torch.arange(ids.numel() + 1, device=ids.device)
    return torch.repeat_interleave(rows, count).to(torch.int32)


def segment_sum_tiled_ref(
    data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int, tile_rows: int
) -> torch.Tensor:
    """Segment sum by the kernel's split, plainly: its passes, not its
    order of sums inside a tile. Each run of one segment inside a tile of
    ``tile_rows`` rows is summed on its own (the tile pass); a segment
    inside one tile is its run. The runs of a segment that crosses tiles
    are added in tile order, ``FOLD_TILES`` tiles at a time (the fold
    pass), and those group sums in group order (the finish pass). An
    empty segment is 0. Sums in float32, rounded once to ``data``'s
    dtype."""
    n = num_segments
    ids = seg_ids.long()
    feat = data.shape[1:]
    x = data.reshape(data.shape[0], -1).float()
    ptr = row_pointers_ref(seg_ids, n).long()
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32)
    lo, hi = int(ptr[0]), int(ptr[n])
    rows = torch.arange(lo, hi)
    key = torch.stack([rows // tile_rows, ids[lo:hi]])
    runs, run_of = torch.unique_consecutive(key, dim=1, return_inverse=True)
    partial = torch.zeros((runs.shape[1], x.shape[1])).index_add_(0, run_of, x[lo:hi])
    groups: dict[tuple[int, int], torch.Tensor] = {}
    for (tile, s), part in zip(runs.T.tolist(), partial):
        key = (s, tile // FOLD_TILES)
        groups[key] = groups[key] + part if key in groups else part
    for (s, group), part in groups.items():  # in order of s, then group
        if group == int(ptr[s]) // (tile_rows * FOLD_TILES):
            out[s] = part
        else:
            out[s] += part
    return out.to(data.dtype).reshape(n, *feat)


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

    On the card the work is split by rows (``row_tiles``), whatever the
    largest segment; the call reads nothing back to the host, so it can
    be captured in a CUDA graph. ``data`` whose address is not a
    multiple of 16 bytes is copied first. A ``data`` that requires grad,
    with grad mode on, goes through ``_SegmentSum`` (the same launch;
    ``segment_sum_vjp`` for its gradient); the plain version carries
    autograd by itself.
    """
    del block_e, block_s, max_steps
    if data.dim() < 1 or seg_ids.dim() != 1 or seg_ids.shape[0] != data.shape[0]:
        raise ValueError(
            f"data (m, ...) and seg_ids (m,) disagree: {tuple(data.shape)} "
            f"vs {tuple(seg_ids.shape)}"
        )
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if resolve_impl(impl, data) == "torch":
        return segment_sum_sorted_ref(data, seg_ids, num_segments)
    if data.requires_grad and torch.is_grad_enabled():
        return _SegmentSum.apply(data, seg_ids, num_segments)
    return segment_sum_and_pointers(data, seg_ids, num_segments)[0]


def segment_sum_vjp(grad: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """The gradient of a segment sum with respect to its rows:
    ``grad[seg_ids]``, ``(m, *feature_dims)``, with a zero row for every
    id outside ``[0, num_segments)``. One gather and one masked fill, so
    two calls give the same bits."""
    feat = grad.shape[1:]
    if num_segments == 0:
        return grad.new_zeros((seg_ids.shape[0], *feat))
    ids = seg_ids.long()
    dropped = (ids < 0) | (ids >= num_segments)
    rows = grad.index_select(0, ids.clamp(0, num_segments - 1))
    return rows.masked_fill_(dropped.view(-1, *([1] * len(feat))), 0)


class _SegmentSum(torch.autograd.Function):
    """``segment_sum_sorted``'s kernel with a gradient: the launch, then
    ``segment_sum_vjp`` on the saved ids (``data`` is not saved)."""

    @staticmethod
    def forward(ctx, data, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        ctx.num_segments = num_segments
        return segment_sum_and_pointers(data, seg_ids, num_segments)[0]

    @staticmethod
    def backward(ctx, grad):
        (seg_ids,) = ctx.saved_tensors
        return segment_sum_vjp(grad, seg_ids, ctx.num_segments), None, None


def segment_sum_and_pointers(
    data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The kernel's launch on CUDA tensors: ``segment_sum_sorted``'s
    output and the ``(n + 1,)`` int32 row pointers its tile pass wrote
    (as ``row_pointers_ref``; ``None`` when no rows, columns or segments
    left nothing to launch). Counts the launch."""
    from repro_torch.kernels.build import function

    resolve_impl("cuda", data)  # raises for tensors off the card
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
        return out, None
    if m == 0:
        return out.zero_(), None
    if data.data_ptr() % 16:
        data = data.clone()
    plan = row_tiles(m, d, data.element_size())
    ptr = torch.empty(num_segments + 1, dtype=torch.int32, device=dev)
    carry = torch.empty((plan.carry_rows, 2, d), dtype=torch.float32, device=dev)
    fn = function("segment_sum", "segment_sum_run",
                  (_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _L, _I, _I, _L, _I, _P))
    check_status("segment_sum", fn(
        data.data_ptr(), seg_ids.data_ptr(), ptr.data_ptr(), carry.data_ptr(),
        out.data_ptr(), m, num_segments, d, _DTYPES[data.dtype], plan.lanes,
        plan.walker_rows, plan.tile_rows, plan.col_block, FOLD_TILES, plan.carry_rows,
        COPY_PATHS.index(plan.copy), torch.cuda.current_stream(dev).cuda_stream,
    ))
    launch_counts["segment_sum"] += 1
    return out, ptr
