"""Segment reductions of the port, the counterparts of
``repro/ops/segment.py``.

A float ``segment_sum`` goes through the ``segment_sum`` kernel
(``kernels/segment_sum``), on the card and, as its plain version, on
the CPU: with ``indices_are_sorted=True`` directly, otherwise after a
stable sort of the ids and a gather of the rows. Integer sums and
``segment_max``/``segment_min``/``segment_count`` are scatters in the
reference too, outside any Pallas kernel, and stay PyTorch scatters
here. Ids outside ``[0, num_segments)`` contribute nothing: the
scatters send them to a drop row past the end, cut off afterwards, and
the kernel skips them. Ids wider than int32 are clamped to ``[-1,
num_segments]`` before the kernel's int32, so sorted ids reach it
sorted. An empty segment sums to
0, and its max/min is the identity (``-inf``/``+inf`` for floats, the
type's least/greatest integer), as in ``jax.ops``.

The kernel sums float32 and bfloat16 rows; a float16 sum is widened to
float32 around it and rounded once. float64, which JAX computes only
with x64 enabled, has no kernel: on the card it raises.

The ``_dist`` variants are the edge-sharded forms: each rank reduces
its own edges (a float sum through the ``segment_sum`` kernel), then the
partials are summed (or maxed) over the named mesh axes, which resolve
against ``mesh=`` or the mesh entered with ``with mesh:``. With
``axes=()`` they are the local reductions. Their backward sums the
gradient over the axes too (``collectives.psum_linear``): every rank
uses the reduced nodes alike, so an edge-parallel loss scales its
gradient by one over the axis size (the GNN losses' ``psum_axes`` do).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.collectives import (
    all_reduce,
    grad_scale,
    pmax_linear,
    psum_linear,
)
from repro_torch.distributed.mesh import resolve_mesh
from repro_torch.kernels.segment_sum.ops import segment_sum_sorted


def _drop_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids with those outside ``[0, num_segments)`` moved to the
    drop row ``num_segments``."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    if not data.is_floating_point():
        out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=data.dtype,
                          device=data.device)
        out.index_add_(0, _drop_ids(segment_ids, num_segments), data)
        return out[:num_segments]
    if segment_ids.dtype == torch.int32:
        ids = segment_ids
    else:  # clamped before narrowing: still dropped, and sorted ids stay sorted
        ids = segment_ids.clamp(-1, num_segments).to(torch.int32)
    if data.dtype == torch.float16:
        return segment_sum(data.float(), ids, num_segments,
                           indices_are_sorted=indices_are_sorted).half()
    if not indices_are_sorted:
        ids, perm = torch.sort(ids, stable=True)
        data = data.index_select(0, perm)
    return segment_sum_sorted(data.contiguous(), ids.contiguous(), num_segments)


def _segment_extremum(data, segment_ids, num_segments, reduce: str):
    if data.is_floating_point():
        fill = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(data.dtype)
        fill = info.min if reduce == "amax" else info.max
    out = torch.full((num_segments + 1, *data.shape[1:]), fill,
                     dtype=data.dtype, device=data.device)
    ids = _drop_ids(segment_ids, num_segments)
    index = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    out.scatter_reduce_(0, index, data, reduce, include_self=False)
    return out[:num_segments]


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    del indices_are_sorted  # a scatter does not need the order
    return _segment_extremum(data, segment_ids, num_segments, "amax")


def segment_min(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    del indices_are_sorted
    return _segment_extremum(data, segment_ids, num_segments, "amin")


def segment_count(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Number of elements per segment (degree counting), int32."""
    counts = torch.bincount(_drop_ids(segment_ids, num_segments),
                            minlength=num_segments + 1)
    return counts[:num_segments].to(torch.int32)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments,
                        indices_are_sorted=indices_are_sorted)
    count = segment_count(segment_ids, num_segments).clamp_min(1).to(total.dtype)
    return total / count.reshape(count.shape + (1,) * (total.dim() - 1))


def _gather_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 row indices that read what ``x[segment_ids]`` reads in JAX:
    a negative id counts from the end once, then every id is clamped to
    ``[0, num_segments)``."""
    ids = segment_ids.long()
    ids = torch.where(ids < 0, ids + num_segments, ids)
    return ids.clamp(0, max(num_segments - 1, 0))


def _softmax_parts(logits, segment_ids, num_segments, indices_are_sorted):
    """``(exp(logits - segment max), segment sum of it, floored at the
    dtype's tiny)``; an empty segment's -inf max is taken as 0."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ids = _gather_ids(segment_ids, num_segments)
    expd = torch.exp(logits - seg_max[ids])
    seg_den = segment_sum(expd, segment_ids, num_segments,
                          indices_are_sorted=indices_are_sorted)
    seg_den = seg_den.clamp_min(torch.finfo(expd.dtype).tiny)
    return expd, seg_den, ids


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Numerically stable softmax within each segment (GAT edge
    softmax)."""
    expd, seg_den, ids = _softmax_parts(logits, segment_ids, num_segments,
                                        indices_are_sorted)
    return expd / seg_den[ids]


def segment_sum_dist(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    axes: tuple[str, ...] = (),
    *,
    indices_are_sorted: bool = False,
    mesh=None,
) -> torch.Tensor:
    out = segment_sum(data, segment_ids, num_segments,
                      indices_are_sorted=indices_are_sorted)
    if not axes:
        return out
    return psum_linear(out, resolve_mesh(mesh, axes), tuple(axes))


def segment_count_dist(segment_ids: torch.Tensor, num_segments: int,
                       axes: tuple[str, ...] = (), *, mesh=None) -> torch.Tensor:
    """``segment_count`` over every rank's edges: the degree an
    edge-parallel layer needs (the reference counts the local edges)."""
    out = segment_count(segment_ids, num_segments)
    if not axes:
        return out
    return all_reduce(out, resolve_mesh(mesh, axes), tuple(axes))


def edge_parallel_loss(loss: torch.Tensor, axes: tuple[str, ...] = (), *,
                       mesh=None) -> torch.Tensor:
    """``loss`` with its gradient scaled by one over the size of ``axes``:
    every rank of an edge-parallel forward computes the same loss, and
    the ``_dist`` sums' backward adds the ranks' gradients, so each
    rank's parameter gradients are then its share, which
    ``sharding.reduce_gradients`` sums over ``axes``."""
    if not axes:
        return loss
    mesh = resolve_mesh(mesh, axes)
    return grad_scale(loss, 1.0 / mesh.axis_size(tuple(axes)))


def segment_max_dist(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    axes: tuple[str, ...] = (),
    *,
    mesh=None,
) -> torch.Tensor:
    out = segment_max(data, segment_ids, num_segments)
    if not axes:
        return out
    return pmax_linear(out, resolve_mesh(mesh, axes), tuple(axes))


def segment_softmax_dist(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    axes: tuple[str, ...] = (),
    *,
    indices_are_sorted: bool = False,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge-sharded segment softmax. Returns ``(numerator_per_edge,
    denominator_per_segment)``; the caller divides after aggregating the
    weighted messages, so only two collectives (a max and a sum) run per
    attention layer. Unlike the reference it takes
    ``indices_are_sorted``, so a forward over dst-sorted edges sums its
    denominators without a sort."""
    if not axes:
        expd, seg_den, _ = _softmax_parts(logits, segment_ids, num_segments,
                                          indices_are_sorted)
        return expd, seg_den
    seg_max = segment_max_dist(logits, segment_ids, num_segments, axes, mesh=mesh)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    expd = torch.exp(logits - seg_max[_gather_ids(segment_ids, num_segments)])
    seg_den = segment_sum_dist(expd, segment_ids, num_segments, axes,
                               indices_are_sorted=indices_are_sorted, mesh=mesh)
    return expd, seg_den.clamp_min(torch.finfo(expd.dtype).tiny)
