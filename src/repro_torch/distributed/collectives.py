"""Collectives over the named axes of a ``Mesh``, with the backward each
use needs. The reference writes these as ``jax.lax`` collectives inside
``shard_map`` and lets JAX transpose them; here every rank runs its own
autograd, so each collective states what its gradient means.

Two conventions, one per kind of axis:

* Over an axis whose ranks compute alike (tensor parallelism over
  ``"model"``: every rank holds the same activations between the
  sharded products), a replicated tensor's gradient is the full one on
  every rank. ``copy_to`` marks where a replicated tensor enters work
  split over the axis (its backward sums the partial gradients),
  ``reduce_from`` sums partial results into a replicated one (its
  backward passes the gradient through), ``scatter_to``/``gather_from``
  take and rebuild this rank's chunk of a dim.
* Over an axis that splits the data (the batch over ``"data"``, the
  edges of an edge-parallel GNN), each rank's gradient of a replicated
  parameter is its share, and ``sharding.reduce_gradients`` sums the
  shares once after the backward. The LM's loss sums its partial sums
  with ``reduce_from``. The edge-parallel GNN sums its partial
  aggregates with ``psum_linear``, whose backward all-reduces as the
  linear transpose does (what ``torch.distributed.nn.functional.
  all_reduce`` does), and scales its loss's gradient by one over the
  axis size with ``grad_scale``: every rank computes the same loss from
  the summed aggregates, so the all-reduce in the backward counts each
  rank's gradient that many times.

``all_to_all`` is a permutation of rows among ranks; its backward is
the reverse exchange under either convention. Every collective runs on
the group ``mesh.group(axes)``, also when it has one rank, and a
failure in it raises.

Inside ``with count_traffic() as t:`` each collective also adds its
result's bytes and one call to ``t`` under the reference's HLO op name
(``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``):
what the dry run's roofline reads (``launch/roofline.py``). ``chunk``
sends nothing and counts nothing.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

# The open traffic counters (innermost last); empty when none is open.
_TRAFFIC: list = []


class Traffic:
    """Bytes and calls per collective op, as the dry run counts them."""

    def __init__(self):
        self.bytes_by_op: dict[str, int] = {}
        self.count_by_op: dict[str, int] = {}

    def add(self, op: str, x: torch.Tensor) -> None:
        n = x.numel() * x.element_size()
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + n
        self.count_by_op[op] = self.count_by_op.get(op, 0) + 1


@contextlib.contextmanager
def count_traffic():
    """Count every collective the block sends (see the module docstring)."""
    t = Traffic()
    _TRAFFIC.append(t)
    try:
        yield t
    finally:
        _TRAFFIC.remove(t)


def _count(op: str, result: torch.Tensor) -> None:
    if _TRAFFIC:
        _TRAFFIC[-1].add(op, result)


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``axes``, as a new tensor (no autograd)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=mesh.group(axes))
    _count("all-reduce", y)
    return y


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, concatenated along ``dim`` in the
    axes' order (a tiled ``all_gather``; no autograd)."""
    n = mesh.axis_size(axes)
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.group(axes))
    out = torch.cat(parts, dim=dim)
    _count("all-gather", out)
    return out


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, of which this rank keeps its block
    along ``dim`` (a tiled ``psum_scatter``; no autograd)."""
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(
            f"dim {dim} of {tuple(x.shape)} does not divide over {axes} = {n}")
    send = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((send.shape[0] // n,) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=send.device)
    dist.reduce_scatter_tensor(out, send, group=mesh.group(axes))
    _count("reduce-scatter", out)
    return out.movedim(0, dim)


def chunk(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes``."""
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(
            f"dim {dim} of {tuple(x.shape)} does not divide over {axes} = {n}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axes) * size, size)


def exchange(x: torch.Tensor, mesh, axes, split_dim: int,
             concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all of ``jax.lax.all_to_all``: ``x`` split into
    ``n`` blocks along ``split_dim``, block ``j`` sent to rank ``j`` of
    ``axes``, and the blocks received concatenated along ``concat_dim``
    in rank order (no autograd). A float8 tensor travels as its bytes:
    gloo refuses float8, and its bytes are what NCCL would move."""
    n = mesh.axis_size(axes)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"dim {split_dim} of {tuple(x.shape)} does not split over {axes} = {n}")
    wire = x.detach()
    if wire.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        wire = wire.view(torch.uint8)
    send = torch.stack(wire.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group(axes))
    if recv.dtype != x.dtype:
        recv = recv.view(x.dtype)
    _count("all-to-all", recv)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _PmaxLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        out = all_reduce(x, mesh, axes, dist.ReduceOp.MAX)
        ctx.mesh, ctx.axes = mesh, axes
        ctx.save_for_backward(x == out)
        return out

    @staticmethod
    def backward(ctx, g):
        (mine,) = ctx.saved_tensors
        # The ranks holding the maximum share the summed gradient evenly.
        holders = all_reduce(mine.to(g.dtype), ctx.mesh, ctx.axes)
        g = all_reduce(g, ctx.mesh, ctx.axes)
        return torch.where(mine, g / holders.clamp_min(1), 0), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return chunk(x, mesh, axes, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, concat_dim, split_dim)
        return exchange(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, *ctx.args), None, None, None, None


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def copy_to(x, mesh, axes):
    """Identity; the backward sums the gradient over ``axes`` (a
    replicated tensor entering work split over the axes)."""
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x, mesh, axes):
    """Sum over ``axes``; the backward passes the gradient through (the
    sum is used alike on every rank of the axes)."""
    return _ReduceFrom.apply(x, mesh, axes)


def psum_linear(x, mesh, axes):
    """Sum over ``axes``; the backward sums the gradient over them too."""
    return _PsumLinear.apply(x, mesh, axes)


def pmax_linear(x, mesh, axes):
    """Elementwise max over ``axes``; the backward sums the gradient
    over them and hands it to the ranks that hold the max."""
    return _PmaxLinear.apply(x, mesh, axes)


def gather_from(x, mesh, axes, dim):
    """Every rank's chunk concatenated along ``dim``; the backward keeps
    this rank's chunk of the (replicated) gradient."""
    return _GatherFrom.apply(x, mesh, axes, dim)


def scatter_to(x, mesh, axes, dim):
    """This rank's chunk of a replicated ``x`` along ``dim``; the
    backward gathers every rank's chunk of the gradient."""
    return _ScatterTo.apply(x, mesh, axes, dim)


def all_to_all(x, mesh, axes, split_dim, concat_dim):
    """``exchange`` with the reverse exchange as its backward."""
    return _AllToAll.apply(x, mesh, axes, split_dim, concat_dim)


def grad_scale(x, scale: float):
    """Identity whose backward multiplies the gradient by ``scale``."""
    return _GradScale.apply(x, scale)
