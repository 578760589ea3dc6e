"""Advance / filter / compute operators for the frontier engines.

The port of ``repro.core.operators`` (see its docstring and
``docs/operators.md`` for the contract), which the CC, SSSP and
PageRank engines compose:

* **advance** -- the scatter half of gather-apply-scatter, collisions
  resolved by a commutative :class:`Monoid`. ``MIN`` (CC labels, SSSP
  distances) is idempotent, so any collision order gives the same bits.
  ``ADD`` (PageRank mass) is not: float adds do not associate, and the
  reference is bit-stable only because XLA's CPU/TPU scatter-add folds
  in edge-slot order. A CUDA ``index_add_`` folds through atomics in no
  fixed order, so the port's ``ADD`` never uses it: it sorts the index
  stably and folds each target's values in slot order, through the
  ``ordered_fold`` kernel on the card and its plain version on the CPU.
  A caller that scatters along one index many times builds the
  ``FoldPlan`` once (``kernels.ordered_fold.ops.fold_plan``) and passes
  it in place of the index; with a plan, the values may be a
  :class:`GatheredValues`, which the kernel gathers and multiplies itself
  (PageRank's mass step), so no m-long value array is written.
* **filter** -- ``next_pow2`` size buckets, ``bucket_size``, and
  ``compact_frontier`` / ``compact_weighted``, which gather the masked
  live edges into a fixed-size buffer padded with inert ``(0, 0)``
  (zero-weight) self-loops.
* **compute** -- a per-node map.

plus the two host drivers ``run_bucket_ladder`` (CC's shrinking
power-of-two levels) and ``run_rebuild_loop`` (the rebuild-every-level
loop), which raise ``ConvergenceError`` rather than let a loop that
stopped early return wrong results.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.core.components import ConvergenceError
from repro_torch.kernels.ordered_fold.ops import (
    FoldPlan,
    fold_plan,
    ordered_fold_gathered,
    ordered_fold_sorted,
)


@dataclass(frozen=True)
class Monoid:
    """A commutative monoid resolving ``advance`` scatter collisions.

    ``scatter(target, index, values)`` folds ``values`` into
    ``target[..., index]`` under the monoid's combine; ``identity`` is
    the pad value that makes a buffer slot inert."""

    name: str
    identity: float
    scatter: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _scatter_min(t: torch.Tensor, i: torch.Tensor, v: torch.Tensor):
    # Index the last (node) axis, for (n,) vectors and (S, n) rows alike.
    return t.scatter_reduce(
        -1, i.long().expand(v.shape), v, "amin", include_self=True
    )


class GatheredValues(NamedTuple):
    """ADD advance values that the fold gathers itself: slot ``s`` of a
    ``FoldPlan`` carries ``scale * (node[index[s]] * weight[s])``, each
    multiply rounded on its own; ``index`` and ``weight`` are in the plan's
    slot order (``x[plan.perm]`` of arrays in edge order)."""

    node: torch.Tensor
    index: torch.Tensor
    weight: torch.Tensor
    scale: torch.Tensor  # one float32 value


def _scatter_add(t: torch.Tensor, i, v):
    # Slot-order fold along the last (node) axis; ``i`` is an index or a
    # FoldPlan built from one. (S, n) rows fold one row at a time.
    if isinstance(v, GatheredValues):
        if not isinstance(i, FoldPlan) or t.dim() != 1:
            raise ValueError("GatheredValues need a FoldPlan and an (n,) target")
        return ordered_fold_gathered(t, i.row_ptr, v.index, v.node, v.weight,
                                     v.scale)
    plan = i if isinstance(i, FoldPlan) else fold_plan(i, t.shape[-1])
    if t.dim() == 1:
        return ordered_fold_sorted(t, plan.row_ptr, plan.perm, v)
    return torch.stack([
        ordered_fold_sorted(tr, plan.row_ptr, plan.perm, vr)
        for tr, vr in zip(t, v.expand(t.shape[0], -1))
    ])


MIN = Monoid("min", float("inf"), _scatter_min)
ADD = Monoid("add", 0.0, _scatter_add)


def advance(target, index, values, *, monoid: Monoid):
    """One advance step: scatter ``values`` into ``target`` at ``index``
    (the last -- node -- axis), collisions resolved by ``monoid``."""
    return monoid.scatter(target, index, values)


def compute(fn: Callable, *arrays):
    """Per-node map: apply elementwise ``fn`` over node-indexed arrays."""
    return fn(*arrays)


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 0): the bucket ladder the
    frontier engine sizes its compacted edge buffers on."""
    return 1 << max(x - 1, 0).bit_length() if x > 0 else 1


def bucket_size(live: int, *, min_bucket: int, cap: int | None = None) -> int:
    """The ``next_pow2`` ceiling of the live count, floored at
    ``min_bucket`` and clipped to ``cap``."""
    size = max(min_bucket, next_pow2(live))
    return size if cap is None else min(cap, size)


def _compact(fmask, size, *arrays):
    # A cumulative sum gives each live slot its place; one scatter per
    # array moves it there, dropped lanes going to a scratch slot past
    # the end that is cut off.
    slot = torch.cumsum(fmask, 0) - 1
    tgt = torch.where(fmask, slot, size).clamp_(max=size)
    return tuple(x.new_zeros(size + 1).scatter_(0, tgt, x)[:size]
                 for x in arrays)


def compact_frontier(a, b, fmask, *, size):
    """Gather the masked frontier into a ``size``-slot buffer, in edge
    order, padding with inert (0, 0) self-loops.

    The counterpart of ``jnp.nonzero(fmask, size=size)``, with no
    device->host read. Live edges past ``size`` are dropped, as
    ``jnp.nonzero`` truncates; callers size the buffer to cover the live
    count."""
    return _compact(fmask, size, a, b)


def compact_weighted(a, b, w, fmask, *, size):
    """``compact_frontier`` with a weight lane: pads are inert (0, 0)
    zero-weight self-loops (a self-relax never improves, and 0.0 is the
    ADD identity, so they are inert under both monoids)."""
    return _compact(fmask, size, a, b, w)


def run_bucket_ladder(
    *,
    bucket: int,
    min_bucket: int,
    run_level: Callable[[int, int | None], tuple[bool, bool]],
    live_count: Callable[[], int],
    compact: Callable[[int], None],
    on_shrink: Callable[[int], None] | None = None,
    on_nonconverged: Callable[[], None] | None = None,
) -> None:
    """The MONOTONE frontier loop (CC's shrinking bucket ladder): run
    levels at a fixed buffer size, shrink the buffer to the live
    frontier's ``next_pow2`` bucket between levels, never re-expand.

    ``run_level(bucket, shrink_at)`` runs one level and returns
    ``(converged, stop)``; ``shrink_at`` is the half-buffer watermark
    the level may stop early on (``None``: run to convergence or the
    bound). ``live_count()`` reads the live frontier size,
    ``on_shrink(new_bucket)`` is the stats hook charged before
    ``compact(new_bucket)`` rebuilds the buffer. A ladder that stops
    without converging calls ``on_nonconverged`` and otherwise raises a
    generic ``ConvergenceError``.
    """
    force_converge = False
    while True:
        shrink_at = (
            None if (bucket <= min_bucket or force_converge)
            else bucket // 2
        )
        converged, stop = run_level(bucket, shrink_at)
        if converged or stop:
            break
        live = live_count()
        new_bucket = max(min_bucket, next_pow2(live))
        if new_bucket >= bucket:  # can't shrink: run to convergence
            force_converge = True
            continue
        if on_shrink is not None:
            on_shrink(new_bucket)
        compact(new_bucket)
        bucket = new_bucket
    if not converged:
        if on_nonconverged is not None:
            on_nonconverged()
        raise ConvergenceError("bucket ladder stopped before convergence")


def run_rebuild_loop(
    *,
    bound: int,
    live_count: Callable[[], int],
    run_level: Callable[[int], None],
    on_bound: Callable[[int, int], None] | None = None,
) -> int:
    """The REBUILDING frontier loop: every level asks ``live_count()``
    for the current live size, stops at zero, and otherwise runs
    ``run_level(live)``. Returns the number of levels run. Hitting
    ``bound`` with a live frontier calls ``on_bound(live, rounds)`` and
    otherwise raises ``ConvergenceError``."""
    rounds = 0
    while True:
        live = live_count()
        if not live:
            return rounds
        if rounds >= bound:
            if on_bound is not None:
                on_bound(live, rounds)
            raise ConvergenceError(
                f"rebuild loop hit its round bound ({bound}) with "
                f"{live} live"
            )
        run_level(live)
        rounds += 1
