"""Shortest paths on the frontier machinery: frontier Bellman-Ford.

The port of ``repro.core.sssp`` (see its docstring for the design). The
CC engine's hook-min-scatter becomes a relax-min-scatter,
``dist[:, b] = min(dist[:, b], dist[:, a] + w)``, an ``advance`` under
the ``MIN`` monoid: ``scatter_reduce(..., "amin")``, which gives the
same bits in any collision order, on the CPU and on the card alike. No
hand kernel is needed, and the reference has no Pallas kernel here.
BFS is the unit-weight case (``weights=None``).

Two engines share the relax round:

* ``bellman_ford`` -- the dense walk: every oriented edge relaxes every
  round. The reference runs its rounds in one ``lax.while_loop``; here a
  host loop reads the "changed" flag once per round.
* ``frontier_bellman_ford`` -- level-synchronous frontier relaxation:
  each level gathers only the edges out of nodes whose distance changed
  last round into a ``next_pow2``-bucketed buffer (inert (0, 0)
  zero-weight pads) and relaxes those, re-compacting from the full edge
  list every level (a settled edge wakes up when its source's distance
  later drops). One host read a level: the live count.

**Exactness.** Distances are the unique least fixpoint of the float32
relaxations (each candidate is one add, and min needs no order), so
both engines, batched and solo runs and the serial oracles
(``core/serial.py``) agree bit for bit. ``parent[v]`` is the minimum u
over non-self-loop arcs with ``dist[u] + w == dist[v]`` (min-CRCW
again), ``parent[source] = source``, and an unreachable node has
``dist = +inf`` and parent ``-1``.

**Batched multi-source** keeps the reference's ``(S, n)`` layout:
sources are rows of one distance matrix, relaxed by one scatter, and
each row equals its solo run bit for bit.

Negative weights are rejected up front: edges relax in both
orientations, so a negative edge is a negative cycle.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.components import (
    ConvergenceError,
    check_choice,
    oriented_edges,
    oriented_weights,
)
from repro_torch.core.operators import (
    MIN,
    advance,
    bucket_size,
    compact_weighted,
    run_rebuild_loop,
)
from repro_torch.obs import trace

# shortest_paths(engine=) choices: the knob "sssp_engine".
SSSP_ENGINES = ("auto", "frontier", "dense")

UNREACHABLE = -1  # parent sentinel for dist == +inf nodes


def sssp_round_bound(n: int) -> int:
    """Relax-round ceiling: a shortest path uses at most n - 1 edges,
    so n rounds always suffice (n - 1 improving + 1 confirming)."""
    return max(int(n), 1)


@dataclass
class SsspStats:
    """Work accounting for the SSSP engines, as in the reference.

    ``relax_visits`` counts one edge slot per buffer slot per relax
    round (the S source rows share each slot); the dense engine's is
    ``m2 * rounds``. ``mask_visits`` is the frontier engine's full-list
    frontier-mask gather, ``m2`` per level."""

    rounds: int
    relax_visits: int  # compacted relax slots walked (see docstring)
    mask_visits: int  # full-list frontier-mask gathers, m2 per level
    m2: int  # oriented edge count (dense relaxes this per round)
    num_sources: int
    levels: list = field(default_factory=list)  # (bucket, live) per level

    def publish(self, registry=None, prefix: str = "sssp.frontier") -> None:
        """Publish into the metrics registry (``repro_torch.obs.metrics``)."""
        from repro_torch.obs.metrics import publish_stats

        publish_stats(self, prefix, registry)


def _prep_edges(src, dst, weights, n: int, device=None):
    """Both-orientation arc tensors ``(a, b, w2)``: the repo's undirected
    2m walk. ``weights=None`` means unit weights (BFS). Host weights are
    validated (NaN and negative weights rejected; +inf is a legal
    "non-edge"); node ids outside ``[0, n)`` raise
    (``components.oriented_edges``)."""
    if weights is not None and isinstance(weights, (np.ndarray, list, tuple)):
        wh = np.asarray(weights, np.float32).ravel()
        if np.isnan(wh).any():
            raise ValueError("weights contain NaN")
        if (wh < 0).any():
            raise ValueError(
                "negative weights are unsupported: edges relax in both "
                "orientations (undirected), so a negative edge is a "
                "negative cycle"
            )
        weights = wh
    a, b = oriented_edges(src, dst, n, device)
    return a, b, oriented_weights(weights, a)


def _prep_sources(sources, n: int):
    """Normalized (sources int32 array, scalar?) pair. Scalar callers
    get (n,)-shaped results back; array callers the (S, n) batch."""
    scalar = np.ndim(sources) == 0
    srcs = np.atleast_1d(np.asarray(sources, np.int32))
    if srcs.size < 1:
        raise ValueError("need at least one source")
    if srcs.min() < 0 or srcs.max() >= n:
        raise ValueError(
            f"sources outside [0, {n}): {srcs[(srcs < 0) | (srcs >= n)]}"
        )
    return srcs, scalar


def _init_dist(srcs: torch.Tensor, n: int) -> torch.Tensor:
    S = srcs.shape[0]
    dist = torch.full((S, n), float("inf"), dtype=torch.float32,
                      device=srcs.device)
    dist[torch.arange(S, device=srcs.device), srcs.long()] = 0.0
    return dist


def _bf_dense(a, b, w, dist0, *, bound):
    """All-edges-every-round Bellman-Ford. Returns ``(dist, rounds,
    converged)``; the host reads the "changed" flag once per round."""
    dist, s, changed = dist0, 1, True
    while changed and s <= bound:
        new = advance(dist, b, dist[:, a] + w, monoid=MIN)
        changed = bool((new < dist).any())
        dist, s = new, s + 1
    return dist, s - 1, not changed


def _min_parents(a, b, w, dist, srcs):
    """Deterministic parent recovery (one full-edge pass after the
    distance fixpoint): ``parent[v] = min{u : dist[u] + w(u, v) ==
    dist[v], u != v}`` by a min-scatter; sources point at themselves,
    unreachable nodes at ``UNREACHABLE``."""
    S, n = dist.shape
    opt = (dist[:, a] + w == dist[:, b]) & (a != b)[None, :]
    cand = torch.where(opt, a[None, :], n)
    parent = advance(
        torch.full((S, n), n, dtype=torch.int32, device=dist.device), b, cand,
        monoid=MIN,
    )
    parent = torch.where(parent < n, parent, UNREACHABLE)
    parent = torch.where(torch.isinf(dist), UNREACHABLE, parent)
    parent[torch.arange(S, device=dist.device), srcs.long()] = srcs
    return parent


def _relax_level(ca, cb, cw, dist):
    """One relax round over a compacted edge buffer. Returns the new
    distance matrix and the (n,) any-row node-improved mask that seeds
    the next level's frontier."""
    new = advance(dist, cb, dist[:, ca] + cw, monoid=MIN)
    return new, (new < dist).any(dim=0)


def bellman_ford(
    src,
    dst,
    weights,
    num_nodes: int,
    *,
    sources=0,
    max_rounds: int | None = None,
    with_stats: bool = False,
    device=None,
):
    """Dense Bellman-Ford: relax all 2m oriented edges per round until
    the distance fixpoint. Returns ``(dist, parent, rounds)`` -- float32
    distances (``+inf`` unreachable), int32 parents (``_min_parents``)
    shaped ``(n,)`` for a scalar source and ``(S, n)`` for an array of
    sources, and the round count as an int. ``with_stats`` appends
    ``SsspStats``. Hitting ``max_rounds`` (default
    ``sssp_round_bound(n)``, which always suffices) before the fixpoint
    raises ``ConvergenceError``. Host inputs go to ``device`` (default:
    the CUDA card); tensors stay where they are."""
    n = num_nodes
    a, b, w2 = _prep_edges(src, dst, weights, n, device)
    m2 = int(a.shape[0])
    srcs, scalar = _prep_sources(sources, n)
    bound = max_rounds if max_rounds is not None else sssp_round_bound(n)
    srcs_t = torch.from_numpy(srcs).to(a.device)
    with trace.span(
        "sssp.dense", device=True, n=n, m2=m2, sources=int(srcs.shape[0]),
        bound=bound,
    ) as sp:
        dist, rounds, converged = _bf_dense(
            a, b, w2, _init_dist(srcs_t, n), bound=bound
        )
        parent = _min_parents(a, b, w2, dist, srcs_t)
        sp.block_on(dist)
    if not converged:
        raise ConvergenceError(
            f"bellman_ford hit max_rounds={bound} before the "
            f"distance fixpoint on {n} nodes; raise max_rounds (the "
            f"safe bound is sssp_round_bound(n)={sssp_round_bound(n)})"
        )
    if scalar:
        dist, parent = dist[0], parent[0]
    if with_stats:
        stats = SsspStats(
            rounds=rounds, relax_visits=m2 * rounds, mask_visits=0, m2=m2,
            num_sources=int(srcs.shape[0]),
        )
        return dist, parent, rounds, stats
    return dist, parent, rounds


def frontier_bellman_ford(
    src,
    dst,
    weights,
    num_nodes: int,
    *,
    sources=0,
    max_rounds: int | None = None,
    min_bucket: int = 1024,
    with_stats: bool = False,
    device=None,
):
    """Level-synchronous frontier Bellman-Ford: each level relaxes only
    the edges out of nodes whose distance improved last round, gathered
    into a ``next_pow2`` size bucket. Distances, parents and rounds equal
    ``bellman_ford``'s bit for bit; the return convention and the
    ``ConvergenceError`` sentinel are the same. The host reads each
    level's live count (the level-synchronous sync)."""
    n = num_nodes
    a, b, w2 = _prep_edges(src, dst, weights, n, device)
    dev = a.device
    m2 = int(a.shape[0])
    srcs, scalar = _prep_sources(sources, n)
    S = int(srcs.shape[0])
    bound = max_rounds if max_rounds is not None else sssp_round_bound(n)
    srcs_t = torch.from_numpy(srcs).to(dev)
    dist = _init_dist(srcs_t, n)
    # Level 0 frontier: the source rows' one-hot improvement mask.
    changed_nodes = torch.zeros(n, dtype=torch.bool, device=dev)
    changed_nodes[srcs_t.long()] = True
    stats = SsspStats(
        rounds=0, relax_visits=0, mask_visits=0, m2=m2, num_sources=S
    )
    fmask = None
    with trace.span("sssp.frontier", n=n, m2=m2, sources=S) as run_sp:

        def live_edges():
            nonlocal fmask
            if m2 == 0:
                return 0
            fmask = changed_nodes[a]
            stats.mask_visits += m2
            # The level-synchronous sync: the host reads the live count
            # to pick the next power-of-two bucket.
            return int(fmask.sum())

        def relax(live):
            nonlocal dist, changed_nodes
            size = bucket_size(live, min_bucket=min_bucket, cap=m2)
            with trace.span("sssp.level", bucket=size, live=live):
                ca, cb, cw = compact_weighted(a, b, w2, fmask, size=size)
                dist, changed_nodes = _relax_level(ca, cb, cw, dist)
            stats.relax_visits += size
            stats.levels.append((size, live))

        def bound_hit(live, _rounds):
            raise ConvergenceError(
                f"frontier_bellman_ford hit its round bound "
                f"({bound}) with {live} frontier edges still live "
                f"on {n} nodes; raise max_rounds (the safe bound "
                f"is sssp_round_bound(n)={sssp_round_bound(n)})"
            )

        rounds = run_rebuild_loop(
            bound=bound, live_count=live_edges, run_level=relax,
            on_bound=bound_hit,
        )
        run_sp.tag(rounds=rounds, levels=len(stats.levels))
    stats.rounds = rounds
    parent = _min_parents(a, b, w2, dist, srcs_t)
    if scalar:
        dist, parent = dist[0], parent[0]
    out = (dist, parent, rounds)
    if with_stats:
        out = out + (stats,)
    return out


def shortest_paths(
    src,
    dst,
    weights=None,
    num_nodes: int | None = None,
    *,
    sources=0,
    max_rounds: int | None = None,
    engine: str = "auto",
    **kwargs,
):
    """Single/multi-source shortest paths with engine dispatch. Returns
    ``(dist, parent, rounds)``: float32 distances (``+inf`` =
    unreachable), the min-id parent tree (``parent[source] = source``,
    unreachable ``-1``) and the relax-round count. A scalar ``sources``
    gives ``(n,)`` tensors, an array ``(S, n)``, each row bit-equal to
    its solo run. ``weights=None`` means unit weights: BFS.

    ``engine=`` -- ``"auto"`` (default), ``"frontier"``, ``"dense"``
    (knob ``sssp_engine``):

    * ``"auto"``: the frontier engine. The reference runs the dense
      engine instead under a ``jax.jit`` trace, where a host-driven
      loop cannot run; PyTorch runs eagerly, so that branch has no
      counterpart here.
    * ``"frontier"``: the level-synchronous frontier engine
      (``min_bucket=`` sizes its smallest bucket).
    * ``"dense"``: the all-edges-every-round walk.

    Both engines raise ``ConvergenceError`` when ``max_rounds`` cuts
    the relax loop before the distance fixpoint, and both take
    ``with_stats=True`` and ``device=`` (where host inputs go: the CUDA
    card by default).
    """
    if num_nodes is None:
        raise TypeError("shortest_paths requires num_nodes")
    check_choice("sssp_engine", engine, SSSP_ENGINES)
    if engine in ("auto", "frontier"):
        return frontier_bellman_ford(
            src, dst, weights, num_nodes, sources=sources,
            max_rounds=max_rounds, **kwargs,
        )
    if "min_bucket" in kwargs:
        raise ValueError(
            "min_bucket= is a frontier-engine option; use "
            "engine='frontier' (or 'auto')"
        )
    return bellman_ford(
        src, dst, weights, num_nodes, sources=sources,
        max_rounds=max_rounds, **kwargs,
    )
