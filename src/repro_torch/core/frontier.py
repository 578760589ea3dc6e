"""Frontier-compacted Shiloach-Vishkin connected components.

The port of ``repro.core.frontier``. An edge whose endpoints already
share a label can never hook again, so after the first few rounds most
of the dense engine's 2m walk is dead work. This engine compacts the
edge list to the **active frontier** (edges with ``D[a] != D[b]``)
between levels:

* the round body is ``components.sv_round_fns``, the same body the
  dense engine runs, so with ``sample_rounds=0`` labels AND round
  counts match ``sv_run`` exactly;
* buffers shrink along **power-of-two size levels**: a level runs SV
  rounds at a fixed edge-buffer size until the frontier mask falls to
  half the buffer, then the buffer is compacted into the next
  power-of-two bucket (padded with inert (0, 0) self-loops) and the
  round state ``(D, Q, s)`` carries on unchanged.

The round loop is a host loop: after each round the host reads the
"changed" flag and the live count together (one device->host read per
round). The reference keeps a level's rounds on the device and reads
once per level.

The optional **Afforest-style sampling pre-pass** (``sample_rounds=k >
0``; Sutton, Ben-Nun & Barak, IPDPS 2018) runs k SV rounds that hook
each node through one sampled incident edge, then compacts the full
edge list once. It changes which root represents each component, so it
is off unless asked for (or turned on by the dispatch's auto rule).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.components import (
    HOOK_IMPLS,
    ConvergenceError,
    _maybe_dedup,
    check_choice,
    init_hooks,
    oriented_edges,
    sv_compress,
    sv_round_bound,
    sv_round_fns,
)
from repro_torch.core.operators import (
    bucket_size,
    compact_frontier,
    run_bucket_ladder,
)
from repro_torch.obs import trace


@dataclass
class FrontierStats:
    """Work accounting for the frontier engine.

    ``edges_touched`` counts edge-slot visits the way the paper's
    Table 4 counts kernel work: each SV round walks its edge buffer
    TWICE (one SV2 pass, one SV3 pass, which also yields the live mask),
    each compaction writes the new buffer once, and the sampling
    pre-pass streams the full edge list once to build its (n, k) table.
    The dense engine's same-metric cost is ``2 * m2 * rounds``.
    """

    rounds: int  # total SV rounds (pre-pass included)
    edges_touched: int  # per-phase edge-slot visits (see docstring)
    m2: int  # oriented edge count after dedup (dense walks this per phase)
    levels: list = field(default_factory=list)  # (buffer_size, rounds) pairs
    sample_rounds: int = 0
    live_after_sample: int = 0  # frontier size after the pre-pass
    largest_component_frac: float = 0.0  # node share of the Afforest giant

    def publish(self, registry=None, prefix: str = "cc.frontier") -> None:
        """Publish into the metrics registry (``repro_torch.obs.metrics``)."""
        from repro_torch.obs.metrics import publish_stats

        publish_stats(self, prefix, registry)


def run_level(body, D, Q, aux, s, m_loc, *, bound, shrink_at,
              reduce_flags=None):
    """Run SV rounds of ``body`` (an ``sv_round_fns`` body built with
    ``with_frontier=True`` over an ``m_loc``-edge buffer) until
    convergence, the round bound, or (when ``shrink_at`` is set) the
    frontier mask drops to half the buffer -- whichever comes first. The
    mask is the round body's own SV3 compare, a superset of the
    truly-live edges, which only delays a shrink, never breaks one.

    After each round the host reads the changed flag and the live count
    together, one read a round. ``reduce_flags`` (the sharded engine's
    MAX all-reduce) makes the live count the largest over the ranks
    first, so every rank takes the same branch. Returns ``(D, Q, aux, s,
    changed, fmask, live, rounds)``."""
    changed, live, rounds = True, m_loc, 0
    fmask = torch.ones(m_loc, dtype=torch.bool, device=D.device)
    while changed and s <= bound and (shrink_at is None or live > shrink_at):
        D, Q, aux, s, flag, fmask = body((D, Q, aux, s, changed, fmask))
        rounds += 1
        flags = torch.stack([flag.to(torch.int64), fmask.sum()])
        if reduce_flags is not None:
            flags = reduce_flags(flags)
        changed, live = flags.tolist()
        changed = bool(changed)
    return D, Q, aux, s, changed, fmask, live, rounds


def _build_samples(a, b, perm, *, n, k):
    """ONE streaming scatter pass over the 2m edges fills an (n, k)
    sampled-neighbor table. Write i (in permutation order) goes to
    ``(a[perm[i]], i % k)`` with value ``b[perm[i]]``, and where several
    writes hit one slot the last one wins -- what the reference's
    ``.at[].set`` does. A CUDA ``index_put_`` leaves the order of
    duplicates undefined, so the winner is chosen explicitly: a
    scatter-max of the write position, then a gather."""
    m = a.shape[0]
    pos = torch.arange(m, dtype=torch.int64, device=a.device)
    ap, bp = a[perm], b[perm]
    flat = ap.long() * k + pos % k
    win = torch.full((n * k,), -1, dtype=torch.int64, device=a.device)
    win.scatter_reduce_(0, flat, pos, "amax", include_self=True)
    tbl = torch.where(win >= 0, bp[win.clamp(min=0)], -1)
    return tbl.view(n, k)


def _sample_round(neigh, D, Q, s, aux, *, n, hook_impl,
                  record_hooks=False):
    """One SV round hooking every node through one sampled neighbor;
    nodes without a sample become inert self-loops. Its hook phases go
    through ``edge_hook`` like every other round's."""
    sa = torch.arange(n, dtype=torch.int32, device=D.device)
    sb = torch.where(neigh >= 0, neigh, sa)
    body = sv_round_fns(sa, sb, n, hook_impl=hook_impl,
                        record_hooks=record_hooks)
    D, Q, aux, s, _changed = body((D, Q, aux, s, True))
    return D, Q, aux, s


def _largest_component_frac(D, *, n) -> float:
    counts = torch.bincount(D.long(), minlength=n)
    return float(counts.max().to(torch.float32) / n)


def frontier_shiloach_vishkin(
    src,
    dst,
    num_nodes: int,
    *,
    max_rounds: int | None = None,
    dedup: bool = True,
    sample_rounds: int = 0,
    min_bucket: int = 1024,
    hook_impl: str = "auto",
    seed: int = 0,
    record_hooks: bool = False,
    with_stats: bool = False,
    device=None,
):
    """Connected components over a shrinking active-edge frontier.

    Bit-exact vs ``shiloach_vishkin`` (labels AND rounds) when
    ``sample_rounds=0``; with a sampling pre-pass the labels are a
    correct partition with possibly different representatives. Returns
    ``(labels, rounds)``, then ``(hook_u, hook_v)`` when
    ``record_hooks``, then ``FrontierStats`` when ``with_stats``. Host
    inputs go to ``device`` (default: the CUDA card); tensors stay where
    they are.
    """
    n = num_nodes
    check_choice("hook_impl", hook_impl, HOOK_IMPLS)
    src, dst = _maybe_dedup(src, dst, dedup)
    a, b = oriented_edges(src, dst, n, device)
    dev = a.device
    m2 = a.shape[0]

    bound = (max_rounds if max_rounds is not None else sv_round_bound(n))
    bound += sample_rounds
    D = torch.arange(n, dtype=torch.int32, device=dev)
    Q = torch.zeros(n, dtype=torch.int32, device=dev)
    s = 1
    # the round body's aux: the hook record, no exchange state
    aux = (init_hooks(n, dev), None) if record_hooks else None
    stats = FrontierStats(rounds=0, edges_touched=0, m2=m2,
                          sample_rounds=sample_rounds)

    if sample_rounds > 0 and m2 > 0:
        with trace.span("cc.frontier.sample", k=sample_rounds) as sample_sp:
            rng = np.random.default_rng(seed)
            perm = torch.from_numpy(rng.permutation(m2)).to(dev)
            samples = _build_samples(a, b, perm, n=n, k=sample_rounds)
            stats.edges_touched += m2  # the sampling pass streams all edges once
            for t in range(sample_rounds):
                D, Q, aux, s = _sample_round(
                    samples[:, t], D, Q, s, aux, n=n, hook_impl=hook_impl,
                    record_hooks=record_hooks,
                )
                stats.edges_touched += 2 * n  # SV2 + SV3 over the n sampled edges
            if with_stats:  # O(n) count + host read: only when asked for
                stats.largest_component_frac = _largest_component_frac(D, n=n)
            # Compact straight away: drops ALL edges internal to the giant
            # (and to every other component the pre-pass already resolved).
            live_mask = D[a] != D[b]
            live = int(live_mask.sum())
            stats.live_after_sample = live
            stats.edges_touched += m2  # full-list live scan
            size = bucket_size(live, min_bucket=min_bucket, cap=m2)
            a, b = compact_frontier(a, b, live_mask, size=size)
            m2_level = size
            sample_sp.tag(live=live)
    else:
        m2_level = m2

    fmask = None
    with trace.span("cc.frontier", n=n, m2=m2) as run_sp:

        def sv_level(bucket, shrink_at):
            nonlocal D, Q, aux, s, fmask
            with trace.span("cc.frontier.level", bucket=bucket) as sp:
                body = sv_round_fns(
                    a, b, n, hook_impl=hook_impl, with_frontier=True,
                    record_hooks=record_hooks,
                )
                D, Q, aux, s, changed, fmask, _, level_rounds = run_level(
                    body, D, Q, aux, s, a.shape[0], bound=bound,
                    shrink_at=shrink_at,
                )
                # SV2 + SV3 passes; SV3 exports the live mask.
                stats.edges_touched += 2 * level_rounds * bucket
                stats.levels.append((bucket, level_rounds))
                converged = not changed
                sp.tag(rounds=level_rounds, converged=converged)
            return converged, not converged and s > bound

        def live_edges():
            return int(fmask.sum())

        def charge_shrink(new_size):
            # The mask came out of this level's last SV3 pass; only the
            # gather-write of the surviving edges into the new buffer is
            # extra work.
            stats.edges_touched += new_size

        def shrink(new_size):
            nonlocal a, b
            a, b = compact_frontier(a, b, fmask, size=new_size)

        def bound_hit():
            raise ConvergenceError(
                f"frontier_shiloach_vishkin hit its round bound ({bound}"
                f"{f', incl. {sample_rounds} sampling rounds' if sample_rounds else ''})"
                f" before the label fixpoint on {n} nodes; raise max_rounds"
            )

        run_bucket_ladder(
            bucket=m2_level, min_bucket=min_bucket, run_level=sv_level,
            live_count=live_edges, compact=shrink, on_shrink=charge_shrink,
            on_nonconverged=bound_hit,
        )
        D = sv_compress(D, n)
        rounds_total = s - 1
        run_sp.tag(rounds=rounds_total, levels=len(stats.levels))
    stats.rounds = rounds_total
    out = (D, rounds_total)
    if record_hooks:
        out = out + (aux[0],)
    if with_stats:
        out = out + (stats,)
    return out
