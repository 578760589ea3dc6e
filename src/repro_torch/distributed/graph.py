"""Edge-partitioned graph engine on ``torch.distributed``.

The port of ``repro.distributed.graph``: the paper's two algorithms
across a 1-D group of ranks, **edges partitioned, labels replicated**,
each round ending in one associative label exchange.

* ``sharded_shiloach_vishkin`` -- each rank min-hooks over its own edge
  block into its replica of the labels ``D``; a MIN all-reduce after SV2
  (with a MAX all-reduce of the stamps ``Q``) and another after SV3 make
  every replica equal to the single-device min-scatter, because a
  min-scatter distributes over unions of edge blocks. Short-cuts touch
  only replicated state and run on every rank with no communication.
  ``exchange="sparse"`` sends only the (index, label) pairs each rank's
  scatter changed, in a fixed-capacity buffer (default n/8), all-gathered
  and applied again onto the shared pre-scatter base -- still bit-exact.
  When a round's largest change count overflows the buffer, every rank
  takes the dense path for that merge.
* ``sharded_frontier_shiloach_vishkin`` -- the same, with each rank
  compacting its own edge block to the live frontier between
  power-of-two bucket levels (``core.frontier``'s ladder).
* ``sharded_random_splitter_rank`` -- RS3's sub-list walks split by
  splitter block (rank d walks lanes ``[d*pp/P, (d+1)*pp/P)``); the
  walk stores merge with one MAX all-reduce (sub-lists partition the
  nodes, so exactly one rank writes each node); RS4 all-gathers the
  p-lane splitter list and ranks it on every rank through the
  ``pointer_jump`` kernel; RS5 aggregates each rank's node block through
  ``splitter_aggregate``.

How ``shard_map`` maps onto ranks: ``in_specs=P(axis)`` is contiguous
block d of the padded array on rank d (edges padded with inert ``(0,
0)`` self-loops to a multiple of P, the reference's blocks, so the
per-rank counters agree); ``out_specs=P()`` is the replicated array
every rank returns. RS5's ``P(axis)`` output is all-gathered here, so
every rank returns the whole rank array. Every rank deduplicates the
same host input, which is deterministic and needs no broadcast.

The reference's level loops are device ``while_loop``s over a pmax'd
live count; here they are host loops, one read a round, and every value
the host branches on (the changed flag, the live count, a sparse
exchange's overflow count, the walk's convergence) is the all-reduced
one, so every rank takes the same branch and raises ``ConvergenceError``
at the same point. The hook phases go through ``edge_hook`` on each
rank's block: the CUDA kernel on the card, its plain version on the CPU.
The kernel picks its packed or direct path from the block's edge count
and n (``kernels/edge_hook/ops.py::packed_path``), so at P > 1 a block
may take the direct path where the whole graph takes the packed one;
both are bit-exact.
A mesh on the card runs NCCL, on the CPU gloo; nothing switches
between them, and a failing collective raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

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
    sv_run,
)
from repro_torch.core.frontier import run_level
from repro_torch.core.list_ranking import (
    KERNEL_IMPLS,
    SplitterStats,
    _splitter_list_rank,
    aos_walk_fns,
    max_splitters_for_linear_work,
    select_splitters,
)
from repro_torch.core.operators import compact_frontier, run_bucket_ladder
from repro_torch.core.pram import lockstep_walk
from repro_torch.device import as_int32, resolve_device
from repro_torch.kernels.edge_hook.ref import drop_scatter_fill, drop_scatter_min
from repro_torch.kernels.pointer_jump.ops import default_iters
from repro_torch.kernels.splitter_aggregate.ops import splitter_aggregate
from repro_torch.obs import trace

GRAPH_AXIS = "graph"

# Valid cross-rank label-exchange modes for the sharded CC engines. The
# frontier engine defaults to "sparse", the dense engine to "dense".
EXCHANGES = ("dense", "sparse")

_MIN, _MAX = dist.ReduceOp.MIN, dist.ReduceOp.MAX


@dataclass(frozen=True)
class GraphMesh:
    """A 1-D group of ranks: what ``jax.sharding.Mesh`` is to the
    reference. ``group`` is the process group (``None``: the default
    one); ``device`` is where this rank's tensors live."""

    axis_names: tuple
    size: int
    rank: int
    group: object
    device: torch.device


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def graph_mesh(
    num_devices: int | None = None, axis: str = GRAPH_AXIS, device=None
) -> GraphMesh:
    """1-D mesh over the ranks of the default process group (default:
    all of them, the counterpart of "all visible devices").

    With no group initialised, ``graph_mesh()`` / ``graph_mesh(1)``
    starts a one-rank group from an in-memory store (no network): NCCL
    for the card, gloo for ``device="cpu"``. The collectives then run
    for real with one participant. A mesh on the card needs a group
    whose backend serves CUDA tensors (NCCL) and on the CPU one that
    serves CPU tensors (gloo); anything else raises. On a card this
    rank's tensors live on the current CUDA device (set it with
    ``torch.cuda.set_device`` before). Asking for more ranks than the
    group has raises ``ValueError``, and so does asking for fewer: a
    mesh here spans its whole group.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = _backend_for(dev)
    if not dist.is_initialized():
        nd = 1 if num_devices is None else num_devices
        if nd != 1:
            raise ValueError(
                f"asked for {nd} devices, have 1: no process group is "
                f"initialised (start {nd} ranks with "
                "torch.distributed.init_process_group first)"
            )
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1
        )
    world = dist.get_world_size()
    nd = world if num_devices is None else num_devices
    if nd > world:
        raise ValueError(f"asked for {nd} devices, have {world}")
    if nd != world:
        raise ValueError(
            f"asked for {nd} of the group's {world} ranks: a mesh spans "
            "its whole process group here; start the group with "
            f"{nd} ranks"
        )
    have = dist.get_backend()
    if backend not in have:
        raise ValueError(
            f"a mesh on {dev} needs the {backend} backend; the process "
            f"group runs {have!r}"
        )
    return GraphMesh((axis,), nd, dist.get_rank(), None, dev)


def _resolve_axis(mesh: GraphMesh, axis: str) -> str:
    """Accept any 1-D mesh regardless of its axis name; a multi-axis
    mesh must name the axis that carries the edges."""
    if axis in mesh.axis_names:
        return axis
    if len(mesh.axis_names) == 1:
        return mesh.axis_names[0]
    raise ValueError(
        f"sharded graph engine needs a 1-D mesh or axis={axis!r} present; "
        f"got mesh axes {mesh.axis_names}"
    )


def _mesh_for(mesh, axis: str, device, data) -> GraphMesh:
    """The caller's mesh (its device must agree with ``device=``, if
    given) or ``graph_mesh(axis=axis, device=...)`` on ``device``, else
    on the device of ``data`` where it is a tensor (tensors stay on
    their device), else on the card."""
    if mesh is None:
        if device is None and isinstance(data, torch.Tensor):
            device = data.device
        return graph_mesh(axis=axis, device=device)
    _resolve_axis(mesh, axis)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(
            f"device={device!r} differs from the mesh's device "
            f"{mesh.device}"
        )
    return mesh


def _pad_to(x: torch.Tensor, size: int, fill) -> torch.Tensor:
    if x.shape[0] == size:
        return x
    pad = x.new_full((size - x.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad])


def _all_reduce(mesh: GraphMesh, x: torch.Tensor, op) -> torch.Tensor:
    """``x`` reduced over the mesh, as a new tensor (every value the
    engines reduce is an integer: flags travel as int64 or int32)."""
    y = x.clone()
    dist.all_reduce(y, op=op, group=mesh.group)
    return y


def _all_gather(mesh: GraphMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x``, concatenated along dim 0 in rank order (a
    tiled ``all_gather``)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def _shard_edges(src, dst, n, mesh: GraphMesh, *, dedup: bool):
    """This rank's block of the oriented edges ``(a, b)`` (both
    orientations of the deduplicated input), padded with ``(0, 0)``
    self-loops to a multiple of the mesh size, and the global count m2.
    The block is a copy of its own, so it is aligned like any fresh
    tensor."""
    src, dst = _maybe_dedup(src, dst, dedup)
    a, b = oriented_edges(src, dst, n, mesh.device)
    a, b = a.to(mesh.device), b.to(mesh.device)
    m2 = int(a.shape[0])
    blk = max(-(-m2 // mesh.size), 1)
    a, b = _pad_to(a, blk * mesh.size, 0), _pad_to(b, blk * mesh.size, 0)
    lo = mesh.rank * blk
    return a[lo:lo + blk].clone(), b[lo:lo + blk].clone(), m2


# ---------------------------------------------------------------------------
# Sharded Shiloach-Vishkin connected components
# ---------------------------------------------------------------------------


def _exchange_aux(bound: int, device):
    """The exchange counters, indexed by round: int32 words one rank
    sent (known on the host) and the largest per-rank change count (a
    device value, never read until the stats are asked for)."""
    return (
        np.zeros(bound + 2, np.int32),
        torch.zeros(bound + 2, dtype=torch.int32, device=device),
    )


def _dense_merge_fns(mesh: GraphMesh, n: int):
    """The replicated-label exchanges: full MIN/MAX all-reduces every
    round."""

    def merge_labels(d, base, aux, s):
        words, frontier = aux
        cnt = _all_reduce(mesh, (d != base).sum().to(torch.int32).view(1), _MAX)
        words[s] += n
        frontier[s] = torch.maximum(frontier[s], cnt[0])
        return _all_reduce(mesh, d, _MIN), aux

    def merge_stamps(q, base, aux, s):
        aux[0][s] += n
        return _all_reduce(mesh, q, _MAX), aux

    return merge_labels, merge_stamps


def _first_changed(changed: torch.Tensor, capacity: int, n: int):
    """The first ``capacity`` indices where ``changed`` holds, in order,
    padded with ``n`` (``jnp.nonzero(changed, size=C, fill_value=n)``),
    without a device->host read."""
    slot = torch.cumsum(changed, 0) - 1
    tgt = torch.where(changed, slot, capacity).clamp_(max=capacity)
    idx = torch.full((capacity + 1,), n, dtype=torch.int32, device=changed.device)
    ids = torch.arange(changed.shape[0], dtype=torch.int32, device=changed.device)
    return idx.scatter_(0, tgt, ids)[:capacity]


def _sparse_merge_fns(mesh: GraphMesh, n: int, capacity: int):
    """Sparse frontier exchange: each rank publishes only the (index,
    label) pairs its own min-scatter changed this round, in a
    fixed-capacity buffer; every replica applies the all-gathered pairs
    onto the common pre-scatter base. A min-scatter distributes over
    unions of edge blocks, so ``base.at[union of idx].min(vals)`` equals
    the MIN all-reduce of the full arrays whenever every rank's change
    count fits the buffer. The all-reduced largest count, read on the
    host, sends every rank down the same branch."""
    C = capacity

    def count_max(changed):
        cnt = _all_reduce(mesh, changed.sum().to(torch.int32).view(1), _MAX)
        return cnt, int(cnt)

    def merge_labels(d, base, aux, s):
        words, frontier = aux
        changed = d != base
        cnt, cnt_max = count_max(changed)
        overflow = cnt_max > C
        if overflow:
            merged = _all_reduce(mesh, d, _MIN)
        else:
            idx = _first_changed(changed, C, n)
            vals = torch.where(idx < n, d[idx.clamp(max=n - 1)], n)
            merged = drop_scatter_min(
                base, _all_gather(mesh, idx), _all_gather(mesh, vals)
            )
        # 2C words (idx, label) when sparse, n when dense; +1 for the
        # all-reduced overflow count either way.
        words[s] += (n if overflow else 2 * C) + 1
        frontier[s] = torch.maximum(frontier[s], cnt[0])
        return merged, aux

    def merge_stamps(q, base, aux, s):
        changed = q != base
        _, cnt_max = count_max(changed)
        overflow = cnt_max > C
        if overflow:
            merged = _all_reduce(mesh, q, _MAX)
        else:
            # Every SV2 stamp this round is the same value s, so indices
            # alone carry the exchange (C words, not 2C).
            idx_all = _all_gather(mesh, _first_changed(changed, C, n))
            merged = drop_scatter_fill(base, idx_all, s)
        aux[0][s] += (n if overflow else C) + 1
        return merged, aux

    return merge_labels, merge_stamps


def _merge_fns(mesh: GraphMesh, n: int, exchange: str, capacity: int,
               record_hooks: bool):
    """The label, stamp and hook merges of one exchange mode. Hook
    recording merges with MIN: candidate winning-edge arrays use the
    sentinel n, so the two-step (u, then v) MIN of each phase finds the
    lexicographically smallest global winner even when it lies in
    another rank's block."""
    if exchange == "sparse":
        ml, mq = _sparse_merge_fns(mesh, n, capacity)
    else:
        ml, mq = _dense_merge_fns(mesh, n)
    mh = (lambda arr: _all_reduce(mesh, arr, _MIN)) if record_hooks else None
    return ml, mq, mh


@dataclass
class CCExchangeStats:
    """Measured per-round exchange volume.

    ``words_per_round[r]`` is the int32 words one rank sent in round r+1
    across all three exchanges; ``frontier_per_round[r]`` is the largest
    per-rank changed-label count that round (the sparse payload the
    fixed-capacity buffer must hold to stay off the dense fallback)."""

    words_per_round: np.ndarray
    frontier_per_round: np.ndarray
    exchange: str
    capacity: int | None

    def publish(self, registry=None, prefix: str = "cc.sharded") -> None:
        """Publish into the metrics registry (``repro_torch.obs.metrics``)."""
        from repro_torch.obs.metrics import publish_stats

        publish_stats(self, prefix, registry)


def default_sparse_capacity(num_nodes: int) -> int:
    """Per-rank (index, label) buffer: n/8 keeps a no-overflow round's
    label exchange at n/4 words against the dense path's n."""
    return max(64, num_nodes // 8)


def sharded_shiloach_vishkin(
    src,
    dst,
    num_nodes: int,
    *,
    mesh: GraphMesh | None = None,
    axis: str = GRAPH_AXIS,
    max_rounds: int | None = None,
    exchange: str = "dense",
    sparse_capacity: int | None = None,
    dedup: bool = True,
    record_hooks: bool = False,
    with_stats: bool = False,
    device=None,
):
    """Multi-rank connected components, bit-exact against one device.

    Edges (both orientations, minus self-loops and duplicates of host
    inputs) are split over the mesh's ranks; labels are replicated and
    merged twice a round. ``exchange="sparse"`` sends only the (index,
    label) pairs each rank changed (capacity ``sparse_capacity``,
    default n/8, dense fallback on overflow). Returns ``(labels,
    rounds)`` like ``shiloach_vishkin``, plus the ``(hook_u, hook_v)``
    record when ``record_hooks``, plus a ``CCExchangeStats`` when
    ``with_stats``. Every rank returns the same values. The mesh
    defaults to ``graph_mesh(axis=axis, device=...)`` on ``device``, or
    on the device of tensor inputs, or on the card; inputs go to the
    mesh's device. The reference takes no ``hook_impl`` here; the hooks
    run through ``edge_hook``'s "auto" route.
    """
    check_choice("exchange", exchange, EXCHANGES)
    mesh = _mesh_for(mesh, axis, device, src)
    n, nd = num_nodes, mesh.size
    a, b, _ = _shard_edges(src, dst, n, mesh, dedup=dedup)
    capacity = (
        sparse_capacity if sparse_capacity is not None
        else default_sparse_capacity(n)
    )
    bound = max_rounds if max_rounds is not None else sv_round_bound(n)
    ml, mq, mh = _merge_fns(mesh, n, exchange, capacity, record_hooks)
    with trace.span(
        "cc.sharded", device=True, n=n, devices=nd, exchange=exchange,
    ) as sp:
        res = sv_run(
            a, b, n, bound, ml, mq, aux0=_exchange_aux(bound, mesh.device),
            return_aux=True, record_hooks=record_hooks, merge_hooks=mh,
        )
        labels, rounds, converged = res[0], res[1], res[2]
        words, frontier = res[-1]
        sp.block_on(labels)
    if not converged:
        # The flag comes from the merged stamps: every rank raises here.
        raise ConvergenceError(
            f"sharded_shiloach_vishkin hit max_rounds={bound} before the "
            f"label fixpoint on {n} nodes; raise max_rounds (the proven "
            f"bound is sv_round_bound(n)={sv_round_bound(n)})"
        )
    out = (labels, rounds) + ((res[3],) if record_hooks else ())
    if not with_stats:
        return out
    stats = CCExchangeStats(
        words_per_round=words[1:rounds + 1],
        frontier_per_round=frontier.cpu().numpy()[1:rounds + 1],
        exchange=exchange,
        capacity=capacity if exchange == "sparse" else None,
    )
    return out + (stats,)


def cc_exchange_words_per_round(
    num_nodes: int, *, stats: CCExchangeStats | None = None
):
    """int32 words a rank sends per SV round: the dense model
    MIN(D2) + MAX(Q) + MIN(D3) = 3n as a scalar, or with ``stats`` the
    measured per-round volumes as an array."""
    if stats is not None:
        return stats.words_per_round
    return 3 * num_nodes


# ---------------------------------------------------------------------------
# Sharded frontier-compacted Shiloach-Vishkin (per-rank edge frontiers)
# ---------------------------------------------------------------------------


@dataclass
class ShardedFrontierStats:
    """Work and exchange accounting for the sharded frontier engine.

    ``edges_touched`` counts **per-rank** edge-slot visits with the rules
    of ``core.frontier.FrontierStats`` (two hook passes a round over the
    local bucket, one bucket write a compaction); the dense sharded
    engine's same-metric cost is ``2 * ceil(m2 / nd) * rounds`` a rank.
    ``words_per_round`` / ``frontier_per_round`` are the measured
    exchange volumes, as in ``CCExchangeStats``; ``capacities`` lists the
    sparse buffer chosen at each level (empty for the dense exchange)."""

    rounds: int
    edges_touched: int  # per-rank edge-slot visits (see docstring)
    m2: int  # global oriented edge count after dedup
    num_devices: int
    levels: list = field(default_factory=list)  # (per-rank bucket, rounds)
    exchange: str = "sparse"
    capacities: list = field(default_factory=list)  # per-level sparse cap
    words_per_round: np.ndarray | None = None
    frontier_per_round: np.ndarray | None = None

    def publish(
        self, registry=None, prefix: str = "cc.sharded_frontier"
    ) -> None:
        """Publish into the metrics registry (``repro_torch.obs.metrics``)."""
        from repro_torch.obs.metrics import publish_stats

        publish_stats(self, prefix, registry)


def frontier_sparse_capacity(
    num_nodes: int, bucket: int, user_capacity: int | None = None
) -> int:
    """Per-rank sparse-exchange buffer for one frontier level: a rank's
    min-scatter changes at most one label a local edge, so the bucket
    bounds its change count, and once the frontier undercuts the fixed
    ``default_sparse_capacity`` the buffer shrinks with it and cannot
    overflow. An explicit ``user_capacity`` holds at every level."""
    if user_capacity is not None:
        return user_capacity
    return max(64, min(bucket, default_sparse_capacity(num_nodes)))


def sharded_frontier_shiloach_vishkin(
    src,
    dst,
    num_nodes: int,
    *,
    mesh: GraphMesh | None = None,
    axis: str = GRAPH_AXIS,
    max_rounds: int | None = None,
    exchange: str = "sparse",
    sparse_capacity: int | None = None,
    min_bucket: int = 1024,
    hook_impl: str = "auto",
    dedup: bool = True,
    record_hooks: bool = False,
    with_stats: bool = False,
    device=None,
):
    """Frontier-compacted CC on the mesh: the sharded engine (edges
    split, labels replicated, per-round exchanges) with each rank
    compacting its OWN edge block to the live frontier between bucket
    levels.

    Bit-exact in labels, rounds and recorded hook forests against the
    dense sharded engine and the single-device engines: the round body is
    the shared ``sv_round_fns``, compaction keeps every edge whose labels
    differ, and the ``(0, 0)`` padding is inert under both hook
    conditions. ``exchange="sparse"`` is the default, its buffer sized
    from the live frontier per level (``frontier_sparse_capacity``).
    ``hook_impl`` picks the ``edge_hook`` route of each rank's hook
    phases (``"auto"``: the CUDA kernel on the card). Every route counts
    two passes a round in ``edges_touched``, the reference's
    ``hook_impl="xla"`` count, because the kernel's sv3 exports the live
    mask. Returns ``(labels, rounds)``, then the ``(hook_u, hook_v)``
    record when ``record_hooks``, then ``ShardedFrontierStats`` when
    ``with_stats``. The level loop is host-driven, one read a round of
    the all-reduced changed flag and largest live count.
    """
    n = num_nodes
    check_choice("exchange", exchange, EXCHANGES)
    check_choice("hook_impl", hook_impl, HOOK_IMPLS)
    mesh = _mesh_for(mesh, axis, device, src)
    nd, dev = mesh.size, mesh.device
    a, b, m2 = _shard_edges(src, dst, n, mesh, dedup=dedup)
    bucket = a.shape[0]  # per-rank edge-buffer size

    bound = max_rounds if max_rounds is not None else sv_round_bound(n)
    D = torch.arange(n, dtype=torch.int32, device=dev)
    Q = torch.zeros(n, dtype=torch.int32, device=dev)
    s = 1
    exa = _exchange_aux(bound, dev)
    aux = (init_hooks(n, dev), exa) if record_hooks else exa
    stats = ShardedFrontierStats(
        rounds=0, edges_touched=0, m2=m2, num_devices=nd, exchange=exchange,
    )

    fmask = live_max = None
    with trace.span(
        "cc.sharded_frontier", n=n, m2=m2, devices=nd, exchange=exchange,
    ) as run_sp:

        def sv_level(bucket_now, shrink_at):
            nonlocal D, Q, aux, s, fmask, live_max
            capacity = (
                frontier_sparse_capacity(n, bucket_now, sparse_capacity)
                if exchange == "sparse" else 0
            )
            if exchange == "sparse":
                stats.capacities.append(capacity)
            with trace.span(
                "cc.sharded_frontier.level", bucket=bucket_now,
                capacity=capacity,
            ) as sp:
                ml, mq, mh = _merge_fns(mesh, n, exchange, capacity,
                                        record_hooks)
                body = sv_round_fns(
                    a, b, n, ml, mq, hook_impl=hook_impl, with_frontier=True,
                    record_hooks=record_hooks, merge_hooks=mh,
                )
                D, Q, aux, s, changed, fmask, live_max, level_rounds = (
                    run_level(
                        body, D, Q, aux, s, bucket_now, bound=bound,
                        shrink_at=shrink_at,
                        reduce_flags=lambda t: _all_reduce(mesh, t, _MAX),
                    )
                )
                # SV2 + SV3 passes over the local bucket; sv3 exports the
                # live mask. The compaction write is charged below.
                stats.edges_touched += 2 * level_rounds * bucket_now
                stats.levels.append((bucket_now, level_rounds))
                converged = not changed
                sp.tag(rounds=level_rounds, converged=converged)
            return converged, not converged and s > bound

        def live_edges():
            # Every rank shrinks to the power-of-two bucket covering the
            # LARGEST per-rank live count (one shared bucket size).
            return live_max

        def charge_shrink(new_bucket):
            stats.edges_touched += new_bucket

        def shrink(new_bucket):
            nonlocal a, b
            a, b = compact_frontier(a, b, fmask, size=new_bucket)

        def bound_hit():
            raise ConvergenceError(
                f"sharded frontier SV hit its round bound ({bound}) before"
                f" the label fixpoint on {n} nodes across {nd} devices; the"
                " labels at the bound are NOT components -- raise"
                " max_rounds (the proven bound is sv_round_bound(n)="
                f"{sv_round_bound(n)})"
            )

        run_bucket_ladder(
            bucket=bucket, min_bucket=min_bucket, run_level=sv_level,
            live_count=live_edges, compact=shrink, on_shrink=charge_shrink,
            on_nonconverged=bound_hit,
        )
        D = sv_compress(D, n)
        rounds_total = s - 1
        run_sp.tag(rounds=rounds_total, levels=len(stats.levels))
    stats.rounds = rounds_total
    out = (D, rounds_total)
    if record_hooks:
        hooks, exa = aux
        out = out + (hooks,)
    if not with_stats:
        return out
    words, frontier = exa
    stats.words_per_round = words[1:rounds_total + 1]
    stats.frontier_per_round = frontier.cpu().numpy()[1:rounds_total + 1]
    return out + (stats,)


# ---------------------------------------------------------------------------
# Sharded random-splitter list ranking
# ---------------------------------------------------------------------------


def _sharded_rs(succ, spl_pad, *, n, p, pp, npad, max_steps, mesh,
                kernel_impl):
    """RS1..RS5 on this rank. Returns ``(rank, sublist_lengths,
    walk_steps, converged)``, each the same on every rank."""
    nd, d, dev = mesh.size, mesh.rank, succ.device
    lanes_per = pp // nd
    # RS1/RS2 (replicated): stop set and ownership seed from the full
    # splitter list; every rank computes the same start.
    spl = spl_pad[:p].long()
    all_lanes = torch.arange(p, dtype=torch.int32, device=dev)
    is_stop = torch.zeros(n, dtype=torch.bool, device=dev)
    is_stop[spl] = True
    packed = torch.full((n + 1, 2), -1, dtype=torch.int32, device=dev)
    packed[:, 0] = 0
    packed[spl, 1] = all_lanes

    # RS3 (split by splitter block): rank d walks global lanes
    # [d*lanes_per, (d+1)*lanes_per); padded lanes (id >= p) are inert.
    lanes = d * lanes_per + torch.arange(lanes_per, dtype=torch.int32,
                                         device=dev)
    spl_loc = spl_pad[d * lanes_per:(d + 1) * lanes_per]
    state = dict(
        store=(packed,),
        cur=spl_loc,
        nxt=succ[spl_loc.long()],
        dist=torch.ones(lanes_per, dtype=torch.int32, device=dev),
    )
    # RS3 is a host loop of small operations a step: mask only where
    # lanes were padded.
    valid = lanes < p if pp > p else None
    active_fn, step_fn = aos_walk_fns(succ, is_stop, lanes, valid=valid)
    final, steps, converged = lockstep_walk(
        state, active_fn, step_fn, max_steps=max_steps
    )

    # Merge the stores: sub-lists partition the nodes, so one rank wrote
    # each node (local >= 1 over 0, owner >= 0 over -1) and MAX is a
    # lossless union: ONE n-row exchange for the whole walk.
    rows = _all_reduce(mesh, final["store"][0][:n], _MAX)  # [local, owner]
    owner = rows[:, 1]

    # RS4 (gathered): all-gather the per-lane walk results and rank the
    # p-node splitter list on every rank, through pointer_jump.
    walked = _all_gather(
        mesh, torch.stack([final["dist"], final["nxt"]], dim=-1)
    )[:p]
    dist_full = walked[:, 0].contiguous()
    spsucc = owner[walked[:, 1].long()]
    is_term = spsucc == all_lanes
    w_adj = dist_full - is_term.to(torch.int32)
    rank_sp = _splitter_list_rank(w_adj, spsucc, default_iters(p),
                                  kernel_impl)

    # RS5 (split back out): each rank aggregates its node block through
    # splitter_aggregate, and the blocks are all-gathered so every rank
    # returns the whole rank array.
    blk = npad // nd
    rows_blk = _pad_to(rows, npad, 0)[d * blk:(d + 1) * blk]
    rank_blk = splitter_aggregate(rows_blk, rank_sp, impl=kernel_impl)
    rank = _all_gather(mesh, rank_blk)[:n]

    # The global trip count is the largest; the walk converged only if
    # every rank's lanes finished (MAX of "not converged").
    flags = torch.tensor([steps, int(not converged)], dtype=torch.int64,
                         device=dev)
    steps, unfinished = _all_reduce(mesh, flags, _MAX).tolist()
    return rank, dist_full, steps, not unfinished


def sharded_random_splitter_rank(
    succ,
    num_splitters: int | None = None,
    *,
    splitters: np.ndarray | None = None,
    head: int = 0,
    seed: int = 0,
    mesh: GraphMesh | None = None,
    axis: str = GRAPH_AXIS,
    max_steps: int | None = None,
    kernel_impl: str = "auto",
    with_stats: bool = False,
    device=None,
):
    """Multi-rank list ranking, bit-exact against ``random_splitter_rank``.

    Splitter selection (RS1/RS2) is the single-device one (same KISS
    streams, same seed), so both rank the same sub-lists. ``kernel_impl``
    routes RS4/RS5 on every rank: ``"auto"`` the ``pointer_jump`` and
    ``splitter_aggregate`` kernels on the card, their plain versions on
    the CPU. Every rank returns the whole int32 rank array. If
    ``max_steps`` cuts a walk off, every rank raises ``ConvergenceError``.
    """
    check_choice("kernel_impl", kernel_impl, KERNEL_IMPLS)
    mesh = _mesh_for(mesh, axis, device, succ)
    nd = mesh.size
    succ = as_int32(succ, mesh.device).to(mesh.device)
    n = int(succ.shape[0])
    if splitters is None:
        p = num_splitters or min(4096, max_splitters_for_linear_work(n))
        p = min(p, n)
        splitters = select_splitters(n, p, seed=seed, head=head)
    splitters = np.asarray(splitters)
    p = len(splitters)
    pp = max(-(-p // nd) * nd, nd)  # lane padding (masked inert)
    npad = max(-(-n // nd) * nd, nd)  # node padding for the RS5 blocks
    spl_pad = _pad_to(as_int32(splitters, mesh.device), pp, 0)
    with trace.span(
        "rank.splitter.sharded", device=True, n=n, p=p, devices=nd,
    ) as sp:
        rank, sublens, steps, converged = _sharded_rs(
            succ, spl_pad, n=n, p=p, pp=pp, npad=npad, max_steps=max_steps,
            mesh=mesh, kernel_impl=kernel_impl,
        )
        sp.block_on(rank)
    if not converged:
        raise ConvergenceError(
            f"sharded_random_splitter_rank hit max_steps={max_steps}"
            f" with unfinished lanes ({p} splitters, {n} nodes); the"
            " ranks are NOT valid -- raise max_steps"
        )
    if not with_stats:
        return rank
    stats = SplitterStats(
        splitters=splitters,
        sublist_lengths=sublens.cpu().numpy(),
        walk_steps=steps,
        expected_mean=n / p,
    )
    return rank, stats


def rank_exchange_words(n: int, p: int, num_devices: int) -> int:
    """int32 words a rank sends for one sharded ranking call: the MAX
    merge of the (local, owner) rows (2n) and the lane all-gather of
    (dist, nxt) (2p)."""
    del num_devices  # replicated-label scheme: volume is rank-local
    return 2 * n + 2 * p


__all__ = [
    "GRAPH_AXIS",
    "EXCHANGES",
    "GraphMesh",
    "graph_mesh",
    "CCExchangeStats",
    "ShardedFrontierStats",
    "default_sparse_capacity",
    "frontier_sparse_capacity",
    "cc_exchange_words_per_round",
    "rank_exchange_words",
    "sharded_shiloach_vishkin",
    "sharded_frontier_shiloach_vishkin",
    "sharded_random_splitter_rank",
]
