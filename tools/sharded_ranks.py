#!/usr/bin/env python3
"""Run ``repro_torch``'s sharded graph engine over NCCL with one rank on
each CUDA card of one host.

    python3 tools/sharded_ranks.py [P]

Spawns P ranks (default: every visible card), rank r on card r, joined
by an NCCL group whose rendezvous is a ``FileStore`` in a temporary
directory (no network). Every rank builds ``chip_smoke.py``'s giant+dust
(2^22 nodes) and random (2^20 nodes, m/n = 4) CC cells, each
deduplicated once, and its 2^23-node list, then runs on the mesh: the
sharded frontier engine (sparse exchange), the dense sharded engine with
the dense and with the sparse exchange, and ``list_rank`` with 4096
splitters. Each call is timed on the host clock, every card synchronised
and the ranks joined by a barrier, as the median of three after a
warm-up. Every rank's labels and ranks must equal every other rank's
(a MIN and a MAX all-reduce agree), and rank 0 holds them against the
single-device dense engine and ``random_splitter_rank`` on its card, bit
for bit; ``edge_hook`` must launch twice a round on every rank. Rank 0
prints rounds, levels, words per round and the per-rank edge visits,
and, from one ``torch.profiler`` run of the sharded frontier call on the
random cell, the share of its card's busy time in NCCL kernels. Every
line carries the card's name and power limit. The kernels are built
once, before the ranks start.
"""
from __future__ import annotations

import datetime
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 180  # a collective that waits longer raises
PROFILE_WARMUP_LAUNCHES = 1024  # as chip_smoke.py's device_share


def _timed(fn, dist, torch):
    """Median host seconds of three calls of ``fn`` after a warm-up, each
    call between two barriers with the card synchronised."""
    fn()
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs), secs


def _nccl_share(fn, torch):
    """One profiled call: NCCL kernel ms, busy ms (the union of the
    call's device records) and the number of those records, on this
    rank's card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP_LAUNCHES):
            scratch.add_(1)
        torch.cuda.synchronize()
        with record_function("sharded_ranks.profiled"):
            fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    window = next(ev.time_range for ev in events
                  if ev.name == "sharded_ranks.profiled"
                  and ev.device_type == DeviceType.CPU)
    device = [ev for ev in events if ev.device_type == DeviceType.CUDA
              and window.start <= ev.time_range.start <= window.end
              and ev.name != "sharded_ranks.profiled"]
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in device)
    busy, cur = 0.0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]
    nccl = sum(ev.time_range.end - ev.time_range.start for ev in device
               if "nccl" in ev.name.lower())
    return nccl / 1e3, busy / 1e3, len(device)


def _rank(rank: int, size: int, store_dir: str, card: str) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.core import (
        connected_components,
        dedup_edges,
        list_rank,
        random_splitter_rank,
        shiloach_vishkin,
    )
    from repro_torch.distributed import graph_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ops.kiss import random_linked_list

    torch.cuda.set_device(rank)
    store = dist.FileStore(f"{store_dir}/store", size)
    dist.init_process_group(
        "nccl", store=store, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        mesh = graph_mesh(size)
        cs.check(mesh.device == torch.device("cuda", rank),
                 f"rank {rank} on card {rank}")

        def same_everywhere(x, what):
            lo, hi = x.clone(), x.clone()
            dist.all_reduce(lo, op=dist.ReduceOp.MIN)
            dist.all_reduce(hi, op=dist.ReduceOp.MAX)
            cs.check(torch.equal(lo, hi), f"{what}: every rank returned the same")

        for name, edges, n in cs.cc_graphs()[:2]:
            du, dv = dedup_edges(edges[:, 0], edges[:, 1])
            del edges
            single_s = None  # rank 0's
            if rank == 0:
                # The engine itself: with several ranks the dispatch would
                # pick the sharded engine, whose collectives the other
                # ranks would never join.
                want_l, want_r = shiloach_vishkin(du, dv, n, dedup=False,
                                                  device="cuda")
                single_s, _ = _timed(lambda: shiloach_vishkin(
                    du, dv, n, dedup=False, device="cuda"), _Solo(), torch)
            dist.barrier()
            for label, kw in (("sharded_frontier", dict(mesh=mesh)),
                              ("dense", dict(mesh=mesh, engine="dense")),
                              ("dense_sparse", dict(mesh=mesh, engine="dense",
                                                    exchange="sparse"))):
                reset_launch_counts()
                labels, rounds, st = connected_components(
                    du, dv, n, dedup=False, with_stats=True, **kw)
                for mode in ("edge_hook.sv2", "edge_hook.sv3"):
                    cs.check(launch_counts[mode] == rounds,
                             f"{name} {label} rank {rank}: {mode} launched "
                             f"{launch_counts[mode]} times in {rounds} rounds")
                same_everywhere(labels, f"{name} {label} labels")
                if rank == 0:
                    cs.check(rounds == want_r and torch.equal(labels, want_l),
                             f"{name} {label}: labels and rounds equal the "
                             "single-device dense engine's")
                secs, samples = _timed(lambda kw=kw: connected_components(
                    du, dv, n, dedup=False, **kw), dist, torch)
                extra = (f"levels={st.levels} edges_touched/rank="
                         f"{st.edges_touched} capacities={st.capacities}"
                         if label == "sharded_frontier" else
                         f"capacity={st.capacity}")
                say(f"ranks={size} {name} {label} ({st.exchange} exchange): "
                    f"n={n} m2={2 * len(du)} rounds={rounds} wall_s={secs} "
                    f"samples={samples} single_device_dense_s={single_s} "
                    f"words_per_round={st.words_per_round.tolist()} {extra} "
                    f"[{card}]")
            if name == "random":
                nccl_ms, busy_ms, records = _nccl_share(
                    lambda: connected_components(du, dv, n, dedup=False,
                                                 mesh=mesh), torch)
                say(f"ranks={size} {name} sharded_frontier profiled (rank 0's "
                    f"card): nccl_ms={nccl_ms} busy_ms={busy_ms} "
                    f"nccl_share_of_busy={nccl_ms / busy_ms if busy_ms else 'n/a'} "
                    f"device_records={records} [{card}]")
            del du, dv

        succ = random_linked_list(cs.LIST_N, seed=0)
        single_s = None
        if rank == 0:
            want = random_splitter_rank(succ, device="cuda")
            single_s, _ = _timed(lambda: random_splitter_rank(
                succ, device="cuda"), _Solo(), torch)
        dist.barrier()
        rank_t, st = list_rank(succ, mesh=mesh, with_stats=True)
        same_everywhere(rank_t, "list_rank ranks")
        if rank == 0:
            cs.check(torch.equal(rank_t, want),
                     "list_rank: ranks equal the single-device engine's")
        secs, samples = _timed(lambda: list_rank(succ, mesh=mesh), dist, torch)
        say(f"ranks={size} list_rank n={cs.LIST_N} p={len(st.splitters)} "
            f"walk_steps={st.walk_steps} wall_s={secs} samples={samples} "
            f"single_device_s={single_s} [{card}]")
        say(f"ranks={size}: every check held [{card}]")
    finally:
        dist.destroy_process_group()


class _Solo:
    """A barrier that waits for no one: rank 0's single-device timings."""

    @staticmethod
    def barrier():
        pass


def main() -> int:
    import multiprocessing as mp

    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("sharded_ranks: CUDA is not available", file=sys.stderr)
        return 2
    size = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    card = cs.card_line().replace("\n", "; ")
    print(f"card: {card} count={torch.cuda.device_count()} ranks={size}")
    build.build()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as store_dir:
        procs = [ctx.Process(target=_rank, args=(r, size, store_dir, card))
                 for r in range(size)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=2 * TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    codes = [p.exitcode for p in procs]
    print(f"rank exit codes: {codes}")
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
