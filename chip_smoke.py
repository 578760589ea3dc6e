#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100. Phases, each
of which raises on failure:

1. Device and build: the card's name and power limit, the torch
   version, and the three CUDA kernels built from ``kernels/csrc`` (one
   ``nvcc`` per source, all at once) with ``-Xptxas -v``'s registers and
   shared memory.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, bit for bit.
3. Connected components through ``connected_components(src, dst, n)``
   on a 2^22-node giant+dust graph, a 2^20-node random graph with about
   2^22 edges, and a 2^20-node random graph with about 9 * 2^20 edges,
   dense enough (m/n >= 8) for the dispatch to run the Afforest
   sampling pre-pass. Each is checked by vectorised invariants, by the
   true component count, and against the dense engine's plain PyTorch
   run: labels and rounds bit for bit, or, after sampling, which picks
   other roots, the same partition. ``edge_hook`` must have launched
   twice per round, sampling rounds included. On the dense graph the
   pre-pass's sample table, whose duplicate writes the last one wins,
   is held against numpy's in-order assignment.
4. List ranking through ``list_rank(succ)`` on a 2^23-node random list
   with 4096 splitters, checked as a permutation with
   ``rank[succ[j]] == rank[j] - 1``; ``pointer_jump`` and
   ``splitter_aggregate`` must each have launched once.
5. Times: each kernel's device time, from CUDA events around replays
   of a CUDA graph of many calls, beside its byte bound at the H100's
   3.35 TB/s, its plain version's time taken the same way, and the time
   per call when the wrapper is called from Python (the difference is
   the host's cost of a call); the
   end-to-end wall time of phases 3 and 4 (median of three calls after
   a warm-up); from separate traced runs, the engine's share of each CC
   call and the RS3 walk's share of ``list_rank``; from
   ``torch.profiler`` runs, the card's idle share in each CC cell and in
   ``list_rank`` on a 2^20-node list.

Every line but the last is a report. The line before the last is one
JSON object with a record per kernel; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, the script exits nonzero and prints no
result. It imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet

# The main path's sizes.
CC_GIANT_N = 4_194_304
CC_RANDOM_N = 1_048_576
CC_RANDOM_DENSITY = 8 / (CC_RANDOM_N - 1)  # m = 4n edges, m/n = 4
CC_DENSE_N = 1_048_576
CC_DENSE_DENSITY = 18 / (CC_DENSE_N - 1)  # m = 9n edges: auto-Afforest on
LIST_N = 8_388_608
SPLITTERS = 4096
POINTER_JUMP_BIG_P = 65_536  # above the one-launch limit: the step path
PROFILE_LIST_N = 1_048_576  # list size of the profiled list_rank call

KERNELS = {
    "edge_hook.sv2": ("edge_hook", "src/repro/kernels/edge_hook/edge_hook.py:27"),
    "edge_hook.sv3": ("edge_hook", "src/repro/kernels/edge_hook/edge_hook.py:27"),
    "pointer_jump": (
        "pointer_jump", "src/repro/kernels/pointer_jump/pointer_jump.py:22"),
    "splitter_aggregate": (
        "splitter_aggregate",
        "src/repro/kernels/splitter_aggregate/splitter_aggregate.py:19"),
}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` called from Python, by CUDA
    events, after a warm-up. A call shorter than the host's cost of
    issuing it is timed at the host's rate."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn``: CUDA events around
    ``replays`` replays of one CUDA graph that holds ``calls`` calls, so
    no host work sits between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def wall_s(fn):
    """``(result, seconds)`` of ``fn()`` by the host clock, ending in a
    device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced(fn) -> dict[str, float]:
    """Run ``fn`` once with the port's tracer on; returns the total
    milliseconds of each span name."""
    from repro_torch.obs import trace

    trace.configure(trace="on")
    trace.reset()
    try:
        fn()
    finally:
        trace.configure(trace="off")
    totals: dict[str, float] = {}
    for ev in trace.chrome_trace()["traceEvents"]:
        if ev["ph"] == "X":
            totals[ev["name"]] = totals.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return totals


E2E_SAMPLES = 3  # timed calls per end-to-end cell; the first is checked


def device_share(fn) -> tuple[float, float]:
    """Run ``fn`` once under ``torch.profiler``; returns its wall
    milliseconds and the milliseconds the card spent in kernels and
    copies. The profiler slows the host, so the idle share it implies is
    an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    return wall_ms, device_us / 1e3


def median(xs):
    return sorted(xs)[len(xs) // 2]


def components_by_propagation(src: np.ndarray, dst: np.ndarray, n: int) -> int:
    """The component count by numpy min-label propagation with pointer
    jumping, independent of the code under test: a fixpoint has equal
    labels across every edge, and each label is the least id of its
    component."""
    u, v = src.astype(np.int64), dst.astype(np.int64)
    lab = np.arange(n, dtype=np.int64)
    while True:
        low = np.minimum(lab[u], lab[v])
        new = lab.copy()
        np.minimum.at(new, u, low)
        np.minimum.at(new, v, low)
        new = new[new]
        if np.array_equal(new, lab):
            return int(np.count_nonzero(lab == np.arange(n)))
        lab = new


def same_partition(x, y) -> bool:
    """Whether two label tensors cut the nodes into the same sets: each
    label of ``x`` pairs with exactly one label of ``y``."""
    import torch

    pairs = torch.unique(x.to(torch.int64) * (y.numel() + 1) + y.to(torch.int64))
    return pairs.numel() == torch.unique(x).numel() == torch.unique(y).numel()


def check_sample_table(dev, src, dst, n, k):
    """The Afforest pre-pass's (n, k) sample table built on the card,
    where the order of duplicate writes is undefined, against numpy's
    in-order fancy assignment, in which the last write wins: the
    reference's rule."""
    import torch

    from repro_torch.core.components import dedup_edges, oriented_edges
    from repro_torch.core.frontier import _build_samples

    a, b = oriented_edges(*dedup_edges(src, dst), n, device=dev)
    m2 = a.shape[0]
    perm = np.random.default_rng(0).permutation(m2)
    got = _build_samples(a, b, torch.from_numpy(perm).to(dev), n=n, k=k)
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    want = np.full(n * k, -1, dtype=np.int64)
    want[a_np[perm].astype(np.int64) * k + np.arange(m2) % k] = b_np[perm]
    filled = int(np.count_nonzero(want >= 0))
    err = max_abs_err(got.reshape(-1).cpu(), torch.from_numpy(want))
    print(f"afforest sample table n={n} k={k} m2={m2}: filled={filled} "
          f"max_abs_err={err}")
    check(err == 0, "the card's sample table keeps the last write")


def max_abs_err(x, y) -> int:
    """Largest |x - y| over two integer (or bool) tensors."""
    import torch

    if x.shape != y.shape:
        raise RuntimeError(f"shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
    if x.numel() == 0:
        return 0
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


def hook_states(a, b, n, dev):
    """Two SV round states of the graph (a, b) as the hook phases see
    them: the first round's, and the fourth's after three plain rounds.
    Each is ``(D1, D, Q, s)``: short-cut labels, labels before it, the
    stamps after SV1b, and the round number."""
    import torch

    from repro_torch.core.components import sv_round_fns
    from repro_torch.kernels.edge_hook.ref import drop_scatter_fill

    D = torch.arange(n, dtype=torch.int32, device=dev)
    Q = torch.zeros(n, dtype=torch.int32, device=dev)
    states = [(D[D], D, Q, 1)]
    body = sv_round_fns(a, b, n, hook_impl="torch")
    s, hooks = 1, None
    for _ in range(3):
        D, Q, hooks, s, _changed = body((D, Q, hooks, s, True))
    D1 = D[D]
    states.append((D1, D, drop_scatter_fill(Q, torch.where(D1 != D, D1, n), s), s))
    return states


def phase_kernels(dev, cc_edges, list_n, splitters, big_p, kernel_impl):
    """Phase 2: every kernel against its plain version at the main
    path's shapes. Returns ``{name: max_abs_err}`` and the inputs phase
    5 times."""
    import torch

    from repro_torch.core.components import dedup_edges, oriented_edges
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.edge_hook.ops import edge_hook
    from repro_torch.kernels.pointer_jump.ops import pointer_jump
    from repro_torch.kernels.splitter_aggregate.ops import splitter_aggregate
    from repro_torch.ops.kiss import random_linked_list

    errs: dict[str, int] = {}
    src, dst, n = cc_edges
    a, b = oriented_edges(*dedup_edges(src, dst), n, device=dev)
    for k, (D1, D, Q, s) in enumerate(hook_states(a, b, n, dev)):
        got = edge_hook(a, b, D1, Q, s, labels_prev=D, mode="sv2", impl=kernel_impl)
        want = edge_hook(a, b, D1, Q, s, labels_prev=D, mode="sv2", impl="torch")
        err2 = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        D2, Q2 = want
        got = edge_hook(a, b, D2, Q2, s, mode="sv3", impl=kernel_impl)
        want = edge_hook(a, b, D2, Q2, s, mode="sv3", impl="torch")
        err3 = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        check(bool((want[1] == (D2[a] != D2[b])).all()),
              "sv3 mask is D2[a] != D2[b]")
        print(f"edge_hook round-{s} state: m2={a.shape[0]} n={n} "
              f"sv2 max_abs_err={err2} sv3 max_abs_err={err3}")
        errs["edge_hook.sv2"] = max(errs.get("edge_hook.sv2", 0), err2)
        errs["edge_hook.sv3"] = max(errs.get("edge_hook.sv3", 0), err3)
        if k == 0:
            hook_inputs = (a, b, D1, D, Q, D2, Q2, s, n)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    before = dict(launch_counts)
    lab = torch.arange(10, dtype=torch.int32, device=dev)
    q = torch.zeros(10, dtype=torch.int32, device=dev)
    out2 = edge_hook(empty, empty, lab, q, 1, mode="sv2", impl=kernel_impl)
    out3 = edge_hook(empty, empty, lab, q, 1, mode="sv3", impl=kernel_impl)
    check(launch_counts == before, "an m2=0 edge_hook call launches nothing")
    check(bool((out2[0] == lab).all() and (out2[1] == q).all()
               and (out3[0] == lab).all() and out3[1].numel() == 0),
          "an m2=0 edge_hook call returns its inputs")
    print("edge_hook m2=0: no launch, inputs returned")

    # The main path's p, and the edges of both paths: one node, an odd
    # size, the one-launch limit and one past it, the step path.
    pj_inputs = {}
    for p in (1, 1000, splitters, splitters + 1, big_p):
        nxt = torch.from_numpy(random_linked_list(p, seed=p)).to(dev)
        w = (nxt != torch.arange(p, dtype=torch.int32, device=dev)).to(torch.int32)
        got = pointer_jump(nxt, w, impl=kernel_impl)
        want = pointer_jump(nxt, w, impl="torch")
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        print(f"pointer_jump p={p}: max_abs_err={err}")
        errs["pointer_jump"] = max(errs.get("pointer_jump", 0), err)
        pj_inputs[p] = (nxt, w)

    rng = np.random.default_rng(0)
    packed = torch.from_numpy(np.stack([
        rng.integers(0, list_n // splitters + 1, list_n),
        rng.integers(0, splitters, list_n),
    ], axis=-1).astype(np.int32)).to(dev)
    sprank = torch.from_numpy(
        rng.integers(0, list_n, splitters).astype(np.int32)).to(dev)
    err = max_abs_err(splitter_aggregate(packed, sprank, impl=kernel_impl),
                      splitter_aggregate(packed, sprank, impl="torch"))
    print(f"splitter_aggregate n={list_n} p={splitters}: max_abs_err={err}")
    errs["splitter_aggregate"] = err
    # Tables past the default 48 KB of shared memory (64 KB) and past the
    # 227 KB a block can have (256 KB: the global-memory variant).
    for p in (16_384, 65_536):
        rows = packed[: list_n // 8].clone()
        rows[:, 1] = torch.randint(0, p, (rows.shape[0],), device=dev,
                                   dtype=torch.int32)
        table = torch.randint(0, list_n, (p,), device=dev, dtype=torch.int32)
        err = max_abs_err(splitter_aggregate(rows, table, impl=kernel_impl),
                          splitter_aggregate(rows, table, impl="torch"))
        print(f"splitter_aggregate n={rows.shape[0]} p={p}: max_abs_err={err}")
        errs["splitter_aggregate"] = max(errs["splitter_aggregate"], err)
    for name, e in errs.items():
        check(e == 0, f"{name} is bit-exact against its plain version")
    return errs, hook_inputs, pj_inputs, (packed, sprank)


def phase_cc(dev, graphs, timer):
    """Phase 3: the CC main path on each graph. Returns the launch
    counts of the checked runs and the report rows."""
    import torch

    from repro_torch.core import connected_components, dedup_edges
    from repro_torch.kernels import launch_counts, reset_launch_counts

    totals = {name: 0 for name in launch_counts}
    rows = []
    for name, src, dst, n, want_count, want_sample_rounds in graphs:
        connected_components(src, dst, n, device=dev)  # warm-up
        reset_launch_counts()
        def call():
            return connected_components(src, dst, n, with_stats=True,
                                        device=dev)

        (labels, rounds, stats), first = timer(call)
        counts = dict(launch_counts)
        secs = [first] + [timer(call)[1] for _ in range(E2E_SAMPLES - 1)]
        s_t = torch.from_numpy(src.astype(np.int64)).to(dev)
        d_t = torch.from_numpy(dst.astype(np.int64)).to(dev)
        check(labels.device.type == dev.type, f"{name}: labels on {dev}")
        check(bool((labels[s_t] == labels[d_t]).all()),
              f"{name}: labels[src] == labels[dst] on every edge")
        check(bool((labels[labels] == labels).all()),
              f"{name}: labels[labels] == labels")
        got_count = int(torch.unique(labels).numel())
        check(got_count == want_count,
              f"{name}: {got_count} components, want {want_count}")
        ref_labels, ref_rounds = connected_components(
            src, dst, n, engine="dense", hook_impl="torch", device=dev)
        if stats.sample_rounds:
            # Sampling picks other roots and takes other rounds.
            check(same_partition(labels, ref_labels),
                  f"{name}: the same partition as the dense plain run")
        else:
            check(ref_rounds == rounds and bool((ref_labels == labels).all()),
                  f"{name}: labels and rounds equal the dense plain run")
        check(stats.sample_rounds == want_sample_rounds,
              f"{name}: {stats.sample_rounds} sampling rounds, want "
              f"{want_sample_rounds}")
        for mode in ("edge_hook.sv2", "edge_hook.sv3"):
            check(counts[mode] == rounds,
                  f"{name}: {mode} launched {counts[mode]} times in "
                  f"{rounds} rounds")
        for k in totals:
            totals[k] += counts[k]
        print(f"cc {name}: n={n} m={len(src)} m2={stats.m2} "
              f"components={got_count} rounds={rounds} "
              f"sample_rounds={stats.sample_rounds} "
              f"live_after_sample={stats.live_after_sample} "
              f"levels={stats.levels} "
              f"edges_touched={stats.edges_touched} "
              f"edge_hook launches={counts['edge_hook.sv2'] + counts['edge_hook.sv3']} "
              f"wall_s={median(secs)} samples={secs}")
        # A separate traced run: the engine's own span against the call,
        # the rest being host preparation (dedup, copy to the card).
        spans, traced_s = timer(lambda: traced(
            lambda: connected_components(src, dst, n, device=dev)))
        t0 = time.perf_counter()
        dedup_edges(src, dst)
        dedup_ms = (time.perf_counter() - t0) * 1e3
        print(f"cc {name} traced: call_ms={traced_s * 1e3} "
              f"cc.frontier_ms={spans['cc.frontier']} "
              f"cc.frontier.level_ms={spans['cc.frontier.level']} "
              f"cc.frontier.sample_ms={spans.get('cc.frontier.sample', 0.0)} "
              f"host_prep_ms={traced_s * 1e3 - spans['cc.frontier'] - spans.get('cc.frontier.sample', 0.0)} "
              f"of which dedup_edges_ms={dedup_ms}")
        wall_ms, device_ms = device_share(
            lambda: connected_components(src, dst, n, device=dev))
        print(f"cc {name} profiled: wall_ms={wall_ms} device_ms={device_ms} "
              f"device_idle_share={1 - device_ms / wall_ms}")
        rows.append((name, median(secs)))
    return totals, rows


def phase_list(dev, n, timer):
    """Phase 4: the list-ranking main path. Returns the launch counts of
    the checked run, its wall time, and the traced RS3 share."""
    import torch

    from repro_torch.core import list_rank
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ops.kiss import random_linked_list

    succ = random_linked_list(n, seed=0)
    list_rank(succ, device=dev)  # warm-up
    reset_launch_counts()
    def call():
        return list_rank(succ, with_stats=True, device=dev)

    (rank, stats), first = timer(call)
    counts = dict(launch_counts)
    secs = [first] + [timer(call)[1] for _ in range(E2E_SAMPLES - 1)]
    succ_t = torch.from_numpy(succ.astype(np.int64)).to(dev)
    lanes = torch.arange(n, device=dev)
    check(rank.device.type == dev.type, f"ranks on {dev}")
    check(int(rank[0]) == n - 1, "rank[0] == n - 1")
    inner = succ_t != lanes
    check(bool((rank[succ_t[inner]] == rank[inner] - 1).all()),
          "rank[succ[j]] == rank[j] - 1 for every j but the tail")
    check(bool((torch.bincount(rank.long(), minlength=n) == 1).all()),
          "ranks are a permutation of 0..n-1")
    check(counts["pointer_jump"] == 1 and counts["splitter_aggregate"] == 1,
          f"one pointer_jump and one splitter_aggregate launch, got {counts}")

    spans = traced(lambda: list_rank(succ, device=dev))
    walk_share = spans["rank.splitter.walk"] / spans["rank.splitter"]
    print(f"list_rank: n={n} p={len(stats.splitters)} "
          f"walk_steps={stats.walk_steps} wall_s={median(secs)} "
          f"samples={secs} "
          f"traced rank.splitter_ms={spans['rank.splitter']} "
          f"rs3_walk_ms={spans['rank.splitter.walk']} "
          f"rs3_ms_per_step={spans['rank.splitter.walk'] / stats.walk_steps} "
          f"rs3_share={walk_share}")
    # The profiler records every one of the walk's ~17 small operations a
    # step, and summarising 20,000 steps of them takes minutes; a list of
    # PROFILE_LIST_N nodes runs the same loop, shorter.
    small = random_linked_list(PROFILE_LIST_N, seed=0)
    list_rank(small, device=dev)  # warm-up at this size
    wall_ms, device_ms = device_share(lambda: list_rank(small, device=dev))
    print(f"list_rank n={PROFILE_LIST_N} profiled: wall_ms={wall_ms} "
          f"device_ms={device_ms} device_idle_share={1 - device_ms / wall_ms}")
    return counts, median(secs), walk_share


def kernel_times(hook_inputs, pj_inputs, agg_inputs, splitters, big_p,
                 kernel_impl):
    """Phase 5: each kernel's device time and its plain version's, the
    time of a call from Python, and the bytes each call must move.
    Returns ``{name: (ms, plain_ms, eager_ms, bytes)}``."""
    from repro_torch.kernels.edge_hook.ops import edge_hook
    from repro_torch.kernels.pointer_jump.ops import pointer_jump
    from repro_torch.kernels.splitter_aggregate.ops import splitter_aggregate

    a, b, D1, D, Q, D2, Q2, s, n = hook_inputs
    m2 = a.shape[0]
    nxt, w = pj_inputs[splitters]
    packed, sprank = agg_inputs
    calls = {
        "edge_hook.sv2": (
            lambda impl: edge_hook(a, b, D1, Q, s, labels_prev=D, mode="sv2",
                                   impl=impl),
            8 * m2 + 20 * n),
        "edge_hook.sv3": (
            lambda impl: edge_hook(a, b, D2, Q2, s, mode="sv3", impl=impl),
            9 * m2 + 12 * n),
        "pointer_jump": (
            lambda impl: pointer_jump(nxt, w, impl=impl), 16 * splitters),
        "splitter_aggregate": (
            lambda impl: splitter_aggregate(packed, sprank, impl=impl),
            12 * packed.shape[0] + 4 * sprank.shape[0]),
    }
    big_nxt, big_w = pj_inputs[big_p]
    calls["pointer_jump.step_path"] = (
        lambda impl: pointer_jump(big_nxt, big_w, impl=impl), 16 * big_p)
    out = {}
    for name, (fn, nbytes) in calls.items():
        out[name] = (graph_ms(lambda: fn(kernel_impl)),
                     graph_ms(lambda: fn("torch")),
                     cuda_ms(lambda: fn(kernel_impl)), nbytes)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import AUTO_SAMPLE_ROUNDS
    from repro_torch.kernels import build
    from repro_torch.ops.kiss import giant_dust_graph, random_graph

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # Phase 1: build every kernel, one nvcc per source, all at once.
    t0 = time.perf_counter()
    build.build()
    print(f"build_s={time.perf_counter() - t0} nvcc {' '.join(build.NVCC_FLAGS)}")
    for name in build.SOURCES:
        print(f"ptxas {name}:\n{build.ptxas_report(name)}")

    giant = giant_dust_graph(CC_GIANT_N, seed=0)
    g = max(2, int(CC_GIANT_N * 0.9))
    rand = random_graph(CC_RANDOM_N, CC_RANDOM_DENSITY, seed=1)
    dense = random_graph(CC_DENSE_N, CC_DENSE_DENSITY, seed=2)
    counts = {}
    for name, edges, n in (("random", rand, CC_RANDOM_N),
                           ("random_dense", dense, CC_DENSE_N)):
        t0 = time.perf_counter()
        counts[name] = components_by_propagation(edges[:, 0], edges[:, 1], n)
        print(f"{name} graph: m/n={len(edges) / n} numpy propagation "
              f"count={counts[name]} host_s={time.perf_counter() - t0}")

    # Phase 2: kernels against their plain versions.
    errs, hook_inputs, pj_inputs, agg_inputs = phase_kernels(
        dev, (giant[:, 0], giant[:, 1], CC_GIANT_N), LIST_N, SPLITTERS,
        POINTER_JUMP_BIG_P, "cuda")

    # Phases 3 and 4: the main path, launches counted from 0 in each run.
    check_sample_table(dev, dense[:, 0], dense[:, 1], CC_DENSE_N,
                       AUTO_SAMPLE_ROUNDS)
    cc_counts, cc_rows = phase_cc(dev, [
        ("giant_dust", giant[:, 0], giant[:, 1], CC_GIANT_N,
         CC_GIANT_N - g + 1, 0),
        ("random", rand[:, 0], rand[:, 1], CC_RANDOM_N, counts["random"], 0),
        ("random_dense", dense[:, 0], dense[:, 1], CC_DENSE_N,
         counts["random_dense"], AUTO_SAMPLE_ROUNDS),
    ], wall_s)
    list_counts, list_secs, walk_share = phase_list(dev, LIST_N, wall_s)

    # Phase 5: times.
    times = kernel_times(hook_inputs, pj_inputs, agg_inputs, SPLITTERS,
                         POINTER_JUMP_BIG_P, "cuda")
    launches = {k: cc_counts[k] + list_counts[k] for k in cc_counts}
    records = []
    for name, (ms, plain_ms, eager_ms, nbytes) in times.items():
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"time {name}: ms={ms} plain_ms={plain_ms} bound_ms={bound_ms} "
              f"bytes={nbytes} share_of_bound={bound_ms / ms} "
              f"eager_ms={eager_ms} eager_minus_graph_ms={eager_ms - ms} "
              f"[{card}]")
        if name not in KERNELS:
            continue
        source, replaces = KERNELS[name]
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
        })
    print("library_ms: n/a for every kernel -- no single PyTorch call "
          "computes an SV hook phase, a pointer-jumping run or the RS5 "
          "aggregation")
    for name, secs in cc_rows:
        print(f"e2e connected_components {name}: wall_s={secs} [{card}]")
    print(f"e2e list_rank n={LIST_N}: wall_s={list_secs} "
          f"rs3_walk_share={walk_share} [{card}]")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
