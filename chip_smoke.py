#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100. Phases, each
of which raises on failure:

1. Device and build: the card's name and power limit, the torch
   version, and the five CUDA kernels built from ``kernels/csrc`` (one
   ``nvcc`` per source, all at once) with ``-Xptxas -v``'s registers and
   shared memory. Then the ogb_products graph of the GNN phase,
   ``full_graph(2_449_029, 61_859_140, 100, 47, seed=0)``, built on the
   host (its seconds printed): its destinations are phase 2's ids.
2. Each graph kernel against its plain PyTorch version on the card, at
   the shapes of the main path, bit for bit. ``segment_sum`` against
   its plain version at the GNN path's shapes: the ogb_products ids with
   (m, 100) and (m, 64) float32 rows (gin-tu's layers), GAT's (m, 8, 8),
   (m, 8), (m, 1, 47) and (m, 1), (m, 64) in bf16, a hub segment owning
   a tenth of 2^22 rows, and empty segments with negative and sentinel
   ids. float32 within rtol 2e-5, bf16 within 2e-2, each with an atol
   of 2e-5 times the output's rms times sqrt(max degree): the two sum
   in different orders (the plain version with atomics).
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
   ``list_rank`` on a 2^20-node list. ``segment_sum`` at gin-tu's
   layer-1 and layer-2 shapes and at the hub case: device ms, ms per
   Python call, plain ms, and ``torch.segment_reduce(data, "sum",
   lengths=...)`` (``library_ms``; ``index_add_`` beside it), both
   yardsticks the port never calls, with the byte bound.

6. ``flash_attention`` against its plain version (``attention_ref``)
   on the card within rtol = 3e-2 in bf16 and 2e-3 in float32, and an
   atol of the same fraction of the output's root mean square:
   (a) qwen3-4b's prefill shape, B=2, Hq=32, Hkv=8, S=4096, D=128,
   causal; (b) layer 0's q/k/v of the full-width model on the prefill
   tokens; (c) gemma's MQA shape (Hq=8, Hkv=1, D=256, S=1000); (d)
   phi3's MHA shape (Hq=Hkv=32, D=96, S=777), non-causal, so keys past
   a block edge must not score; (e) S=2048 with window=512; (f) float32;
   every other head_dim instance in both types; rows with no live key
   (Sq > Sk + window); and, at S=32768 (the ``prefill_32k`` length, where
   the plain version's scores would take 137 GB), the first and last
   256 rows against ``attention_ref`` on those rows alone.
7. Prefill at full width: qwen3-4b's ``CONFIG`` in bf16 from
   ``init_params`` with a seeded CUDA generator, ``forward`` on (2, 4096)
   tokens from ``np.random.default_rng(0)``: a warm-up, then three
   timed calls (median ms, tokens/s), ``flash_attention`` launched 36
   times in the first, peak device memory, and the device idle share
   from one ``torch.profiler`` run.
   The activation's op-by-op cost against one fused ``F.silu``.
8. Prefill against decode: the logits of ``forward`` (through the
   kernel) and of ``prefill``'s loop (token by token through
   ``serve_step``, which shares no attention code with it) at every
   position of B=2, S=512: every row whose decode top-2 margin exceeds
   0.1 must have the same argmax, and no logit may differ by more than
   ``CONSISTENCY_MAX_DIFF``.
9. Serving at full width: ``ServeEngine(params, CONFIG, num_slots=4,
   max_len=512)`` on 8 requests, and ``num_slots=64, max_len=4096`` (the
   KV cache one card holds beside the weights) on 128, with prompts of
   16-128 tokens and ``max_new_tokens=32``: 2 waves, every request
   completed, 32 tokens each; decode tokens/s, steps, ms per step, peak
   memory; one request of each re-scored by ``forward`` under the
   margin rule; the idle share of a short profiled run of the wide
   engine.
10. ``flash_attention``'s times at shape (a) and at S=32768 beside
   ``scaled_dot_product_attention`` (the yardstick; the port never
   calls it) and its FLOP bound at 989 TFLOP/s.
11. GNN inference, after the LM has freed its memory: gin-tu and
   gat-cora at ``config_for("ogb_products")`` (full width, float32,
   random from a seeded CUDA generator) on the ogb_products graph: a
   warm-up, then three timed ``forward`` calls (median ms, edges/s =
   layers * m / t, peak memory), exactly 5 and 4 ``segment_sum``
   launches in the first, and the logits against an independent
   forward (``gnn_by_index_add``) within rtol = 2e-3 and an atol of
   2e-3 times the smaller of 1 and the logits' rms, with equal argmaxes
   wherever the top-2 margin exceeds 1e-2; the idle share and top
   device kernels of each from one ``torch.profiler`` run. Then gin-tu
   with graph readout on ``molecule_batch(128)``: 6 launches, the same
   check.

Every profile prints the host's launch calls beside the device records
it kept, and is used only if it kept one for each (``device_share``).

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
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores, the same sheet

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
    "flash_attention": (
        "flash_attention",
        "src/repro/kernels/flash_attention/flash_attention.py:24"),
    "segment_sum": (
        "segment_sum", "src/repro/kernels/segment_sum/segment_sum.py:24"),
}

# The GNN phases' sizes: GNN_SHAPES["ogb_products"] at full width.
GNN_SHAPE = "ogb_products"
GNN_N, GNN_M, GNN_D, GNN_CLASSES = 2_449_029, 61_859_140, 100, 47
GNN_ARCHS = (("gin-tu", 5), ("gat-cora", 4))  # segment_sum launches a forward
MOLECULE_BATCH, MOLECULE_LAUNCHES = 128, 6  # gin-tu with graph readout
HUB_M, HUB_N = 1 << 22, 1 << 18  # one segment owns HUB_M // 10 rows
SEGSUM_RTOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
SEGSUM_ATOL = 2e-5  # times the output's rms times sqrt(max degree)
GNN_TOL = 2e-3  # rtol of the logits against gnn_by_index_add; atol x min(1, rms)
GNN_MARGIN = 1e-2  # top-2 gap above which two argmaxes must agree

# The LM phases' sizes.
LM_ARCH = "qwen3-4b"
PREFILL_B, PREFILL_S = 2, 4096
CONSISTENCY_S = 512
SERVE_NEW = 32  # tokens each request generates
# (slots, max_len, requests, profiled): the small check, and the cell at
# the width one card holds: 64 slots of 4096 rows of qwen3-4b KV cache
# are 38.7 GB beside the 8.8 GB of weights (128 slots would need 77 GB).
SERVE_CELLS = ((4, 512, 8, False), (64, 4096, 128, True))
LONG_S = 32_768  # prefill_32k's sequence length
MARGIN = 0.1  # top-2 logit gap above which two argmaxes must agree
# Largest |forward - decode| over every logit of phase 8: about twice
# the largest reading of passing runs on an H100 (0.129 over all 1,024
# positions; 0.094 at the last ones).
CONSISTENCY_MAX_DIFF = 0.25
ATTN_TOL = {"torch.bfloat16": 3e-2, "torch.float32": 2e-3}


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


# Host calls that each put one record on the card's timeline.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
# On the H100 a profile loses device records of the first launches after
# it starts (from one to a few hundred; never later ones), more often the
# longer the process has run. Each profile first launches this many
# throwaway kernels, outside the profiled call, to take those losses.
PROFILE_WARMUP_LAUNCHES = 1024
PROFILE_ATTEMPTS = 3


def device_share(fn=None, top: int = 0, prepare=None):
    """Run ``fn`` once under ``torch.profiler``; returns its wall
    milliseconds, the milliseconds the card was busy (the union of the
    intervals of its kernels, copies and sets, so nothing is counted
    twice), the number of those device events, the ``top`` device event
    names by total milliseconds, and the device idle share. The profiler
    slows the host, so the idle share is an upper bound.

    Only the launch calls made inside ``fn`` (a ``record_function``
    span) and their device records count. A profile is used only if it
    holds a record for each of those calls; one that lost records would
    count their time as idle. It is taken again, up to PROFILE_ATTEMPTS
    times, and the check fails if none is whole. ``prepare``, where
    given, is called before each attempt, outside the profile, and
    returns the call to profile (for a call that cannot run twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch = torch.zeros(1, device="cuda")
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        if prepare is not None:
            fn = None
            fn = prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_WARMUP_LAUNCHES):
                scratch.add_(1)
            torch.cuda.synchronize()
            with record_function("chip_smoke.profiled"):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        events = list(prof.events())
        window = next(ev.time_range for ev in events
                      if ev.name == "chip_smoke.profiled"
                      and ev.device_type == DeviceType.CPU)
        launches = {ev.id for ev in events
                    if ev.device_type != DeviceType.CUDA and ev.name in LAUNCH_CALLS
                    and window.start <= ev.time_range.start <= window.end}
        device = [ev for ev in events
                  if ev.device_type == DeviceType.CUDA and ev.id in launches
                  and ev.name != "chip_smoke.profiled"]
        warm = sum(1 for ev in events if ev.device_type == DeviceType.CUDA
                   and ev.time_range.start < window.start)
        print(f"profiler attempt {attempt}: launch_calls={len(launches)} "
              f"device_events={len(device)} warmup_records={warm} of "
              f"{PROFILE_WARMUP_LAUNCHES}")
        if launches and len({ev.id for ev in device}) == len(launches):
            break
    check(launches and len({ev.id for ev in device}) == len(launches),
          f"a profile holds a device record for each of its "
          f"{len(launches)} launch calls ({len(device)} held)")
    spans, by_name = [], {}
    for ev in device:
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = (by_name.get(ev.name, 0.0)
                            + (ev.time_range.end - ev.time_range.start) / 1e3)
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return wall_ms, busy_us / 1e3, len(spans), ranked, 1 - busy_us / 1e3 / wall_ms


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
        wall_ms, device_ms, _, _, idle = device_share(
            lambda: connected_components(src, dst, n, device=dev))
        print(f"cc {name} profiled: wall_ms={wall_ms} device_busy_ms={device_ms} "
              f"device_idle_share={idle}")
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
    wall_ms, device_ms, _, _, idle = device_share(
        lambda: list_rank(small, device=dev))
    print(f"list_rank n={PROFILE_LIST_N} profiled: wall_ms={wall_ms} "
          f"device_busy_ms={device_ms} device_idle_share={idle}")
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


def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """The (query, key) pairs that ``attention_ref`` keeps: the work an
    attention call must do, 4 * D FLOPs per pair (two products)."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    lo = np.zeros(sq, np.int64) if window is None else np.maximum(q - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_bound_ms(b, hq, hkv, sq, sk, d, causal, window, itemsize):
    """``(bound_ms, flops, bytes)``: the larger of the FLOPs over the bf16
    tensor-core peak and the bytes (q, k, v read once, the output
    written once) over the HBM rate."""
    flops = 4 * d * b * hq * live_pairs(sq, sk, causal, window)
    nbytes = itemsize * d * (2 * b * hq * sq + 2 * b * hkv * sk)
    return (max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
            flops, nbytes)


def attn_err(got, want, dtype_name: str, name: str) -> float:
    """max |got - want|, checked everywhere against
    ``|got - want| <= tol * rms(want) + tol * |want|``: rtol is the
    dtype's tolerance, and atol the same fraction of the output's own
    size. An output row over N live keys is about sqrt(e / N) in size,
    so a fixed atol of 3e-2 would pass a kernel that dropped tiles at
    long S."""
    import torch

    tol = ATTN_TOL[dtype_name]
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: finite output")
    diff = (g - w).abs()
    atol = tol * float(w.square().mean().sqrt())
    over = int((diff > atol + tol * w.abs()).sum())
    err = float(diff.max())
    print(f"flash_attention {name}: max_abs_err={err} mean_abs_err={float(diff.mean())} "
          f"mean_abs_want={float(w.abs().mean())} rtol={tol} atol={atol} "
          f"over_tol={over}")
    check(over == 0, f"{name}: kernel within rtol {tol}, atol {atol} of attention_ref")
    return err


def phase_attention(dev, layer0_qkv):
    """Phase 6: the kernel against ``attention_ref`` at the LM shapes.
    Returns the largest max_abs_err and the inputs of shape (a)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        return tuple(torch.randn(b, h, s, d, device=dev, generator=gen).to(dtype)
                     for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))

    def run(name, q, k, v, causal=True, window=None):
        got = flash_attention(q, k, v, causal=causal, window=window, impl="cuda")
        want = attention_ref(q, k, v, causal=causal, window=window)
        return attn_err(got, want, str(q.dtype), name)

    shape_a = qkv(PREFILL_B, 32, 8, PREFILL_S, PREFILL_S, 128, bf)
    errs = [run(f"(a) B={PREFILL_B} Hq=32 Hkv=8 S={PREFILL_S} D=128 bf16 causal",
                *shape_a)]
    q, k, v = (x.transpose(1, 2) for x in layer0_qkv)
    errs.append(run(f"(b) layer 0 q/k/v of {LM_ARCH} on the prefill tokens "
                    f"{tuple(q.shape)}", q, k, v))
    errs.append(run("(c) gemma MQA Hq=8 Hkv=1 D=256 S=1000 bf16 causal",
                    *qkv(2, 8, 1, 1000, 1000, 256, bf)))
    errs.append(run("(d) phi3 MHA Hq=Hkv=32 D=96 S=777 bf16 causal=False",
                    *qkv(2, 32, 32, 777, 777, 96, bf), causal=False))
    errs.append(run("(e) Hq=32 Hkv=8 D=128 S=2048 bf16 causal window=512",
                    *qkv(1, 32, 8, 2048, 2048, 128, bf), window=512))
    errs.append(run("(f) Hq=32 Hkv=8 D=128 S=1000 float32 causal",
                    *qkv(1, 32, 8, 1000, 1000, 128, f32)))
    for d in (16, 32, 64):
        for dtype in (bf, f32):
            errs.append(run(f"head_dim={d} {dtype} Hq=4 Hkv=2 S=130",
                            *qkv(2, 4, 2, 130, 130, d, dtype)))
    for dtype in (bf, f32):
        errs.append(run(f"rows without a live key {dtype} Sq=300 Sk=100 window=64",
                        *qkv(1, 4, 2, 300, 100, 64, dtype), window=64))
    # S = 32768: the kernel's first and last 256 rows against the plain
    # version on those rows alone.
    q, k, v = qkv(1, 32, 8, LONG_S, LONG_S, 128, bf)
    out = flash_attention(q, k, v, impl="cuda")
    n = 256
    errs.append(attn_err(out[:, :, :n], attention_ref(q[:, :, :n], k[:, :, :n], v[:, :, :n]),
                         str(bf), f"S={LONG_S} rows 0..{n - 1}"))
    errs.append(attn_err(out[:, :, -n:],
                         attention_ref(q[:, :, -n:], k, v, q_offset=LONG_S - n),
                         str(bf), f"S={LONG_S} rows {LONG_S - n}..{LONG_S - 1}"))
    del q, k, v, out
    return max(errs), shape_a


def margin_agreement(ref_logits, other_logits, name: str) -> None:
    """Rows whose top-2 margin in ``ref_logits`` exceeds ``MARGIN`` must
    have the same argmax in ``other_logits`` (both (rows, V))."""
    top = ref_logits.float().topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    sure = margin > MARGIN
    agree = ref_logits.argmax(-1) == other_logits.argmax(-1)
    bad = int((sure & ~agree).sum())
    print(f"{name}: rows={ref_logits.shape[0]} margin>{MARGIN}: {int(sure.sum())} "
          f"argmax agree={int(agree.sum())} disagree_with_margin={bad} "
          f"margins={[round(float(x), 4) for x in margin[:8]]}")
    check(bad == 0, f"{name}: argmaxes agree wherever the margin exceeds {MARGIN}")


def phase_prefill(params, cfg, tokens, timer):
    """Phase 7: ``forward`` at full width; launches counted from 0 in
    the first timed call. Returns the report values."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import forward

    b, s = tokens.shape
    with torch.inference_mode():
        forward(params, cfg, tokens)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        logits, first = timer(lambda: forward(params, cfg, tokens))
        counts = dict(launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(counts["flash_attention"] == cfg.num_layers,
              f"flash_attention launched {counts['flash_attention']} times in "
              f"one forward of {cfg.num_layers} layers")
        check(tuple(logits.shape) == (b, s, cfg.vocab_size)
              and logits.dtype == torch.float32, "logits (B, S, V) float32")
        check(bool(torch.isfinite(logits).all()), "finite logits")
        std = float(logits.std())
        del logits
        secs = [first] + [timer(lambda: forward(params, cfg, tokens))[1]
                          for _ in range(E2E_SAMPLES - 1)]
        wall_ms, device_ms, events, ranked, idle = device_share(
            lambda: forward(params, cfg, tokens), top=12)
    # What the op-by-op activation (the reference's bf16 rounding, see
    # models/common.py) costs against one fused call, at this FFN width.
    from repro_torch.models.common import activation_fn

    h = torch.randn(b, s, cfg.d_ff, device=params.embed.device).to(torch.bfloat16)
    act_ms = graph_ms(lambda: activation_fn(cfg.activation)(h))
    fused_ms = graph_ms(lambda: torch.nn.functional.silu(h))
    del h
    print(f"prefill activation {cfg.activation} on ({b}, {s}, {cfg.d_ff}) bf16: "
          f"op_by_op_ms={act_ms} fused_silu_ms={fused_ms} "
          f"per_forward_extra_ms={(act_ms - fused_ms) * cfg.num_layers}")
    med = median(secs)
    print(f"prefill {LM_ARCH} B={b} S={s}: wall_ms={med * 1e3} "
          f"samples_ms={[x * 1e3 for x in secs]} tokens_per_s={b * s / med} "
          f"flash_attention launches={counts['flash_attention']} "
          f"peak_memory_gb={peak_gb} logits_std={std}")
    print(f"prefill profiled: wall_ms={wall_ms} device_busy_ms={device_ms} "
          f"device_events={events} device_idle_share={idle}")
    for name, ms in ranked:
        print(f"prefill device time by kernel: {ms:.3f} ms {name[:110]}")
    return counts, med, b * s / med, peak_gb, idle


def phase_consistency(params, cfg, tokens):
    """Phase 8: ``forward``'s logits at every position against those of
    the decode path, ``prefill``'s loop (``init_kv_cache``, then one
    ``serve_step`` per token) with each step's logits kept."""
    import torch

    from repro_torch.models.transformer import forward, init_kv_cache, serve_step

    b, s = tokens.shape
    with torch.inference_mode():
        full = forward(params, cfg, tokens)
        tok = torch.from_numpy(tokens).to(full.device)
        cache = init_kv_cache(cfg, b, s, device=full.device)
        dec = torch.empty_like(full)
        for i in range(s):
            logits, cache = serve_step(params, cfg, cache, tok[:, i:i + 1], i)
            dec[:, i] = logits[:, 0]
        del cache
    diff = (full - dec).abs()
    row_max = diff.amax(-1).reshape(-1)
    max_diff = float(row_max.max())
    print(f"prefill vs decode B={b} S={s}, every position: "
          f"max_abs_diff={max_diff} mean_abs_diff={float(diff.mean())} "
          f"row_max_abs_diff p50={float(row_max.median())} "
          f"p99={float(row_max.quantile(0.99))} "
          f"last_position_max_abs_diff={float(diff[:, -1].max())} "
          f"logit_std={float(dec.std())} limit={CONSISTENCY_MAX_DIFF}")
    margin_agreement(dec.reshape(b * s, -1), full.reshape(b * s, -1),
                     "prefill vs decode")
    check(max_diff <= CONSISTENCY_MAX_DIFF,
          f"prefill vs decode: max |delta| {max_diff} within {CONSISTENCY_MAX_DIFF}")


def phase_serving(params, cfg, slots: int, max_len: int, n_requests: int,
                  profile: bool):
    """Phase 9: the LM engine at full width with ``slots`` slots of
    ``max_len`` rows on ``n_requests`` requests (two waves). Returns the
    report values; the idle share only where ``profile``."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import forward
    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(0)
    lengths = rng.integers(16, 129, n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    eng = ServeEngine(params, cfg, num_slots=slots, max_len=max_len)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=list(prompt), max_new_tokens=SERVE_NEW))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    done, secs = wall_s(eng.run)
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    h = eng.health_records[-1]
    snap = eng.metrics.snapshot()
    tokens = sum(len(r.output) for r in done)
    check(eng.waves == 2 and h.completed == n_requests and h.failed == 0,
          f"2 waves, {n_requests} completed, 0 failed: got {eng.waves}, "
          f"{h.completed}, {h.failed}")
    check(all(len(r.output) == SERVE_NEW and r.done for r in done),
          f"{SERVE_NEW} tokens for every request")
    steps = snap["serve.lm.steps"]
    cell = f"serve {LM_ARCH} slots={slots} max_len={max_len} requests={n_requests}"
    print(f"{cell} prompt_lengths={lengths.tolist()} "
          f"new_tokens={SERVE_NEW}: wall_s={secs} waves={eng.waves} "
          f"steps={steps} decode_tokens={tokens} decode_tokens_per_s={tokens / secs} "
          f"ms_per_step={secs * 1e3 / steps} peak_memory_gb={peak_gb} "
          f"launches={counts}")
    # Re-score the first request with forward (teacher-forced).
    r = min(done, key=lambda x: x.uid)
    seq = r.prompt + r.output
    with torch.inference_mode():
        logits = forward(params, cfg, np.asarray([seq]))[0]
    p = len(r.prompt)
    rows = logits[p - 1:p - 1 + len(r.output)]
    margin_agreement(rows, torch.nn.functional.one_hot(
        torch.tensor(r.output, device=rows.device), rows.shape[-1]).float(),
        f"{cell}: request {r.uid} re-scored by forward")
    idle = None
    if profile:
        # The idle share of a short run of the same engine, one wave.
        engines = []

        def wave():
            engines.clear()  # one engine's KV cache at a time
            engines.append(ServeEngine(params, cfg, num_slots=slots,
                                       max_len=max_len))
            for uid in range(slots):
                engines[0].submit(Request(uid=uid, prompt=prompts[uid][:16],
                                          max_new_tokens=8))
            return engines[0].run

        wall_ms, device_ms, events, ranked, idle = device_share(
            top=6, prepare=wave)
        small_steps = engines[0].metrics.snapshot()["serve.lm.steps"]
        print(f"{cell} profiled ({slots} requests, 16-token prompts, 8 new tokens, "
              f"{small_steps} steps): wall_ms={wall_ms} device_busy_ms={device_ms} "
              f"device_events={events} device_events_per_step={events / small_steps} "
              f"ms_per_step={wall_ms / small_steps} device_idle_share={idle}")
        for name, ms in ranked:
            print(f"serve device time by kernel: {ms:.3f} ms {name[:110]}")
    return tokens / secs, steps, secs * 1e3 / steps, peak_gb, idle


def attention_times(shape_a, dev):
    """Phase 10: the kernel's device time at shape (a) and at S=32768,
    the time per Python call, the plain version's and SDPA's. Returns
    the record fields of shape (a)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = shape_a
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    bound_ms, flops, nbytes = attention_bound_ms(b, hq, hkv, s, s, d, True, None, 2)
    ms = graph_ms(lambda: flash_attention(q, k, v, impl="cuda"))
    eager_ms = cuda_ms(lambda: flash_attention(q, k, v, impl="cuda"), iters=20)
    # The plain version allocates ~13 GB a call: timed from Python, where
    # at 20+ ms a call the host's share is small.
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v), iters=3, warmup=1)
    sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    print(f"time flash_attention B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16 causal: "
          f"ms={ms} eager_ms={eager_ms} plain_ms={plain_ms} sdpa_ms={sdpa_ms} "
          f"bound_ms={bound_ms} flops={flops} bytes={nbytes} "
          f"share_of_bound={bound_ms / ms} tflops={flops / ms / 1e9}")
    gen = torch.Generator(dev).manual_seed(2)
    ql, kl, vl = (torch.randn(1, h, LONG_S, 128, device=dev, generator=gen).to(torch.bfloat16)
                  for h in (32, 8, 8))
    long_bound, long_flops, _ = attention_bound_ms(1, 32, 8, LONG_S, LONG_S, 128,
                                                   True, None, 2)
    long_ms = graph_ms(lambda: flash_attention(ql, kl, vl, impl="cuda"), calls=2, replays=2)
    long_sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True, enable_gqa=True), calls=2, replays=2)
    print(f"time flash_attention B=1 Hq=32 Hkv=8 S={LONG_S} D=128 bf16 causal: "
          f"ms={long_ms} sdpa_ms={long_sdpa} bound_ms={long_bound} "
          f"share_of_bound={long_bound / long_ms} tflops={long_flops / long_ms / 1e9} "
          f"plain: not run (its scores would take "
          f"{32 * LONG_S * LONG_S * 4 / 1e9:.0f} GB)")
    return ms, plain_ms, eager_ms, sdpa_ms, bound_ms



def max_degree(ids, n: int) -> int:
    """The largest number of rows of one segment in ``[0, n)``."""
    import torch

    valid = ids[(ids >= 0) & (ids < n)].long()
    return int(torch.bincount(valid, minlength=n).max()) if valid.numel() else 0


def segsum_check(name, data, ids, n) -> float:
    """The kernel against its plain version on one input; returns the
    largest |err|. Checked everywhere against ``|got - want| <= atol +
    rtol * |want|``: rtol is the dtype's, atol ``SEGSUM_ATOL`` times the
    output's rms times sqrt(max degree), since a sum of k rows in
    another order differs by about sqrt(k) roundings of its size."""
    import torch

    from repro_torch.kernels.segment_sum import segment_sum_sorted

    got = segment_sum_sorted(data, ids, n, impl="cuda")
    want = segment_sum_sorted(data, ids, n, impl="torch")
    check(got.shape == want.shape and got.dtype == want.dtype == data.dtype,
          f"segment_sum {name}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"segment_sum {name}: finite output")
    rtol = SEGSUM_RTOL[str(data.dtype)]
    deg = max_degree(ids, n)
    atol = SEGSUM_ATOL * float(w.square().mean().sqrt()) * max(deg, 1) ** 0.5
    diff = (g - w).abs()
    over = int((diff > atol + rtol * w.abs()).sum())
    err = float(diff.max()) if diff.numel() else 0.0
    print(f"segment_sum {name}: m={ids.shape[0]} n={n} feat={tuple(data.shape[1:])} "
          f"{data.dtype} max_degree={deg} max_abs_err={err} rtol={rtol} "
          f"atol={atol} over_tol={over}")
    check(over == 0, f"segment_sum {name}: kernel within tolerance of its "
          "plain version")
    return err


def phase_segment_sum(dev, dst: np.ndarray) -> float:
    """Phase 2, ``segment_sum``: the kernel against its plain version at
    the GNN path's shapes and at the edge cases. Returns the largest
    max_abs_err at the main path's (ogb_products, float32) shapes."""
    import torch

    from repro_torch.kernels.segment_sum import segment_sum_sorted

    gen = torch.Generator(dev).manual_seed(3)
    ids = torch.from_numpy(dst).to(dev)
    errs = []
    for feat, dtype, what in (
            ((GNN_D,), torch.float32, "gin-tu layer 1"),
            ((64,), torch.float32, "gin-tu layers 2-5"),
            ((8, 8), torch.float32, "gat-cora layer 1 messages"),
            ((8,), torch.float32, "gat-cora layer 1 denominators"),
            ((1, GNN_CLASSES), torch.float32, "gat-cora layer 2 messages"),
            ((1,), torch.float32, "gat-cora layer 2 denominators"),
            ((64,), torch.bfloat16, "bf16")):
        data = torch.randn((GNN_M, *feat), device=dev, generator=gen).to(dtype)
        err = segsum_check(f"{GNN_SHAPE} {what}", data, ids, GNN_N)
        if dtype == torch.float32:
            errs.append(err)
        del data
    del ids
    hub_ids, hub_data = hub_case(dev, gen)
    segsum_check("hub", hub_data, hub_ids, HUB_N)
    # Empty segments (every other one), negative ids and sentinels: the
    # reference's padding id n, and ns_pad + block_s.
    n = 1 << 20
    body = torch.randint(0, n // 2, (1 << 22,), device=dev, generator=gen) * 2
    ids = torch.cat([torch.tensor([-9, -1, -1], device=dev), body,
                     torch.tensor([n, n, n + 256 + 1000], device=dev)])
    ids = ids.sort().values.to(torch.int32)
    data = torch.randn(ids.shape[0], 24, device=dev, generator=gen)
    segsum_check("empty, negative and sentinel ids", data, ids, n)
    got = segment_sum_sorted(data, ids, n, impl="cuda")
    check(not bool(got[1::2].any()), "empty segments sum to 0")
    del got, data, ids, body, hub_ids, hub_data
    torch.cuda.empty_cache()
    return max(errs)


def hub_case(dev, gen):
    """HUB_M sorted ids over HUB_N segments, one of which owns a tenth
    of the rows, with (HUB_M, 64) float32 rows."""
    import torch

    hub = HUB_M // 10
    rest = torch.randint(0, HUB_N, (HUB_M - hub,), device=dev, generator=gen)
    ids = torch.cat([rest, torch.full((hub,), HUB_N // 2, device=dev)])
    ids = ids.sort().values.to(torch.int32)
    return ids, torch.randn(HUB_M, 64, device=dev, generator=gen)


def segment_sum_times(dev, dst: np.ndarray):
    """Phase 5, ``segment_sum``: device ms (CUDA-graph replays), ms per
    Python call, plain ms, ``torch.segment_reduce`` and ``index_add_``
    ms, and the byte bound, at gin-tu's layer-1 and layer-2 shapes and
    the hub case. Returns the layer-1 record fields."""
    import torch

    from repro_torch.kernels.segment_sum import segment_sum_sorted
    from repro_torch.kernels.segment_sum.ref import segment_sum_sorted_ref

    gen = torch.Generator(dev).manual_seed(4)
    ogb_ids = torch.from_numpy(dst).to(dev)
    hub_ids, hub_data = hub_case(dev, gen)
    cases = (
        (f"{GNN_SHAPE} gin-tu layer 1 (m, {GNN_D})", ogb_ids, GNN_N, GNN_D),
        (f"{GNN_SHAPE} gin-tu layers 2-5 (m, 64)", ogb_ids, GNN_N, 64),
        ("hub (2^22, 64), one segment of 2^22 / 10 rows", hub_ids, HUB_N, 64),
    )
    first = None
    for name, ids, n, d in cases:
        data = (hub_data if ids is hub_ids
                else torch.randn(GNN_M, d, device=dev, generator=gen))
        m = ids.shape[0]
        lengths = torch.bincount(ids.long(), minlength=n)
        long_ids = ids.long()

        def kernel():
            return segment_sum_sorted(data, ids, n, impl="cuda")

        def plain():
            return segment_sum_sorted_ref(data, ids, n)

        ms = graph_ms(kernel, calls=10, replays=3)
        eager_ms = cuda_ms(kernel, iters=10, warmup=2)
        plain_ms = graph_ms(plain, calls=3, replays=3)
        lib_ms = cuda_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths),
                         iters=5, warmup=1)
        add_ms = cuda_ms(lambda: torch.zeros(n, d, device=dev).index_add_(
            0, long_ids, data), iters=5, warmup=1)
        lib_err = float((torch.segment_reduce(data, "sum", lengths=lengths)
                         - kernel()).abs().max())
        nbytes = m * d * 4 + 4 * m + n * d * 4 + 4 * (n + 1)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"time segment_sum {name}: ms={ms} eager_ms={eager_ms} "
              f"plain_ms={plain_ms} segment_reduce_ms={lib_ms} "
              f"index_add_ms={add_ms} bound_ms={bound_ms} bytes={nbytes} "
              f"share_of_bound={bound_ms / ms} "
              f"gb_per_s={nbytes / ms / 1e6} "
              f"segment_reduce_max_abs_diff={lib_err}")
        if first is None:
            first = (ms, plain_ms, eager_ms, lib_ms, bound_ms)
        del data, lengths, long_ids
    del ogb_ids, hub_ids, hub_data
    torch.cuda.empty_cache()
    return first


def gnn_by_index_add(name, params, cfg, graph):
    """The logits of gin-tu or gat-cora computed independently of the
    port's aggregation path: plain ``index_add_`` sums over unsorted-safe
    int64 ids, ``scatter_reduce`` maxima, ``F.layer_norm``, and the same
    layers on the same parameters."""
    import torch
    import torch.nn.functional as F

    h = graph["node_feats"]
    n = h.shape[0]
    src, dst = graph["src"].long(), graph["dst"].long()

    def agg(msgs, index, rows):
        out = torch.zeros((rows, *msgs.shape[1:]), dtype=msgs.dtype,
                          device=msgs.device)
        return out.index_add_(0, index, msgs)

    if name == "gin-tu":
        reps = []
        for layer in params.layers:
            z = (1.0 + layer.eps) * h + agg(h[src], dst, n)
            z = F.linear(F.relu(F.linear(z, layer.w1.weight, layer.w1.bias)),
                         layer.w2.weight, layer.w2.bias)
            h = F.layer_norm(z, (z.shape[-1],), layer.ln_g, layer.ln_b, eps=1e-5)
            reps.append(h)
        hcat = torch.cat(reps, dim=-1)
        if cfg.readout == "graph":
            hcat = agg(hcat, graph["graph_ids"].long(), int(graph["num_graphs"]))
        return F.linear(hcat, params.head.weight, params.head.bias)
    for i, layer in enumerate(params.layers):
        last = i == len(params.layers) - 1
        heads = 1 if last else cfg.num_heads
        d_out = cfg.num_classes if last else cfg.d_hidden
        wh = (h @ layer.w.weight.T).reshape(n, heads, d_out)
        s_src = (wh * layer.a_src).sum(-1)
        s_dst = (wh * layer.a_dst).sum(-1)
        e = F.leaky_relu(s_src[src] + s_dst[dst], cfg.negative_slope)
        top = torch.full((n, heads), float("-inf"), device=h.device)
        top.scatter_reduce_(0, dst[:, None].expand_as(e), e, "amax")
        top = torch.where(torch.isfinite(top), top, 0.0)
        p = torch.exp(e - top[dst])
        del e
        den = agg(p, dst, n).clamp_min(torch.finfo(p.dtype).tiny)
        out = agg(wh[src] * p[..., None], dst, n) / den[..., None]
        del p
        h = out.mean(dim=1) if last else F.elu(out.reshape(n, -1) + layer.b)
    return h


def check_logits(name, got, want):
    """``got`` within rtol = GNN_TOL of ``want`` and an atol of GNN_TOL
    times the smaller of 1 and ``want``'s rms (so a cell of small logits,
    gat-cora's rms is about 0.05, is held to its own scale), and the same
    argmax wherever ``want``'s top-2 margin exceeds GNN_MARGIN."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype == torch.float32,
          f"{name}: logits {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: finite logits")
    diff = (got - want).abs()
    atol = GNN_TOL * min(1.0, float(want.square().mean().sqrt()))
    over = int((diff > atol + GNN_TOL * want.abs()).sum())
    top = want.topk(2, dim=-1).values
    sure = (top[:, 0] - top[:, 1]) > GNN_MARGIN
    agree = got.argmax(-1) == want.argmax(-1)
    bad = int((sure & ~agree).sum())
    print(f"{name} vs gnn_by_index_add: max_abs_diff={float(diff.max())} "
          f"mean_abs_diff={float(diff.mean())} logit_std={float(want.std())} "
          f"atol={atol} over_tol={over} rows={want.shape[0]} margin>{GNN_MARGIN}: "
          f"{int(sure.sum())} argmax_agree={int(agree.sum())} "
          f"disagree_with_margin={bad}")
    check(over == 0, f"{name}: logits within tolerance of the independent forward")
    check(bad == 0, f"{name}: argmaxes agree wherever the margin exceeds {GNN_MARGIN}")


def gnn_cell(dev, name, shape, graph, want_launches, profile: bool):
    """One GNN cell: ``forward`` of ``name`` at ``config_for(shape)`` on
    ``graph`` (tensors on the card), launches counted from 0 in the
    first timed call, checked against ``gnn_by_index_add``; where
    ``profile``, the idle share and top device kernels of one profiled
    call. Returns the report values."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    arch = get_arch(name)
    cfg = arch.config_for(shape)
    fwd = arch.module.forward
    params = arch.module.init_params(
        cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    m = graph["src"].shape[0]
    with torch.inference_mode():
        fwd(params, cfg, graph)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        logits, first = wall_s(lambda: fwd(params, cfg, graph))
        counts = dict(launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(counts["segment_sum"] == want_launches,
              f"{name} {shape}: segment_sum launched {counts['segment_sum']} "
              f"times in one forward, want {want_launches}")
        secs = [first] + [wall_s(lambda: fwd(params, cfg, graph))[1]
                          for _ in range(E2E_SAMPLES - 1)]
        check_logits(f"{name} {shape}", logits,
                     gnn_by_index_add(name, params, cfg, graph))
        del logits
        idle = None
        if profile:
            wall_ms, device_ms, events, ranked, idle = device_share(
                lambda: fwd(params, cfg, graph), top=8)
            print(f"gnn {name} {shape} profiled: wall_ms={wall_ms} "
                  f"device_busy_ms={device_ms} device_events={events} "
                  f"device_idle_share={idle}")
            for kname, ms in ranked:
                print(f"gnn {name} device time by kernel: {ms:.3f} ms {kname[:110]}")
    med = median(secs)
    print(f"gnn {name} {shape}: n={graph['node_feats'].shape[0]} m={m} "
          f"layers={cfg.num_layers} readout={getattr(cfg, 'readout', 'node')} "
          f"wall_ms={med * 1e3} samples_ms={[x * 1e3 for x in secs]} "
          f"edges_per_s={cfg.num_layers * m / med} "
          f"segment_sum launches={counts['segment_sum']} peak_memory_gb={peak_gb}")
    del params
    return med, cfg.num_layers * m / med, peak_gb, idle, counts["segment_sum"]


def gnn_on_card(g: dict, dev) -> dict:
    import torch

    out = {k: torch.from_numpy(np.ascontiguousarray(g[k])).to(dev)
           for k in ("node_feats", "src", "dst", "graph_ids")}
    out["num_graphs"] = int(g["num_graphs"])
    return out


def phase_gnn(dev, ogb: dict) -> dict:
    """Phase 11: GNN inference on the ogb_products graph, each cell
    profiled, and on a molecule batch. Returns ``{cell: (seconds,
    edges/s, peak GB, idle share, launches)}``."""
    import torch

    from repro_torch.data.graphs import molecule_batch

    graph = gnn_on_card(ogb, dev)
    print(f"gnn graph {GNN_SHAPE} on the card: "
          f"{sum(v.numel() * v.element_size() for k, v in graph.items() if k != 'num_graphs') / 1e9} GB")
    cells = {}
    for name, launches in GNN_ARCHS:
        cells[(name, GNN_SHAPE)] = gnn_cell(dev, name, GNN_SHAPE, graph,
                                            launches, profile=True)
        torch.cuda.empty_cache()
    del graph
    mol = gnn_on_card(molecule_batch(MOLECULE_BATCH), dev)
    cells[("gin-tu", "molecule")] = gnn_cell(
        dev, "gin-tu", "molecule", mol, MOLECULE_LAUNCHES, profile=False)
    torch.cuda.empty_cache()
    return cells


def phase_lm(dev) -> dict:
    """Phases 6-10 on qwen3-4b at full width."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import init_params
    from repro_torch.models.transformer.attention import qkv_projections
    from repro_torch.models.transformer.model import as_tokens, embed_lookup

    cfg = get_arch(LM_ARCH).config
    t0 = time.perf_counter()
    params = init_params(cfg, device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model {LM_ARCH}: params={n_params} dtype={cfg.dtype} "
          f"init_s={time.perf_counter() - t0} "
          f"memory_gb={torch.cuda.memory_allocated() / 1e9}")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S))
    with torch.inference_mode():
        tok = as_tokens(params, tokens)
        layer = params.dense_layers[0]
        positions = torch.arange(PREFILL_S, dtype=torch.int32, device=dev)
        layer0_qkv = qkv_projections(
            layer.attn, cfg, rms_norm(embed_lookup(params, cfg, tok), layer.ln1),
            positions[None].expand(PREFILL_B, PREFILL_S))
    max_err, shape_a = phase_attention(dev, layer0_qkv)
    del layer0_qkv
    counts, prefill_s, tps, peak_gb, idle = phase_prefill(
        params, cfg, tokens, wall_s)
    phase_consistency(params, cfg, tokens[:, :CONSISTENCY_S])
    serving = [phase_serving(params, cfg, *cell) for cell in SERVE_CELLS]
    del params
    torch.cuda.empty_cache()
    return {
        "counts": counts, "max_abs_err": max_err,
        "prefill_s": prefill_s, "prefill_tps": tps, "prefill_peak_gb": peak_gb,
        "prefill_idle": idle, "serving": serving,
        "times": attention_times(shape_a, dev),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import AUTO_SAMPLE_ROUNDS
    from repro_torch.data.graphs import full_graph
    from repro_torch.kernels import build
    from repro_torch.ops.kiss import giant_dust_graph, random_graph

    dev = torch.device("cuda")
    # Float32 products in full float32 (no TF32), for the plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # Phase 1: build every kernel, one nvcc per source, all at once.
    t0 = time.perf_counter()
    build.build()
    print(f"build_s={time.perf_counter() - t0} nvcc {' '.join(build.NVCC_FLAGS)}")
    for name in build.SOURCES:
        print(f"ptxas {name}:\n{build.ptxas_report(name)}")
    t0 = time.perf_counter()
    ogb = full_graph(GNN_N, GNN_M, GNN_D, GNN_CLASSES, seed=0)
    print(f"gnn graph full_graph({GNN_N}, {GNN_M}, {GNN_D}, {GNN_CLASSES}, "
          f"seed=0): host_s={time.perf_counter() - t0}")

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
    errs["segment_sum"] = phase_segment_sum(dev, ogb["dst"])

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
    del giant, rand, dense, hook_inputs, pj_inputs, agg_inputs
    torch.cuda.empty_cache()
    ss_times = segment_sum_times(dev, ogb["dst"])

    # Phases 6-10: the LM.
    lm = phase_lm(dev)
    launches["flash_attention"] = lm["counts"]["flash_attention"]

    # Phase 11: GNN inference, launches counted from 0 in each cell.
    gnn = phase_gnn(dev, ogb)
    del ogb
    launches["segment_sum"] = sum(cell[-1] for cell in gnn.values())
    errs["flash_attention"] = lm["max_abs_err"]
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
    print("library_ms: n/a for the three graph kernels -- no single "
          "PyTorch call computes an SV hook phase, a pointer-jumping run or "
          "the RS5 aggregation")
    fa_ms, fa_plain, fa_eager, fa_sdpa, fa_bound = lm["times"]
    records.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": KERNELS["flash_attention"][1],
        "launches": launches["flash_attention"],
        "max_abs_err": errs["flash_attention"], "ms": fa_ms,
        "plain_ms": fa_plain, "bound_ms": fa_bound, "bound_by": "operations",
        "library_ms": fa_sdpa,
    })
    print(f"time flash_attention (record): ms={fa_ms} eager_ms={fa_eager} "
          f"plain_ms={fa_plain} library_ms(sdpa)={fa_sdpa} bound_ms={fa_bound} "
          f"[{card}]")
    ss_ms, ss_plain, ss_eager, ss_lib, ss_bound = ss_times
    records.append({
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": KERNELS["segment_sum"][1],
        "launches": launches["segment_sum"],
        "max_abs_err": errs["segment_sum"], "ms": ss_ms,
        "plain_ms": ss_plain, "bound_ms": ss_bound, "bound_by": "bytes",
        "library_ms": ss_lib,
    })
    print(f"time segment_sum (record, {GNN_SHAPE} (m, {GNN_D}) float32): "
          f"ms={ss_ms} eager_ms={ss_eager} plain_ms={ss_plain} "
          f"library_ms(segment_reduce)={ss_lib} bound_ms={ss_bound} [{card}]")
    for name, secs in cc_rows:
        print(f"e2e connected_components {name}: wall_s={secs} [{card}]")
    print(f"e2e list_rank n={LIST_N}: wall_s={list_secs} "
          f"rs3_walk_share={walk_share} [{card}]")
    print(f"e2e prefill {LM_ARCH} B={PREFILL_B} S={PREFILL_S}: "
          f"wall_ms={lm['prefill_s'] * 1e3} tokens_per_s={lm['prefill_tps']} "
          f"peak_memory_gb={lm['prefill_peak_gb']} "
          f"device_idle_share={lm['prefill_idle']} [{card}]")
    for (slots, max_len, n, _), (tps, steps, ms_step, peak, idle) in zip(
            SERVE_CELLS, lm["serving"]):
        print(f"e2e serve {LM_ARCH} slots={slots} max_len={max_len} {n} requests "
              f"x {SERVE_NEW} tokens: decode_tokens_per_s={tps} steps={steps} "
              f"ms_per_step={ms_step} peak_memory_gb={peak} "
              f"device_idle_share={'not profiled' if idle is None else idle} [{card}]")
    for (name, shape), (secs, eps, peak, idle, n_launch) in gnn.items():
        print(f"e2e gnn {name} {shape}: wall_ms={secs * 1e3} edges_per_s={eps} "
              f"peak_memory_gb={peak} segment_sum_launches={n_launch} "
              f"device_idle_share={'not profiled' if idle is None else idle} "
              f"[{card}]")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
