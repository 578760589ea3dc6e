#!/usr/bin/env python3
"""Time ``repro_torch``'s ``ordered_fold`` of one checkout on one CUDA card,
on PageRank's calls.

    python3 tools/ordered_fold_ab.py [SRC_DIR]

``SRC_DIR`` is the ``src`` directory of the checkout whose kernel is
timed (by default this checkout's). On ``chip_smoke.py``'s PageRank graph
(the CC random cell's: 2^20 nodes, m2 = 8,388,600 arcs, ``default_rng(3)``
weights) it prints the device ms (``chip_smoke.graph_ms``) of the
checkout's ``ordered_fold`` on the degrees pass and the mass step (the
generic fold of ``dmp * (out[a] * w2)`` written out, and, where the
checkout has it, the fused form that gathers and multiplies itself),
of one whole mass step as the checkout's ``pagerank`` runs it
(``_mass_step``: out-mass, gathers, multiplies and fold), of 2^23
power-law ids (weight (r + 1) ** -0.8) and of a star of 2^20 arcs into
one hub; each beside its byte bound, L2's
random-sector floor and the chain floor (the largest degree times one
add), and ``torch.index_add`` on the same values. Then the wall time of
the dense 98-iteration ``pagerank`` and of ``pagerank`` to tol 1e-6
(median of three after a warm-up), and a probe built from
``tools/gather_probe.cu``: random 4-byte gathers from a 4 MB table (the
fused form's node array) and a 32 MB one (the generic form's value
array), in sectors per second. Every line carries the card's name and
power limit. To compare two commits, unpack one beside the other and run
this script on each in turns in one call on the same card: parent,
change, change, parent.
"""
from __future__ import annotations

import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBE_TABLES = (("4 MB", 20), ("32 MB", 23))  # log2 of the table's 4-byte words


def gather_rates(cs, build, card: str) -> None:
    """Print the probe's random-gather rate from each of PROBE_TABLES."""
    import torch

    from tools.edge_hook_ab import PROBE_LIB, PROBE_SRC, PROBE_THREADS

    PROBE_LIB.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(PROBE_LIB),
                    str(PROBE_SRC)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(PROBE_LIB))
    lib.gather_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p]
    lib.gather_probe.restype = ctypes.c_int
    lib.gather_probe_per_thread.restype = ctypes.c_int
    gathers = PROBE_THREADS * lib.gather_probe_per_thread()
    out = torch.empty(PROBE_THREADS, dtype=torch.int32, device="cuda")
    for name, log2_words in PROBE_TABLES:
        table = torch.randint(0, 1 << 30, (1 << log2_words,), dtype=torch.int32,
                              device="cuda")

        def launch():
            status = lib.gather_probe(table.data_ptr(), log2_words, out.data_ptr(),
                                      PROBE_THREADS,
                                      torch.cuda.current_stream().cuda_stream)
            cs.check(status == 0, f"gather_probe launch: CUDA error {status}")

        ms = cs.graph_ms(launch)
        print(f"ordered_fold_ab probe: random 4-byte gathers from a {name} table: "
              f"gathers={gathers} ms={ms} sectors_per_s={gathers / ms * 1e3} [{card}]",
              flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ordered_fold_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    sys.path.insert(0, str(src))
    from repro_torch.core import pagerank
    from repro_torch.core.components import oriented_edges
    from repro_torch.kernels import build
    from repro_torch.kernels.ordered_fold import ops
    from repro_torch.ops.kiss import random_graph

    pr = importlib.import_module("repro_torch.core.pagerank")
    card = cs.card_line()
    dev = torch.device("cuda")
    build.build(("ordered_fold",))
    has_chain = hasattr(build.load("ordered_fold"), "ordered_fold_chain_floor")
    add_ms = (cs.chain_floor_ms(cs.STAR_LEAVES) / cs.STAR_LEAVES if has_chain
              else None)
    n = cs.CC_RANDOM_N
    edges = random_graph(n, cs.CC_RANDOM_DENSITY, seed=1)
    weights = cs.sssp_weights(len(edges))
    a, b = oriented_edges(edges[:, 0], edges[:, 1], n, device=dev)
    w = torch.from_numpy(weights).to(dev)
    w2 = torch.cat([w, w])
    m2 = a.numel()
    a_plan, b_plan = ops.fold_plan(a, n), ops.fold_plan(b, n)
    zeros = torch.zeros(n, device=dev)
    deg = ops.ordered_fold_sorted(zeros, a_plan.row_ptr, a_plan.perm, w2)
    dmp = torch.tensor(np.float32(0.85), device=dev)
    omd = torch.tensor(np.float32(1.0) - np.float32(0.85), device=dev)
    t = torch.full((n,), 1.0 / n, device=dev)
    out = torch.where(deg > 0, t / deg, 0.0)
    base = omd * t
    vals = dmp * (out[a] * w2)

    def row(name, fold, lib, nbytes, gathers, max_deg, **kw):
        ms = cs.graph_ms(fold, **kw)
        lib_ms = None if lib is None else cs.graph_ms(lib, **kw)
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        chain = "n/a" if add_ms is None else max_deg * add_ms
        print(f"ordered_fold_ab {src} {name}: ms={ms} bound_ms={bound} "
              f"share_of_bound={bound / ms} l2_floor_ms="
              f"{gathers / cs.L2_SECTORS_PER_S * 1e3} max_degree={max_deg} "
              f"chain_floor_ms={chain} library_ms(index_add)={lib_ms} [{card}]",
              flush=True)

    def max_degree(plan):
        return int(torch.diff(plan.row_ptr).max())

    a_long, b_long = a.long(), b.long()
    row("pagerank degrees", lambda: ops.ordered_fold_sorted(
        zeros, a_plan.row_ptr, a_plan.perm, w2),
        lambda: torch.index_add(zeros, 0, a_long, w2), 8 * m2 + 12 * n + 4, m2,
        max_degree(a_plan))
    row("mass step generic", lambda: ops.ordered_fold_sorted(
        base, b_plan.row_ptr, b_plan.perm, vals),
        lambda: torch.index_add(base, 0, b_long, vals), 8 * m2 + 12 * n + 4, m2,
        max_degree(b_plan))
    if hasattr(ops, "ordered_fold_gathered"):
        a_sorted, w_sorted = pr._mass_arcs(a, w2, b_plan)
        row("mass step fused", lambda: ops.ordered_fold_gathered(
            base, b_plan.row_ptr, a_sorted, out, w_sorted, dmp), None,
            8 * m2 + 16 * n + 8, m2, max_degree(b_plan))
        step_args = (b_plan, a_sorted, w_sorted)
    else:
        step_args = (a, b_plan, w2)
    step_ms = cs.graph_ms(lambda: pr._mass_step(*step_args, deg, t, t, dmp, omd))
    print(f"ordered_fold_ab {src} whole mass step (_mass_step, as pagerank runs "
          f"it): ms={step_ms} [{card}]", flush=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    pl_ids = cs.power_law_draws(dev, gen, n, cs.PAGERANK_M2)
    pl_vals = torch.randn(cs.PAGERANK_M2, device=dev, generator=gen)
    pl_base = torch.randn(n, device=dev, generator=gen)
    pl_plan = ops.fold_plan(pl_ids.to(torch.int32), n)
    row("power-law ids", lambda: ops.ordered_fold_sorted(
        pl_base, pl_plan.row_ptr, pl_plan.perm, pl_vals),
        lambda: torch.index_add(pl_base, 0, pl_ids, pl_vals),
        8 * cs.PAGERANK_M2 + 12 * n + 4, cs.PAGERANK_M2, max_degree(pl_plan))
    hub_vals = torch.randn(cs.STAR_LEAVES, device=dev, generator=gen)
    hub_base = torch.randn(cs.STAR_LEAVES + 1, device=dev, generator=gen)
    hub_ids = torch.zeros(cs.STAR_LEAVES, dtype=torch.int64, device=dev)
    hub_plan = ops.fold_plan(hub_ids.to(torch.int32), cs.STAR_LEAVES + 1)
    row("star hub", lambda: ops.ordered_fold_sorted(
        hub_base, hub_plan.row_ptr, hub_plan.perm, hub_vals),
        lambda: torch.index_add(hub_base, 0, hub_ids, hub_vals),
        8 * cs.STAR_LEAVES + 12 * (cs.STAR_LEAVES + 1) + 4, cs.STAR_LEAVES,
        cs.STAR_LEAVES, calls=2, replays=2)
    del pl_ids, pl_vals, pl_plan, hub_vals, hub_base, hub_ids, hub_plan
    for engine in ("dense", "frontier"):
        def call():
            return pagerank(edges[:, 0], edges[:, 1], weights, n, engine=engine,
                            device=dev)

        call()  # warm-up
        secs = [cs.wall_s(call)[1] for _ in range(3)]
        print(f"ordered_fold_ab {src} pagerank {engine}: iterations={call()[1]} "
              f"wall_s={cs.median(secs)} samples={secs} [{card}]", flush=True)
    gather_rates(cs, build, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
