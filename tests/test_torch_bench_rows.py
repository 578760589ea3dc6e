"""The full-size counter rows of ``BENCH_cc.json`` and
``BENCH_trees.json``, recomputed by the port on the CPU and held to the
files character for character: ``benchmarks/cc_frontier.py``'s nine
``cc_frontier/*`` rows (n = 800,000), ``benchmarks/multidev_scaling.py``'s
``cc_single`` row and its ``*_dev{1,2,4,8}`` rows (n = 20,000; a gloo
group of each size, formed in turn by eight spawned processes), and ``benchmarks/tree_ops.py``'s
twelve ``tree_ops/*`` rows (n = 200,000). Only the derived counters are
compared; the timings are the reference's own."""
import json
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import frontier_shiloach_vishkin, shiloach_vishkin  # noqa: E402
from repro_torch.data.graphs import (  # noqa: E402
    random_succ,
    random_tree,
    random_tree_forest,
)
from repro_torch.ops.kiss import giant_dust_graph, list_graph, random_graph  # noqa: E402
from repro_torch.trees import (  # noqa: E402
    euler_tour,
    spanning_forest,
    tour_capacity,
    tree_computations,
)



ROOT = Path(__file__).resolve().parents[1]
CC_N, MULTIDEV_N, TREES_N = 800_000, 20_000, 200_000
SIZES = (1, 2, 4, 8)
TIMEOUT = 300  # seconds: the wait for one group's rows


def _rows(path: str) -> dict:
    return {r["name"]: r["derived"]
            for r in json.loads((ROOT / path).read_text())}


# ---------------------------------------------------------------------------
# cc_frontier/* (benchmarks/cc_frontier.py at its default n)
# ---------------------------------------------------------------------------


def _cc_families(n):
    return {
        "giant+dust": lambda: giant_dust_graph(n, 0.9, seed=1),
        "forest-small": lambda: list_graph(n, max(2, n // 64), seed=2),
        "chain": lambda: list_graph(n, 1, seed=3),
    }


@pytest.mark.parametrize("family", ["giant+dust", "forest-small", "chain"])
def test_cc_frontier_rows_equal_bench_cc(family):
    n = CC_N
    edges = _cc_families(n)[family]()
    src, dst = edges[:, 0], edges[:, 1]
    _, rounds = shiloach_vishkin(src, dst, n, device="cpu")
    _, _, st = frontier_shiloach_vishkin(src, dst, n, with_stats=True,
                                         device="cpu")
    dense_visits = 2 * st.m2 * int(rounds)
    ratio = dense_visits / max(st.edges_touched, 1)
    _, _, sta = frontier_shiloach_vishkin(src, dst, n, sample_rounds=2,
                                          with_stats=True, device="cpu")
    got = {
        f"cc_frontier/dense/{family}/n={n}":
            f"rounds={int(rounds)};edges_touched={dense_visits}",
        f"cc_frontier/frontier/{family}/n={n}":
            f"rounds={st.rounds};edges_touched={st.edges_touched};"
            f"visit_ratio={ratio:.2f};levels={len(st.levels)}",
        f"cc_frontier/afforest/{family}/n={n}":
            f"edges_touched={sta.edges_touched};"
            f"giant_frac={sta.largest_component_frac:.2f};"
            f"live_after_sample={sta.live_after_sample}",
    }
    want = _rows("BENCH_cc.json")
    for name, derived in got.items():
        assert derived == want[name], name


# ---------------------------------------------------------------------------
# multidev_scaling (benchmarks/multidev_scaling.py at its default n)
# ---------------------------------------------------------------------------


def _multidev_inputs(n):
    from repro_torch.core.list_ranking import select_splitters

    p = min(512, n)
    return (random_graph(n, 4.0 / n, seed=1), random_succ(n, seed=0), p,
            select_splitters(n, p, seed=0))


def test_cc_single_row_equals_bench_cc():
    n = MULTIDEV_N
    edges, *_ = _multidev_inputs(n)
    _, rounds = shiloach_vishkin(edges[:, 0], edges[:, 1], n, device="cpu")
    assert f"rounds={int(rounds)};exKiB=0" == _rows("BENCH_cc.json")["cc_single"]


def _multidev_rows(d: int, n: int) -> dict:
    """The three ``*_dev{d}`` derived strings, on this rank of a group of
    ``d`` gloo ranks."""
    from repro_torch.distributed import (
        cc_exchange_words_per_round,
        graph_mesh,
        rank_exchange_words,
        sharded_random_splitter_rank,
        sharded_shiloach_vishkin,
    )

    edges, succ, p, spl = _multidev_inputs(n)
    mesh = graph_mesh(d, device="cpu")
    _, rounds = sharded_shiloach_vishkin(edges[:, 0], edges[:, 1], n, mesh=mesh)
    ex_kib = cc_exchange_words_per_round(n) * 4 / 1024
    out = {f"cc_sharded_dev{d}": (
        f"rounds={int(rounds)};exKiB/round={ex_kib:.1f};"
        f"edges/dev={2 * len(edges) // d}")}
    _, _, st = sharded_shiloach_vishkin(
        edges[:, 0], edges[:, 1], n, mesh=mesh, exchange="sparse",
        with_stats=True)
    w = cc_exchange_words_per_round(n, stats=st)
    out[f"cc_sharded_sparse_dev{d}"] = (
        f"capacity={st.capacity};wordsR1={int(w[0])};"
        f"wordsLast={int(w[-1])};denseWords={3 * n}")
    sharded_random_splitter_rank(succ, splitters=spl, mesh=mesh)
    ex_kib = rank_exchange_words(n, p, d) * 4 / 1024
    out[f"rank_sharded_dev{d}"] = f"exKiB={ex_kib:.1f};lanes/dev={-(-p // d)}"
    return out


def _rank_worker(rank, tmp, n, q):
    """One process, a rank of each group size in turn, largest first:
    ranks ``[0, size)`` of every size that has this rank form a gloo
    group of their own (a fresh file store each), compute the rows and
    destroy it. So 8 processes serve all four sizes."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        for size in sorted(SIZES, reverse=True):
            if rank >= size:
                break
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp}/store{size}", rank=rank,
                world_size=size,
            )
            try:
                q.put((size, rank, _multidev_rows(size, n)))
            finally:
                dist.destroy_process_group()
    except BaseException:  # reported to the parent, then re-raised
        q.put((None, rank, traceback.format_exc()))
        raise


@pytest.fixture(scope="module")
def multidev(tmp_path_factory):
    """``{size: [rows of each rank]}``: max(SIZES) spawned processes, each
    a rank of every group size in turn."""
    import multiprocessing as mp

    tmp = tmp_path_factory.mktemp("bench_rows")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_worker, args=(r, str(tmp), MULTIDEV_N, q))
             for r in range(max(SIZES))]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(sum(SIZES)):
            size, rank, out = q.get(timeout=TIMEOUT)
            assert isinstance(out, dict), f"rank {rank}:\n{out}"
            got[(size, rank)] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return {size: [got[(size, r)] for r in range(size)] for size in SIZES}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["cc_sharded", "cc_sharded_sparse",
                                  "rank_sharded"])
def test_multidev_scaling_rows_equal_bench_cc(multidev, kind, size):
    name = f"{kind}_dev{size}"
    want = _rows("BENCH_cc.json")[name]
    for rank, rows in enumerate(multidev[size]):
        assert rows[name] == want, (name, rank)


# ---------------------------------------------------------------------------
# tree_ops/* (benchmarks/tree_ops.py at its default n)
# ---------------------------------------------------------------------------


def _tree_families(n):
    return {
        "one-tree": lambda: random_tree(n, seed=1),
        "path": lambda: np.stack([np.arange(n - 1, dtype=np.int32),
                                  np.arange(1, n, dtype=np.int32)], axis=1),
        "molecule-batch": lambda: random_tree_forest(n, max(2, n // 30), seed=2),
    }


@pytest.mark.parametrize("family", ["one-tree", "path", "molecule-batch"])
def test_tree_ops_rows_equal_bench_trees(family):
    n = TREES_N
    edges = _tree_families(n)[family]()
    forest = spanning_forest(edges[:, 0], edges[:, 1], n, device="cpu")
    cap = tour_capacity(forest.num_edges)
    tour = euler_tour(forest.edge_u, forest.edge_v, n, labels=forest.labels,
                      pad_to=cap, device="cpu")
    got = {
        f"tree_ops/forest/{family}/n={n}":
            f"trees={forest.num_trees};edges={forest.num_edges}",
        f"tree_ops/tour/{family}/n={n}":
            f"arcs={tour.num_arcs};capacity={tour.capacity}",
    }
    for engine in ("wylie", "splitter"):
        comp = tree_computations(tour, rank_engine=engine)
        max_depth = int(comp.depth.max())
        total_size = int(comp.subtree_size.long().sum())
        got[f"tree_ops/compute/{family}/{engine}/n={n}"] = (
            f"max_depth={max_depth};size_sum={total_size};arcs={tour.num_arcs}")
    want = _rows("BENCH_trees.json")
    for name, derived in got.items():
        assert derived == want[name], name
