"""The port's Euler-tour tree analytics against ``repro.trees`` on the
CPU, bit for bit: spanning forests, tours (exact, ``pad_to`` and padded
``num_edges=`` buffers) and tree computations on both rank engines with
``kernel_impl="torch"``; ``tour_splitters``; the ``tree_ops/*`` rows of
``BENCH_smoke.json``; the port's serial oracle; ``random_tree`` and
``random_tree_forest`` against ``repro.data.graphs``; and the sorted
dispatch helpers against ``repro.ops.sorted_dispatch``."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.trees as rt  # noqa: E402
from repro.data import graphs as rgraphs  # noqa: E402
from repro.ops import kiss  # noqa: E402
from repro.ops import sorted_dispatch as rsd  # noqa: E402
from repro.trees.reference import serial_tree_reference as ref_oracle  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.trees as tt  # noqa: E402
from repro_torch.data import graphs as tgraphs  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.ops import sorted_dispatch as tsd  # noqa: E402
from repro_torch.trees.reference import serial_tree_reference  # noqa: E402

FIELDS = ("parent", "depth", "subtree_size", "preorder", "postorder")
TOUR_FIELDS = ("succ", "arc_src", "arc_dst", "twin", "head_of_arc", "valid",
               "labels", "root_of")


def _path(n):
    return np.stack([np.arange(n - 1, dtype=np.int32),
                     np.arange(1, n, dtype=np.int32)], axis=1)


def _star(n):
    return np.stack([np.zeros(n - 1, np.int32),
                     np.arange(1, n, dtype=np.int32)], axis=1)


def _shapes():
    return {
        "path": (80, _path(80)),
        "star": (64, _star(64)),
        "random-tree": (257, rgraphs.random_tree(257, seed=5)),
        "forest": (300, rgraphs.random_tree_forest(300, 12, seed=7)),
        "single-edge": (2, np.array([[1, 0]], np.int32)),
        "no-edges": (5, np.zeros((0, 2), np.int32)),
    }


SHAPES = _shapes()


def _eq(want, got):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


def _same_tour(want, got):
    for k in TOUR_FIELDS:
        _eq(getattr(want, k), getattr(got, k))
    assert got.num_arcs == want.num_arcs and got.capacity == want.capacity


@pytest.mark.parametrize("root", [None, "middle"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tour_and_computations_match_reference(shape, root):
    n, e = SHAPES[shape]
    u, v = e[:, 0], e[:, 1]
    r = None if root is None else n // 2
    for pad_to in (None, tt.tour_capacity(len(u)) * 2):
        want = rt.euler_tour(u, v, n, root=r, pad_to=pad_to)
        got = tt.euler_tour(u, v, n, root=r, pad_to=pad_to, device="cpu")
        _same_tour(want, got)
        oracle = serial_tree_reference(u, v, n, root=r)
        ref = ref_oracle(u, v, n, root=r)
        for eng in ("wylie", "splitter"):
            want_c = rt.tree_computations(want, rank_engine=eng)
            got_c = tt.tree_computations(got, rank_engine=eng,
                                         kernel_impl="torch")
            _eq(want_c.ranks, got_c.ranks)
            for k in FIELDS:
                _eq(getattr(want_c, k), getattr(got_c, k))
                np.testing.assert_array_equal(oracle[k], ref[k])
                np.testing.assert_array_equal(
                    getattr(got_c, k).numpy(), oracle[k], err_msg=k)


@pytest.mark.parametrize("n,trees,seed", [(40, 5, 0), (60, 3, 1), (7, 7, 2),
                                          (30, 1, 3)])
def test_padded_edge_buffer_matches_reference(n, trees, seed):
    F = 64
    e = rgraphs.random_tree_forest(n, trees, seed=seed)
    u, v = e[:, 0], e[:, 1]
    up, vp = np.zeros(F, np.int32), np.zeros(F, np.int32)
    up[:len(u)], vp[:len(v)] = u, v
    labels = rt.spanning_forest(u, v, n).labels
    want = rt.euler_tour(up, vp, n, labels=labels, num_edges=len(u))
    got = tt.euler_tour(up, vp, n, labels=labels, num_edges=len(u),
                        device="cpu")
    _same_tour(want, got)
    assert int(got.valid.sum()) == got.num_arcs == 2 * len(u)
    oracle = serial_tree_reference(u, v, n)
    for eng in ("wylie", "splitter"):
        got_c = tt.tree_computations(got, rank_engine=eng, kernel_impl="torch")
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(got_c, k).numpy(), oracle[k])
    np.testing.assert_array_equal(tt.tour_splitters(got),
                                  rt.tour_splitters(want))
    base = tt.tree_analytics(u, v, n, engine="dense", device="cpu")
    padded = tt.tree_analytics(u, v, n, engine="dense", pad_edges_to=F,
                               device="cpu")
    ref = rt.tree_analytics(u, v, n, engine="dense", pad_edges_to=F)
    for k in FIELDS:
        assert torch.equal(getattr(padded.computations, k),
                           getattr(base.computations, k))
        _eq(getattr(ref.computations, k), getattr(padded.computations, k))


@pytest.mark.parametrize("num_splitters,seed", [(None, 0), (3, 1), (50, 7)])
def test_tour_splitters_match_reference(num_splitters, seed):
    n = 500
    e = rgraphs.random_tree_forest(n, 40, seed=3)
    want = rt.euler_tour(e[:, 0], e[:, 1], n, pad_to=2048)
    got = tt.euler_tour(e[:, 0], e[:, 1], n, pad_to=2048, device="cpu")
    spl = tt.tour_splitters(got, num_splitters=num_splitters, seed=seed)
    np.testing.assert_array_equal(
        spl, rt.tour_splitters(want, num_splitters=num_splitters, seed=seed))
    assert len(spl) & (len(spl) - 1) == 0, "padded to a power of two"
    comp = tt.tree_computations(got, rank_engine="splitter",
                                num_splitters=num_splitters, seed=seed)
    ref = rt.tree_computations(want, rank_engine="splitter",
                               num_splitters=num_splitters, seed=seed)
    for k in FIELDS:
        _eq(getattr(ref, k), getattr(comp, k))


def _forest_cases():
    r = np.random.default_rng(11)
    return {
        "tree": (400, kiss.tree_graph(400, 3, seed=1)),
        "giant+dust": (500, kiss.giant_dust_graph(500, 0.9, seed=2)),
        "random": (300, kiss.random_graph(300, 0.02, seed=3)),
        "multigraph": (60, r.integers(0, 60, (500, 2)).astype(np.int32)),
        "empty": (9, np.zeros((0, 2), np.int32)),
    }


@pytest.mark.parametrize("engine", ["frontier", "dense"])
@pytest.mark.parametrize("case", sorted(_forest_cases()))
def test_spanning_forest_and_analytics_match_reference(case, engine):
    n, e = _forest_cases()[case]
    want = rt.spanning_forest(e[:, 0], e[:, 1], n, engine=engine)
    got = tt.spanning_forest(e[:, 0], e[:, 1], n, engine=engine, device="cpu")
    for k in ("labels", "edge_u", "edge_v"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)))
    assert got.rounds == want.rounds and got.num_trees == want.num_trees
    want_a = rt.tree_analytics(e[:, 0], e[:, 1], n, engine=engine,
                               rank_engine="splitter")
    got_a = tcore.tree_analytics(e[:, 0], e[:, 1], n, engine=engine,
                                 rank_engine="splitter", kernel_impl="torch",
                                 device="cpu")
    for k in FIELDS:
        _eq(getattr(want_a.computations, k), getattr(got_a.computations, k))


def _bench_smoke_counters(name):
    records = json.loads(
        (Path(__file__).resolve().parents[1] / "BENCH_smoke.json").read_text()
    )
    derived = next(r["derived"] for r in records if r["name"] == name)
    return {
        k: v for k, v in (kv.split("=") for kv in derived.split(";"))
        if not k.startswith("~")
    }


@pytest.mark.parametrize("family", ["one-tree", "path", "molecule-batch"])
def test_counters_match_bench_smoke(family):
    # benchmarks/tree_ops.py's families at its smoke size, n = 1000.
    n = 1000
    e = {
        "one-tree": lambda: tgraphs.random_tree(n, seed=1),
        "path": lambda: _path(n),
        "molecule-batch": lambda: tgraphs.random_tree_forest(n, n // 30,
                                                             seed=2),
    }[family]()
    forest = tt.spanning_forest(e[:, 0], e[:, 1], n, device="cpu")
    row = _bench_smoke_counters(f"tree_ops/forest/{family}/n={n}")
    assert int(row["trees"]) == forest.num_trees
    assert int(row["edges"]) == forest.num_edges
    tour = tt.euler_tour(forest.edge_u, forest.edge_v, n, labels=forest.labels,
                         pad_to=tt.tour_capacity(forest.num_edges),
                         device="cpu")
    row = _bench_smoke_counters(f"tree_ops/tour/{family}/n={n}")
    assert int(row["arcs"]) == tour.num_arcs
    assert int(row["capacity"]) == tour.capacity
    for engine in ("wylie", "splitter"):
        comp = tt.tree_computations(tour, rank_engine=engine,
                                    kernel_impl="torch")
        row = _bench_smoke_counters(f"tree_ops/compute/{family}/{engine}/n={n}")
        assert int(row["max_depth"]) == int(comp.depth.max())
        assert int(row["size_sum"]) == int(comp.subtree_size.sum())
        assert int(row["arcs"]) == tour.num_arcs


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 3), (257, 5), (20_000, 1)])
def test_random_tree_matches_reference(n, seed):
    np.testing.assert_array_equal(tgraphs.random_tree(n, seed=seed),
                                  rgraphs.random_tree(n, seed=seed))


@pytest.mark.parametrize("n,trees,seed", [(300, 12, 7), (1000, 33, 2),
                                          (10, 20, 4), (5, 1, 0)])
def test_random_tree_forest_matches_reference(n, trees, seed):
    np.testing.assert_array_equal(
        tgraphs.random_tree_forest(n, trees, seed=seed),
        rgraphs.random_tree_forest(n, trees, seed=seed))


def test_sorted_dispatch_matches_reference():
    r = np.random.default_rng(2)
    keys = r.integers(0, 6, 200).astype(np.int32)
    vals = r.standard_normal((200, 3)).astype(np.float32)
    want = rsd.sort_by_key(jnp.asarray(keys), jnp.asarray(vals))
    got = tsd.sort_by_key(torch.from_numpy(keys), torch.from_numpy(vals))
    for x, y in zip(want, got):
        _eq(x, y)
    for groups in (6, 4):
        for x, y in zip(rsd.grouped_offsets(want[0], groups),
                        tsd.grouped_offsets(got[0], groups)):
            _eq(x, y)
    _eq(rsd.position_in_group(jnp.asarray(keys), 6),
        tsd.position_in_group(torch.from_numpy(keys), 6))
    for x, y in zip(
        rsd.take_grouped(jnp.asarray(vals), jnp.asarray(keys), 6, 20,
                         fill_value=-1.0),
        tsd.take_grouped(torch.from_numpy(vals), torch.from_numpy(keys), 6,
                         20, fill_value=-1.0),
    ):
        _eq(x, y)


def test_dispatch_validation_and_no_launch_on_the_cpu():
    n = 60
    e = rgraphs.random_tree_forest(n, 4, seed=1)
    tour = tt.euler_tour(e[:, 0], e[:, 1], n, device="cpu")
    before = dict(launch_counts)
    tt.tree_computations(tour, rank_engine="splitter")
    assert launch_counts == before, "no launch for CPU tensors"
    with pytest.raises(ValueError, match="rank_engine"):
        tt.tour_ranks(tour, rank_engine="fastest")
    with pytest.raises(ValueError, match="kernel_impl"):
        tt.tree_computations(tour, kernel_impl="pallas")
    with pytest.raises(ValueError, match="pack_mode"):
        tt.tour_ranks(tour, pack_mode="word64")
    # mesh= reaches the sharded engines, as in the reference: a one-rank
    # gloo mesh against the reference's one-device mesh.
    from repro.distributed.graph import graph_mesh as ref_mesh
    from repro_torch.distributed import graph_mesh

    mesh, rmesh = graph_mesh(1, device="cpu"), ref_mesh(1)
    rtour = rt.euler_tour(e[:, 0], e[:, 1], n)
    _eq(rt.tour_ranks(rtour, mesh=rmesh, num_splitters=8),
        tt.tour_ranks(tour, mesh=mesh, num_splitters=8))
    with pytest.raises(ValueError, match="wylie_rank is single-device"):
        tt.tour_ranks(tour, mesh=mesh, rank_engine="wylie")
    want = rt.tree_analytics(e[:, 0], e[:, 1], n, mesh=rmesh)
    got = tcore.tree_analytics(e[:, 0], e[:, 1], n, mesh=mesh, device="cpu")
    for k in ("parent", "depth", "subtree_size"):
        _eq(getattr(want, k), getattr(got, k))
    _eq(want.computations.ranks, got.computations.ranks)
    assert tcore.serve_graphs([], mesh=mesh, device="cpu") == []
    with pytest.raises(ValueError, match="pad_to"):
        tt.euler_tour(e[:, 0], e[:, 1], n, pad_to=2, device="cpu")
    with pytest.raises(ValueError, match="num_edges"):
        tt.euler_tour(np.zeros(4, np.int32), np.zeros(4, np.int32), 5,
                      num_edges=5, device="cpu")
    with pytest.raises(ValueError, match="pad_edges_to"):
        tt.tree_analytics(e[:, 0], e[:, 1], n, pad_edges_to=1, device="cpu")
    with pytest.raises(ValueError, match="always records hooks"):
        tt.spanning_forest(e[:, 0], e[:, 1], n, record_hooks=False,
                           device="cpu")
    # The accessors and the core wrappers agree with the full computation.
    comp = tt.tree_computations(tour)
    for fn, k in ((tt.root_tree, "parent"), (tt.depths, "depth"),
                  (tt.subtree_sizes, "subtree_size"),
                  (tt.preorder, "preorder"), (tt.postorder, "postorder")):
        assert torch.equal(fn(tour), getattr(comp, k))
    assert torch.equal(tcore.root_tree(tour), comp.parent)
    t2 = tcore.euler_tour(e[:, 0], e[:, 1], n, device="cpu")
    assert torch.equal(t2.succ, tour.succ)
    assert tt.__all__ == rt.__all__
