"""The port's SSSP engines against ``repro.core.sssp`` on the CPU, bit for
bit: distances, parents, rounds and ``SsspStats`` of the dense, frontier
and batched engines on the same inputs; the ``sssp_frontier/*`` rows of
``BENCH_smoke.json``; the port's serial oracles against the reference's;
and the validation and convergence sentinels."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_frontier import _adversarial_families  # noqa: E402

from repro.core import sssp as rs  # noqa: E402
from repro.core.components import ConvergenceError as RefConvergenceError  # noqa: E402
from repro.core import serial as rserial  # noqa: E402
from repro.ops import kiss  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SSSP_ENGINES,
    ConvergenceError,
    SsspStats,
    bellman_ford,
    frontier_bellman_ford,
    shortest_paths,
)
from repro_torch.core import serial as tserial  # noqa: E402
from repro_torch.obs.metrics import Registry  # noqa: E402


def _eighth_weights(edges, salt=0):
    """Weights in {0, 0.25, ..., 1.75}: zero weights tie on purpose."""
    r = np.random.default_rng(1000 + salt + len(edges))
    return (r.integers(0, 8, size=len(edges)) / 4.0).astype(np.float32)


def _same(want, got):
    """A reference result tuple equals the port's, stats included."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2])
    if len(want) > 3:
        assert dataclasses.asdict(got[3]) == dataclasses.asdict(want[3])


FAMILIES = _adversarial_families()


@pytest.mark.parametrize("engine", ["frontier", "dense"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engines_match_reference(family, engine):
    n, e = FAMILIES[family]
    w = _eighth_weights(e)
    kw = {"min_bucket": 64} if engine == "frontier" else {}
    want = rs.shortest_paths(e[:, 0], e[:, 1], w, n, engine=engine,
                             with_stats=True, **kw)
    got = shortest_paths(e[:, 0], e[:, 1], w, n, engine=engine,
                         with_stats=True, device="cpu", **kw)
    _same(want, got)


@pytest.mark.parametrize("family", ["random", "tree", "dense-multigraph"])
def test_batched_sources_match_reference_and_solo_runs(family):
    n, e = FAMILIES[family]
    w = _eighth_weights(e, salt=3)
    srcs = np.array([0, n // 2, n - 1, 0], np.int32)
    for engine in ("frontier", "dense"):
        want = rs.shortest_paths(e[:, 0], e[:, 1], w, n, sources=srcs,
                                 engine=engine, with_stats=True)
        got = shortest_paths(e[:, 0], e[:, 1], w, n, sources=srcs,
                             engine=engine, with_stats=True, device="cpu")
        _same(want, got)
        assert got[0].shape == (4, n)
        for row, s in enumerate(srcs):
            d, p, _ = shortest_paths(e[:, 0], e[:, 1], w, n, sources=int(s),
                                     engine=engine, device="cpu")
            assert torch.equal(got[0][row], d) and torch.equal(got[1][row], p)


def test_unit_weights_and_the_serial_oracles():
    n, e = FAMILIES["random"]
    w = _eighth_weights(e)
    for weights in (None, w):
        od, op = tserial.serial_dijkstra(e, weights, n, 3)
        bd, bp = tserial.serial_bellman_ford(e, weights, n, 3)
        rd, rp = rserial.serial_dijkstra(e, weights, n, 3)
        for x, y in ((od, rd), (op, rp), (bd, rd), (bp, rp)):
            np.testing.assert_array_equal(x, y)
        d, p, _ = shortest_paths(e[:, 0], e[:, 1], weights, n, sources=3,
                                 device="cpu")
        np.testing.assert_array_equal(d.numpy(), od)
        np.testing.assert_array_equal(p.numpy(), op)


def test_zero_weight_clique_takes_min_id_parents():
    n = 5
    a, b = np.triu_indices(n, k=1)
    edges = np.stack([a, b], axis=1).astype(np.int32)
    w = np.zeros(len(edges), np.float32)
    d, p, _ = shortest_paths(edges[:, 0], edges[:, 1], w, n, sources=2,
                             device="cpu")
    assert (d == 0).all() and p.tolist() == [1, 0, 2, 0, 0]


def _bench_smoke_counters(name):
    records = json.loads(
        (Path(__file__).resolve().parents[1] / "BENCH_smoke.json").read_text()
    )
    derived = next(r["derived"] for r in records if r["name"] == name)
    return {
        k: v for k, v in (kv.split("=") for kv in derived.split(";"))
        if not k.startswith("~")
    }


def _bench_families():
    # benchmarks/sssp_frontier.py's families at its smoke size, n = 4000.
    n = 4000
    star = np.stack([np.zeros(n - 1, np.int32),
                     np.arange(1, n, dtype=np.int32)], axis=1)
    return {
        "giant+dust": (1000, kiss.giant_dust_graph(1000, 0.9, seed=1)),
        "star": (n, star),
        "random": (n, kiss.random_graph(n, 2.0 / (n - 1), seed=2)),
        "chain": (512, kiss.list_graph(512, 1, seed=3)),
    }


def _bench_weights(edges):
    r = np.random.default_rng(100)
    return (r.integers(0, 8, size=len(edges)) / 4.0).astype(np.float32)


@pytest.mark.parametrize("family", ["giant+dust", "star", "random", "chain"])
def test_counters_match_bench_smoke(family):
    n, e = _bench_families()[family]
    w = _bench_weights(e)
    *_, fs = frontier_bellman_ford(e[:, 0], e[:, 1], w, n, min_bucket=64,
                                   with_stats=True, device="cpu")
    want = _bench_smoke_counters(f"sssp_frontier/frontier/{family}/n={n}")
    assert int(want["rounds"]) == fs.rounds
    assert int(want["relax_visits"]) == fs.relax_visits
    assert int(want["mask_visits"]) == fs.mask_visits
    assert int(want["levels"]) == len(fs.levels)
    *_, ds = bellman_ford(e[:, 0], e[:, 1], w, n, with_stats=True,
                          device="cpu")
    want = _bench_smoke_counters(f"sssp_frontier/dense/{family}/n={n}")
    assert int(want["rounds"]) == ds.rounds
    assert int(want["relax_visits"]) == ds.relax_visits
    assert int(want["m2"]) == ds.m2


def test_batched_counters_match_bench_smoke():
    n, e = _bench_families()["random"]
    *_, st = bellman_ford(e[:, 0], e[:, 1], _bench_weights(e), n,
                          sources=np.arange(4, dtype=np.int32),
                          with_stats=True, device="cpu")
    want = _bench_smoke_counters(f"sssp_frontier/batched/random/n={n}/S=4")
    assert int(want["rounds"]) == st.rounds == 28
    assert int(want["relax_visits"]) == st.relax_visits
    assert int(want["num_sources"]) == st.num_sources


def test_validation_and_convergence_sentinels():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 3], np.int32)
    assert SSSP_ENGINES == rs.SSSP_ENGINES
    with pytest.raises(TypeError, match="num_nodes"):
        shortest_paths(src, dst)
    with pytest.raises(ValueError, match="sssp_engine"):
        shortest_paths(src, dst, None, 4, engine="fastest", device="cpu")
    with pytest.raises(ValueError, match="negative weights"):
        shortest_paths(src, dst, np.array([1.0, -0.5, 1.0], np.float32), 4,
                       device="cpu")
    with pytest.raises(ValueError, match="NaN"):
        shortest_paths(src, dst, np.array([1.0, np.nan, 1.0], np.float32), 4,
                       device="cpu")
    with pytest.raises(ValueError, match="weights length"):
        shortest_paths(src, dst, np.ones(2, np.float32), 4, device="cpu")
    with pytest.raises(ValueError, match="sources outside"):
        shortest_paths(src, dst, None, 4, sources=[0, 4], device="cpu")
    with pytest.raises(ValueError, match="min_bucket"):
        shortest_paths(src, dst, None, 4, engine="dense", min_bucket=8,
                       device="cpu")
    for engine in ("frontier", "dense"):
        with pytest.raises(RefConvergenceError):
            rs.shortest_paths(src, dst, None, 4, engine=engine, max_rounds=2)
        with pytest.raises(ConvergenceError, match="max_rounds"):
            shortest_paths(src, dst, None, 4, engine=engine, max_rounds=2,
                           device="cpu")


def test_stats_publish_like_the_reference():
    n, e = _bench_families()["giant+dust"]
    w = _bench_weights(e)
    *_, want = rs.frontier_bellman_ford(e[:, 0], e[:, 1], w, n,
                                        min_bucket=64, with_stats=True)
    *_, got = frontier_bellman_ford(e[:, 0], e[:, 1], w, n, min_bucket=64,
                                    with_stats=True, device="cpu")
    from repro.obs.metrics import Registry as RefRegistry

    ref_reg, reg = RefRegistry(), Registry()
    want.publish(ref_reg)
    got.publish(reg)
    assert isinstance(got, SsspStats)
    assert reg.snapshot() == ref_reg.snapshot()
