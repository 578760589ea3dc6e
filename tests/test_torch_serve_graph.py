"""The port's wave-batched graph serving (``repro_torch.serve.graph``) on
the CPU against ``repro.serve.graph``: the same request streams through
both engines give equal results field by field, equal wave records,
bucket counts, pad waste, health records and metric snapshots; the
port's batched results equal its solo engine calls; and its counters
equal the ``graph_serve/*`` and ``serve_chaos/*`` rows of
``BENCH_smoke.json``. Every comparison is exact."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import given, settings, st  # noqa: E402  (hypothesis or stubs)

from repro.data.graphs import graph_request_stream as ref_stream  # noqa: E402
from repro.obs.metrics import Registry as RefRegistry  # noqa: E402
from repro.obs.metrics import derived_fragment as ref_fragment  # noqa: E402
from repro.serve import FaultPlan as RefFaultPlan  # noqa: E402
from repro.serve import GraphRequest as RefRequest  # noqa: E402
from repro.serve import GraphServeEngine as RefEngine  # noqa: E402
from repro_torch.core import (  # noqa: E402
    connected_components,
    num_components,
    pagerank,
    pagerank_iter_bound,
    serve_graphs,
    shortest_paths,
    spanning_forest,
    tree_analytics,
)
from repro_torch.core.serial import serial_pagerank  # noqa: E402
from repro_torch.data.graphs import graph_request_stream  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.obs.metrics import Registry, derived_fragment  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    KINDS,
    FaultPlan,
    GraphRequest,
    GraphResult,
    GraphServeEngine,
    WaveRecord,
)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("parent", "depth", "subtree_size", "preorder", "postorder")
CPU = "cpu"


def _requests(stream, cls=GraphRequest):
    return [cls(uid=i, **g) for i, g in enumerate(stream)]


def _port(stream, **kw):
    """Serve ``stream`` with the port on the CPU; returns (engine, done)."""
    eng = GraphServeEngine(device=CPU, **kw)
    for r in _requests(stream):
        eng.submit(r)
    return eng, eng.run()


def _ref(stream, **kw):
    eng = RefEngine(**kw)
    for r in _requests(stream, RefRequest):
        eng.submit(r)
    return eng, eng.run()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_results(ref_done, done):
    """Equal terminal states and GraphResults, field by field and dtype
    by dtype; failures carry the same error class."""
    assert [r.uid for r in done] == [r.uid for r in ref_done]
    for want, got in zip(ref_done, done):
        assert (got.done, got.failed) == (want.done, want.failed), got.uid
        assert (got.error is None) == (want.error is None)
        if want.error is not None:
            assert got.error.split(":")[0] == want.error.split(":")[0]
        if want.result is None:
            assert got.result is None
            continue
        for f in dataclasses.fields(GraphResult):
            w, g = getattr(want.result, f.name), getattr(got.result, f.name)
            if w is None:
                assert g is None, (got.uid, f.name)
            elif isinstance(w, np.ndarray):
                assert isinstance(g, np.ndarray), (got.uid, f.name)
                assert g.dtype == w.dtype, (got.uid, f.name, g.dtype, w.dtype)
                np.testing.assert_array_equal(g, w, err_msg=f"{got.uid} {f.name}")
            else:
                assert g == w, (got.uid, f.name)


def _assert_same_engine(ref_eng, eng):
    """Equal wave records, bucket counts, pad waste, health records and
    metric snapshots."""
    assert [dataclasses.asdict(r) for r in eng.wave_records] == [
        dataclasses.asdict(r) for r in ref_eng.wave_records
    ]
    assert eng.waves == ref_eng.waves
    assert eng.bucket_compiles == ref_eng.bucket_compiles
    assert eng.requests_per_wave == ref_eng.requests_per_wave
    assert eng.node_pad_waste == ref_eng.node_pad_waste
    assert eng.edge_pad_waste == ref_eng.edge_pad_waste
    assert [dataclasses.asdict(h) for h in eng.health_records] == [
        dataclasses.asdict(h) for h in ref_eng.health_records
    ]
    assert eng.metrics.snapshot() == ref_eng.metrics.snapshot()


def _assert_matches_solo(req, g, *, engine="dense", pagerank_iters=None,
                         damping=0.85):
    """The port's batched result == the port's engines on the request
    alone (the reference's ``_assert_matches_solo``, on the CPU)."""
    res = req.result
    assert req.done and res is not None
    if g["kind"] == "pagerank":
        iters = pagerank_iters if pagerank_iters is not None else pagerank_iter_bound()
        scores, _ = pagerank(g["src"], g["dst"], g.get("weights"), g["num_nodes"],
                             damping=damping, engine="dense", num_iters=iters,
                             device=CPU)
        np.testing.assert_array_equal(res.scores, _np(scores))
        assert res.labels is None and res.dist is None
        assert res.edge_u is None and res.parent is None
        return
    if g["kind"] == "sssp":
        sources = g.get("sources")
        if sources is None:
            sources = np.zeros(1, np.int32)
        sources = np.atleast_1d(np.asarray(sources, np.int32))
        dist, pred, _ = shortest_paths(g["src"], g["dst"], g.get("weights"),
                                       g["num_nodes"], sources=sources,
                                       engine="dense", device=CPU)
        np.testing.assert_array_equal(res.dist, _np(dist))
        np.testing.assert_array_equal(res.pred, _np(pred))
        np.testing.assert_array_equal(res.sources, sources)
        assert res.labels is None and res.edge_u is None
        return
    lab, _ = connected_components(g["src"], g["dst"], g["num_nodes"],
                                  engine=engine, dedup=False, device=CPU)
    np.testing.assert_array_equal(res.labels, _np(lab))
    assert res.num_components == num_components(lab)
    if g["kind"] == "cc":
        assert res.edge_u is None and res.parent is None
    if g["kind"] == "forest":
        assert res.parent is None
    if g["kind"] in ("forest", "analytics"):
        forest = spanning_forest(g["src"], g["dst"], g["num_nodes"], engine=engine,
                                 dedup=False, device=CPU)
        np.testing.assert_array_equal(res.edge_u, forest.edge_u)
        np.testing.assert_array_equal(res.edge_v, forest.edge_v)
    if g["kind"] == "analytics":
        ta = tree_analytics(g["src"], g["dst"], g["num_nodes"], engine=engine,
                            dedup=False, device=CPU)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(res, k),
                                          _np(getattr(ta.computations, k)),
                                          err_msg=f"{k} uid={req.uid}")


# ---------------------------------------------------------------------------
# the request stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("family", ["random", "tree"])
@pytest.mark.parametrize("kind", KINDS)
def test_graph_request_stream_equals_reference(kind, family, seed):
    got = graph_request_stream(9, kind=kind, family=family, seed=seed)
    want = ref_stream(9, kind=kind, family=family, seed=seed)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k
    with pytest.raises(ValueError, match="family"):
        graph_request_stream(2, family="grid")


# ---------------------------------------------------------------------------
# the port against the reference, stream by stream (each reference stream
# runs once, in a module-scoped fixture)
# ---------------------------------------------------------------------------


def _mixed_stream(make):
    """Mixed cc/forest/analytics requests (stage promotion), an
    empty-edge request and a one-node request, interleaved."""
    stream = (
        make(4, kind="cc", seed=1)
        + make(3, kind="forest", family="tree", seed=2)
        + make(4, kind="analytics", family="tree", seed=3)
    )
    z = np.zeros(0, np.int32)
    stream.append({"src": z, "dst": z, "num_nodes": 6, "kind": "analytics"})
    stream.append({"src": z, "dst": z, "num_nodes": 1, "kind": "cc"})
    np.random.default_rng(0).shuffle(stream)
    return stream


def _boundary_stream(make):
    """All three packing families, each boundary closing a wave."""
    return (
        make(1, kind="cc", seed=61)
        + make(1, kind="analytics", family="tree", seed=62)
        + make(2, kind="sssp", seed=63)
        + make(2, kind="pagerank", seed=64)
        + make(1, kind="cc", seed=65)
        + make(1, kind="pagerank", seed=66)
    )


# name -> (the stream, as a function of a package's graph_request_stream;
# the engine knobs; the fault plan, as a function of a package's FaultPlan
# class, or None)
SCENARIOS = {
    "mixed": (_mixed_stream, dict(max_requests=5), None),
    "boundary": (_boundary_stream, dict(max_requests=16), None),
    "cc_buckets": (lambda make: make(12, kind="cc", seed=5),
                   dict(max_requests=3), None),
    "analytics_solo": (lambda make: make(4, kind="analytics", family="tree",
                                         seed=7), dict(max_requests=1), None),
    "forest_frontier": (lambda make: make(5, kind="forest", seed=9),
                        dict(max_requests=4, engine="frontier", min_bucket=32),
                        None),
    "analytics_splitter": (lambda make: make(9, kind="analytics", family="tree",
                                             seed=13),
                           dict(max_requests=4, rank_engine="splitter"), None),
    "analytics_random": (lambda make: make(7, kind="analytics", seed=17),
                         dict(max_requests=3), None),
    "sssp": (lambda make: make(7, kind="sssp", seed=19), dict(max_requests=3),
             None),
    "sssp_frontier": (lambda make: make(5, kind="sssp", seed=21),
                      dict(max_requests=2, engine="frontier", min_bucket=32), None),
    "pagerank": (lambda make: make(6, kind="pagerank", seed=31),
                 dict(max_requests=3), None),
    "pagerank_iters": (lambda make: make(5, kind="pagerank", family="tree",
                                         seed=33),
                       dict(max_requests=2, pagerank_iters=7, damping=0.6), None),
    "chaos_cc": (lambda make: make(10, kind="cc", seed=23),
                 dict(max_requests=4, max_retries=2),
                 lambda cls: cls.random(5, range(10), p_poison=0.2,
                                        p_transient=0.2, max_transient=2,
                                        p_nonconverge=0.15)),
    "chaos_oom": (lambda make: make(8, kind="analytics", family="tree", seed=25),
                  dict(max_requests=8),
                  lambda cls: cls(oom_node_caps=frozenset([256]),
                                  nonconverge_uids=frozenset([6]))),
    "chaos_sssp": (lambda make: make(8, kind="sssp", seed=37),
                   dict(max_requests=8, max_retries=2),
                   lambda cls: cls.random(40, range(8), p_poison=0.2,
                                          p_transient=0.2, max_transient=2,
                                          p_nonconverge=0.12)),
    "chaos_pagerank": (lambda make: make(8, kind="pagerank", seed=43),
                       dict(max_requests=8, max_retries=2),
                       lambda cls: cls.random(44, range(8), p_poison=0.2,
                                              p_transient=0.2, max_transient=2,
                                              p_nonconverge=0.12)),
}


@pytest.fixture(scope="module")
def reference_runs():
    """Every scenario through the reference engine, once."""
    out = {}
    for name, (build, knobs, plan) in SCENARIOS.items():
        kw = dict(knobs)
        if plan is not None:
            kw["fault_plan"] = plan(RefFaultPlan)
        out[name] = _ref(build(ref_stream), **kw)
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_matches_reference(reference_runs, name):
    build, knobs, plan = SCENARIOS[name]
    kw = dict(knobs)
    if plan is not None:
        kw["fault_plan"] = plan(FaultPlan)
    stream = build(graph_request_stream)
    eng, done = _port(stream, **kw)
    ref_eng, ref_done = reference_runs[name]
    assert len(done) == len(stream)
    _assert_same_results(ref_done, done)
    _assert_same_engine(ref_eng, eng)
    for r in done:
        if r.done:
            _assert_matches_solo(r, stream[r.uid], engine=eng.engine,
                                 pagerank_iters=eng.pagerank_iters,
                                 damping=eng.damping)


# ---------------------------------------------------------------------------
# BENCH_smoke.json counters, exactly
# ---------------------------------------------------------------------------


def _bench_rows() -> dict:
    rows = json.loads((ROOT / "BENCH_smoke.json").read_text())
    return {r["name"]: r["derived"] for r in rows}


def _counters(derived: str) -> str:
    """A derived string without its wall-time entries (``~p10_us``...)."""
    return ";".join(p for p in derived.split(";") if not p.startswith("~"))


@pytest.mark.parametrize("kind,family", [
    ("cc", "random"), ("analytics", "tree"), ("pagerank", "random"),
])
def test_graph_serve_counters_equal_bench_smoke(kind, family):
    """``benchmarks/graph_serve.py``'s batched and solo rows at req=8."""
    rows = _bench_rows()
    stream = graph_request_stream(8, kind=kind, family=family, seed=11)
    eng, _ = _port(stream, max_requests=16)
    got = (f"waves={eng.waves};req_per_wave={eng.requests_per_wave:.2f};"
           f"compiles={eng.bucket_compiles};"
           f"node_waste={eng.node_pad_waste:.3f};"
           f"edge_waste={eng.edge_pad_waste:.3f};"
           + derived_fragment(eng.metrics.snapshot()))
    assert got == _counters(rows[f"graph_serve/batched/{kind}/{family}/req=8"])
    solo, _ = _port(stream, max_requests=1)
    assert (f"waves={solo.waves};compiles={solo.bucket_compiles}"
            == _counters(rows[f"graph_serve/solo/{kind}/{family}/req=8"]))


def test_graph_serve_splitter_counters_equal_bench_smoke():
    """The splitter lane's waves and bucket count. Its ``rank_compiles``
    (a jit-cache delta of the reference) has no torch meaning."""
    want = dict(p.split("=") for p in _counters(
        _bench_rows()["graph_serve/batched/analytics-splitter/tree/req=8"]
    ).split(";"))
    stream = graph_request_stream(8, kind="analytics", family="tree", seed=13)
    eng, done = _port(stream, max_requests=16, rank_engine="splitter")
    assert (eng.waves, eng.bucket_compiles) == (int(want["waves"]),
                                                int(want["compiles"]))
    for r in done:
        _assert_matches_solo(r, stream[r.uid])


def _chaos(stream, plan=None):
    """``benchmarks/serve_chaos.py``'s engine knobs."""
    return _port(stream, max_requests=8, fault_plan=plan, max_retries=2)[0]


def _health(eng, keys) -> str:
    h = dataclasses.asdict(eng.health_records[-1])
    return ";".join(f"{k}={h[k]}" for k in keys)


FULL = ("completed", "failed", "retried", "quarantined", "degraded",
        "bisections", "wave_runs")


def _faulty_cc_plan(cls, stream, make_request, probe):
    """The ``serve_chaos/faulty`` plan, built as the benchmark builds it:
    the seeded plan plus an OOM on the first wave's own bucket."""
    plan = cls.random(31, range(len(stream)), p_poison=0.08, p_transient=0.12,
                      max_transient=2, p_nonconverge=0.04)
    first_cap, _ = probe._wave_caps(
        [make_request(uid=i, **g) for i, g in enumerate(stream)][:8])
    return cls(poison_uids=plan.poison_uids, transient_uids=plan.transient_uids,
               nonconverge_uids=plan.nonconverge_uids,
               oom_node_caps=frozenset([first_cap]))


def test_serve_chaos_cc_counters_equal_bench_smoke():
    """``serve_chaos/clean/req=16`` and ``serve_chaos/faulty/req=16``:
    completed=12 failed=4 retried=3 quarantined=4 degraded=1
    bisections=4 wave_runs=22, and the whole metric fragment equal to
    the reference's, character for character."""
    rows = _bench_rows()
    stream = graph_request_stream(16, kind="cc", family="random", seed=29)
    clean = _chaos(stream)
    assert (_health(clean, ("completed", "failed", "wave_runs"))
            + f";waves={clean.waves}") == rows["serve_chaos/clean/req=16"]
    plan = _faulty_cc_plan(FaultPlan, stream, GraphRequest,
                           GraphServeEngine(max_requests=8, device=CPU))
    eng = _chaos(stream, plan)
    got = _health(eng, FULL) + ";" + derived_fragment(eng.metrics.snapshot())
    assert got == rows["serve_chaos/faulty/req=16"]
    assert got.startswith("completed=12;failed=4;retried=3;quarantined=4;"
                          "degraded=1;bisections=4;wave_runs=22;")
    ref_s = ref_stream(16, kind="cc", family="random", seed=29)
    ref_plan = _faulty_cc_plan(RefFaultPlan, ref_s, RefRequest,
                               RefEngine(max_requests=8))
    ref_eng, ref_done = _ref(ref_s, max_requests=8, fault_plan=ref_plan,
                             max_retries=2)
    assert derived_fragment(eng.metrics.snapshot()) == ref_fragment(
        ref_eng.metrics.snapshot())
    _assert_same_engine(ref_eng, eng)


@pytest.mark.parametrize("kind,seed,plan_seed,want", [
    ("sssp", 37, 40, "completed=5;failed=3;retried=2;quarantined=3;degraded=0;"
                     "bisections=3;wave_runs=14"),
    ("pagerank", 43, 44, "completed=5;failed=3;retried=3;quarantined=3;degraded=0;"
                         "bisections=3;wave_runs=15"),
])
def test_serve_chaos_weighted_counters_equal_bench_smoke(kind, seed, plan_seed, want):
    """``serve_chaos/{sssp,pagerank}_{clean,faulty}/req=8``: the
    non-convergence injections fire the dense engines' real
    ``ConvergenceError`` sentinels."""
    rows = _bench_rows()
    stream = graph_request_stream(8, kind=kind, family="random", seed=seed)
    clean = _chaos(stream)
    assert (_health(clean, ("completed", "failed", "wave_runs"))
            + f";waves={clean.waves}") == rows[f"serve_chaos/{kind}_clean/req=8"]
    plan = FaultPlan.random(plan_seed, range(8), p_poison=0.2, p_transient=0.2,
                            max_transient=2, p_nonconverge=0.12)
    eng = _chaos(stream, plan)
    assert _health(eng, FULL) == rows[f"serve_chaos/{kind}_faulty/req=8"] == want
    failed = {r.uid: r.error for r in eng.finished if r.failed}
    assert all(failed[u].startswith("ConvergenceError")
               for u in plan.nonconverge_uids if u not in plan.poison_uids)


# ---------------------------------------------------------------------------
# batched == solo in the port
# ---------------------------------------------------------------------------


def test_batched_bit_exact_vs_solo_mixed_kinds():
    stream = _mixed_stream(graph_request_stream)
    eng, done = _port(stream, max_requests=5)
    assert len(done) == len(stream) and eng.waves == 3
    for r in done:
        _assert_matches_solo(r, stream[r.uid])


def test_bucket_count_bounded_and_reused():
    """Same-bucket waves share one bucket: the count is the number of
    distinct (stage, node_cap, edge_cap), and each is new exactly once."""
    stream = graph_request_stream(12, kind="cc", seed=5)
    eng, _ = _port(stream, max_requests=3)
    assert eng.waves == 4
    assert eng.bucket_compiles == len(
        {(w.stage, w.node_cap, w.edge_cap) for w in eng.wave_records})
    assert sum(w.new_bucket for w in eng.wave_records) == eng.bucket_compiles
    assert eng.requests_per_wave == pytest.approx(3.0)
    assert 0.0 <= eng.node_pad_waste < 1.0 and 0.0 <= eng.edge_pad_waste < 1.0


def test_solo_wave_engine_is_identity_baseline():
    stream = graph_request_stream(4, kind="analytics", family="tree", seed=7)
    eng, done = _port(stream, max_requests=1)
    assert eng.waves == len(stream)
    assert all(w.requests == 1 for w in eng.wave_records)
    for r in done:
        _assert_matches_solo(r, stream[r.uid])


def test_serve_graphs_serves_every_kind():
    """``repro_torch.core.serve_graphs`` serves all five kinds, honours
    engine= (the frontier engine, still bit-exact), and launches no
    kernel for CPU tensors."""
    stream = []
    for i, kind in enumerate(KINDS):
        stream += graph_request_stream(2, kind=kind, seed=70 + i,
                                       family="tree" if kind == "analytics"
                                       else "random")
    before = dict(launch_counts)
    done = serve_graphs(_requests(stream), max_requests=4, engine="frontier",
                        device=CPU)
    assert launch_counts == before
    assert sorted(r.uid for r in done) == list(range(len(stream)))
    for r in done:
        _assert_matches_solo(r, stream[r.uid], engine="frontier")


def test_pagerank_batched_bit_exact_vs_solo_and_oracle():
    stream = graph_request_stream(6, kind="pagerank", seed=31)
    eng, done = _port(stream, max_requests=3)
    assert len(done) == 6 and eng.waves == 2
    assert all(w.stage == "pagerank" for w in eng.wave_records)
    assert all(w.rounds == eng.pagerank_iters for w in eng.wave_records)
    for r in done:
        g = stream[r.uid]
        _assert_matches_solo(r, g, pagerank_iters=eng.pagerank_iters)
        oracle = serial_pagerank(np.stack([g["src"], g["dst"]], axis=1),
                                 g["weights"], g["num_nodes"],
                                 num_iters=eng.pagerank_iters)
        np.testing.assert_array_equal(r.result.scores, oracle)


def test_three_way_family_boundary_fifo_stable():
    stream = _boundary_stream(graph_request_stream)
    eng, done = _port(stream, max_requests=16)
    assert len(done) == len(stream)
    assert [w.stage for w in eng.wave_records] == [
        "analytics", "sssp", "pagerank", "cc", "pagerank"]
    assert [w.requests for w in eng.wave_records] == [2, 2, 2, 1, 1]
    assert [r.uid for r in done] == list(range(len(stream)))
    for r in done:
        _assert_matches_solo(r, stream[r.uid], pagerank_iters=eng.pagerank_iters)
    by_uid = {r.uid: r for r in done}
    assert by_uid[0].result.scores is None and by_uid[0].result.dist is None
    assert by_uid[2].result.scores is None
    assert by_uid[4].result.labels is None


def test_sssp_wave_reads_back_only_each_requests_block():
    """The sssp unpack gathers each request's (sources, nodes) block on
    the device: pad rows (sources at a pad node) and other requests'
    columns never reach a result."""
    stream = graph_request_stream(5, kind="sssp", seed=47)
    eng, done = _port(stream, max_requests=5)
    (rec,) = eng.wave_records
    assert rec.src_cap > sum(len(g["sources"]) for g in stream)  # pad rows
    for r in done:
        g = stream[r.uid]
        assert r.result.dist.shape == (len(g["sources"]), g["num_nodes"])
        assert r.result.pred.shape == r.result.dist.shape
        _assert_matches_solo(r, g)


def _random_stream(num_requests, seed, kinds):
    r = np.random.default_rng(seed)
    stream = []
    for _ in range(num_requests):
        n = int(r.integers(1, 14))
        m = int(r.integers(0, 4 * n))
        g = {
            "src": r.integers(0, n, m).astype(np.int32),
            "dst": r.integers(0, n, m).astype(np.int32),
            "num_nodes": n,
            "kind": kinds[int(r.integers(0, len(kinds)))],
        }
        if g["kind"] in ("sssp", "pagerank"):
            g["weights"] = (r.integers(0, 8, m) / 4.0).astype(np.float32)
        if g["kind"] == "sssp":
            g["sources"] = r.integers(0, n, int(r.integers(1, 3))).astype(np.int32)
        stream.append(g)
    return stream


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 6), st.integers(0, 10_000), st.integers(1, 4))
def test_mixed_family_streams_bit_exact_property(num_requests, seed, width):
    stream = _random_stream(num_requests, seed, ("cc", "analytics", "sssp", "pagerank"))
    done = serve_graphs(_requests(stream), max_requests=width, device=CPU)
    assert sorted(req.uid for req in done) == list(range(num_requests))
    for req in done:
        _assert_matches_solo(req, stream[req.uid])


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 6), st.integers(0, 10_000), st.integers(1, 4))
def test_random_streams_bit_exact_property(num_requests, seed, width):
    stream = _random_stream(num_requests, seed, ("analytics",))
    done = serve_graphs(_requests(stream), max_requests=width, device=CPU)
    for req in done:
        _assert_matches_solo(req, stream[req.uid])


# ---------------------------------------------------------------------------
# validation, sharded options, the device
# ---------------------------------------------------------------------------


def _rejections(engine_cls, request_cls, **kw):
    """The messages each bad submit raises, in order (the reference's
    cases and the sssp ones); the queue stays empty."""
    z = np.zeros(0, np.int32)
    one, two = np.array([0], np.int32), np.array([1], np.int32)
    eng = engine_cls(max_nodes=64, max_edges=64, **kw)
    cases = [
        dict(uid=0, src=z, dst=z, num_nodes=3, kind="labels"),
        dict(uid=1, src=z, dst=z, num_nodes=0),
        dict(uid=2, src=z, dst=z, num_nodes=65),
        dict(uid=3, src=np.zeros(65, np.int32), dst=np.zeros(65, np.int32),
             num_nodes=4),
        dict(uid=4, src=one, dst=np.array([5], np.int32), num_nodes=4),
        dict(uid=6, src=one, dst=np.array([-1], np.int32), num_nodes=4),
        dict(uid=5, src=one, dst=z, num_nodes=4),
        dict(uid=7, src=z, dst=z, num_nodes=3, kind="pagerank",
             sources=np.zeros(1, np.int32)),
        dict(uid=8, src=one, dst=two, num_nodes=3, kind="pagerank",
             weights=np.array([-1.0], np.float32)),
        dict(uid=9, src=z, dst=z, num_nodes=3, kind="cc",
             weights=np.zeros(0, np.float32)),
        dict(uid=10, src=one, dst=two, num_nodes=3, kind="sssp",
             weights=np.array([np.inf], np.float32)),
        dict(uid=11, src=one, dst=two, num_nodes=3, kind="sssp",
             weights=np.array([1.0, 2.0], np.float32)),
        dict(uid=12, src=one, dst=two, num_nodes=3, kind="sssp",
             sources=np.zeros(9, np.int32)),
        dict(uid=13, src=one, dst=two, num_nodes=3, kind="sssp",
             sources=np.array([3], np.int32)),
        dict(uid=14, src=one, dst=two, num_nodes=3, kind="pagerank",
             weights=np.array([np.nan], np.float32)),
    ]
    msgs = []
    for case in cases:
        with pytest.raises(ValueError) as info:
            eng.submit(request_cls(**case))
        msgs.append(str(info.value))
    assert eng.queue == []
    return msgs


def test_submit_rejects_what_the_reference_rejects():
    got = _rejections(GraphServeEngine, GraphRequest, device=CPU)
    want = _rejections(RefEngine, RefRequest)
    assert got == want
    for text, msg in zip(["kind", "num_nodes", "budget", "budget", "endpoints",
                          "endpoints", "mismatch", "sssp-only", "finite",
                          "only consumed", "finite", "weights length", "sources",
                          "sources outside", "finite"], got):
        assert text in msg


@pytest.mark.parametrize("knobs,match", [
    (dict(sample_rounds=2), "sample_rounds"),
    (dict(dedup=True), "dedup"),
    (dict(record_hooks=True), "record_hooks"),
    (dict(engine="fastest"), "engine"),
    (dict(rank_engine="fastest"), "rank_engine"),
    (dict(kernel_impl="fastest"), "kernel_impl"),
    (dict(on_failure="ignore"), "on_failure"),
    (dict(pagerank_iters=0), "pagerank_iters"),
    (dict(damping=1.5), "damping"),
])
def test_engine_knob_validation(knobs, match):
    with pytest.raises(ValueError, match=match):
        GraphServeEngine(device=CPU, **knobs)
    with pytest.raises(ValueError, match=match):
        RefEngine(**knobs)


def test_knobs_the_weighted_kinds_cannot_take():
    z = np.zeros(0, np.int32)
    knobbed = GraphServeEngine(engine="frontier", min_bucket=32, device=CPU)
    with pytest.raises(ValueError, match="not pagerank engine knobs"):
        knobbed.submit(GraphRequest(uid=3, src=z, dst=z, num_nodes=3,
                                    kind="pagerank"))
    hooked = GraphServeEngine(hook_impl="torch", device=CPU)
    with pytest.raises(ValueError, match="not sssp engine knobs"):
        hooked.submit(GraphRequest(uid=4, src=z, dst=z, num_nodes=3, kind="sssp"))
    assert knobbed.queue == [] and hooked.queue == []


@pytest.mark.parametrize("knobs", [
    dict(mesh="graph_mesh(1)"), dict(engine="sharded_frontier"),
    dict(exchange="sparse"), dict(sparse_capacity=64), dict(axis="x"),
])
def test_sharded_options_raise_naming_item_11(knobs):
    """Each sharded option reaches the sharded engines, as in the
    reference: cc, forest and analytics waves give the reference's
    results and wave records (a one-rank gloo mesh against the
    reference's one-device mesh), and sssp and pagerank requests are
    rejected at ``submit`` by both engines."""
    from repro.distributed.graph import graph_mesh as ref_mesh
    from repro_torch.distributed import graph_mesh

    port_kw, ref_kw = dict(knobs), dict(knobs)
    if "mesh" in knobs:
        port_kw["mesh"], ref_kw["mesh"] = graph_mesh(1, device=CPU), ref_mesh(1)
    stream = _mixed_stream(graph_request_stream)
    ref_eng, ref_done = _ref(stream, **ref_kw)
    eng, done = _port(stream, **port_kw)
    assert eng.engine == ref_eng.engine
    _assert_same_results(ref_done, done)
    _assert_same_engine(ref_eng, eng)
    assert serve_graphs([], device=CPU, **port_kw) == []
    z = np.zeros(0, np.int32)
    for kind in ("sssp", "pagerank"):
        with pytest.raises(ValueError, match="drop mesh=|not .* engine knobs"):
            RefEngine(**ref_kw).submit(
                RefRequest(uid=0, src=z, dst=z, num_nodes=3, kind=kind))
        with pytest.raises(ValueError, match="drop mesh=|not .* engine knobs"):
            GraphServeEngine(device=CPU, **port_kw).submit(
                GraphRequest(uid=0, src=z, dst=z, num_nodes=3, kind=kind))


def test_the_card_is_the_default_and_never_falls_back(monkeypatch):
    """Without a card the engine raises; it never serves on the CPU
    unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphServeEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_graphs(_requests(graph_request_stream(1, kind="cc")))
    assert GraphServeEngine(device=CPU).device == torch.device("cpu")


def test_auto_resolves_to_dense():
    assert GraphServeEngine(device=CPU).engine == "dense"
    assert GraphServeEngine(engine="frontier", device=CPU).engine == "frontier"


def test_wave_record_publishes_under_the_reference_names():
    from repro.serve import WaveRecord as RefWaveRecord

    rec = dict(requests=3, stage="sssp", num_nodes=40, num_edges=61, node_cap=64,
               edge_cap=128, new_bucket=True, rounds=9, src_cap=4)
    reg, ref_reg = Registry(), RefRegistry()
    for _ in range(2):
        WaveRecord(**rec).publish(reg)
        RefWaveRecord(**rec).publish(ref_reg)
    assert reg.snapshot() == ref_reg.snapshot()
    assert reg.snapshot()["serve.graph.wave.requests"] == 6


# ---------------------------------------------------------------------------
# metrics: the histogram and the derived fragment
# ---------------------------------------------------------------------------


def test_histogram_and_derived_fragment_equal_reference():
    samples = [("a.hist", 3), ("a.hist", 1.25), ("b.count", 2), ("c.frac", 0.3333)]
    reg, ref_reg = Registry(), RefRegistry()
    for r in (reg, ref_reg):
        for name, v in samples:
            if name.endswith("hist"):
                r.observe(name, v)
            elif name.endswith("count"):
                r.inc(name, v)
            else:
                r.gauge(name, v)
    snap = reg.snapshot()
    assert snap == ref_reg.snapshot()
    assert snap["a.hist.count"] == 2 and snap["a.hist.min"] == 1.25
    assert snap["a.hist.max"] == 3 and snap["a.hist.sum"] == 4.25
    assert list(snap) == sorted(snap)
    shuffled = dict(reversed(list(snap.items())))
    for prefix in ("", "a.", "c"):
        assert derived_fragment(shuffled, prefix) == ref_fragment(snap, prefix)
    assert derived_fragment(snap) == ("a.hist.count=2;a.hist.max=3;a.hist.min=1.250;"
                                      "a.hist.sum=4.250;b.count=2;c.frac=0.333")
    with pytest.raises(ValueError, match="already a histogram"):
        reg.inc("a.hist")


def test_module_level_histogram():
    from repro_torch.obs import metrics

    metrics.reset()
    try:
        metrics.observe("x", 2)
        metrics.observe("x", 5)
        assert metrics.snapshot() == {"x.count": 2, "x.max": 5, "x.min": 2,
                                      "x.sum": 7}
    finally:
        metrics.reset()
