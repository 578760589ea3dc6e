"""Fault containment of the port's graph serving on the CPU: quarantine
and bisection, bounded retry, graceful degradation and the dense
engines' real ``ConvergenceError`` sentinels under the deterministic
``FaultPlan`` harness, each survivor bit-exact against the port's solo
engines; ``FaultPlan.random`` and the chaos rounds equal to the
reference's."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import given, settings, st  # noqa: E402  (hypothesis or stubs)

from repro.serve import FaultPlan as RefFaultPlan  # noqa: E402
from repro_torch.core import ConvergenceError  # noqa: E402
from repro_torch.data.graphs import graph_request_stream  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    FaultPlan,
    GraphRequest,
    GraphServeEngine,
    InjectedEngineError,
)
from test_torch_serve_graph import (  # noqa: E402
    _assert_matches_solo,
    _assert_same_engine,
    _assert_same_results,
    _random_stream,
    _ref,
    _requests,
)

CPU = "cpu"


def _stream(k, seed=1, kind="cc"):
    return graph_request_stream(k, kind=kind, seed=seed)


def _engine(**kw):
    return GraphServeEngine(device=CPU, **kw)


def _served(stream, **kw):
    eng = _engine(**kw)
    for r in _requests(stream):
        eng.submit(r)
    return eng, eng.run()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 31, 40, 44])
def test_fault_plan_random_equals_reference(seed):
    kw = dict(p_poison=0.2, p_transient=0.2, max_transient=2, p_nonconverge=0.12)
    got = FaultPlan.random(seed, range(40), **kw)
    want = RefFaultPlan.random(seed, range(40), **kw)
    assert got.poison_uids == want.poison_uids
    assert got.transient_uids == want.transient_uids
    assert got.nonconverge_uids == want.nonconverge_uids
    assert got.poison_uids or got.transient_uids or got.nonconverge_uids
    again = FaultPlan.random(seed, range(40), **kw)
    assert dataclasses.asdict(again) == dataclasses.asdict(got)


def test_fault_plan_graph_checkpoints():
    plan = FaultPlan(oom_node_caps=frozenset([256]),
                     nonconverge_uids=frozenset([3]))
    plan.check_bucket(128)
    with pytest.raises(MemoryError, match="node_cap=256"):
        plan.check_bucket(256)
    reqs = _requests(_stream(4))
    assert plan.wants_nonconverge(reqs) and not plan.wants_nonconverge(reqs[:3])
    bad = plan.malform(reqs[0])
    assert int(bad.src[-1]) == bad.num_nodes + 7 == int(bad.dst[-1])


# ---------------------------------------------------------------------------
# poison bisection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,k,poison", [
    ("cc", 8, 3), ("cc", 8, 0), ("cc", 8, 7), ("cc", 5, 2), ("sssp", 8, 3),
    ("pagerank", 8, 5),
])
def test_poison_bisected_within_log_bound(kind, k, poison):
    stream = _stream(k, seed={"cc": 1, "sssp": 41, "pagerank": 51}[kind], kind=kind)
    eng, done = _served(stream, max_requests=k,
                        fault_plan=FaultPlan(poison_uids=frozenset([poison])))
    assert len(done) == k
    by_uid = {r.uid: r for r in done}
    bad = by_uid[poison]
    assert bad.failed and not bad.done and bad.result is None
    assert "InjectedEngineError" in bad.error
    for uid in set(range(k)) - {poison}:
        assert not by_uid[uid].failed
        _assert_matches_solo(by_uid[uid], stream[uid])
    h = eng.health_records[-1]
    assert h.wave_runs - 1 <= math.ceil(math.log2(k)) + 1
    assert h.quarantined == 1 and h.failed == 1 and h.completed == k - 1
    assert h.bisections == 1 and h.retried == 0 and h.degraded == 0
    assert all(w.stage == kind for w in eng.wave_records)


def test_two_poisons_both_isolated():
    k = 8
    stream = _stream(k, seed=3)
    eng, done = _served(stream, max_requests=k,
                        fault_plan=FaultPlan(poison_uids=frozenset([1, 6])))
    by_uid = {r.uid: r for r in done}
    assert len(done) == k and by_uid[1].failed and by_uid[6].failed
    for uid in set(range(k)) - {1, 6}:
        _assert_matches_solo(by_uid[uid], stream[uid])
    h = eng.health_records[-1]
    assert h.quarantined == 2 and h.bisections >= 2


def test_poison_in_singleton_wave_quarantines_directly():
    eng, done = _served(_stream(3, seed=5), max_requests=1,
                        fault_plan=FaultPlan(poison_uids=frozenset([1])))
    h = eng.health_records[-1]
    assert {r.uid for r in done if r.failed} == {1}
    assert h.bisections == 0 and h.wave_runs == 3


def test_on_failure_raise_restores_fail_fast():
    eng = _engine(max_requests=4, on_failure="raise",
                  fault_plan=FaultPlan(poison_uids=frozenset([2])))
    for r in _requests(_stream(4, seed=7)):
        eng.submit(r)
    with pytest.raises(InjectedEngineError):
        eng.run()


# ---------------------------------------------------------------------------
# transient retry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,seed,uid", [("cc", 9, 2), ("sssp", 43, 2),
                                           ("pagerank", 53, 1)])
def test_transient_fault_retried_in_place(kind, seed, uid):
    stream = _stream(4, seed=seed, kind=kind)
    eng, done = _served(stream, max_requests=4, max_retries=1,
                        fault_plan=FaultPlan(transient_uids={uid: 1}))
    assert all(not r.failed for r in done)
    for r in done:
        _assert_matches_solo(r, stream[r.uid])
    h = eng.health_records[-1]
    assert h.retried == 1 and h.quarantined == 0 and h.bisections == 0
    assert h.wave_runs == 2


def test_transient_beyond_retry_budget_is_quarantined():
    stream = _stream(1, seed=11)
    eng, done = _served(stream, max_requests=1, max_retries=1,
                        fault_plan=FaultPlan(transient_uids={0: 5}))
    assert done[0].failed and "TransientFault" in done[0].error
    assert eng.health_records[-1].retried == 1


# ---------------------------------------------------------------------------
# graceful degradation (simulated OOM)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,seed", [("cc", 13), ("sssp", 47), ("pagerank", 57)])
def test_oom_degrades_bucket_and_completes_everything(kind, seed):
    stream = _stream(8, seed=seed, kind=kind)
    node_cap, _ = _engine(max_requests=8)._wave_caps(_requests(stream))
    eng, done = _served(stream, max_requests=8,
                        fault_plan=FaultPlan(oom_node_caps=frozenset([node_cap])))
    assert len(done) == 8 and all(not r.failed for r in done)
    for r in done:
        _assert_matches_solo(r, stream[r.uid])
    h = eng.health_records[-1]
    assert h.degraded >= 1 and h.quarantined == 0
    assert eng._node_budget <= node_cap // 2
    assert all(w.node_cap < node_cap for w in eng.wave_records)


def test_oom_on_singleton_wave_quarantines():
    stream = _stream(1, seed=15)
    eng = _engine(max_requests=4)
    caps = eng._wave_caps(_requests(stream))
    eng.fault_plan = FaultPlan(oom_node_caps=frozenset([caps[0]]))
    eng.submit(_requests(stream)[0])
    done = eng.run()
    assert done[0].failed and "SimulatedOOM" in done[0].error
    assert eng.health_records[-1].degraded == 0


def test_card_out_of_memory_message_degrades():
    """A real ``torch.OutOfMemoryError`` ("CUDA out of memory") is
    resource-shaped: the wave degrades instead of quarantining."""
    from repro_torch.serve import classify_failure

    assert classify_failure(torch.OutOfMemoryError("CUDA out of memory.")) == (
        "resource")


# ---------------------------------------------------------------------------
# the dense engines' convergence sentinels
# ---------------------------------------------------------------------------


def test_zero_round_budget_raises_in_each_dense_engine():
    """``max_rounds=0`` -- what a non-convergence injection passes --
    raises the real ConvergenceError in dense SV, dense Bellman-Ford
    and dense PageRank."""
    from repro_torch.core import pagerank, shiloach_vishkin, shortest_paths

    src = np.arange(7, dtype=np.int32)
    dst = src + 1
    w = np.ones(7, np.float32)
    with pytest.raises(ConvergenceError, match="max_rounds"):
        shiloach_vishkin(src, dst, 8, max_rounds=0, dedup=False, device=CPU)
    with pytest.raises(ConvergenceError, match="max_rounds"):
        shortest_paths(src, dst, w, 8, sources=np.zeros(1, np.int32),
                       engine="dense", max_rounds=0, device=CPU)
    with pytest.raises(ConvergenceError, match="max_rounds"):
        pagerank(src, dst, w, 8, engine="dense", num_iters=98, max_rounds=0,
                 device=CPU)


@pytest.mark.parametrize("kind,seed", [("cc", 17), ("analytics", 19), ("sssp", 45),
                                       ("pagerank", 55)])
def test_nonconvergence_injection_fails_only_that_wave(kind, seed):
    stream = graph_request_stream(6, kind=kind, seed=seed,
                                  family="tree" if kind == "analytics" else "random")
    eng, done = _served(stream, max_requests=2,
                        fault_plan=FaultPlan(nonconverge_uids=frozenset([2])))
    by_uid = {r.uid: r for r in done}
    assert len(done) == 6
    assert by_uid[2].failed and "ConvergenceError" in by_uid[2].error
    assert "max_rounds" in by_uid[2].error
    for uid in set(range(6)) - {2}:
        assert not by_uid[uid].failed
        _assert_matches_solo(by_uid[uid], stream[uid])


# ---------------------------------------------------------------------------
# stale results, duplicate uids, malformed submits
# ---------------------------------------------------------------------------


def test_run_returns_only_new_results():
    reqs = _requests(_stream(4, seed=19))
    eng = _engine(max_requests=2)
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    assert {r.uid for r in eng.run()} == {0, 1}
    eng.submit(reqs[2])
    eng.submit(reqs[3])
    assert {r.uid for r in eng.run()} == {2, 3}
    assert eng.run() == []


def test_duplicate_uid_rejected():
    stream = _stream(2, seed=21)
    g = _engine()
    g.submit(GraphRequest(uid=0, **stream[0]))
    with pytest.raises(ValueError, match="in flight"):
        g.submit(GraphRequest(uid=0, **stream[1]))
    g.run()
    g.submit(GraphRequest(uid=0, **stream[1]))


def test_malformed_submit_rejected_before_any_wave():
    plan = FaultPlan(malformed_uids=frozenset([1]))
    eng = _engine(fault_plan=plan)
    for r in _requests(_stream(2, seed=23)):
        if r.uid in plan.malformed_uids:
            plan.malform(r)
            with pytest.raises(ValueError, match="endpoints"):
                eng.submit(r)
        else:
            eng.submit(r)
    assert {r.uid for r in eng.run()} == {0}
    assert eng.health_records[-1].wave_runs == 1


# ---------------------------------------------------------------------------
# the chaos property
# ---------------------------------------------------------------------------


def _chaos_round(num_requests, seed, width, kinds=("analytics",), reference=False):
    """Random stream x random FaultPlan: every request terminates exactly
    once and every survivor is bit-exact vs the port's solo engines;
    with ``reference``, the whole run also equals the reference's."""
    stream = _random_stream(num_requests, seed, kinds)

    def plan(cls):
        return cls.random(seed, range(num_requests), p_poison=0.25,
                          p_transient=0.25, max_transient=2, p_nonconverge=0.1)

    knobs = dict(max_requests=width, max_retries=2)
    eng, done = _served(stream, fault_plan=plan(FaultPlan), **knobs)
    assert sorted(req.uid for req in done) == list(range(num_requests))
    for req in done:
        assert req.done != req.failed
        if req.failed:
            assert req.error and req.result is None
        else:
            _assert_matches_solo(req, stream[req.uid])
    h = eng.health_records[-1]
    assert h.completed + h.failed == num_requests and h.failed == h.quarantined
    if reference:
        ref_eng, ref_done = _ref(stream, fault_plan=plan(RefFaultPlan), **knobs)
        _assert_same_results(ref_done, done)
        _assert_same_engine(ref_eng, eng)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 7), st.integers(0, 10_000), st.integers(1, 4))
def test_chaos_property_every_request_terminates_once(num_requests, seed, width):
    _chaos_round(num_requests, seed, width)


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 7), st.integers(0, 10_000), st.integers(1, 4))
def test_chaos_property_all_three_families(num_requests, seed, width):
    _chaos_round(num_requests, seed, width, kinds=("analytics", "sssp", "pagerank"))


@pytest.mark.parametrize("seed,kinds", [
    (0, ("analytics",)), (101, ("analytics",)), (202, ("analytics",)),
    (7, ("analytics", "sssp")), (303, ("analytics", "sssp")),
    (13, ("analytics", "sssp", "pagerank")), (404, ("analytics", "sssp", "pagerank")),
])
def test_chaos_deterministic_seeds_equal_reference(seed, kinds):
    """The reference's deterministic chaos rounds, held to the reference
    run for run: results, wave records and health counters."""
    _chaos_round(6, seed, 3, kinds=kinds, reference=True)
