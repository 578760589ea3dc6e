"""The port's wave-batched LM engine on the CPU against ``repro``'s: the
same weights and request streams through both ``ServeEngine``s, outputs
token for token, wave counters and health records equal, under the
overflow policies, zero budgets and injected faults."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.transformer import init_params as jax_init_params  # noqa: E402
from repro.serve import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.models.transformer.convert import params_from_jax  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    FAILURE_POLICIES,
    OVERFLOW_POLICIES,
    FaultPlan,
    Request,
    ServeEngine,
    SimulatedOOM,
    classify_failure,
    is_resource_exhausted,
)


@pytest.fixture(scope="module")
def model():
    """qwen3-4b's smoke config (float32) with the reference's weights in
    both packages."""
    jcfg = jax_get_arch("qwen3-4b").smoke_config
    cfg = get_arch("qwen3-4b").smoke_config
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _both(model, requests, **kw):
    """Run ``requests`` (uid, prompt, max_new_tokens) through both
    engines built with ``kw``; a ``fault_plan`` kwarg is a function of a
    package's ``FaultPlan`` class, called once per engine for a fresh
    plan. Returns (port engine, its results, reference engine, its
    results)."""
    jcfg, jparams, cfg, params = model
    plan = kw.pop("fault_plan", None)
    eng = ServeEngine(params, cfg, fault_plan=plan and plan(FaultPlan), **kw)
    jeng = JaxServeEngine(jparams, jcfg, fault_plan=plan and plan(JaxFaultPlan), **kw)
    for uid, prompt, new in requests:
        eng.submit(Request(uid=uid, prompt=list(prompt), max_new_tokens=new))
        jeng.submit(JaxRequest(uid=uid, prompt=list(prompt), max_new_tokens=new))
    return eng, eng.run(), jeng, jeng.run()


def _assert_same(eng, done, jeng, jdone):
    assert [r.uid for r in done] == [r.uid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.output == jr.output, r.uid
        assert (r.done, r.failed, r.truncated, r.prompt) == (
            jr.done, jr.failed, jr.truncated, jr.prompt)
        assert (r.error is None) == (jr.error is None)
    assert eng.waves == jeng.waves
    assert eng.num_slots == jeng.num_slots
    assert [vars(h) for h in eng.health_records] == [
        vars(h) for h in jeng.health_records]
    assert eng.metrics.snapshot() == jeng.metrics.snapshot()


def test_example_requests_token_for_token(model):
    """The requests of examples/serve_lm.py: 6 requests, 3 slots."""
    reqs = [(uid, [1 + uid, 2 + uid, 3], 8) for uid in range(6)]
    eng, done, jeng, jdone = _both(model, reqs, num_slots=3, max_len=64)
    _assert_same(eng, done, jeng, jdone)
    assert len(done) == 6 and eng.waves == 2
    assert all(r.done and len(r.output) == 8 for r in done)


def test_ragged_prompts_and_cache_end_token_for_token(model):
    reqs = [(0, [5, 9, 2, 7, 1], 30), (1, [3], 4), (2, [8, 8, 8], 2),
            (3, [4, 6], 64), (4, list(range(10, 22)), 5)]
    eng, done, jeng, jdone = _both(model, reqs, num_slots=2, max_len=16)
    _assert_same(eng, done, jeng, jdone)
    by_uid = {r.uid: r for r in done}
    assert len(by_uid[3].output) == 16 - 2 + 1  # the cache's last row used


def test_engine_equals_greedy_decode_by_forward(model):
    _, _, cfg, params = model
    eng = ServeEngine(params, cfg, num_slots=2, max_len=32)
    prompt = [3, 7, 11]
    eng.submit(Request(uid=0, prompt=list(prompt), max_new_tokens=5))
    out = eng.run()[0].output
    toks = list(prompt)
    for _ in range(5):
        logits = forward(params, cfg, np.asarray([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    assert out == toks[len(prompt):]


def test_overflow_error_truncate_and_zero_budget(model):
    jcfg, jparams, cfg, params = model
    assert OVERFLOW_POLICIES == ("error", "truncate")
    eng = ServeEngine(params, cfg, num_slots=2, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(uid=0, prompt=list(range(1, 10)), max_new_tokens=4))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(uid=1, prompt=[], max_new_tokens=4))
    with pytest.raises(ValueError, match="on_overflow"):
        ServeEngine(params, cfg, on_overflow="drop")
    assert eng.queue == []
    # Truncation, zero and one-token budgets, and a prompt of exactly
    # max_len, against the reference.
    reqs = [(0, list(range(1, 14)), 3), (1, [3, 7], 0), (2, [3, 7], 1),
            (3, list(range(1, 9)), 4)]
    eng, done, jeng, jdone = _both(model, reqs, num_slots=2, max_len=8,
                                   on_overflow="truncate")
    _assert_same(eng, done, jeng, jdone)
    by_uid = {r.uid: r for r in done}
    assert by_uid[0].truncated and by_uid[0].prompt == list(range(6, 14))
    assert by_uid[1].done and by_uid[1].output == []
    assert len(by_uid[2].output) == 1 and len(by_uid[3].output) == 1


@pytest.mark.parametrize("plan", [
    lambda P: P(oom_slots_at=4),                       # degrade 4 -> 2 slots
    lambda P: P(poison_uids=frozenset([2])),           # bisect one poison
    lambda P: P(transient_uids={1: 1}),                # one retry
    lambda P: P(poison_uids=frozenset([0, 3]), transient_uids={2: 1}),
], ids=["oom", "poison", "transient", "mixed"])
def test_fault_containment_health_matches_reference(model, plan):
    reqs = [(i, [i + 1, i + 2], 3) for i in range(4)]
    eng, done, jeng, jdone = _both(model, reqs, num_slots=4, max_len=32,
                                   fault_plan=plan)
    _assert_same(eng, done, jeng, jdone)
    assert len(done) == 4


def test_oom_halves_slots_and_keeps_outputs(model):
    """The reference's ``test_lm_engine_oom_halves_slots`` on the port."""
    _, _, cfg, params = model
    eng = ServeEngine(params, cfg, num_slots=4, max_len=32,
                      fault_plan=FaultPlan(oom_slots_at=4))
    solo = ServeEngine(params, cfg, num_slots=4, max_len=32)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=[i + 1, i + 2], max_new_tokens=3))
        solo.submit(Request(uid=i, prompt=[i + 1, i + 2], max_new_tokens=3))
    done = eng.run()
    assert eng.num_slots == 2
    assert len(done) == 4 and all(not r.failed for r in done)
    assert {r.uid: r.output for r in done} == {r.uid: r.output for r in solo.run()}
    assert eng.health_records[-1].degraded == 1


def test_quarantine_records_an_instant_trace_event(model):
    _, _, cfg, params = model
    eng = ServeEngine(params, cfg, num_slots=2, max_len=16,
                      fault_plan=FaultPlan(poison_uids=frozenset([1])))
    for i in range(2):
        eng.submit(Request(uid=i, prompt=[i + 1], max_new_tokens=2))
    trace.configure(trace="on")
    trace.reset()
    try:
        eng.run()
    finally:
        trace.configure(trace="off")
    events = trace.chrome_trace()["traceEvents"]
    marks = [e for e in events if e["ph"] == "i"]
    assert [e["name"] for e in marks] == ["serve.quarantine"]
    assert marks[0]["args"]["uid"] == 1 and marks[0]["args"]["failure"] == "poison"
    assert {"serve.run", "serve.wave", "serve.bisect"} <= {e["name"] for e in events}


def test_failure_policies_and_classification():
    assert FAILURE_POLICIES == ("quarantine", "raise")
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB (GPU 0; 79.10 GiB "
        "total capacity)")
    assert is_resource_exhausted(oom)
    assert classify_failure(oom) == "resource"
    assert classify_failure(SimulatedOOM("x")) == "resource"
    assert classify_failure(RuntimeError("CUDA error: an illegal memory access")) == "poison"


def test_on_failure_raise_restores_fail_fast(model):
    _, _, cfg, params = model
    eng = ServeEngine(params, cfg, num_slots=2, max_len=16, on_failure="raise",
                      fault_plan=FaultPlan(poison_uids=frozenset([0])))
    eng.submit(Request(uid=0, prompt=[1], max_new_tokens=2))
    with pytest.raises(RuntimeError, match="injected engine error"):
        eng.run()
    with pytest.raises(ValueError, match="on_failure"):
        ServeEngine(params, cfg, on_failure="ignore")


@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_moe_and_mla_engines_token_for_token(name):
    """The engine is generic over the cache: mixtral-smoke (MoE, an
    8-row window ring) and deepseek-smoke (MLA's compressed cache, dense
    then MoE layers) serve ragged prompts past the window token for token
    with the reference, at the published capacity factor (so a decode
    step's tokens compete for experts as the reference's do)."""
    jcfg = jax_get_arch(name).smoke_config
    cfg = get_arch(name).smoke_config
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    reqs = [(0, [5, 9, 2, 7, 1], 14), (1, [3], 4), (2, [8, 8, 8], 9),
            (3, list(range(10, 22)), 6), (4, [4, 6], 3)]
    eng, done, jeng, jdone = _both((jcfg, jparams, cfg, params), reqs,
                                   num_slots=3, max_len=24)
    _assert_same(eng, done, jeng, jdone)
    assert len(done) == 5 and eng.waves == 2
