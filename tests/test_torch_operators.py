"""The port's operator layer and tracing against ``repro`` on the CPU:
the filter primitives, the MIN advance, the host drivers, and the span
names and counters the engines publish."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import frontier as rf  # noqa: E402
from repro.core import operators as ro  # noqa: E402
from repro.obs.metrics import Registry as RefRegistry  # noqa: E402
from repro.ops import kiss  # noqa: E402
from repro_torch.core import operators as to  # noqa: E402
from repro_torch.core.components import ConvergenceError, shiloach_vishkin  # noqa: E402
from repro_torch.core.frontier import frontier_shiloach_vishkin  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.metrics import Registry  # noqa: E402


def test_bucket_helpers_match_reference():
    for x in (-3, 0, 1, 2, 3, 5, 1023, 1024, 1025, 1 << 30):
        assert to.next_pow2(x) == ro.next_pow2(x)
        for cap in (None, 100, 1 << 20):
            assert to.bucket_size(x, min_bucket=64, cap=cap) == ro.bucket_size(
                x, min_bucket=64, cap=cap
            )


@pytest.mark.parametrize("m,size,p_live", [(500, 512, 0.3), (500, 64, 0.3),
                                           (500, 16, 0.0), (1, 8, 1.0)])
def test_compact_frontier_matches_reference(m, size, p_live):
    r = np.random.default_rng(m + size)
    a = r.integers(0, 100, m).astype(np.int32)
    b = r.integers(0, 100, m).astype(np.int32)
    mask = r.random(m) < p_live
    want = ro.compact_frontier(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), size=size
    )
    got = to.compact_frontier(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mask),
        size=size,
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rows", [None, 3])
def test_min_advance_matches_reference(rows):
    r = np.random.default_rng(7)
    n, m = 30, 200
    shape = (n,) if rows is None else (rows, n)
    target = r.random(shape).astype(np.float32)
    index = r.integers(0, n, m).astype(np.int32)
    values = r.random(shape[:-1] + (m,)).astype(np.float32)
    want = ro.advance(
        jnp.asarray(target), jnp.asarray(index), jnp.asarray(values),
        monoid=ro.MIN,
    )
    got = to.advance(
        torch.from_numpy(target), torch.from_numpy(index),
        torch.from_numpy(values), monoid=to.MIN,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert to.compute(lambda x, y: x + y, got, got).shape == got.shape
    assert to.MIN.identity == ro.MIN.identity


def test_host_drivers_raise_before_wrong_results_escape():
    with pytest.raises(ConvergenceError):
        to.run_bucket_ladder(
            bucket=64, min_bucket=64, run_level=lambda b, s: (False, True),
            live_count=lambda: 0, compact=lambda size: None,
        )
    lives = iter([5, 3, 0])
    assert to.run_rebuild_loop(
        bound=10, live_count=lambda: next(lives), run_level=lambda live: None
    ) == 2
    with pytest.raises(ConvergenceError, match="round bound"):
        to.run_rebuild_loop(
            bound=1, live_count=lambda: 4, run_level=lambda live: None
        )


def test_ladder_shrinks_like_the_reference():
    calls = {}
    for mod in (ro, to):
        log = []
        state = {"live": 900}

        def run_level(bucket, shrink_at, log=log, state=state):
            log.append(("level", bucket, shrink_at))
            state["live"] //= 3
            return state["live"] < 10, False

        mod.run_bucket_ladder(
            bucket=1024, min_bucket=16, run_level=run_level,
            live_count=lambda state=state: state["live"],
            compact=lambda size, log=log: log.append(("compact", size)),
        )
        calls[mod.__name__] = log
    assert calls["repro_torch.core.operators"] == calls["repro.core.operators"]


def test_engines_trace_their_spans():
    e = kiss.random_graph(200, 0.09, seed=1)
    trace.configure(trace="on")
    trace.reset()
    try:
        frontier_shiloach_vishkin(
            e[:, 0], e[:, 1], 200, sample_rounds=2, min_bucket=64,
            device="cpu",
        )
        shiloach_vishkin(e[:, 0], e[:, 1], 200, device="cpu")
        names = {ev["name"] for ev in trace.chrome_trace()["traceEvents"]}
    finally:
        trace.configure(trace="off")
        trace.reset()
    assert {"cc.frontier", "cc.frontier.level", "cc.frontier.sample",
            "cc.dense"} <= names
    with pytest.raises(ValueError, match="unknown trace 'loud'"):
        trace.configure(trace="loud")


def test_frontier_stats_publish_like_the_reference():
    e = kiss.giant_dust_graph(1000, seed=2)
    *_, want = rf.frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], 1000, with_stats=True, min_bucket=64
    )
    *_, got = frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], 1000, with_stats=True, min_bucket=64, device="cpu"
    )
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ref_reg, reg = RefRegistry(), Registry()
    want.publish(ref_reg)
    got.publish(reg)
    assert reg.snapshot() == ref_reg.snapshot()
