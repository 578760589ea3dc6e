"""The port's PageRank, its ``ADD`` monoid and the plain version of the
``ordered_fold`` kernel against ``repro`` on the CPU, bit for bit: scores
and iteration counts of both engines against ``repro.core.pagerank`` and
the numpy oracle ``serial_pagerank`` (the reference's and the port's
copy), iteration for iteration; the ``pagerank/*`` rows of
``BENCH_smoke.json``; teleport vectors and the sentinels; and the
slot-order fold on duplicates, empty groups and one group."""
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import operators as ro  # noqa: E402
# The module, not the function of the same name that repro.core exports.
rp = importlib.import_module("repro.core.pagerank")
from repro.core.components import ConvergenceError as RefConvergenceError  # noqa: E402
from repro.core.serial import serial_pagerank as ref_serial_pagerank  # noqa: E402
from repro.obs.metrics import Registry as RefRegistry  # noqa: E402
from repro.ops import kiss  # noqa: E402
from repro_torch.core import (  # noqa: E402
    PAGERANK_ENGINES,
    ConvergenceError,
    pagerank,
    pagerank_iter_bound,
)
from repro_torch.core import operators as to  # noqa: E402
from repro_torch.core.serial import serial_pagerank  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.ordered_fold.ops import (  # noqa: E402
    fold_plan,
    ordered_fold_sorted,
)
from repro_torch.kernels.ordered_fold.ref import ordered_fold_ref  # noqa: E402
from repro_torch.obs.metrics import Registry  # noqa: E402


def _weights(edges, salt=0):
    r = np.random.default_rng(100 + salt)
    return (r.integers(0, 8, size=len(edges)) / 4.0).astype(np.float32)


def _star(n):
    return np.stack([np.zeros(n - 1, np.int32),
                     np.arange(1, n, dtype=np.int32)], axis=1)


def _families(n=4000):
    # benchmarks/pagerank.py's families at its smoke size, n = 4000.
    return {
        "giant+dust": (1000, kiss.giant_dust_graph(1000, 0.9, seed=1)),
        "star": (n, _star(n)),
        "random": (n, kiss.random_graph(n, 2.0 / (n - 1), seed=2)),
        "chain": (512, kiss.list_graph(512, 1, seed=3)),
    }


FAMILIES = _families()


def _bench_smoke_counters(name):
    records = json.loads(
        (Path(__file__).resolve().parents[1] / "BENCH_smoke.json").read_text()
    )
    derived = next(r["derived"] for r in records if r["name"] == name)
    return {
        k: v for k, v in (kv.split("=") for kv in derived.split(";"))
        if not k.startswith("~")
    }


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_both_engines_match_reference_and_bench_smoke(family):
    n, e = FAMILIES[family]
    w = _weights(e)
    for engine in ("frontier", "dense"):
        want, want_it, want_st = rp.pagerank(e[:, 0], e[:, 1], w, n,
                                             engine=engine, with_stats=True)
        got, it, st = pagerank(e[:, 0], e[:, 1], w, n, engine=engine,
                               with_stats=True, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert it == int(want_it) == st.iterations
        assert st.edges_touched == want_st.edges_touched
        assert st.levels == want_st.levels
        row = _bench_smoke_counters(f"pagerank/{engine}/{family}/n={n}")
        assert int(row["iters"]) == it
        assert int(row["edges_touched"]) == st.edges_touched
        if engine == "frontier":
            assert int(row["m2"]) == st.m2
            assert int(row["iter_bound"]) == pagerank_iter_bound()


def test_parity_row_of_bench_smoke():
    # benchmarks/pagerank.py's parity record: the random family with the
    # salt-1 weights.
    n, e = FAMILIES["random"]
    w = _weights(e, salt=1)
    got_f, k = pagerank(e[:, 0], e[:, 1], w, n, engine="frontier",
                        device="cpu")
    got_d, _ = pagerank(e[:, 0], e[:, 1], w, n, engine="dense", num_iters=k,
                        device="cpu")
    oracle = serial_pagerank(e, w, n, num_iters=k)
    row = _bench_smoke_counters(f"pagerank/parity/random/n={n}")
    assert int(row["iters"]) == k == 39
    assert int(row["dense_match"]) == int(torch.equal(got_f, got_d)) == 1
    assert int(row["oracle_match"]) == int(
        np.array_equal(got_f.numpy(), oracle)) == 1


@pytest.mark.parametrize("family", ["star", "giant+dust"])
def test_every_iteration_equals_both_oracles(family):
    n, e = FAMILIES[family]
    w = _weights(e, salt=2)
    for k in (0, 1, 2, 5, 17):
        got, it = pagerank(e[:, 0], e[:, 1], w, n, engine="dense",
                           num_iters=k, device="cpu")
        assert it == k
        want = serial_pagerank(e, w, n, num_iters=k)
        np.testing.assert_array_equal(want, ref_serial_pagerank(e, w, n,
                                                                num_iters=k))
        np.testing.assert_array_equal(got.numpy(), want)
        ref, _ = rp.pagerank(e[:, 0], e[:, 1], w, n, engine="dense",
                             num_iters=k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_teleport_damping_and_edge_cases_match_reference():
    n, e = FAMILIES["chain"]
    r = np.random.default_rng(5)
    tele = r.random(n).astype(np.float32)
    tele[::7] = 0.0
    for kw in (dict(teleport=tele), dict(damping=0.5, tol=1e-4),
               dict(weights_none=True)):
        kw = dict(kw)
        w = None if kw.pop("weights_none", False) else _weights(e)
        want, want_it = rp.pagerank(e[:, 0], e[:, 1], w, n, **kw)
        got, it = pagerank(e[:, 0], e[:, 1], w, n, device="cpu", **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert it == int(want_it)
    cases = [
        (np.zeros(0, np.int32), np.zeros(0, np.int32), None, 1),
        (np.zeros(0, np.int32), np.zeros(0, np.int32), None, 5),
        (np.array([0, 0, 0], np.int32), np.array([1, 1, 1], np.int32), None, 3),
        (np.array([0, 1], np.int32), np.array([1, 2], np.int32),
         np.array([0.0, 0.0], np.float32), 3),
        (np.array([0, 1, 2, 0], np.int32), np.array([1, 2, 0, 0], np.int32),
         np.array([0.5, 1.5, 0.25, 1.0], np.float32), 4),
    ]
    for src, dst, w, n in cases:
        got, k = pagerank(src, dst, w, n, engine="frontier", device="cpu")
        want, want_k = rp.pagerank(src, dst, w, n, engine="frontier")
        assert k == int(want_k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(),
            serial_pagerank(np.stack([src, dst], axis=1), w, n, num_iters=k))


def test_validation_and_sentinels():
    src = np.array([0, 1], np.int32)
    dst = np.array([1, 2], np.int32)
    assert PAGERANK_ENGINES == rp.PAGERANK_ENGINES
    with pytest.raises(TypeError, match="num_nodes"):
        pagerank(src, dst)
    with pytest.raises(ValueError, match="pagerank_engine"):
        pagerank(src, dst, None, 3, engine="fastest", device="cpu")
    with pytest.raises(ValueError, match="finite"):
        pagerank(src, dst, np.array([1.0, np.inf], np.float32), 3, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        pagerank(src, dst, np.array([1.0, -1.0], np.float32), 3, device="cpu")
    with pytest.raises(ValueError, match="teleport"):
        pagerank(src, dst, None, 3, teleport=np.ones(2, np.float32),
                 device="cpu")
    with pytest.raises(ValueError, match="damping"):
        pagerank_iter_bound(damping=1.0)
    with pytest.raises(ValueError, match="num_iters"):
        pagerank(src, dst, None, 3, engine="frontier", num_iters=5,
                 device="cpu")
    with pytest.raises(ConvergenceError, match="iteration bound"):
        pagerank(src, dst, None, 3, engine="frontier", max_rounds=1,
                 device="cpu")
    with pytest.raises(RefConvergenceError, match="iteration bound"):
        rp.pagerank(src, dst, None, 3, engine="frontier", max_rounds=1)
    with pytest.raises(ConvergenceError, match="iteration budget"):
        pagerank(src, dst, None, 3, engine="dense", max_rounds=0, device="cpu")
    got, k = pagerank(src, dst, None, 3, engine="dense", num_iters=200,
                      max_rounds=150, device="cpu")
    assert k == 150
    _, _, st = pagerank(src, dst, None, 3, with_stats=True, device="cpu")
    _, _, want = rp.pagerank(src, dst, None, 3, with_stats=True)
    ref_reg, reg = RefRegistry(), Registry()
    want.publish(ref_reg)
    st.publish(reg)
    assert reg.snapshot() == ref_reg.snapshot()


def test_add_advance_folds_like_the_reference():
    r = np.random.default_rng(3)
    n, m = 50, 700
    idx = r.integers(0, n, m).astype(np.int32)
    idx[:40] = 7  # a hub
    vals = (r.standard_normal(m) * 10.0 ** r.integers(-4, 4, m)).astype(np.float32)
    base = r.standard_normal(n).astype(np.float32)
    want = ro.advance(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(vals),
                      monoid=ro.ADD)
    oracle = base.copy()
    np.add.at(oracle, idx, vals)
    np.testing.assert_array_equal(np.asarray(want), oracle)
    got = to.advance(torch.from_numpy(base), torch.from_numpy(idx),
                     torch.from_numpy(vals), monoid=to.ADD)
    np.testing.assert_array_equal(got.numpy(), oracle)
    # A plan built once serves as the index; (S, n) rows fold row by row.
    plan = fold_plan(torch.from_numpy(idx), n)
    rows = np.stack([vals, vals[::-1].copy()])
    got2 = to.advance(torch.from_numpy(np.stack([base, base])), plan,
                      torch.from_numpy(rows), monoid=to.ADD)
    want2 = ro.advance(jnp.asarray(np.stack([base, base])), jnp.asarray(idx),
                       jnp.asarray(rows), monoid=ro.ADD)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    assert to.ADD.identity == ro.ADD.identity == 0.0


def test_ordered_fold_plain_version_on_empty_and_single_groups():
    before = dict(launch_counts)
    # Empty groups between full ones, ids out of range dropped.
    idx = torch.tensor([3, 3, 0, 9, -1, 3, 5], dtype=torch.int32)
    vals = torch.tensor([1e8, 1.0, 2.0, 4.0, 8.0, -1e8, 0.5])
    base = torch.tensor([0.25, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    plan = fold_plan(idx, 7)
    # Sorted ids: -1, 0, 3, 3, 3, 5, 9; the -1 and the 9 lie in no group.
    assert plan.row_ptr.tolist() == [1, 2, 2, 2, 5, 5, 6, 6]
    got = ordered_fold_sorted(base, plan.row_ptr, plan.perm, vals)
    want = base.numpy().copy()
    np.add.at(want, [3, 3, 0, 3, 5], np.float32([1e8, 1.0, 2.0, -1e8, 0.5]))
    np.testing.assert_array_equal(got.numpy(), want)
    # Slot order: (((3 + 1e8) + 1) - 1e8) loses the 3 and the 1 in float32.
    assert got[3].item() == 0.0
    # One group owning every slot.
    r = np.random.default_rng(0)
    v = r.standard_normal(5000).astype(np.float32)
    plan = fold_plan(torch.zeros(5000, dtype=torch.int32), 1)
    got = ordered_fold_ref(torch.zeros(1), plan.row_ptr, plan.perm,
                           torch.from_numpy(v))
    want = np.zeros(1, np.float32)
    np.add.at(want, np.zeros(5000, np.int64), v)
    np.testing.assert_array_equal(got.numpy(), want)
    # No slots, no groups.
    empty = torch.zeros(0, dtype=torch.int32)
    plan = fold_plan(empty, 4)
    assert plan.row_ptr.tolist() == [0] * 5
    got = ordered_fold_sorted(base[:4], plan.row_ptr, plan.perm,
                              torch.zeros(0))
    assert torch.equal(got, base[:4])
    plan = fold_plan(empty, 0)
    assert ordered_fold_sorted(torch.zeros(0), plan.row_ptr, plan.perm,
                               torch.zeros(0)).numel() == 0
    assert launch_counts == before, "no launch for CPU tensors"
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ordered_fold_sorted(base, plan.row_ptr, plan.perm, vals, impl="cuda")


def test_compact_weighted_matches_reference():
    r = np.random.default_rng(4)
    m = 300
    a = r.integers(0, 40, m).astype(np.int32)
    b = r.integers(0, 40, m).astype(np.int32)
    w = r.random(m).astype(np.float32)
    mask = r.random(m) < 0.3
    size = to.bucket_size(int(mask.sum()), min_bucket=16)
    want = ro.compact_weighted(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
                               jnp.asarray(mask), size=size)
    got = to.compact_weighted(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(w), torch.from_numpy(mask),
                              size=size)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
