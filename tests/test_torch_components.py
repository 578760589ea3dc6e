"""The port's dense and frontier connected components against ``repro``
on the CPU: labels, rounds, recorded hook forests and ``FrontierStats``
bit for bit (the reference with ``hook_impl="xla"``, whose frontier mask
and counters the port's sv3 kernel reproduces)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import components as rc  # noqa: E402
from repro.core import frontier as rf  # noqa: E402
from repro.ops import kiss  # noqa: E402
from repro_torch.core import components as tc  # noqa: E402
from repro_torch.core import frontier as tf  # noqa: E402
from repro_torch.core.serial import (  # noqa: E402
    canonicalize_labels,
    serial_connected_components,
)


def _graphs():
    dup = np.array([[0, 1], [1, 0], [0, 1], [2, 2], [3, 4], [4, 3]], np.int32)
    return {
        "chain": (kiss.list_graph(600, 1, seed=1), 600),
        "giant_dust": (kiss.giant_dust_graph(1500, seed=0), 1500),
        "forest": (kiss.random_forest(1200, 9, seed=2), 1200),
        "random": (kiss.random_graph(400, 0.01, seed=3), 400),
        "empty": (np.zeros((0, 2), np.int32), 7),
        "duplicates": (dup, 6),
        "single_node": (np.zeros((0, 2), np.int32), 1),
    }


GRAPHS = _graphs()


def _eq(jax_arr, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(jax_arr))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dense_matches_reference(name):
    e, n = GRAPHS[name]
    want_l, want_r, want_h = rc.shiloach_vishkin(
        e[:, 0], e[:, 1], n, record_hooks=True
    )
    got_l, got_r, got_h = tc.shiloach_vishkin(
        e[:, 0], e[:, 1], n, record_hooks=True, device="cpu"
    )
    _eq(want_l, got_l)
    assert got_r == int(want_r)
    _eq(want_h[0], got_h[0])
    _eq(want_h[1], got_h[1])
    np.testing.assert_array_equal(
        canonicalize_labels(got_l.numpy()), serial_connected_components(e, n)
    )


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_frontier_matches_reference(name):
    e, n = GRAPHS[name]
    want = rf.frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], n, record_hooks=True, with_stats=True,
        min_bucket=64, hook_impl="xla",
    )
    got = tf.frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], n, record_hooks=True, with_stats=True,
        min_bucket=64, device="cpu",
    )
    _eq(want[0], got[0])
    assert got[1] == int(want[1])
    _eq(want[2][0], got[2][0])
    _eq(want[2][1], got[2][1])
    assert dataclasses.asdict(got[3]) == dataclasses.asdict(want[3])


def test_frontier_without_dedup_matches_reference():
    e, n = GRAPHS["duplicates"]
    want = rf.frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], n, dedup=False, with_stats=True, min_bucket=2
    )
    got = tf.frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], n, dedup=False, with_stats=True, min_bucket=2,
        device="cpu",
    )
    _eq(want[0], got[0])
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])


@pytest.mark.parametrize("seed", [0, 5])
def test_afforest_sampling_matches_reference(seed):
    # m/n >= 8: the density at which the dispatch turns sampling on. The
    # (n, k) sample table is where duplicate writes resolve last-wins.
    n = 300
    e = kiss.random_graph(n, 0.06, seed=seed)
    assert len(e) / n >= 8
    want = rf.frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], n, sample_rounds=2, seed=seed, min_bucket=64,
        record_hooks=True, with_stats=True,
    )
    got = tf.frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], n, sample_rounds=2, seed=seed, min_bucket=64,
        record_hooks=True, with_stats=True, device="cpu",
    )
    _eq(want[0], got[0])
    assert got[1] == int(want[1])
    _eq(want[2][0], got[2][0])
    _eq(want[2][1], got[2][1])
    ws, gs = dataclasses.asdict(want[3]), dataclasses.asdict(got[3])
    # The reference's float32 quotient is rounded by XLA's CPU backend
    # one unit in the last place away from torch's (a gauge, not a count).
    assert gs.pop("largest_component_frac") == pytest.approx(
        ws.pop("largest_component_frac"), rel=1e-6
    )
    assert gs == ws


def test_sample_table_keeps_the_last_write():
    a = torch.tensor([0, 0, 0, 1, 1], dtype=torch.int32)
    b = torch.tensor([5, 6, 7, 8, 9], dtype=torch.int32)
    perm = torch.tensor([4, 0, 2, 1, 3])
    tbl = tf._build_samples(a, b, perm, n=3, k=2)
    # writes in order: (1,0)<-9 (0,1)<-5 (0,0)<-7 (0,1)<-6 (1,0)<-8
    np.testing.assert_array_equal(tbl.numpy(), [[7, 6], [8, -1], [-1, -1]])
    want = rf._build_samples(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
        jnp.asarray(perm.numpy().astype(np.int32)), n=3, k=2,
    )
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(want))


@pytest.mark.parametrize("engine", ["dense", "frontier"])
def test_too_few_rounds_raise(engine):
    e, n = GRAPHS["chain"]
    fn = tc.shiloach_vishkin if engine == "dense" else tf.frontier_shiloach_vishkin
    with pytest.raises(tc.ConvergenceError):
        fn(e[:, 0], e[:, 1], n, max_rounds=2, device="cpu")


_CC_ENTRY_POINTS = {
    "dense": tc.shiloach_vishkin,
    "frontier": tf.frontier_shiloach_vishkin,
    "afforest": lambda *a, **k: tf.frontier_shiloach_vishkin(
        *a, sample_rounds=2, **k),
    "propagation": tc.label_propagation,
}


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("bad", [-1, 6])
@pytest.mark.parametrize("engine", sorted(_CC_ENTRY_POINTS))
def test_out_of_range_node_ids_raise(engine, bad, as_tensor):
    # A node id outside [0, n) is refused before any round runs, on
    # every engine, for host and tensor inputs alike: on the card the
    # hook kernels would gather and scatter out of bounds with it.
    src = np.array([0, 1, 2, bad], np.int32)
    dst = np.array([1, 2, 3, 4], np.int32)
    if as_tensor:
        src, dst = torch.from_numpy(src), torch.from_numpy(dst)
    with pytest.raises(ValueError, match=r"must lie in \[0, 6\)"):
        _CC_ENTRY_POINTS[engine](src, dst, 6, device="cpu")


def test_label_propagation_matches_reference():
    e, n = GRAPHS["forest"]
    want_l, want_s = rc.label_propagation(e[:, 0], e[:, 1], n)
    got_l, got_s = tc.label_propagation(e[:, 0], e[:, 1], n, device="cpu")
    _eq(want_l, got_l)
    assert got_s == int(want_s)
    assert tc.num_components(got_l) == rc.num_components(want_l)


def test_round_bound_and_dedup_match_reference():
    for n in (0, 1, 2, 3, 1000, 1 << 22):
        assert tc.sv_round_bound(n) == rc.sv_round_bound(n)
    e, _ = GRAPHS["duplicates"]
    for want, got in zip(rc.dedup_edges(e[:, 0], e[:, 1]),
                         tc.dedup_edges(e[:, 0], e[:, 1])):
        np.testing.assert_array_equal(got, want)


def test_tensor_inputs_stay_on_their_device_and_skip_dedup():
    e, n = GRAPHS["giant_dust"]
    src = torch.from_numpy(e[:, 0].copy())
    dst = torch.from_numpy(e[:, 1].copy())
    labels, rounds, stats = tf.frontier_shiloach_vishkin(
        src, dst, n, with_stats=True
    )
    assert labels.device.type == "cpu" and stats.m2 == 2 * len(e)
    want_l, want_r = rc.shiloach_vishkin(e[:, 0], e[:, 1], n)
    _eq(want_l, labels)
    assert rounds == int(want_r)


def test_hook_impl_is_validated():
    with pytest.raises(ValueError, match="unknown hook_impl 'xla'"):
        tc.shiloach_vishkin([0], [1], 2, hook_impl="xla", device="cpu")


def _bench_smoke_counters(name):
    import json
    from pathlib import Path

    records = json.loads(
        (Path(__file__).resolve().parents[1] / "BENCH_smoke.json").read_text()
    )
    derived = next(r["derived"] for r in records if r["name"] == name)
    return {
        k: v for k, v in (kv.split("=") for kv in derived.split(";"))
        if not k.startswith("~")
    }


@pytest.mark.parametrize("family", ["giant+dust", "forest-small", "chain"])
def test_counters_match_bench_smoke(family):
    # benchmarks/cc_frontier.py's families at n=4000, default settings.
    n = 4000
    e = {
        "giant+dust": lambda: kiss.giant_dust_graph(n, 0.9, seed=1),
        "forest-small": lambda: kiss.list_graph(n, n // 64, seed=2),
        "chain": lambda: kiss.list_graph(n, 1, seed=3),
    }[family]()
    _, rounds, st = tf.frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], n, with_stats=True, device="cpu"
    )
    want = _bench_smoke_counters(f"cc_frontier/frontier/{family}/n={n}")
    assert int(want["rounds"]) == rounds == st.rounds
    assert int(want["edges_touched"]) == st.edges_touched
    assert int(want["levels"]) == len(st.levels)
    dense = _bench_smoke_counters(f"cc_frontier/dense/{family}/n={n}")
    assert int(dense["edges_touched"]) == 2 * st.m2 * rounds
    *_, sta = tf.frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], n, sample_rounds=2, with_stats=True, device="cpu"
    )
    aff = _bench_smoke_counters(f"cc_frontier/afforest/{family}/n={n}")
    assert int(aff["edges_touched"]) == sta.edges_touched
    assert int(aff["live_after_sample"]) == sta.live_after_sample
