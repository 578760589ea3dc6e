"""The port's ``ops/segment.py`` and ``ops/scatter_gather.py`` against
``repro.ops`` on the CPU, on sorted and unsorted ids: integer results
exactly, maxima and minima exactly (-inf / +inf on empty segments),
float sums, means and softmaxes at 2e-5 (the sums run in another
order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ops import scatter_gather as jsg  # noqa: E402
from repro.ops import segment as jseg  # noqa: E402
from repro_torch.ops import scatter_gather as tsg  # noqa: E402
from repro_torch.ops import segment as tseg  # noqa: E402

TOL = 2e-5
NS = 40


def _ids(seed, m, *, sorted_, invalid):
    """Ids over NS segments, a third of them empty; with ``invalid``,
    some below 0 and some at or past NS, which both packages drop."""
    r = np.random.default_rng(seed)
    ids = r.choice(np.arange(0, NS, 3) if seed % 2 else np.arange(NS // 3, NS), m)
    if invalid:
        ids[r.choice(m, 6, replace=False)] = [-1, -2, NS, NS, NS + 1, NS + 50]
    if sorted_:
        ids = np.sort(ids)
    return ids.astype(np.int32)


def _floats(seed, shape):
    return np.random.default_rng(seed + 100).normal(size=shape).astype(np.float32)


def _ints(seed, shape):
    return np.random.default_rng(seed + 200).integers(-50, 50, shape).astype(np.int32)


CASES = [
    pytest.param(sorted_, invalid, feat,
                 id=f"{'sorted' if sorted_ else 'unsorted'}-"
                    f"{'invalid' if invalid else 'valid'}-{len(feat) + 1}d")
    for sorted_ in (True, False)
    for invalid in (False, True)
    for feat in ((), (5,), (3, 4))
]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _exact(got, want):
    assert got.dtype == getattr(torch, str(np.asarray(want).dtype))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sorted_,invalid,feat", CASES)
def test_segment_sum_max_min_count_mean(sorted_, invalid, feat):
    seed = 3 * sorted_ + 5 * invalid + len(feat)
    m = 300
    ids = _ids(seed, m, sorted_=sorted_, invalid=invalid)
    x, k = _floats(seed, (m, *feat)), _ints(seed, (m, *feat))
    tids, jids = torch.from_numpy(ids), jnp.asarray(ids)
    kw = dict(indices_are_sorted=sorted_)
    _close(tseg.segment_sum(torch.from_numpy(x), tids, NS, **kw),
           jseg.segment_sum(jnp.asarray(x), jids, NS, **kw))
    _exact(tseg.segment_sum(torch.from_numpy(k), tids, NS, **kw),
           jseg.segment_sum(jnp.asarray(k), jids, NS, **kw))
    for name in ("segment_max", "segment_min"):
        for data in (x, k):
            _exact(getattr(tseg, name)(torch.from_numpy(data), tids, NS, **kw),
                   getattr(jseg, name)(jnp.asarray(data), jids, NS, **kw))
    _exact(tseg.segment_count(tids, NS), jseg.segment_count(jids, NS))
    _close(tseg.segment_mean(torch.from_numpy(x), tids, NS, **kw),
           jseg.segment_mean(jnp.asarray(x), jids, NS, **kw))


def test_empty_segments_read_the_identity():
    ids = torch.tensor([0, 0, 2], dtype=torch.int32)
    x = torch.tensor([1.0, 2.0, 3.0])
    assert tseg.segment_max(x, ids, 4).tolist() == [2.0, float("-inf"), 3.0, float("-inf")]
    assert tseg.segment_min(x, ids, 4).tolist() == [1.0, float("inf"), 3.0, float("inf")]
    assert tseg.segment_sum(x, ids, 4).tolist() == [3.0, 0.0, 3.0, 0.0]
    lo = torch.iinfo(torch.int32).min
    assert tseg.segment_max(x.int(), ids, 3).tolist() == [2, lo, 3]


@pytest.mark.parametrize("sorted_", [True, False])
def test_float_sum_drops_int64_ids_past_int32(sorted_):
    # An int64 id of 2**32 + 3 must not wrap into segment 3 when the ids
    # are narrowed to the kernel's int32.
    ids = torch.tensor([-(2**32) + 1, 0, 3, 3, 2**32 + 3, 2**40], dtype=torch.int64)
    if not sorted_:
        ids = ids.flip(0)
    x = torch.arange(1.0, 7.0)
    if not sorted_:
        x = x.flip(0)
    kw = dict(indices_are_sorted=sorted_)
    assert tseg.segment_sum(x, ids, 5, **kw).tolist() == [2.0, 0.0, 0.0, 7.0, 0.0]
    assert tseg.segment_sum(x.long(), ids, 5, **kw).tolist() == [2, 0, 0, 7, 0]


def test_float16_sum_is_summed_in_float32_and_rounded_once():
    m = 300
    ids = _ids(13, m, sorted_=True, invalid=True)
    x = _floats(13, (m, 3)).astype(np.float16)
    got = tseg.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), NS,
                           indices_are_sorted=True)
    assert got.dtype == torch.float16
    keep = (ids >= 0) & (ids < NS)
    want = np.zeros((NS, 3), np.float32)
    np.add.at(want, ids[keep], x[keep].astype(np.float32))
    # One rounding of the float32 sum: within float16's half ulp (2**-11).
    np.testing.assert_allclose(got.numpy().astype(np.float32), want,
                               rtol=2**-11, atol=2**-24)


@pytest.mark.parametrize("invalid", [False, True])
@pytest.mark.parametrize("sorted_", [True, False])
@pytest.mark.parametrize("feat", [(), (4,)])
def test_segment_softmax(sorted_, feat, invalid):
    # Out-of-range ids read their segment's max and denominator the way
    # JAX's gather does: a negative id wraps once, then ids are clamped.
    m = 250
    ids = _ids(7 + sorted_, m, sorted_=sorted_, invalid=invalid)
    x = 5 * _floats(7, (m, *feat))
    tids, jids = torch.from_numpy(ids), jnp.asarray(ids)
    kw = dict(indices_are_sorted=sorted_)
    _close(tseg.segment_softmax(torch.from_numpy(x), tids, NS, **kw),
           jseg.segment_softmax(jnp.asarray(x), jids, NS, **kw))
    num, den = tseg.segment_softmax_dist(torch.from_numpy(x), tids, NS, **kw)
    jnum, jden = jseg.segment_softmax_dist(jnp.asarray(x), jids, NS)
    _close(num, jnum)
    _close(den, jden)


@pytest.mark.parametrize("sorted_", [True, False])
def test_dist_variants_are_the_local_reductions(sorted_):
    m = 200
    ids = _ids(11, m, sorted_=sorted_, invalid=True)
    x = _floats(11, (m, 3))
    tids, jids = torch.from_numpy(ids), jnp.asarray(ids)
    _close(tseg.segment_sum_dist(torch.from_numpy(x), tids, NS,
                                 indices_are_sorted=sorted_),
           jseg.segment_sum_dist(jnp.asarray(x), jids, NS,
                                 indices_are_sorted=sorted_))
    _exact(tseg.segment_max_dist(torch.from_numpy(x), tids, NS),
           jseg.segment_max_dist(jnp.asarray(x), jids, NS))


@pytest.mark.parametrize("fn", ["segment_sum_dist", "segment_max_dist",
                                "segment_softmax_dist"])
def test_sharded_axes_raise_naming_the_roadmap_items(fn):
    x, ids = torch.ones(4), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="queue 1, items 11 and 16"):
        getattr(tseg, fn)(x, ids, 2, ("data",))


def _edges(seed, n, m):
    r = np.random.default_rng(seed)
    return (r.integers(0, n, m).astype(np.int32),
            r.integers(0, n // 2, m).astype(np.int32))  # duplicate dsts


def test_sort_edges_by_dst_is_the_same_stable_sort():
    src, dst = _edges(1, 60, 500)
    got = tsg.sort_edges_by_dst(torch.from_numpy(src), torch.from_numpy(dst))
    want = jsg.sort_edges_by_dst(jnp.asarray(src), jnp.asarray(dst))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_messages():
    src, _ = _edges(2, 60, 500)
    h = _floats(2, (60, 7))
    _exact(tsg.gather_messages(torch.from_numpy(h), torch.from_numpy(src)),
           jsg.gather_messages(jnp.asarray(h), jnp.asarray(src)))


@pytest.mark.parametrize("sorted_", [True, False])
@pytest.mark.parametrize("reducer", ["sum", "mean", "max"])
def test_scatter_reduce(sorted_, reducer):
    n, m = 60, 400
    src, dst = _edges(3, n, m)
    if sorted_:
        dst = np.sort(dst)
    msgs = _floats(3, (m, 6))
    got = tsg.scatter_reduce(torch.from_numpy(msgs), torch.from_numpy(dst), n,
                             reducer=reducer, indices_are_sorted=sorted_)
    want = jsg.scatter_reduce(jnp.asarray(msgs), jnp.asarray(dst), n,
                              reducer=reducer, indices_are_sorted=sorted_)
    _close(got, want)
    if reducer == "max":  # isolated nodes (the upper half) read 0
        assert not got[n // 2:].any()


def test_scatter_reduce_rejects_an_unknown_reducer():
    with pytest.raises(ValueError, match="unknown reducer"):
        tsg.scatter_reduce(torch.ones(2, 1), torch.zeros(2, dtype=torch.int32), 1,
                           reducer="prod")


@pytest.mark.parametrize("sorted_", [True, False])
@pytest.mark.parametrize("reducer", ["sum", "max"])
def test_mpnn_aggregate(sorted_, reducer):
    n, m = 50, 300
    src, dst = _edges(4, n, m)
    if sorted_:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    h, e = _floats(4, (n, 5)), _floats(5, (m, 2))

    def message_fn(x):
        return x * 2.0 + 1.0

    got = tsg.mpnn_aggregate(
        torch.from_numpy(h), torch.from_numpy(src), torch.from_numpy(dst), n,
        message_fn=message_fn, edge_feats=torch.from_numpy(e), reducer=reducer,
        indices_are_sorted=sorted_)
    want = jsg.mpnn_aggregate(
        jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst), n,
        message_fn=message_fn, edge_feats=jnp.asarray(e), reducer=reducer,
        indices_are_sorted=sorted_)
    assert tuple(got.shape) == (n, 7)
    _close(got, want)
