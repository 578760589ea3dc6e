"""The ``ordered_fold`` kernel's two wrappers on the CPU, through their
plain versions, bit for bit: the gathered form (``scale * (node[idx] *
weight)`` folded in slot order) against the generic fold of the same
values materialised, against ``np.add.at`` and against the reference's
``ADD`` advance; the port's PageRank mass step against the reference's;
and the kernel's warp schedule (``csrc/ordered_fold.cu``), written out in
Python, covering every slot of every target once, in slot order."""
import importlib
from bisect import bisect_right

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import operators as ro  # noqa: E402
from repro_torch.core import operators as to  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.ordered_fold.ops import (  # noqa: E402
    CHUNK,
    HEAVY,
    fold_plan,
    ordered_fold_gathered,
    ordered_fold_sorted,
)

# The modules, not the functions of the same name that the packages export.
rp = importlib.import_module("repro.core.pagerank")
tp = importlib.import_module("repro_torch.core.pagerank")


def _power_law(r, n, m):
    p = (np.arange(n) + 1.0) ** -0.8
    return r.choice(n, size=m, p=p / p.sum()).astype(np.int32)


def _case(name, seed=0):
    """``(n, targets, sources)`` of one index family; sources index the
    node array, targets may fall outside ``[0, n)`` (dropped)."""
    r = np.random.default_rng(seed)
    if name == "random":
        n, m = 300, 2400
        b = r.integers(0, n, m)
    elif name == "power_law":
        n, m = 400, 6000
        b = _power_law(r, n, m)
    elif name == "star":
        n, m = 64, 3000
        b = np.zeros(m, np.int64)
    elif name == "empty_groups":
        n, m = 90, 900
        b = 3 * r.integers(0, n // 3, m)
    elif name == "one_group":
        n, m = 1, 5000
        b = np.zeros(m, np.int64)
    elif name == "dropped_ids":
        n, m = 50, 800
        b = r.integers(-20, n + 20, m)
    else:
        raise KeyError(name)
    return n, b.astype(np.int32), r.integers(0, n, m).astype(np.int32)


CASES = ("random", "power_law", "star", "empty_groups", "one_group", "dropped_ids")
# The damping, and a scale that sends every product below float32's
# smallest normal (no flush to zero anywhere).
SCALES = (np.float32(0.85), np.float32(2.0 ** -140))
DAMPING = SCALES[0]


def _inputs(name, seed=0):
    n, b, a = _case(name, seed)
    r = np.random.default_rng(seed + 1)
    node = (r.standard_normal(n) * 10.0 ** r.integers(-3, 3, n)).astype(np.float32)
    w = r.random(len(b)).astype(np.float32)
    base = r.standard_normal(n).astype(np.float32)
    return n, b, a, node, w, base


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("case", CASES)
def test_gathered_equals_generic_fold_and_add_at(case, scale):
    n, b, a, node, w, base = _inputs(case)
    if scale < 1e-30:
        base[:] = 0.0  # keep the subnormal sums visible
    tb, ta = torch.from_numpy(b), torch.from_numpy(a)
    tnode, tw, tbase = map(torch.from_numpy, (node, w, base))
    tscale = torch.tensor(scale)
    vals = tscale * (tnode[ta.long()] * tw)
    plan = fold_plan(tb, n)
    perm = plan.perm.long()
    before = dict(launch_counts)
    want = ordered_fold_sorted(tbase, plan.row_ptr, plan.perm, vals)
    got = ordered_fold_gathered(tbase, plan.row_ptr, ta[perm].contiguous(), tnode,
                                tw[perm].contiguous(), tscale)
    assert launch_counts == before, "no launch for CPU tensors"
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    oracle = base.copy()
    keep = (b >= 0) & (b < n)
    np.add.at(oracle, b[keep], scale * (node[a[keep]] * w[keep]))
    np.testing.assert_array_equal(got.numpy(), oracle)
    if scale < 1e-30:
        assert (np.abs(oracle[oracle != 0]) < np.finfo(np.float32).tiny).all()


@pytest.mark.parametrize("case", ["random", "power_law", "star"])
def test_gathered_equals_reference_add_advance(case):
    n, b, a, node, w, base = _inputs(case, seed=7)
    want = ro.advance(jnp.asarray(base), jnp.asarray(b),
                      jnp.float32(DAMPING) * (jnp.asarray(node)[a] * jnp.asarray(w)),
                      monoid=ro.ADD)
    plan = fold_plan(torch.from_numpy(b), n)
    perm = plan.perm.long()
    got = to.advance(
        torch.from_numpy(base), plan,
        to.GatheredValues(torch.from_numpy(node), torch.from_numpy(a)[perm],
                          torch.from_numpy(w)[perm], torch.tensor(DAMPING)),
        monoid=to.ADD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _graph(name, seed):
    r = np.random.default_rng(seed)
    if name == "star":
        n = 500
        e = np.stack([np.zeros(n - 1, np.int32), np.arange(1, n, dtype=np.int32)], 1)
    else:  # power-law destinations, uniform sources; 30 nodes left isolated
        n, m = 600, 2400
        e = np.stack([r.integers(0, n - 30, m), _power_law(r, n - 30, m)], 1)
    w = r.random(len(e)).astype(np.float32)
    w[::11] = 0.0
    return n, e.astype(np.int32), w


@pytest.mark.parametrize("graph", ["star", "power_law"])
def test_mass_step_equals_reference(graph):
    n, e, w = _graph(graph, seed=3)
    a = np.concatenate([e[:, 0], e[:, 1]])
    b = np.concatenate([e[:, 1], e[:, 0]])
    w2 = np.concatenate([w, w])
    r = np.random.default_rng(4)
    t = np.full(n, 1.0 / n, np.float32)
    omd = np.float32(1.0) - DAMPING
    ta, tw2 = torch.from_numpy(a), torch.from_numpy(w2)
    a_plan, b_plan = fold_plan(ta, n), fold_plan(torch.from_numpy(b), n)
    deg = tp._degrees(a_plan, tw2, torch.from_numpy(t))
    want_deg = rp._degrees(jnp.asarray(a), jnp.asarray(w2), jnp.asarray(t))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    arcs = (b_plan, *tp._mass_arcs(ta, tw2, b_plan))
    for k in range(3):
        scores = (r.random(n) / n).astype(np.float32) if k else t
        want = rp._mass_step(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w2),
                             want_deg, jnp.asarray(t), jnp.asarray(scores),
                             jnp.float32(DAMPING), jnp.float32(omd))
        got = tp._mass_step(*arcs, deg, torch.from_numpy(t),
                            torch.from_numpy(scores), torch.tensor(DAMPING),
                            torch.tensor(omd))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_validation():
    base = torch.zeros(3)
    plan = fold_plan(torch.tensor([0, 2, 2], dtype=torch.int32), 3)
    idx = torch.tensor([1, 0, 2], dtype=torch.int32)
    node = torch.tensor([1.0, 2.0, 3.0])
    dmp = torch.tensor(DAMPING)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ordered_fold_gathered(base, plan.row_ptr, idx, node, torch.ones(3), dmp,
                              impl="cuda")
    with pytest.raises(ValueError, match="FoldPlan"):
        to.advance(base, torch.tensor([0, 2, 2]),
                   to.GatheredValues(node, idx, torch.ones(3), dmp), monoid=to.ADD)
    got = ordered_fold_gathered(base, plan.row_ptr, idx, node, torch.ones(3), dmp)
    # Group 0 holds slot 0 (node[1]); group 2 slots 1 and 2 (node[0], node[2]).
    d = DAMPING
    np.testing.assert_array_equal(
        got.numpy(), np.array([d * np.float32(2.0), 0.0,
                               d * np.float32(1.0) + d * np.float32(3.0)], np.float32))


# The kernel's schedule (csrc/ordered_fold.cu), warp by warp, as lists.


def _owner_of(row_ptr, s):
    """``owner_of``: the 32-ary search for the largest v with row_ptr[v] <= s."""
    n = len(row_ptr) - 1
    if row_ptr[0] > s:
        return -1
    lo, hi = 0, n + 1
    while hi - lo > 1:
        probes = [lo + ((hi - lo) * lane >> 5) for lane in range(32)]
        last = max(lane for lane, p in enumerate(probes) if row_ptr[p] <= s)
        lo, hi = probes[last], hi if last == 31 else probes[last + 1]
    assert lo == bisect_right(row_ptr, s) - 1
    return lo


def _walk(lanes, start, end, chunk, folded):
    """``walk``: the warp's chunks over [start, end); lanes are
    ``(target, lo, hi, skip)``; each lane's slots of a chunk are appended
    to ``folded[target]`` in order."""
    c = start
    while True:
        while True:
            at = [hi for _, lo, hi, skip in lanes if skip and lo == c]
            if not at:
                break
            c = at[0]
        gap = min([lo for _, lo, _, skip in lanes if skip and lo >= c] + [end])
        ch_lo, ch_hi = c, min(c + chunk, gap)
        if ch_lo == ch_hi:
            return
        for v, lo, hi, skip in lanes:
            if v is not None and not skip:
                folded.setdefault(v, []).extend(range(max(lo, ch_lo), min(hi, ch_hi)))
        c = ch_hi


def _schedule(row_ptr, m, chunk, heavy):
    """``{target: slots in the order folded}`` and ``{target: warps}``."""
    n = len(row_ptr) - 1
    folded, writers = {}, {}
    for j in range(-(-m // heavy)):
        s = j * heavy
        v = _owner_of(row_ptr, s)
        if not 0 <= v < n:
            continue
        lo, hi = row_ptr[v], row_ptr[v + 1]
        if hi - lo <= heavy or lo <= s - heavy:
            continue
        _walk([(v, lo, hi, False)], lo, hi, chunk, folded)
        writers.setdefault(v, []).append(("heavy", j))
    for w in range(-(-n // 32)):
        lanes = []
        for v in range(32 * w, 32 * w + 32):
            if v < n:
                lo, hi = row_ptr[v], row_ptr[v + 1]
                lanes.append((v, lo, hi, hi - lo > heavy))
            else:
                lanes.append((None, row_ptr[n], row_ptr[n], False))
        _walk(lanes, lanes[0][1], lanes[-1][2], chunk, folded)
        for v, _, _, skip in lanes:
            if v is not None and not skip:
                writers.setdefault(v, []).append(("light", w))
    return folded, writers


@pytest.mark.parametrize("chunk,heavy", [(CHUNK, HEAVY), (8, 16), (4, 4)])
@pytest.mark.parametrize("case", CASES)
def test_kernel_schedule_folds_every_slot_once_in_order(case, chunk, heavy):
    n, b, _ = _case(case, seed=5)
    row_ptr = fold_plan(torch.from_numpy(b), n).row_ptr.tolist()
    folded, writers = _schedule(row_ptr, len(b), chunk, heavy)
    for v in range(n):
        assert len(writers[v]) == 1, (v, writers[v])
        assert folded.get(v, []) == list(range(row_ptr[v], row_ptr[v + 1])), v
        assert (writers[v][0][0] == "heavy") == (row_ptr[v + 1] - row_ptr[v] > heavy)
