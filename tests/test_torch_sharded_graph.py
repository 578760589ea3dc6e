"""The port's sharded graph engine (``repro_torch.distributed.graph``) on
the CPU against ``repro.distributed.graph``, bit for bit.

* World size 1: a one-rank gloo group in this process.
* World sizes 2 and 4: gloo ranks spawned once per size by a
  module-scoped fixture; every case runs inside that one spawn, and the
  parametrised tests assert on what it returned, including that every
  rank returned the same replicated result.
* The reference runs once per size in a subprocess with that many fake
  CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=P``),
  so its auto dispatch sees as many devices as the port sees ranks.

Compared: labels, rounds, hook forests, ranks, ``CCExchangeStats``,
``ShardedFrontierStats`` and ``SplitterStats`` field for field, the
``ConvergenceError`` of a cut-off run, and the ``multidev_scaling/*_dev1``
rows of ``BENCH_smoke.json`` character for character."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SIZES = (1, 2, 4)
# Seconds: one spawn's or one reference subprocess's wait. A guard
# against a hang, not a speed bound: run alone the fixture takes ~60 s,
# but beside the other files on six workers its subprocesses share the
# cores and one wait has taken 139.5 s; about twice that is allowed.
TIMEOUT = 300


# ---------------------------------------------------------------------------
# inputs and cases (plain data: the spawned ranks and the reference
# subprocess get the same objects)
# ---------------------------------------------------------------------------


def _star(n):
    return np.stack(
        [np.zeros(n - 1, np.int32), np.arange(1, n, dtype=np.int32)], axis=1
    )


def _inputs():
    """The eight families of ``tests/test_sharded_frontier.py``, a list
    for the rankers and a forest for the tree pipeline, from the port's
    numpy generators (bit-identical to the reference's)."""
    from repro_torch.data.graphs import random_tree_forest
    from repro_torch.ops.kiss import (
        giant_dust_graph,
        list_graph,
        random_graph,
        random_linked_list,
        tree_graph,
    )

    r = np.random.default_rng(7)
    succ = random_linked_list(3001, seed=8)
    picks = np.random.default_rng(5).choice(np.arange(1, 3001), 36, replace=False)
    return {
        "long-chain": (2000, list_graph(2000, 1, seed=1)),
        "star": (1500, _star(1500)),
        "giant+dust": (2000, giant_dust_graph(2000, 0.9, seed=2)),
        "empty": (17, np.zeros((0, 2), np.int32)),
        "all-self-loops": (
            9, np.stack([np.arange(9)] * 2, axis=1).astype(np.int32)
        ),
        "tree": (1200, tree_graph(1200, 3, seed=3)),
        "random": (800, random_graph(800, 0.01, seed=4)),
        "dense-multigraph": (
            150, r.integers(0, 150, (3000, 2)).astype(np.int32)
        ),
        "list": succ,
        "splitters": np.sort(np.concatenate([[0], picks])).astype(np.int64),
        "forest": (600, random_tree_forest(600, 20, seed=1)),
    }


FAMILIES = (
    "long-chain", "star", "giant+dust", "empty", "all-self-loops", "tree",
    "random", "dense-multigraph",
)


def _cases():
    """case id -> (engine, input, port keywords)."""
    cases = {}
    for fam in FAMILIES:
        cases[f"frontier/{fam}"] = (
            "frontier", fam, dict(min_bucket=64, record_hooks=True,
                                  with_stats=True))
        cases[f"frontier_dense/{fam}"] = (
            "frontier", fam, dict(min_bucket=64, exchange="dense",
                                  with_stats=True))
        cases[f"dense/{fam}"] = (
            "dense", fam, dict(record_hooks=True, with_stats=True))
        cases[f"dense_sparse/{fam}"] = (
            "dense", fam, dict(exchange="sparse", with_stats=True))
    cases.update({
        # a 4-slot buffer overflows in the early rounds: the dense
        # fallback, then the sparse exchange
        "frontier_overflow/tree": ("frontier", "tree", dict(
            min_bucket=64, sparse_capacity=4, record_hooks=True,
            with_stats=True)),
        "dense_overflow/giant+dust": ("dense", "giant+dust", dict(
            exchange="sparse", sparse_capacity=4, record_hooks=True,
            with_stats=True)),
        "frontier_hook_torch/random": ("frontier", "random", dict(
            min_bucket=64, hook_impl="torch", record_hooks=True,
            with_stats=True)),
        "frontier_max_rounds/long-chain": ("frontier", "long-chain", dict(
            min_bucket=64, max_rounds=3)),
        "dense_max_rounds/long-chain": ("dense", "long-chain", dict(
            max_rounds=3)),
        "rank_seeded/list": ("rank", "list", dict(
            num_splitters=50, seed=3, with_stats=True)),
        "rank_supplied/list": ("rank", "list", dict(
            splitters="splitters", with_stats=True)),
        "rank_torch/list": ("rank", "list", dict(
            num_splitters=64, kernel_impl="torch", with_stats=True)),
        "rank_max_steps/list": ("rank", "list", dict(
            num_splitters=8, max_steps=4)),
        "trees/forest": ("trees", "forest", dict()),
        # no mesh: the dispatch counts devices (ranks)
        "auto_cc/giant+dust": ("auto_cc", "giant+dust", dict()),
        "auto_rank/list": ("auto_rank", "list", dict(num_splitters=40)),
    })
    return cases


CASES = _cases()
# The port's impl names -> the reference's.
_REF_IMPL = {"torch": "xla"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _stats(st):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = np.asarray(v) if isinstance(v, (list, np.ndarray)) else v
    return out


def _run(pkg, case, inputs, mesh, **extra):
    """One case on the engines of ``pkg`` (``"port"`` or ``"ref"``),
    normalised to numpy; a ``ConvergenceError`` becomes a result."""
    engine, name, kw = case
    kw = dict(kw)
    if pkg == "port":
        from repro_torch import core
        from repro_torch.distributed import graph as g
        kw.update(extra)
    else:
        from repro import core
        from repro.distributed import graph as g
        for k in ("hook_impl", "kernel_impl"):
            if k in kw:
                kw[k] = _REF_IMPL[kw[k]]
    if kw.get("splitters") == "splitters":
        kw["splitters"] = inputs["splitters"]
    try:
        return _call(core, g, engine, name, kw, inputs, mesh)
    except core.ConvergenceError:  # a result to compare
        return {"error": "ConvergenceError"}


def _call(core, g, engine, name, kw, inputs, mesh):
    """``_run``'s call of one case on ``core`` / ``g``."""
    if engine in ("frontier", "dense", "trees", "auto_cc"):
        n, e = inputs[name]
        src, dst = e[:, 0], e[:, 1]
        if engine == "trees":
            ta = core.tree_analytics(src, dst, n, mesh=mesh, **kw)
            comp = ta.computations
            return {k: _np(getattr(comp, k)) for k in (
                "parent", "depth", "subtree_size", "preorder",
                "postorder", "ranks")} | {
                "labels": _np(ta.forest.labels),
                "rounds": int(ta.forest.rounds),
                "edge_u": _np(ta.forest.edge_u),
                "edge_v": _np(ta.forest.edge_v)}
        if engine == "auto_cc":
            res = core.connected_components(src, dst, n, **kw)
        else:
            fn = (g.sharded_frontier_shiloach_vishkin
                  if engine == "frontier" else g.sharded_shiloach_vishkin)
            res = fn(src, dst, n, mesh=mesh, **kw)
        out = {"labels": _np(res[0]), "rounds": int(res[1])}
        rest = list(res[2:])
        if kw.get("record_hooks"):
            hu, hv = rest.pop(0)
            out["hook_u"], out["hook_v"] = _np(hu), _np(hv)
        if kw.get("with_stats"):
            out["stats"] = _stats(rest.pop(0))
        return out
    succ = inputs[name]
    if engine == "auto_rank":
        return {"rank": _np(core.list_rank(succ, **kw))}
    res = g.sharded_random_splitter_rank(succ, mesh=mesh, **kw)
    if kw.get("with_stats"):
        return {"rank": _np(res[0]), "stats": _stats(res[1])}
    return {"rank": _np(res)}


def _assert_same(want, got, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _assert_same(want[k], got[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, (where, got.shape, want.shape)
        if want.size:
            assert got.dtype.kind == want.dtype.kind, (where, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


# ---------------------------------------------------------------------------
# the reference, one subprocess per size
# ---------------------------------------------------------------------------

_REF_SCRIPT = """
import pickle, sys
sys.path.insert(0, {tests!r})
import test_torch_sharded_graph as t
from repro.distributed.graph import graph_mesh
with open({inp!r}, "rb") as f:
    inputs = pickle.load(f)
mesh = graph_mesh({size})
out = {{cid: t._run("ref", case, inputs, mesh) for cid, case in t.CASES.items()}}
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
"""


def _start_reference(tmp, size):
    inp, out = tmp / "inputs.pkl", tmp / f"ref{size}.pkl"
    env = dict(
        os.environ,
        XLA_FLAGS=f"--xla_force_host_platform_device_count={size}",
        JAX_PLATFORMS="cpu",
        PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]
        ),
    )
    script = _REF_SCRIPT.format(
        tests=str(ROOT / "tests"), inp=str(inp), out=str(out), size=size
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", script], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, out


# ---------------------------------------------------------------------------
# the port's gloo ranks, spawned once per size
# ---------------------------------------------------------------------------


def _rank_worker(rank, size, init_file, inputs, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=size,
        )
        from repro_torch.distributed import graph_mesh

        mesh = graph_mesh(size, device="cpu")
        out = {
            cid: _run("port", case, inputs, mesh, device="cpu")
            for cid, case in CASES.items()
        }
        q.put((rank, out))
    except BaseException:  # reported to the parent, then re-raised
        q.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(ctx, tmp, size, inputs):
    q = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_worker,
                    args=(r, size, str(tmp / f"store{size}"), inputs, q))
        for r in range(size)
    ]
    for p in procs:
        p.start()
    return q, procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the reference subprocesses and the spawned ranks together,
    then collects what each size returned: ``{size: (reference,
    [per-rank port results])}``; size 1's port side runs in the tests."""
    import multiprocessing as mp
    import queue

    tmp = tmp_path_factory.mktemp("sharded")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    refs = {size: _start_reference(tmp, size) for size in SIZES}
    ctx = mp.get_context("spawn")
    spawned = {size: _spawn(ctx, tmp, size, inputs) for size in SIZES[1:]}
    results = {}
    try:
        for size, (q, procs) in spawned.items():
            got = {}
            for _ in procs:
                rank, out = q.get(timeout=TIMEOUT)
                assert isinstance(out, dict), f"rank {rank} of {size}:\n{out}"
                got[rank] = out
            results[size] = [got[r] for r in range(size)]
        for size, (proc, path) in refs.items():
            log, _ = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, log
            with open(path, "rb") as f:
                ref = pickle.load(f)
            results[size] = (ref, results.get(size))
    finally:
        for _, procs in spawned.values():
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
        for proc, _ in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results["inputs"] = inputs
    return results


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cid", list(CASES))
def test_world_size_1_matches_reference(runs, cid):
    from repro_torch.distributed import graph_mesh

    ref, _ = runs[1]
    got = _run("port", CASES[cid], runs["inputs"], graph_mesh(1, device="cpu"),
               device="cpu")
    _assert_same(ref[cid], got, cid)


@pytest.mark.parametrize("size", SIZES[1:])
@pytest.mark.parametrize("cid", list(CASES))
def test_spawned_ranks_match_reference(runs, size, cid):
    ref, per_rank = runs[size]
    for rank, out in enumerate(per_rank):
        _assert_same(ref[cid], out[cid], f"{cid} rank {rank} of {size}")


@pytest.mark.parametrize("size", SIZES)
def test_cases_show_what_they_claim(runs, size):
    """The cases reach the paths they name in the reference: overflow
    falls back, the sparse exchange sends less in late rounds, the cut
    runs raise, the frontier engine compacts."""
    ref, _ = runs[size]
    words = ref["frontier_overflow/tree"]["stats"]["words_per_round"]
    n = runs["inputs"]["tree"][0]
    assert words.max() > 2 * n and words.min() < 100  # dense, then sparse
    assert ref["frontier_max_rounds/long-chain"] == {"error": "ConvergenceError"}
    assert ref["dense_max_rounds/long-chain"] == {"error": "ConvergenceError"}
    assert ref["rank_max_steps/list"] == {"error": "ConvergenceError"}
    assert len(ref["frontier/long-chain"]["stats"]["levels"]) > 1
    assert ref["frontier/giant+dust"]["stats"]["num_devices"] == size


def test_mesh_validation():
    from repro_torch.distributed import graph_mesh
    from repro_torch.distributed.graph import _resolve_axis

    mesh = graph_mesh(1, device="cpu")
    assert (mesh.size, mesh.rank, mesh.axis_names) == (1, 0, ("graph",))
    assert _resolve_axis(mesh, "data") == "graph"
    assert graph_mesh(device="cpu", axis="x").axis_names == ("x",)
    with pytest.raises(ValueError, match="asked for 2 devices, have 1"):
        graph_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="unknown exchange"):
        from repro_torch.distributed import sharded_shiloach_vishkin

        sharded_shiloach_vishkin([0], [1], 2, mesh=mesh, exchange="ring")
    with pytest.raises(ValueError, match="differs from the mesh"):
        from repro_torch.distributed import sharded_frontier_shiloach_vishkin

        sharded_frontier_shiloach_vishkin([0], [1], 2, mesh=mesh,
                                          device="cuda")


def test_spans_and_publish_under_the_reference_names():
    """The reference's span names and tags, and ``publish()`` snapshots
    equal to the reference's stats published on one device."""
    from repro.distributed import graph as rg
    from repro.obs.metrics import Registry as RefRegistry
    from repro_torch.distributed import graph as tg
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import Registry

    inputs = _inputs()
    n, e = inputs["giant+dust"]
    was = trace.enabled()
    trace.configure(trace="on")
    trace.reset()
    try:
        mesh = tg.graph_mesh(1, device="cpu")
        *_, st = tg.sharded_shiloach_vishkin(
            e[:, 0], e[:, 1], n, mesh=mesh, exchange="sparse", with_stats=True)
        *_, fst = tg.sharded_frontier_shiloach_vishkin(
            e[:, 0], e[:, 1], n, mesh=mesh, with_stats=True)
        tg.sharded_random_splitter_rank(inputs["list"], 16, mesh=mesh)
        spans = {ev["name"]: ev["args"] for ev in trace.chrome_trace()
                 ["traceEvents"] if ev["ph"] == "X"}
    finally:
        trace.configure(trace="on" if was else "off")
        trace.reset()
    assert spans["cc.sharded"] == {"n": n, "devices": 1, "exchange": "sparse"}
    assert spans["cc.sharded_frontier"]["rounds"] == fst.rounds
    assert spans["cc.sharded_frontier"]["levels"] == len(fst.levels)
    assert "cc.sharded_frontier.level" in spans
    assert spans["rank.splitter.sharded"] == {"n": 3001, "p": 16, "devices": 1}

    rmesh = rg.graph_mesh(1)
    *_, rst = rg.sharded_shiloach_vishkin(
        e[:, 0], e[:, 1], n, mesh=rmesh, exchange="sparse", with_stats=True)
    *_, rfst = rg.sharded_frontier_shiloach_vishkin(
        e[:, 0], e[:, 1], n, mesh=rmesh, with_stats=True)
    reg, ref_reg = Registry(), RefRegistry()
    for got, want in ((st, rst), (fst, rfst)):
        got.publish(reg)
        want.publish(ref_reg)
    snap = reg.snapshot()
    assert snap == ref_reg.snapshot()
    assert "cc.sharded.words_per_round.total" in snap
    assert "cc.sharded_frontier.edges_touched" in snap


# ---------------------------------------------------------------------------
# the multidev_scaling/*_dev1 rows of BENCH_smoke.json
# ---------------------------------------------------------------------------


def _dev1_derived():
    """``benchmarks/multidev_scaling.py``'s derived strings for one
    device at the smoke size (n = 100), computed by the port."""
    from repro_torch.data.graphs import random_succ
    from repro_torch.core.list_ranking import select_splitters
    from repro_torch.distributed import (
        cc_exchange_words_per_round,
        graph_mesh,
        rank_exchange_words,
        sharded_frontier_shiloach_vishkin,
        sharded_random_splitter_rank,
        sharded_shiloach_vishkin,
    )
    from repro_torch.ops.kiss import random_graph

    n, d = 100, 1
    edges = random_graph(n, 4.0 / n, seed=1)
    succ = random_succ(n, seed=0)
    p = min(512, n)
    spl = select_splitters(n, p, seed=0)
    mesh = graph_mesh(d, device="cpu")
    _, rounds = sharded_shiloach_vishkin(edges[:, 0], edges[:, 1], n, mesh=mesh)
    ex_kib = cc_exchange_words_per_round(n) * 4 / 1024
    out = {"cc_sharded_dev1": (
        f"rounds={int(rounds)};exKiB/round={ex_kib:.1f};"
        f"edges/dev={2 * len(edges) // d}")}
    _, _, st = sharded_shiloach_vishkin(
        edges[:, 0], edges[:, 1], n, mesh=mesh, exchange="sparse",
        with_stats=True)
    w = cc_exchange_words_per_round(n, stats=st)
    out["cc_sharded_sparse_dev1"] = (
        f"capacity={st.capacity};wordsR1={int(w[0])};"
        f"wordsLast={int(w[-1])};denseWords={3 * n}")
    _, _, stf = sharded_frontier_shiloach_vishkin(
        edges[:, 0], edges[:, 1], n, mesh=mesh, min_bucket=64,
        with_stats=True)
    dense_per_dev = 2 * (-(-stf.m2 // d)) * stf.rounds
    out["cc_sharded_frontier_dev1"] = (
        f"rounds={stf.rounds};edgesTouched/dev={stf.edges_touched};"
        f"denseTouched/dev={dense_per_dev};levels={len(stf.levels)};"
        f"wordsLast={int(stf.words_per_round[-1])}")
    sharded_random_splitter_rank(succ, splitters=spl, mesh=mesh)
    ex_kib = rank_exchange_words(n, p, d) * 4 / 1024
    out["rank_sharded_dev1"] = f"exKiB={ex_kib:.1f};lanes/dev={-(-p // d)}"
    return out


@pytest.mark.parametrize("name", [
    "cc_sharded_dev1", "cc_sharded_sparse_dev1", "cc_sharded_frontier_dev1",
    "rank_sharded_dev1",
])
def test_multidev_scaling_dev1_rows_equal_bench_smoke(name):
    rows = json.loads((ROOT / "BENCH_smoke.json").read_text())
    want = {r["name"]: r["derived"] for r in rows
            if r["suite"] == "multidev_scaling"}
    assert _dev1_derived()[name] == want[name]
