"""The port's meshes, sharding rules, layouts, sharded lookup, elastic
resharding and pipeline (``repro_torch.{distributed.mesh,
distributed.sharding, configs.lm_family, train.elastic,
ops.sharded_lookup, distributed.pipeline}``) on the CPU.

* The rule functions (``ShardingRules.for_mesh``, ``spec_for``,
  ``PathRules.spec_tree``, ``lm_path_rules``, ``_cache_specs``,
  ``drop_missing_axes``, ``fit_spec`` with its warning) equal the
  reference's exactly; they read only ``mesh.axis_names`` and
  ``mesh.shape``, so a plain stub serves.
* On gloo ranks (world size 1 in this process; 2 and 4 spawned once
  each by a module fixture, every case inside that one spawn):
  ``sharded_row_gather`` equals ``table[idx]`` bit for bit and its
  gathered table gradient equals ``index_add_``'s; ``shard_tree`` /
  ``gather_tree`` and ``reshard_state`` round-trip; ``pipeline_apply``
  on a 4-stage ``("pod",)`` mesh (and 1 stage here) against the
  sequential loop and the reference's sequential ``jax.grad`` at 2e-4.

``moe_ffn(mesh=)`` (``models/transformer/moe.py``) against the
reference's sharded ``moe_ffn`` on a fake-device mesh of the same shape:

* Every schedule (all_to_all EP, the small-batch EP psum with and
  without the token gather, expert TP with and without a data axis) on
  the mixtral and deepseek-v3 smoke configs, with and without the fp8
  dispatch payload, float32 and bf16, at the default capacity factor so
  that chunks drop tokens.
* Outputs at 2e-3 (float32) and 3e-2 (bf16) against the reference's;
  each rank's ``kept`` (every dispatch's) bit for bit against the one
  the reference computed on the same device (read out of its
  ``shard_map`` with ``jax.debug.callback``); which schedule ran, by a
  spy on the schedule functions. The reference runs once in a
  subprocess with 8 fake CPU devices.

``start_ranks`` and ``collect`` are the spawn helpers
``test_torch_sharded_train.py`` imports."""
import dataclasses
import logging
import os
import pickle
import subprocess
import sys
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# Seconds one spawn may take: a guard against a hang, not a speed bound.
TIMEOUT = 300
TOL = 2e-4
MOE_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


# ---------------------------------------------------------------------------
# spawning gloo ranks
# ---------------------------------------------------------------------------


def _rank_entry(rank, size, init_file, fn, payload_file, q):
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        with open(payload_file, "rb") as f:
            payload = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=size)
        q.put((rank, fn(rank, size, payload)))
    except BaseException:  # reported to the parent, then re-raised
        q.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_ranks(tmp, size, fn, payload):
    """Spawns ``size`` gloo ranks running ``fn(rank, size, payload)`` (a
    module-level function); returns a handle for ``collect``. The payload
    travels in a file: a large argument would hold each start until its
    child has imported enough to read it."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store, payload_file = Path(tmp) / f"store{size}", Path(tmp) / f"payload{size}.pkl"
    with open(payload_file, "wb") as f:
        pickle.dump(payload, f)
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, size, str(store), fn, str(payload_file), q))
             for r in range(size)]
    # One thread each (torch's and the BLAS's, read when numpy loads):
    # the ranks share the machine with each other and the other tests.
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: "1" for k in _THREAD_VARS})
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return q, procs


def collect(handle) -> list:
    """Every rank's result in rank order; a rank that raised fails the
    caller with its traceback. Stops every process either way."""
    q, procs = handle
    got = {}
    try:
        for _ in procs:
            rank, out = q.get(timeout=TIMEOUT)
            assert not isinstance(out, str), f"rank {rank}:\n{out}"
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [got[r] for r in range(len(procs))]


def cpu_mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(shape, axes, device="cpu")


# ---------------------------------------------------------------------------
# rules against the reference
# ---------------------------------------------------------------------------

STUB_MESHES = [
    ((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
    ((4,), ("pod",)), ((8,), ("graph",)), ((2, 2), ("data", "model")),
]


def _stub(shape, axes):
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("shape,axes", STUB_MESHES)
def test_rules_and_specs_match_the_reference(shape, axes):
    from repro.distributed import sharding as jsh
    from repro_torch.distributed import sharding as sh

    mesh = _stub(shape, axes)
    for name in ("LM_RULES", "LM_DECODE_RULES", "LM_LONG_DECODE_RULES",
                 "GNN_RULES", "RECSYS_RULES"):
        want = getattr(jsh, name).for_mesh(mesh)
        got = getattr(sh, name).for_mesh(mesh)
        assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
            f: getattr(want, f) for f in want.__dataclass_fields__}, name
        for logical in [("batch", None, "vocab"), ("edges",), ("heads", "d_ff"),
                        (None, "seq", "expert"), ("table_rows", "nodes", "stage")]:
            assert sh.spec_for(got, *logical) == _spec(jsh.spec_for(want, *logical))
    from jax.sharding import PartitionSpec as P

    specs = {"a": P(("pod", "data"), None), "b": [P("model"), P(None, ("data", "x"))],
             "c": {"d": P("x", "pod")}}
    port = {"a": (("pod", "data"), None), "b": [("model",), (None, ("data", "x"))],
            "c": {"d": ("x", "pod")}}
    want = jsh.drop_missing_axes(specs, mesh)
    got = sh.drop_missing_axes(port, mesh)
    assert got == {"a": _spec(want["a"]), "b": [_spec(s) for s in want["b"]],
                   "c": {"d": _spec(want["c"]["d"])}}


def _abstract_params(jcfg):
    import jax

    from repro.models.transformer import init_params

    return jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), jcfg))


@pytest.mark.parametrize("name", ["qwen3-4b", "gemma-2b", "mixtral-8x7b",
                                  "deepseek-v3-671b"])
def test_lm_path_rules_spec_tree_and_cache_specs_match_the_reference(name):
    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.configs.lm_family import _cache_specs as jax_cache_specs
    from repro.configs.lm_family import lm_path_rules as jax_rules
    from repro.models.transformer import init_kv_cache as jax_kv
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_family import _cache_specs, lm_path_rules

    jcfg, cfg = jax_get_arch(name).config, get_arch(name).config
    shapes = _abstract_params(jcfg)
    cache = jax.eval_shape(lambda: jax_kv(jcfg, 8, 4096))
    for shape, axes in STUB_MESHES:
        mesh = _stub(shape, axes)
        want = jax.tree.map(_spec, jax_rules(jcfg, mesh).spec_tree(shapes),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert lm_path_rules(cfg, mesh).spec_tree(shapes) == want, (name, shape)
        for batch in (8, 3):
            want_c = jax.tree.map(
                _spec, jax_cache_specs(jcfg, cache, mesh, batch),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            assert _cache_specs(cfg, cache, mesh, batch) == want_c, (name, shape, batch)


def test_fit_spec_matches_the_reference_and_warns_alike(caplog):
    from jax.sharding import PartitionSpec as P

    from repro.train.elastic import fit_spec as jax_fit
    from repro_torch.train.elastic import fit_spec

    cases = [
        (P("model", None), (64, 8)), (P(("data", "model"), None), (64, 8)),
        (P(("data", "model")), (6,)), (P(None, "model"), (3, 5)),
        (P("pod", "data"), (4, 4)), (P(), (2, 3)), (P(("pod", "model"), "x"), (16, 2)),
    ]
    for shape, axes in STUB_MESHES:
        mesh = _stub(shape, axes)
        for spec, dims in cases:
            caplog.clear()
            with caplog.at_level(logging.WARNING, logger="repro.elastic"):
                want = _spec(jax_fit(spec, dims, mesh))
                ref_log = [r.getMessage() for r in caplog.records]
            caplog.clear()
            with caplog.at_level(logging.WARNING, logger="repro.elastic"):
                got = fit_spec(tuple(spec), dims, mesh)
                port_log = [r.getMessage() for r in caplog.records]
            assert got == want, (spec, dims, shape)
            assert port_log == ref_log


def test_lm_param_specs_follow_the_rules_through_unstacking_and_transposes():
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_family import lm_param_specs
    from repro_torch.models.transformer import init_params

    cfg = get_arch("deepseek-v3-671b").smoke_config
    params = init_params(cfg, device="meta")
    specs = lm_param_specs(params, cfg, _stub((2, 2), ("data", "model")))
    assert specs["embed"] == ("model", None)
    assert specs["final_norm"] == (None,)
    assert specs["unembed.weight"] == ("model", None)  # (d, V) transposed
    assert specs["dense_layers.0.attn.wq_b.weight"] == ("model", None)
    assert specs["dense_layers.0.attn.wkv_a.weight"] == (None, None)
    assert specs["dense_layers.0.attn.wo.weight"] == (None, "model")
    assert specs["dense_layers.0.ffn.w_down.weight"] == (None, "model")
    assert specs["moe_layers.0.moe.w_gate"] == ("model", None, None)
    assert specs["moe_layers.0.moe.w_down_shared"] == ("model", None)
    assert specs["moe_layers.0.moe.router"] == (None, None)
    assert specs["mtp_layer.attn.wq_a.weight"] == ("model", None)
    assert specs["mtp_layer.attn.kv_norm"] == (None,)
    assert specs["mtp_norm"] == (None,)
    assert set(specs) == {n for n, _ in params.named_parameters()}
    # the full config's experts spread over both axes
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_axes=("data", "model")))
    specs = lm_param_specs(params, wide, _stub((2, 2), ("data", "model")))
    assert specs["moe_layers.0.moe.w_gate"] == (("data", "model"), None, None)


def test_mesh_builders_validate():
    from repro_torch.distributed import graph_mesh
    from repro_torch.launch.mesh import (
        make_graph_mesh,
        make_production_mesh,
        mesh_num_chips,
    )

    mesh = cpu_mesh((1, 1))
    assert (mesh.axis_names, mesh.shape, mesh.coords) == (
        ("data", "model"), {"data": 1, "model": 1}, {"data": 0, "model": 0})
    assert mesh_num_chips(mesh) == 1 and not mesh.empty
    assert mesh.axis_size(("data", "model")) == 1 and mesh.axis_index("model") == 0
    assert make_graph_mesh(1, device="cpu").axis_names == graph_mesh(
        1, device="cpu").axis_names
    with pytest.raises(ValueError, match="needs 4 ranks"):
        cpu_mesh((2, 2))
    with pytest.raises(ValueError, match="mesh's order"):
        mesh.axes(("model", "data"))
    with pytest.raises(ValueError, match="not in mesh"):
        mesh.group("pod")
    with pytest.raises(RuntimeError, match="needs 256 devices, have 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True, device="cpu")


def test_constrain_returns_its_input_and_checks_the_rank():
    from repro_torch.distributed.sharding import LM_RULES, constrain

    x = torch.ones(2, 3, 4)
    assert constrain(x, None, LM_RULES, "batch", None, None) is x
    mesh = cpu_mesh((1, 1))
    assert constrain(x, mesh, LM_RULES, "batch", None, "vocab") is x
    with pytest.raises(ValueError, match="does not fit a 3-d tensor"):
        constrain(x, mesh, LM_RULES, "batch", None)


# ---------------------------------------------------------------------------
# lookup, layouts, elastic and the pipeline on ranks
# ---------------------------------------------------------------------------


def _inputs():
    r = np.random.default_rng(0)
    return {
        "table": r.normal(size=(64, 8)).astype(np.float32),
        "idx": r.integers(0, 64, (4, 6)).astype(np.int64),
        "w": (r.normal(size=(4, 2, 8, 8)) * 0.3).astype(np.float32),
        "xs": r.normal(size=(6, 5, 8)).astype(np.float32),
        "state": {"a": r.normal(size=(8, 6)).astype(np.float32),
                  "b": [r.normal(size=(6,)).astype(np.float32)]},
        "odd": r.normal(size=(5, 3)).astype(np.float32),
    }


def _layer(x, lp):
    return torch.tanh(x @ lp["w"])


def _lookup(mesh, inp):
    """``sharded_row_gather`` on this rank's rows; returns (values, the
    gathered table gradient of sum(values * weights))."""
    from repro_torch.distributed.sharding import gather_tensor, shard_tensor
    from repro_torch.ops.sharded_lookup import sharded_row_gather

    table = torch.from_numpy(inp["table"])
    block = shard_tensor(table, ("model", None), mesh).requires_grad_(True)
    idx = torch.from_numpy(inp["idx"])
    out = sharded_row_gather(block, idx, mesh, "model")
    wts = torch.arange(out.numel(), dtype=out.dtype).reshape(out.shape)
    (out * wts).sum().backward()
    return out.detach().numpy(), gather_tensor(block.grad, ("model", None), mesh).numpy()


def _pipeline(mesh, inp):
    """``pipeline_apply``'s output and the gathered gradient of
    ``sum(out ** 2)`` with respect to the stacked weights."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import gather_tensor, shard_tensor

    n = mesh.shape["pod"]
    w = torch.from_numpy(inp["w"][:n] if n == 1 else inp["w"])
    block = shard_tensor(w, ("pod",), mesh).requires_grad_(True)
    xs = torch.from_numpy(inp["xs"]).requires_grad_(True)
    out = pipeline_apply(_layer, {"w": block}, xs, mesh, "pod")
    (out ** 2).sum().backward()
    return (out.detach().numpy(), gather_tensor(block.grad, ("pod",), mesh).numpy(),
            xs.grad.numpy())


def _layouts(mesh, inp):
    from repro_torch.distributed.sharding import gather_tree, shard_tree
    from repro_torch.train.elastic import reshard_state

    state = {"a": torch.from_numpy(inp["state"]["a"]),
             "b": [torch.from_numpy(inp["state"]["b"][0])]}
    specs = {"a": ("data", "model"), "b": [("model",)]}
    back = gather_tree(shard_tree(state, specs, mesh), specs, mesh)
    # 5 rows divide over no axis of 2: that dim is replicated
    odd = {"a": torch.from_numpy(inp["state"]["a"]), "odd": torch.from_numpy(inp["odd"])}
    resharded = reshard_state(odd, {"a": ("data", "model"), "odd": ("model", "data")},
                              mesh)
    return ({"a": back["a"].numpy(), "b": back["b"][0].numpy()},
            tuple(resharded["a"].shape), tuple(resharded["odd"].shape))


FP8_CAP = 3


def _fp8_inputs(n):
    """Per rank of ``n``: the dispatch buffer (2n experts, ``FP8_CAP``
    slots, 8 wide; its rows span 1e-3 to 1e3) and the cotangent of the
    exchanged buffer."""
    r = np.random.default_rng(n)
    out = []
    for _ in range(n):
        buf = r.normal(size=(2 * n, FP8_CAP, 8)) * 10.0 ** r.integers(-3, 4, (2 * n, FP8_CAP, 1))
        g = r.normal(size=(2, n * FP8_CAP, 8))
        out.append((buf.astype(np.float32), g.astype(np.float32)))
    return out


def _fp8_exchange(mesh, axes):
    """``moe._Fp8Exchange`` on this rank's buffer: (the exchanged buffer,
    the gradient of ``sum(out * g)`` with respect to the buffer, this
    rank's index over ``axes``)."""
    from repro_torch.models.transformer.moe import _Fp8Exchange

    i = mesh.axis_index(axes)
    buf, g = _fp8_inputs(mesh.axis_size(axes))[i]
    b = torch.from_numpy(buf).requires_grad_(True)
    y = _Fp8Exchange.apply(b, mesh, axes, torch.float8_e4m3fn)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), b.grad.numpy(), i


def _layout_cases(rank, size, inp):
    out = {}
    for shape in {2: [(1, 2), (2, 1)], 4: [(2, 2)]}[size]:
        mesh = cpu_mesh(shape)
        out[f"lookup{shape}"] = _lookup(mesh, inp)
        out[f"layouts{shape}"] = _layouts(mesh, inp)
    fp8 = {2: ((1, 2), ("model",)), 4: ((2, 2), ("data", "model"))}[size]
    out["fp8"] = _fp8_exchange(cpu_mesh(fp8[0]), fp8[1])
    if size == 4:
        out["pipeline"] = _pipeline(cpu_mesh((4,), ("pod",)), inp)
    return out


def _rank_cases(rank, size, payload):
    return _layout_cases(rank, size, payload["layouts"]) | _moe_rank_cases(
        rank, size, payload["moe"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{size: [per-rank results]}`` for 2 and 4 spawned ranks, size 1's
    MoE cases from this process, and ``"moe_ref"``: the reference's."""
    tmp = tmp_path_factory.mktemp("sharding")
    moe_inputs = _moe_inputs()
    proc, out = _start_moe_reference(tmp, moe_inputs)
    try:
        handles = {size: start_ranks(tmp, size, _rank_cases,
                                     {"layouts": _inputs(), "moe": moe_inputs})
                   for size in (2, 4)}
        got = {size: collect(h) for size, h in handles.items()}
        log, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    with open(out, "rb") as f:
        got["moe_ref"] = pickle.load(f)
    got[1] = [_moe_rank_cases(0, 1, moe_inputs)]
    return got


def _want_lookup(inp):
    table = torch.from_numpy(inp["table"])
    idx = torch.from_numpy(inp["idx"])
    want = table[idx]
    grad = torch.zeros_like(table).index_add_(
        0, idx.reshape(-1),
        torch.arange(want.numel(), dtype=table.dtype).reshape(-1, table.shape[1]))
    return want.numpy(), grad.numpy()


@pytest.mark.parametrize("size,dims", [(1, (1, 1)), (2, (1, 2)), (2, (2, 1)),
                                       (4, (2, 2))])
def test_sharded_row_gather_is_a_gather_and_its_grad_index_add(ranks, size, dims):
    inp = _inputs()
    want, want_g = _want_lookup(inp)
    if size == 1:
        per_rank = [_lookup(cpu_mesh(dims), inp)]
    else:
        per_rank = [r[f"lookup{dims}"] for r in ranks[size]]
    for got, got_g in per_rank:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_g, want_g)


@pytest.mark.parametrize("size,dims", [(2, (1, 2)), (2, (2, 1)), (4, (2, 2))])
def test_shard_gather_and_reshard_round_trip(ranks, size, dims):
    inp = _inputs()
    for back, a_shape, odd_shape in (r[f"layouts{dims}"] for r in ranks[size]):
        np.testing.assert_array_equal(back["a"], inp["state"]["a"])
        np.testing.assert_array_equal(back["b"], inp["state"]["b"][0])
        assert a_shape == (8 // dims[0], 6 // dims[1])
        assert odd_shape == (5, 3 // dims[0] if 3 % dims[0] == 0 else 3)


@pytest.mark.parametrize("size", [2, 4])
def test_fp8_exchange_sends_the_payload_and_passes_the_gradient_straight_through(
        ranks, size):
    """The forward is the reference's payload (``moe.py:221-236``): each
    row divided by max|row| / 448 + 1e-12, cast to float8_e4m3fn, and
    multiplied back by the scale sent as bf16. The backward is the
    straight-through gradient that ``_Fp8Exchange`` states (not the
    reference's, which differentiates the casts and the scale): the
    cotangent sent back unquantised, block ``j`` of rank ``r``'s gradient
    being rank ``j``'s cotangent columns of rank ``r``."""
    inputs = _fp8_inputs(size)

    def payload(buf):
        b = torch.from_numpy(buf)
        scale = b.abs().amax(dim=-1, keepdim=True) / 448.0 + 1e-12
        q = (b / scale).to(torch.float8_e4m3fn).float()
        return (q * scale.to(torch.bfloat16).float()).numpy()

    sent = [np.split(payload(buf), size, axis=0) for buf, _ in inputs]
    results = sorted((r["fp8"] for r in ranks[size]), key=lambda t: t[2])
    assert [i for _, _, i in results] == list(range(size))
    for r, (y, grad, _) in enumerate(results):
        np.testing.assert_array_equal(y, np.concatenate([sent[s][r] for s in range(size)], 1))
        own = np.split(inputs[r][0], size, axis=0)[r]
        assert not np.array_equal(y[:, r * FP8_CAP:(r + 1) * FP8_CAP], own)  # quantised
        np.testing.assert_array_equal(grad, np.concatenate(
            [g[:, r * FP8_CAP:(r + 1) * FP8_CAP] for _, g in inputs], 0))


def _sequential(w, xs):
    y = xs
    for s in range(w.shape[0]):
        for layer in range(w.shape[1]):
            y = torch.tanh(y @ w[s, layer])
    return y


@pytest.mark.parametrize("stages", [1, 4])
def test_pipeline_matches_the_sequential_loop_and_the_references_grad(ranks, stages):
    import jax
    import jax.numpy as jnp

    inp = _inputs()
    w_np = inp["w"][:stages]
    if stages == 1:
        per_rank = [_pipeline(cpu_mesh((1,), ("pod",)), inp)]
    else:
        per_rank = [r["pipeline"] for r in ranks[4]]
    w = torch.from_numpy(w_np).requires_grad_(True)
    xs = torch.from_numpy(inp["xs"]).requires_grad_(True)
    want = _sequential(w, xs)
    (want ** 2).sum().backward()

    def jloss(w_):  # the reference's sequential loop, through jax.grad
        y = jnp.asarray(inp["xs"])
        for s in range(w_.shape[0]):
            for layer in range(w_.shape[1]):
                y = jnp.tanh(y @ w_[s, layer])
        return jnp.sum(y ** 2)

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(w_np)))
    for out, gw, gx in per_rank:
        np.testing.assert_allclose(out, want.detach().numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gw, w.grad.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gw, jgrad, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gx, xs.grad.numpy(), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the MoE layer's schedules
# ---------------------------------------------------------------------------

# name -> (arch, mesh shape, (B, S), config changes, dtype, schedule)
MOE_CASES = {
    "mixtral_a2a": ("mixtral-8x7b", (1, 2), (2, 8), {}, "float32", "a2a"),
    "mixtral_a2a_fp8": ("mixtral-8x7b", (1, 2), (2, 8),
                        {"a2a_dtype": "float8_e4m3fn"}, "float32", "a2a"),
    "mixtral_psum": ("mixtral-8x7b", (1, 2), (1, 1), {}, "float32", "psum"),
    "mixtral_expert_tp": ("mixtral-8x7b", (1, 2), (2, 8), {"num_experts": 3},
                          "float32", "expert_tp"),
    "mixtral_expert_tp_dp": ("mixtral-8x7b", (2, 1), (2, 8), {}, "float32",
                             "expert_tp"),
    "mixtral_local_1x1": ("mixtral-8x7b", (1, 1), (2, 8), {}, "float32",
                          "expert_tp"),
    "deepseek_a2a": ("deepseek-v3-671b", (2, 2), (4, 8),
                     {"ep_axes": ("data", "model")}, "float32", "a2a"),
    "deepseek_a2a_fp8_bf16": ("deepseek-v3-671b", (2, 2), (4, 8),
                              {"ep_axes": ("data", "model"),
                               "a2a_dtype": "float8_e4m3fn"}, "bfloat16", "a2a"),
    "deepseek_a2a_data_only": ("deepseek-v3-671b", (2, 1), (2, 8),
                               {"ep_axes": ("data", "model"),
                                "a2a_dtype": "float8_e4m3fn"}, "float32", "a2a"),
    "deepseek_psum_gather": ("deepseek-v3-671b", (2, 2), (2, 1),
                             {"ep_axes": ("data", "model")}, "float32", "psum"),
    # (the psum schedule's bf16 einsums with float32 results do not run in
    # the reference on the CPU: "Unsupported element type for DotThunk")
    "mixtral_expert_tp_bf16": ("mixtral-8x7b", (1, 2), (2, 8), {"num_experts": 3},
                               "bfloat16", "expert_tp"),
    "deepseek_psum_replicated": ("deepseek-v3-671b", (2, 2), (1, 1),
                                 {"ep_axes": ("data", "model")}, "float32", "psum"),
}


def _moe_size(name):
    return int(np.prod(MOE_CASES[name][1]))


def _moe_inputs():
    """Per case: the MoE weights and the input, float32 numpy (bf16 cases
    round the same numbers on both sides)."""
    out = {}
    for i, (name, (arch, _, (b, s), _, _, _)) in enumerate(MOE_CASES.items()):
        cfg = _moe_cfg(name, "port")
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
        r = np.random.default_rng(i)
        w = {"router": r.normal(size=(d, e)) * d ** -0.5,
             "w_gate": r.normal(size=(e, d, f)) * d ** -0.5,
             "w_up": r.normal(size=(e, d, f)) * d ** -0.5,
             "w_down": r.normal(size=(e, f, d)) * f ** -0.5}
        if m.num_shared_experts:
            fs = f * m.num_shared_experts
            w |= {"w_gate_shared": r.normal(size=(d, fs)) * d ** -0.5,
                  "w_up_shared": r.normal(size=(d, fs)) * d ** -0.5,
                  "w_down_shared": r.normal(size=(fs, d)) * fs ** -0.5}
        out[name] = ({k: v.astype(np.float32) for k, v in w.items()},
                     r.normal(size=(b, s, d)).astype(np.float32))
    return out


def _moe_cfg(name, pkg):
    arch, _, _, changes, dtype, _ = MOE_CASES[name]
    if pkg == "port":
        from repro_torch.configs import get_arch
    else:
        from repro.configs import get_arch
    cfg = get_arch(arch).smoke_config
    return dataclasses.replace(cfg, dtype=dtype,
                               moe=dataclasses.replace(cfg.moe, **changes))


def _moe_dp(name):
    """The data axes the reference splits this case's batch over."""
    _, shape, (b, _), _, _, _ = MOE_CASES[name]
    return ("data",) if b % shape[0] == 0 else ()


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _moe_port_case(name, inputs, mesh):
    """(this rank's output block as float32, the schedules that ran, each
    dispatch's kept, this rank's coordinates)."""
    import torch.nn.functional as F

    from repro_torch.configs.lm_family import moe_param_specs
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models.transformer import moe

    cfg = _moe_cfg(name, "port")
    dt = getattr(torch, cfg.dtype)
    w, x = inputs[name]
    full = moe.MoE(cfg, device="cpu", dtype=dt).requires_grad_(False)
    for k, v in w.items():
        getattr(full, k).copy_(torch.from_numpy(v))
    local = shard_tree(full, moe_param_specs(cfg, mesh), mesh)
    dp = _moe_dp(name)
    xb = torch.from_numpy(x).to(dt)
    if dp:
        xb = xb.chunk(mesh.shape["data"])[mesh.coords["data"]]
    ran, kept = [], []
    saved = {s: getattr(moe, s) for s in ("_moe_a2a", "_moe_psum", "_moe_expert_tp",
                                          "_dispatch")}

    def spy(sname):
        def call(*a, **k):
            ran.append(sname)
            return saved[sname](*a, **k)
        return call

    def dispatch(*a, **k):
        out = saved["_dispatch"](*a, **k)
        kept.append(out[2].numpy().copy())
        return out

    try:
        for s in ("_moe_a2a", "_moe_psum", "_moe_expert_tp"):
            setattr(moe, s, spy(s))
        moe._dispatch = dispatch
        with torch.no_grad():
            out = moe.moe_ffn(local, cfg, xb, F.silu, mesh=mesh, dp_axes=dp)
    finally:
        for s, fn in saved.items():
            setattr(moe, s, fn)
    return (out.float().numpy(), ran, kept,
            (mesh.coords["data"], mesh.coords["model"]))


def _moe_rank_cases(rank, size, inputs):
    out = {}
    for name in MOE_CASES:
        if _moe_size(name) == size:
            out[name] = _moe_port_case(name, inputs, cpu_mesh(MOE_CASES[name][1]))
    return out


# ---------------------------------------------------------------------------
# the reference, in one subprocess with 8 fake devices
# ---------------------------------------------------------------------------

_MOE_REF_SCRIPT = """
import pickle, sys
import numpy as np
sys.path.insert(0, {tests!r})
import jax, jax.numpy as jnp
import test_torch_sharding as t
from repro.compat import make_mesh
import repro.models.transformer.moe as jm

with open({inp!r}, "rb") as f:
    inputs = pickle.load(f)
rec = {{}}
orig = jm._dispatch

def spy(tokens, gates, eidx, m, num_experts, capacity):
    out = orig(tokens, gates, eidx, m, num_experts, capacity)
    d, mi = jax.lax.axis_index("data"), jax.lax.axis_index("model")
    jax.debug.callback(
        lambda k, d, mi: rec.setdefault((int(d), int(mi)), []).append(np.asarray(k)),
        out[2], d, mi)
    return out

jm._dispatch = spy
out = {{}}
for name, case in t.MOE_CASES.items():
    cfg = t._moe_cfg(name, "ref")
    shape = case[1]
    mesh = make_mesh(shape, ("data", "model"), devices=jax.devices()[:int(np.prod(shape))])
    w, x = inputs[name]
    dt = jnp.dtype(cfg.dtype)
    p = {{k: jnp.asarray(v, jnp.float32 if k == "router" else dt) for k, v in w.items()}}
    rec.clear()
    y = jax.jit(lambda p, x: jm.moe_ffn(p, cfg, x, jax.nn.silu, mesh=mesh,
                                         dp_axes=("data",)))(p, jnp.asarray(x, dt))
    y = np.asarray(y.astype(jnp.float32))
    jax.effects_barrier()
    out[name] = (y, dict(rec))
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
"""


def _start_moe_reference(tmp, inputs):
    """The reference's sharded ``moe_ffn`` on every case, in a subprocess
    with 8 fake CPU devices; returns (process, output file)."""
    with open(tmp / "moe_inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                   p for p in [os.environ.get("PYTHONPATH")] if p]))
    script = _MOE_REF_SCRIPT.format(tests=str(ROOT / "tests"),
                                    inp=str(tmp / "moe_inputs.pkl"),
                                    out=str(tmp / "moe_ref.pkl"))
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp / "moe_ref.pkl"


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_sharded_moe_matches_the_references_schedule(ranks, name):
    ref = ranks["moe_ref"]
    want, want_kept = ref[name]
    _, shape, (b, _), _, dtype, schedule = MOE_CASES[name]
    tol = MOE_TOL[dtype]
    rms = float(np.sqrt(np.mean(np.square(want))))
    dp = _moe_dp(name)
    for out, ran, kept, (di, mi) in (r[name] for r in ranks[_moe_size(name)]):
        assert ran == [f"_moe_{schedule}"], ran
        rows = b // shape[0] if dp else b
        block = want[di * rows:(di + 1) * rows] if dp else want
        np.testing.assert_allclose(out, block, rtol=tol, atol=tol * rms,
                                   err_msg=f"{name} rank {(di, mi)}")
        ref_kept = want_kept.get((di, mi), [])
        assert len(kept) == len(ref_kept), name
        for k, rk in zip(kept, ref_kept):
            np.testing.assert_array_equal(k, rk, err_msg=name)


def test_the_cases_drop_tokens_and_reach_every_schedule(ranks):
    ref = ranks["moe_ref"]
    dropped = [name for name in MOE_CASES
               if any(not k.all() for ks in ref[name][1].values() for k in ks)]
    assert {"mixtral_a2a", "deepseek_a2a"} <= set(dropped), dropped
    assert {c[5] for c in MOE_CASES.values()} == {"a2a", "psum", "expert_tp"}


def test_a_layout_that_does_not_fit_the_schedule_raises():
    import torch.nn.functional as F

    from repro_torch.models.transformer import moe

    cfg = _moe_cfg("mixtral_a2a", "port")
    full = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    mesh = cpu_mesh((1, 1))
    x = torch.zeros(1, 2, cfg.d_model)
    assert moe.moe_schedule(cfg, None, 2) == "local"
    assert moe.moe_schedule(cfg, mesh, 2) == "expert_tp"
    small = moe.MoE(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, d_ff_expert=cfg.moe.d_ff_expert // 2)), device="cpu")
    with pytest.raises(ValueError, match="expert_tp schedule needs"):
        moe.moe_ffn(small, cfg, x, F.silu, mesh=mesh)
    del full
