"""The port's training slice (``repro_torch.train``) against
``repro.train`` on the CPU: AdamW and int8 compression fed the
reference's gradients (params and moments within 1e-6 after three
steps), ``make_train_step`` with 1 and 4 microbatches, the straggler
watchdog, checkpoints (keep-k, the ``.tmp`` rename, auto-resume, and a
checkpoint the reference wrote restoring in the port, float32 and
bf16), the timer span, and ``train()`` on the qwen3-4b smoke LM and on
GIN."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jax_checkpoint  # noqa: E402
from repro.train import compression as jax_compression  # noqa: E402
from repro.train import loop as jax_loop  # noqa: E402
from repro.train import optimizer as jax_optimizer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.data.lm import lm_batch  # noqa: E402
from repro_torch.models.gnn import gin  # noqa: E402
from repro_torch.models.transformer import init_params, loss_fn  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.train import checkpoint, compression, loop, optimizer, tree  # noqa: E402

STATE_TOL = 1e-6


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "layers": [{"b": rng.normal(size=(5,)).astype(np.float32)},
                       {"b": rng.normal(size=(3,)).astype(np.float32)}]}


def _grads(seed, like):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3).astype(np.float32), like)


def _torch_tree(t, dtype=torch.float32):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x, dtype=np.float32), dtype=dtype), t)


def _close(got_tree, want_tree, tol=STATE_TOL):
    got = tree.named_leaves(got_tree)
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(got) == len(want)
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, dtype=np.float32),
                                   rtol=tol, atol=tol, err_msg=tree.leaf_name(path))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_the_reference_on_its_gradients(moment_dtype):
    # Warm-up of 2 and a short cosine, a clip that binds on some steps,
    # decoupled decay: three steps on the reference's gradients.
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=4.0,
                  moment_dtype=moment_dtype)
    jcfg = jax_optimizer.AdamWConfig(**cfg_kw)
    cfg = optimizer.AdamWConfig(**cfg_kw)
    jp = _params()
    jopt = jax_optimizer.init_opt_state(jp, jcfg)
    p = _torch_tree(jp)
    opt = optimizer.init_opt_state(p, cfg)
    for step in range(3):
        g = _grads(10 + step, jp)
        jp, jopt, jm = jax_optimizer.adamw_update(g, jopt, jp, jcfg)
        p, opt, m = optimizer.adamw_update(_torch_tree(g), opt, p, cfg)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(opt["step"]) == int(jopt["step"]) == 3
    assert opt["m"]["w"].dtype == getattr(torch, moment_dtype)
    _close(p, jp)
    _close(opt["m"], jopt["m"])
    _close(opt["v"], jopt["v"])


def test_adamw_updates_bf16_parameters_through_float32_and_in_chunks(monkeypatch):
    # A bf16 leaf is upcast, updated and cast back; the chunked update
    # (forced to 7 elements a chunk) gives the reference's numbers.
    monkeypatch.setattr(optimizer, "CHUNK", 7)
    cfg_kw = dict(lr=3e-2, warmup_steps=1, total_steps=10)
    jcfg, cfg = jax_optimizer.AdamWConfig(**cfg_kw), optimizer.AdamWConfig(**cfg_kw)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), _params(1))
    jopt = jax_optimizer.init_opt_state(jp, jcfg)
    p = jax.tree.map(lambda x: torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16), jp)
    opt = optimizer.init_opt_state(p, cfg)
    for step in range(3):
        g = _grads(20 + step, _params(1))
        jp, jopt, _ = jax_optimizer.adamw_update(
            jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g), jopt, jp, jcfg)
        p, opt, _ = optimizer.adamw_update(_torch_tree(g, torch.bfloat16), opt, p, cfg)
    assert p["w"].dtype == torch.bfloat16
    _close(p, jp, tol=1e-2)  # one bf16 rounding of each parameter
    _close(opt["m"], jopt["m"])
    _close(opt["v"], jopt["v"])


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5_000, 10_000, 20_000])
def test_learning_rate_schedule_matches_the_reference(step):
    cfg, jcfg = optimizer.AdamWConfig(), jax_optimizer.AdamWConfig()
    got = optimizer._lr_at(cfg, torch.tensor(float(step)))
    want = jax_optimizer._lr_at(jcfg, jnp.float32(step))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_grad_clipping_bounds_the_update():
    params = {"w": torch.zeros(3)}
    cfg = optimizer.AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0, warmup_steps=1)
    opt = optimizer.init_opt_state(params, cfg)
    p2, _, m = optimizer.adamw_update({"w": torch.full((3,), 1e9)}, opt, params, cfg)
    assert float(m["grad_norm"]) > 1e8
    assert float(p2["w"].abs().max()) < 10.0


def test_quantize_int8_matches_the_reference():
    x = np.random.default_rng(1).normal(size=1000).astype(np.float32)
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jax_compression.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    err = float((compression.dequantize_int8(q, s) - torch.from_numpy(x)).abs().max())
    assert err <= float(s) * 0.51 + 1e-9


def test_compress_decompress_matches_the_reference_over_steps():
    jp = _params(2)
    jef = jax_compression.init_error_feedback(jp)
    ef = compression.init_error_feedback(_torch_tree(jp))
    for step in range(3):
        g = _grads(30 + step, jp)
        jg, jef = jax_compression.compress_decompress(g, jef)
        got, ef = compression.compress_decompress(_torch_tree(g), ef)
        _close(got, jg)
        _close(ef, jef)


def _regression():
    r = np.random.default_rng(2)
    return {"x": r.normal(size=(8, 3)).astype(np.float32),
            "y": r.normal(size=(8,)).astype(np.float32)}


@pytest.mark.parametrize("num_microbatches", [1, 4])
@pytest.mark.parametrize("grad_compression", [False, True])
def test_train_step_matches_the_reference(num_microbatches, grad_compression):
    batch = _regression()
    w0 = np.random.default_rng(3).normal(size=3).astype(np.float32)
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1)

    def jloss(params, b):
        return jnp.mean((b["x"] @ params["w"] - b["y"]) ** 2)

    def tloss(params, b):
        x, y = torch.from_numpy(b["x"]), torch.from_numpy(b["y"])
        return torch.mean((x @ params["w"] - y) ** 2)

    jstep = jax_loop.make_train_step(jloss, jax_optimizer.AdamWConfig(**cfg_kw),
                                     num_microbatches=num_microbatches,
                                     grad_compression=grad_compression)
    tstep = loop.make_train_step(tloss, optimizer.AdamWConfig(**cfg_kw),
                                 num_microbatches=num_microbatches,
                                 grad_compression=grad_compression)
    jp = {"w": jnp.asarray(w0)}
    jopt = jax_optimizer.init_opt_state(jp, jax_optimizer.AdamWConfig(**cfg_kw))
    jef = jax_compression.init_error_feedback(jp) if grad_compression else None
    p = {"w": torch.from_numpy(w0.copy())}
    opt = optimizer.init_opt_state(p, optimizer.AdamWConfig(**cfg_kw))
    ef = compression.init_error_feedback(p) if grad_compression else None
    for _ in range(3):
        jp, jopt, jef, jm = jstep(jp, jopt, jef, {k: jnp.asarray(v) for k, v in batch.items()})
        p, opt, ef, m = tstep(p, opt, ef, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)
    _close(p, jp)
    _close(opt["m"], jopt["m"])
    _close(opt["v"], jopt["v"])


def test_microbatches_accumulate_bf16_grads_in_float32():
    # Four microbatches of a bf16 model: the step's gradient is the mean
    # of the four, summed in float32 (the parameters' bf16 .grad would
    # round each partial sum), equal to the float32 sum of the
    # microbatches' own gradients.
    batch = _regression()
    w = torch.tensor([0.5, -1.0, 2.0], dtype=torch.bfloat16, requires_grad=True)

    def tloss(params, b):
        x, y = torch.from_numpy(b["x"]).to(torch.bfloat16), torch.from_numpy(b["y"])
        return torch.mean(((x @ params["w"]).float() - y) ** 2)

    loss, (g,) = loop.value_and_grads(tloss, {"w": w}, batch, num_microbatches=4)
    parts = [loop.value_and_grads(tloss, {"w": w}, loop.microbatch(batch, i, 4))
             for i in range(4)]
    assert g.dtype == torch.float32
    torch.testing.assert_close(g, sum(p[1][0].float() for p in parts) / 4, rtol=0, atol=0)
    torch.testing.assert_close(loss, sum(p[0] for p in parts) / 4, rtol=0, atol=0)


def test_straggler_watchdog_flags_slow_steps():
    for wd in (loop.StragglerWatchdog(factor=3.0), jax_loop.StragglerWatchdog(factor=3.0)):
        for i in range(10):
            wd.observe(i, 0.1)
        assert wd.observe(10, 1.0)
        assert wd.slow_steps and wd.slow_steps[0][0] == 10
        assert not wd.observe(11, 0.12)


def test_timer_span_times_with_tracing_off():
    assert not trace.enabled()
    assert trace.span("x") is trace.span("y")  # the shared no-op span
    with trace.span("train.step", device=True, timer=True, step=0) as sp:
        sp.block_on(torch.ones(3).sum())
        total = sum(range(20_000))
    assert total > 0 and sp.duration > 0
    assert trace.chrome_trace()["traceEvents"] == [] or all(
        e["name"] != "train.step" for e in trace.chrome_trace()["traceEvents"])


# --- checkpoints ------------------------------------------------------------


def _state(dtype=torch.float32):
    return {"params": {"w": torch.arange(6.0).reshape(2, 3).to(dtype)},
            "opt_state": {"step": torch.tensor(7, dtype=torch.int32),
                          "m": {"w": torch.ones((2, 3))}}}


def test_checkpoint_roundtrip_keep_k_and_the_tmp_rename(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "step_000000030.tmp")  # a save cut off earlier
    (tmp_path / "step_000000030.tmp" / "junk.npy").write_bytes(b"x")
    state = _state(torch.bfloat16)
    for step in (10, 20, 30):
        mgr.save(step, state)  # async, one in flight
    mgr.wait()
    assert mgr.list_steps() == [20, 30] and mgr.latest_step() == 30
    assert sorted(os.listdir(tmp_path)) == ["step_000000020", "step_000000030"]
    files = sorted(os.listdir(tmp_path / "step_000000030"))
    assert files == ["meta.json", "opt_state__m__w.npy", "opt_state__step.npy",
                     "params__w.npy"]
    meta = json.loads((tmp_path / "step_000000030" / "meta.json").read_text())
    assert meta["step"] == 30 and meta["sharding"] == "replicated"
    restored = mgr.restore(30, state)
    for (path, got), (_, want) in zip(tree.named_leaves(restored), tree.named_leaves(state)):
        assert got.dtype == want.dtype, path
        assert torch.equal(got, want), path
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(30, {"params": {"w": torch.zeros(3, 3)},
                         "opt_state": state["opt_state"]})


def test_async_save_copies_the_state_before_it_returns(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(1, state)
    state["params"]["w"].add_(100)  # the training step updates in place
    mgr.wait()
    assert float(mgr.restore(1, state)["params"]["w"].max()) == 5.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_checkpoint_the_reference_wrote_restores_in_the_port(tmp_path, dtype):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    jstate = {"params": {"w": jnp.asarray(w, getattr(jnp, dtype)),
                         "layers": [{"b": jnp.arange(3.0)}]},
              "opt_state": {"step": jnp.int32(12), "m": {"w": jnp.ones((4, 5))}}}
    jax_checkpoint.CheckpointManager(str(tmp_path)).save(12, jstate, blocking=True)
    like = {"params": {"w": torch.zeros(4, 5, dtype=getattr(torch, dtype)),
                       "layers": [{"b": torch.zeros(3)}]},
            "opt_state": {"step": torch.zeros((), dtype=torch.int32),
                          "m": {"w": torch.zeros(4, 5)}}}
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 12
    got = mgr.restore(12, like)
    want = jax.tree.map(lambda x: np.asarray(x, np.float32), jstate)
    assert got["params"]["w"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got["params"]["w"].float().numpy(), want["params"]["w"])
    np.testing.assert_array_equal(got["params"]["layers"][0]["b"].numpy(), [0, 1, 2])
    assert int(got["opt_state"]["step"]) == 12
    # And the port writes the reference's file names.
    mgr.save(13, like, blocking=True)
    assert sorted(os.listdir(tmp_path / "step_000000013")) == sorted(
        os.listdir(tmp_path / "step_000000012"))


def _quadratic():
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32))
    return (lambda p, b: torch.mean((p["w"] - target) ** 2)), target


def test_train_resumes_from_the_newest_checkpoint(tmp_path):
    # Preempted after 6 of 8 steps (checkpoints every 3): the restart
    # resumes at step 6, and ends bit-equal to an uninterrupted run.
    loss, _ = _quadratic()
    data = iter(lambda: {}, None)
    opt_cfg = optimizer.AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=1)

    def run(total, directory):
        params = {"w": torch.zeros(8, 4)}
        cfg = loop.LoopConfig(total_steps=total, checkpoint_every=3,
                              checkpoint_dir=str(directory), log_every=100)
        return loop.train(params, loss, data, opt_cfg, cfg)

    _, first = run(6, tmp_path / "a")
    assert len(first["history"]) == 6
    resumed, second = run(8, tmp_path / "a")
    assert [h["step"] for h in second["history"]] == [6, 7]
    straight, _ = run(8, tmp_path / "b")
    assert torch.equal(resumed["w"], straight["w"])
    assert checkpoint.CheckpointManager(str(tmp_path / "a")).list_steps() == [3, 6, 8]


def test_train_on_the_smoke_lm_lowers_the_loss():
    cfg = get_arch("qwen3-4b").smoke_config
    params = init_params(cfg, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    batch = lm_batch(2, 16, cfg.vocab_size, seed=0)
    opt_cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    _, out = loop.train(params, lambda p, b: loss_fn(p, cfg, b), iter(lambda: batch, None),
                        opt_cfg, loop.LoopConfig(total_steps=6, log_every=100))
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    assert all(p.requires_grad for p in params.parameters())


def test_train_gin_with_compression_lowers_the_loss():
    cfg = dataclasses.replace(get_arch("gin-tu").smoke_config, readout="node")
    params = gin.init_params(cfg, device="cpu")
    g = graphs.full_graph(100, 500, cfg.in_dim, cfg.num_classes, seed=2)
    opt_cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    _, out = loop.train(params, lambda p, b: gin.loss_fn(p, cfg, b), iter(lambda: g, None),
                        opt_cfg, loop.LoopConfig(total_steps=5, grad_compression=True,
                                                 log_every=100))
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert out["final_loss"] == losses[-1]
