"""The port's MoE layer and the mixtral model on the CPU against
``repro``'s: capacity, routing and both dispatches bit for bit (fed the
reference's own gates and expert ids), the combine, ``moe_ffn_local``,
mixtral-smoke's ``forward``, ``serve_step`` and ``prefill``, and the
LM token stream (``data/lm.py``) bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data.lm import lm_batch as jax_lm_batch  # noqa: E402
from repro.data.lm import lm_iterator as jax_lm_iterator  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.models.transformer import init_params as jax_init_params  # noqa: E402
from repro.models.transformer import moe as jax_moe  # noqa: E402
from repro.models.transformer import prefill as jax_prefill  # noqa: E402
from repro.models.transformer import serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import lm_batch, lm_iterator  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import forward, prefill, serve_step  # noqa: E402
from repro_torch.models.transformer import moe  # noqa: E402
from repro_torch.models.transformer.convert import (  # noqa: E402
    params_from_jax,
    to_tensor,
)

TOL = {"float32": 2e-3, "bfloat16": 3e-2}
MOE_ARCHS = ["mixtral-8x7b", "deepseek-v3-671b"]


def _moe_cfg(name, dtype="float32", full=False, **moe_changes):
    """The smoke (or full-width) config of ``name`` in both packages,
    with ``dtype`` and ``moe`` fields changed."""
    pair = []
    for get in (jax_get_arch, get_arch):
        arch = get(name)
        cfg = arch.config if full else arch.smoke_config
        cfg = dataclasses.replace(cfg, dtype=dtype,
                                  moe=dataclasses.replace(cfg.moe, **moe_changes))
        pair.append(cfg)
    return pair


def _tokens_in(seed, t, d, dtype):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=(t, d)), jnp.dtype(dtype))
    return x, to_tensor(np.asarray(x))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else (
        x.float().numpy())


@pytest.mark.parametrize("t,k,e,cf", [
    (1, 2, 8, 1.25), (8, 2, 8, 1.25), (8192, 2, 8, 1.25), (4096, 8, 256, 1.25),
    (16, 8, 256, 8.0), (3, 2, 4, 1.0), (100, 1, 7, 0.3),
])
def test_capacity_matches_reference(t, k, e, cf):
    m = get_arch("mixtral-8x7b").config.moe
    m = dataclasses.replace(m, top_k=k, num_experts=e, capacity_factor=cf)
    assert moe._capacity(t, m, e) == jax_moe._capacity(t, m, e)


@pytest.mark.parametrize("name,full", [("mixtral-8x7b", False),
                                       ("deepseek-v3-671b", False),
                                       ("deepseek-v3-671b", True)])
def test_route_matches_reference(name, full):
    """Expert ids bit for bit, gates within 1e-6. The router's float32
    product may round differently in the two packages' BLAS, so the
    smallest gap between the k-th and (k+1)-th probability is printed:
    a flipped expert would show as a near-tie there, not as a fault."""
    jcfg, cfg = _moe_cfg(name, full=full)
    d, m = cfg.d_model, cfg.moe
    r = np.random.default_rng(7)
    router = (r.normal(size=(d, m.num_experts)) * d ** -0.5).astype(np.float32)
    jx, x = _tokens_in(8, 64, d, "float32")
    jg, je = jax_moe._route(jx, jnp.asarray(router), jcfg.moe)
    g, e = moe._route(x, torch.from_numpy(router), m)
    probs = np.sort(np.asarray(jax.nn.softmax(jx @ router, axis=-1)), axis=-1)[:, ::-1]
    gap = float((probs[:, m.top_k - 1] - probs[:, m.top_k]).min()) if (
        m.top_k < m.num_experts) else float("inf")
    print(f"{name} full={full}: smallest k-th/(k+1)-th probability gap {gap}")
    assert e.dtype == torch.int32
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


def _ref_routing(jcfg, seed, t, dtype):
    d, m = jcfg.d_model, jcfg.moe
    router = jnp.asarray(np.random.default_rng(seed).normal(
        size=(d, m.num_experts)) * d ** -0.5, jnp.float32)
    jx, x = _tokens_in(seed + 1, t, d, dtype)
    jg, je = jax_moe._route(jx, router, m)
    return jx, x, jg, je


@pytest.mark.parametrize("dispatch", ["sorted_ep", "unsorted"])
@pytest.mark.parametrize("cf", [1.0, 1.25])
@pytest.mark.parametrize("name,full,t", [("mixtral-8x7b", False, 40),
                                         ("deepseek-v3-671b", False, 40),
                                         ("deepseek-v3-671b", True, 96)])
def test_dispatch_matches_reference_bit_for_bit(dispatch, cf, name, full, t):
    """Fed the reference's own gates and ids: the buffer, slots, kept
    mask, rows' tokens and gates, and so the drops, bit for bit."""
    jcfg, cfg = _moe_cfg(name, "bfloat16", full=full, dispatch=dispatch,
                         capacity_factor=cf)
    m = cfg.moe
    jx, x, jg, je = _ref_routing(jcfg, 3, t, "bfloat16")
    cap = jax_moe._capacity(t, jcfg.moe, m.num_experts)
    want = jax_moe._dispatch(jx, jg, je, jcfg.moe, m.num_experts, cap)
    got = moe._dispatch(x, to_tensor(np.asarray(jg)), to_tensor(
        np.asarray(je)), m, m.num_experts, cap)
    for name_, w, g in zip(("buffer", "slot", "kept", "tok", "gate"), want, got):
        np.testing.assert_array_equal(_np(g) if g.dtype.is_floating_point
                                      else g.numpy(), np.asarray(w), err_msg=name_)
    drops = int((~got[2]).sum())
    print(f"{name} {dispatch} cf={cf}: capacity {cap}, dropped {drops} of {t * m.top_k}")
    if cf == 1.0:
        assert drops > 0, "capacity_factor 1.0 drops some copies on these tokens"


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_sorted_and_unsorted_dispatch_drop_the_same_copies(name):
    _, cfg = _moe_cfg(name, capacity_factor=1.0)
    m = cfg.moe
    jx, x, jg, je = _ref_routing(_moe_cfg(name)[0], 5, 48, "float32")
    g, e = to_tensor(np.asarray(jg)), to_tensor(np.asarray(je))
    cap = moe._capacity(48, m, m.num_experts)
    s = moe._dispatch(x, g, e, m, m.num_experts, cap)
    u = moe._dispatch(x, g, e, dataclasses.replace(m, dispatch="unsorted"),
                      m.num_experts, cap)
    kept_sorted = torch.zeros_like(u[2])
    kept_sorted[s[5]] = s[2]  # back to token-major order
    assert torch.equal(kept_sorted, u[2]) and not bool(u[2].all())
    assert torch.equal(s[0], u[0])
    with pytest.raises(ValueError, match="unknown dispatch"):
        moe._dispatch(x, g, e, dataclasses.replace(m, dispatch="scatter"),
                      m.num_experts, cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["sorted_ep", "unsorted"])
@pytest.mark.parametrize("name,full,t", [("mixtral-8x7b", False, 40),
                                         ("deepseek-v3-671b", True, 96)])
def test_combine_matches_reference(dtype, dispatch, name, full, t):
    """The combine on the reference's dispatch: through ``segment_sum``
    over token-major rows. float32 within 1e-6. bf16 with top_k = 2 bit
    for bit (a sum of two rounded once either way). With top_k = 8 the
    port sums in float32 and rounds once, so it is within one bf16
    rounding (2^-8 relative) of the exact sum of the reference's rounded
    contributions; the reference adds in bf16 and rounds each of its 7
    partial sums, each by up to 2^-9 of the sum of the magnitudes, so
    the two differ by at most 8 * 2^-9 of that sum, token by token."""
    jcfg, cfg = _moe_cfg(name, dtype, full=full, dispatch=dispatch,
                         capacity_factor=1.0)
    m = cfg.moe
    jx, x, jg, je = _ref_routing(jcfg, 11, t, dtype)
    cap = jax_moe._capacity(t, jcfg.moe, m.num_experts)
    jb, jslot, jkept, jtok, jgate = jax_moe._dispatch(
        jx, jg, je, jcfg.moe, m.num_experts, cap)
    order = moe._dispatch(x, to_tensor(np.asarray(jg)), to_tensor(
        np.asarray(je)), m, m.num_experts, cap)[5]
    rows = jnp.asarray(np.random.default_rng(12).normal(size=jb.shape), jb.dtype)
    want = np.asarray(jax_moe._combine(rows, jslot, jkept, jtok, jgate, t, jx.dtype),
                      np.float32)
    got = moe._combine(to_tensor(np.asarray(rows)), to_tensor(np.asarray(jslot)),
                       to_tensor(np.asarray(jkept)),
                       to_tensor(np.asarray(jtok)),
                       to_tensor(np.asarray(jgate)), t, x.dtype, order)
    assert got.dtype == x.dtype and tuple(got.shape) == (t, cfg.d_model)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        return
    if m.top_k == 2:
        np.testing.assert_array_equal(_np(got), want)
        return
    # The reference's contributions, rounded to bf16 as it rounds them.
    flat = rows.reshape(-1, rows.shape[-1])
    contrib = np.asarray(jnp.where(jkept[:, None], flat[jnp.clip(jslot, 0, flat.shape[0] - 1)],
                                   0.0) * jgate[:, None].astype(rows.dtype), np.float64)
    exact, mags = np.zeros((t, cfg.d_model)), np.zeros((t, cfg.d_model))
    np.add.at(exact, np.asarray(jtok), contrib)
    np.add.at(mags, np.asarray(jtok), np.abs(contrib))
    assert np.all(np.abs(_np(got) - exact) <= 2 ** -8 * np.abs(exact) + 1e-30)
    assert np.all(np.abs(_np(got) - want) <= 8 * 2 ** -9 * mags + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["sorted_ep", "unsorted"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_ffn_local_matches_reference(dtype, dispatch, name):
    jcfg, cfg = _moe_cfg(name, dtype, dispatch=dispatch)
    jparams = jax_init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["moe_layers"]["moe"])
    p = params.moe_layers[0].moe
    x = jnp.asarray(np.random.default_rng(2).normal(size=(2, 20, cfg.d_model)),
                    jnp.dtype(dtype))
    with jax.disable_jit():
        want = jax_moe.moe_ffn_local(jp, jcfg, x, jax_common.activation_fn("silu"))
    got = moe.moe_ffn_local(p, cfg, to_tensor(np.asarray(x)), common.activation_fn("silu"))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_moe_mesh_raises_naming_item_16():
    # The sharded schedules came with item 16: on a one-rank mesh the
    # layer runs expert TP with the meshless capacity, bit for bit the
    # meshless layer; a weight layout that does not fit the schedule
    # raises (tests/test_torch_sharding.py holds every schedule).
    _, cfg = _moe_cfg("mixtral-8x7b")
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import init_params

    params = init_params(cfg, device="cpu")
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(0))
    mesh = make_test_mesh((1, 1), device="cpu")
    layer = params.moe_layers[0].moe
    assert moe.moe_schedule(cfg, mesh, 4) == "expert_tp"
    torch.testing.assert_close(moe.moe_ffn(layer, cfg, x, torch.relu, mesh=mesh),
                               moe.moe_ffn(layer, cfg, x, torch.relu), rtol=0, atol=0)
    assert moe.moe_ffn(layer, cfg, x, torch.relu).shape == x.shape


def _model_pair(name, dtype="float32", **moe_changes):
    jcfg, cfg = _moe_cfg(name, dtype, **moe_changes)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _toks(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixtral_forward_matches_reference(dtype):
    """float32 at 2e-3; bf16 at 3e-2 against the reference op by op
    (its jitted bf16 forward fuses and keeps float32 intermediates)."""
    jcfg, jparams, cfg, params = _model_pair("mixtral-8x7b", dtype)
    toks = _toks(cfg, 2, 24)
    with jax.disable_jit():
        want = np.asarray(jax_forward(jparams, jcfg, jnp.asarray(toks)), np.float32)
    got = forward(params, cfg, toks)
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


def test_mixtral_serve_step_and_prefill_match_reference():
    """20 tokens through mixtral-smoke's 8-row window ring; with
    capacity_factor 8, as the reference's own equivalence test, no token
    is dropped, so the decode also agrees with ``forward``."""
    jcfg, jparams, cfg, params = _model_pair("mixtral-8x7b", capacity_factor=8.0)
    toks = _toks(cfg, 2, 20, seed=1)
    jlogits, jcache = jax_prefill(jparams, jcfg, jnp.asarray(toks), 32)
    logits, cache = prefill(params, cfg, toks, 32)
    assert set(cache) == {"moe"} and cache["moe"]["k"].shape[2] == 8
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-3, atol=2e-3)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache["moe"][kv].numpy(),
                                   np.asarray(jcache["moe"][kv]), rtol=2e-3, atol=2e-3)
    jl, _ = jax_serve_step(jparams, jcfg, jcache, jnp.asarray(toks[:, :1]), jnp.int32(20))
    tl, _ = serve_step(params, cfg, cache, toks[:, :1], 20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3)
    full = forward(params, cfg, toks)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b,s,vocab,seed,step", [
    (2, 24, 512, 0, 0), (3, 17, 32000, 1, 5), (1, 4096, 129280, 0, 0),
])
def test_lm_batch_is_bit_for_bit_the_reference(b, s, vocab, seed, step):
    want = jax_lm_batch(b, s, vocab, seed=seed, step=step)
    got = lm_batch(b, s, vocab, seed=seed, step=step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


def test_lm_iterator_prefetches_the_reference_batches():
    it, jit_ = lm_iterator(2, 8, 512, seed=3), jax_lm_iterator(2, 8, 512, seed=3)
    try:
        for _ in range(3):
            a, b = next(it), next(jit_)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    finally:
        it.close()
        jit_.close()


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_bfloat16_prefill_matches_reference(name):
    """``prefill`` (``serve_step`` token by token) in bf16 against the
    reference's op by op, at 3e-2: mixtral-smoke's window ring and
    deepseek-smoke's compressed MLA cache, at the published capacity
    factor (each step's tokens compete for experts in both)."""
    jcfg, jparams, cfg, params = _model_pair(name, "bfloat16")
    toks = _toks(cfg, 2, 10, seed=2)  # past mixtral-smoke's 8-row window
    with jax.disable_jit():
        jlogits, _ = jax_prefill(jparams, jcfg, jnp.asarray(toks), 12)
    logits, _ = prefill(params, cfg, toks, 12)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), rtol=3e-2, atol=3e-2)
