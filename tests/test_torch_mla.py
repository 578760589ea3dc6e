"""The port's MLA attention, the MTP head and the deepseek-v3 model on the
CPU against ``repro``'s: ``_mla_qkv``, the expanded prefill (through the
flash_attention wrapper's plain route at a value head dim apart from the
query/key one) and the absorbed decode, ``_mtp_logits``, deepseek-smoke's
``forward``, ``serve_step`` and ``prefill``, ``params_from_jax`` bit for
bit in bf16, and the wrapper's (D, Dv) argument checks."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_attention_ref,
)
from repro.models.transformer import attention as jax_attention  # noqa: E402
from repro.models.transformer import model as jax_model  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.models.transformer import init_params as jax_init_params  # noqa: E402
from repro.models.transformer import prefill as jax_prefill  # noqa: E402
from repro.models.transformer import serve_step as jax_serve_step  # noqa: E402
from repro.distributed.sharding import ShardingRules  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    SPLIT_HEAD_DIMS,
    _empty_out,
    check_kernel_inputs,
)
from repro_torch.models.transformer import attention  # noqa: E402
from repro_torch.models.transformer import forward, hidden_states, init_params  # noqa: E402
from repro_torch.models.transformer import model, prefill, serve_step  # noqa: E402
from repro_torch.models.transformer.convert import (  # noqa: E402
    params_from_jax,
    to_tensor,
)

TOL = {"float32": 2e-3, "bfloat16": 3e-2}
NAME = "deepseek-v3-671b"


def _pair(dtype="float32", **moe_changes):
    """deepseek-v3's smoke config in both packages and the reference's
    init carried over."""
    cfgs = []
    for get in (jax_get_arch, get_arch):
        cfg = get(NAME).smoke_config
        cfgs.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe_changes)))
    jcfg, cfg = cfgs
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def _toks(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _layer0(jparams, params):
    jp = jax.tree.map(lambda a: a[0], jparams["dense_layers"]["attn"])
    return jp, params.dense_layers[0].attn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_qkv_and_prefill_match_reference(dtype):
    jcfg, jparams, cfg, params = _pair(dtype)
    jp, p = _layer0(jparams, params)
    jx = jnp.asarray(np.random.default_rng(1).normal(size=(2, 20, cfg.d_model)),
                     jnp.dtype(dtype))
    x = to_tensor(np.asarray(jx))
    jpos = jnp.broadcast_to(jnp.arange(20, dtype=jnp.int32)[None], (2, 20))
    pos = model._positions(2, 20, "cpu")
    with jax.disable_jit():
        want_qkv = jax_attention._mla_qkv(jp, jcfg, jx, jpos)
        want = jax_attention.mla_attention(jp, jcfg, jx, jpos)
    for w, g in zip(want_qkv, attention._mla_qkv(p, cfg, x, pos)):
        assert tuple(g.shape) == w.shape
        _close(g, w, dtype)
    got = attention.mla_attention(p, cfg, x, pos)
    assert got.dtype == x.dtype and tuple(got.shape) == (2, 20, cfg.d_model)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 5, 15])
def test_mla_decode_matches_reference(dtype, pos):
    """The absorbed-matmul decode over a compressed cache whose first
    ``pos`` rows are filled; the new entries written at ``pos``."""
    jcfg, jparams, cfg, params = _pair(dtype)
    jp, p = _layer0(jparams, params)
    r = np.random.default_rng(pos)
    dt = jnp.dtype(dtype)
    jx = jnp.asarray(r.normal(size=(3, 1, cfg.d_model)), dt)
    ckv = np.zeros((3, 16, cfg.kv_lora_rank), np.float32)
    krope = np.zeros((3, 16, cfg.qk_rope_head_dim), np.float32)
    ckv[:, :pos] = r.normal(size=(3, pos, cfg.kv_lora_rank))
    krope[:, :pos] = r.normal(size=(3, pos, cfg.qk_rope_head_dim))
    jckv, jkrope = jnp.asarray(ckv, dt), jnp.asarray(krope, dt)
    with jax.disable_jit():
        want, wckv, wkrope = jax_attention.mla_decode(jp, jcfg, jx, jckv, jkrope,
                                                      jnp.int32(pos))
    tckv, tkrope = to_tensor(np.asarray(jckv)), to_tensor(np.asarray(jkrope))
    got, gckv, gkrope = attention.mla_decode(p, cfg, to_tensor(np.asarray(jx)),
                                             tckv, tkrope, pos)
    assert gckv is tckv and gkrope is tkrope  # written in place
    _close(got, want, dtype)
    _close(gckv, wckv, dtype)
    _close(gkrope, wkrope, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mtp_logits_match_reference(dtype):
    jcfg, jparams, cfg, params = _pair(dtype)
    toks = _toks(cfg, 2, 16, seed=4)
    jx = jnp.asarray(np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)),
                     jnp.dtype(dtype))
    with jax.disable_jit():
        want = jax_model._mtp_logits(jparams, jcfg, jx, jnp.asarray(toks), None,
                                     ShardingRules())
    got = model._mtp_logits(params, cfg, to_tensor(np.asarray(jx)), toks)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 16, cfg.vocab_size)
    _close(got, want, dtype)
    from repro_torch.launch.mesh import make_test_mesh

    on_mesh = model._mtp_logits(params, cfg, to_tensor(np.asarray(jx)), toks,
                                mesh=make_test_mesh((1, 1), device="cpu"))
    torch.testing.assert_close(on_mesh, got, rtol=0, atol=0)


def test_deepseek_forward_float32_matches_reference():
    jcfg, jparams, cfg, params = _pair()
    toks = _toks(cfg, 2, 24)
    want = np.asarray(jax_forward(jparams, jcfg, jnp.asarray(toks)))
    got = forward(params, cfg, toks)
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    # The trunk the MTP head reads is forward's, before the final norm.
    np.testing.assert_array_equal(
        model._logits(params, cfg, hidden_states(params, cfg, toks)).numpy(), got.numpy())


def test_deepseek_forward_bfloat16_matches_reference():
    """Each layer at 3e-2 on the reference's own op-by-op input to it;
    then the whole bf16 forward. Through the layers the two packages'
    float32 rms_norm (mean and rsqrt of XLA and of torch on the CPU round
    differently in the last bit) turn a few bf16 activations by one
    rounding, and MLA's extra low-rank norms and the MoE's routing carry
    them on: a handful of the 24,576 logits (4 on these tokens) land past
    3e-2 of the op-by-op reference. So the whole forward is held
    normwise at 3e-2, with the argmax wherever the reference's top-2
    margin exceeds 6e-2 (as the dense archs' bf16 logits test), and the
    count past the elementwise tolerance printed."""
    jcfg, jparams, cfg, params = _pair("bfloat16")
    toks = _toks(cfg, 2, 24)
    b, s = toks.shape
    rules = ShardingRules()
    with jax.disable_jit():
        jx = jax_model._embed_lookup(jparams, jcfg, jnp.asarray(toks), None, rules)
        jpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
        for group, i, layer in params.layers():
            stack = jparams[f"{group}_layers"]
            jl = jax.tree.map(lambda a: a[i], stack)
            want = jax_model._layer_fwd(jcfg, None, rules, group == "moe")(jx, jl, jpos)
            got = model._layer_fwd(layer, cfg, to_tensor(np.asarray(jx)),
                                   model._positions(b, s, "cpu"))
            _close(got, want, "bfloat16")
            jx = want
        ref = np.asarray(jax_forward(jparams, jcfg, jnp.asarray(toks)), np.float32)
    got = forward(params, cfg, toks).numpy()
    over = int((np.abs(got - ref) > 3e-2 + 3e-2 * np.abs(ref)).sum())
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"deepseek-smoke bf16 forward: max |diff| {np.abs(got - ref).max()}, "
          f"normwise {rel}, {over} of {ref.size} past 3e-2 elementwise")
    assert rel < 3e-2
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 6e-2
    assert sure.sum() >= ref.shape[0] * ref.shape[1] // 4
    np.testing.assert_array_equal(got.argmax(-1)[sure], ref.argmax(-1)[sure])


def test_deepseek_serve_step_and_prefill_match_reference():
    """With capacity_factor 8 (the reference's own equivalence test) the
    decode drops no token, so it also agrees with ``forward``: the
    absorbed decode against the expanded prefill."""
    jcfg, jparams, cfg, params = _pair(capacity_factor=8.0)
    toks = _toks(cfg, 2, 20, seed=1)
    jlogits, jcache = jax_prefill(jparams, jcfg, jnp.asarray(toks), 32)
    logits, cache = prefill(params, cfg, toks, 32)
    assert set(cache) == {"dense", "moe"}
    for group in cache:
        assert set(cache[group]) == {"ckv", "krope"}
        for key in ("ckv", "krope"):
            assert tuple(cache[group][key].shape) == jcache[group][key].shape
            np.testing.assert_allclose(cache[group][key].numpy(),
                                       np.asarray(jcache[group][key]),
                                       rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-3, atol=2e-3)
    jl, _ = jax_serve_step(jparams, jcfg, jcache, jnp.asarray(toks[:, :1]), jnp.int32(20))
    tl, _ = serve_step(params, cfg, cache, toks[:, :1], 20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3)
    full = forward(params, cfg, toks)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "mixtral-8x7b"])
def test_params_from_jax_is_bit_exact_in_bfloat16(name):
    jcfg = dataclasses.replace(jax_get_arch(name).smoke_config, dtype="bfloat16")
    cfg = dataclasses.replace(get_arch(name).smoke_config, dtype="bfloat16")
    jparams = jax_init_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")

    def same(got, want, transpose=False):
        want = np.asarray(want).astype(np.float32)
        got = (got.T if transpose else got).float().numpy()
        np.testing.assert_array_equal(got, want)

    moe_j = jparams["moe_layers"]["moe"]
    last = len(params.moe_layers) - 1
    for key in ("router", "w_gate", "w_up", "w_down"):
        same(getattr(params.moe_layers[last].moe, key), moe_j[key][last])
    assert params.moe_layers[0].moe.router.dtype == torch.float32
    if name == "mixtral-8x7b":
        assert len(params.dense_layers) == 0 and params.mtp_layer is None
        same(params.moe_layers[1].attn.wk.weight, jparams["moe_layers"]["attn"]["wk"][1], True)
        return
    for key in ("w_gate_shared", "w_up_shared", "w_down_shared"):
        same(getattr(params.moe_layers[1].moe, key), moe_j[key][1])
    for key in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        same(getattr(params.dense_layers[0].attn, key).weight,
             jparams["dense_layers"]["attn"][key][0], True)
        same(getattr(params.mtp_layer.attn, key).weight,
             jparams["mtp_layer"]["attn"][key], True)
    same(params.mtp_layer.ffn.w_down.weight, jparams["mtp_layer"]["ffn"]["w_down"], True)
    same(params.mtp_norm, jparams["mtp_norm"])
    same(params.moe_layers[0].attn.kv_norm, jparams["moe_layers"]["attn"]["kv_norm"][0])
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_ref


def test_full_width_parameter_counts_on_meta():
    """The full configs' trees hold as many numbers as the reference's,
    and the configs count their parameters as the reference's do."""
    for name in ("mixtral-8x7b", "deepseek-v3-671b"):
        cfg, jcfg = get_arch(name).config, jax_get_arch(name).config
        m = init_params(cfg, device="meta")
        jtree = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg))
        n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jtree))
        assert sum(p.numel() for p in m.parameters()) == n_ref
        assert cfg.total_params() == jcfg.total_params()
        assert cfg.active_params() == jcfg.active_params()
        assert m.moe_layers[0].moe.w_gate.shape == (
            cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)


# ---------------------------------------------------------------------------
# flash_attention with a value head dim apart from the query/key head dim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,dv,causal", [(24, 16, True), (192, 128, True),
                                         (192, 128, False)])
def test_split_head_dims_plain_route_equals_attention_ref(dtype, d, dv, causal):
    r = np.random.default_rng(d + dv)
    jt = jnp.dtype(dtype)
    jq = jnp.asarray(r.normal(size=(1, 4, 33, d)), jt)
    jk = jnp.asarray(r.normal(size=(1, 4, 33, d)), jt)
    jv = jnp.asarray(r.normal(size=(1, 4, 33, dv)), jt)
    want = jax_attention_ref(jq, jk, jv, causal=causal)
    got = flash_attention(*(to_tensor(np.asarray(x)) for x in (jq, jk, jv)),
                          causal=causal)
    assert tuple(got.shape) == (1, 4, 33, dv) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_split_head_dims_argument_checks():
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    assert SPLIT_HEAD_DIMS == ((192, 128),)
    check_kernel_inputs(t(1, 8, 64, 192), t(1, 8, 64, 192), t(1, 8, 64, 128))
    with pytest.raises(ValueError, match=r"head dims \(D, Dv\) = \(192, 128\)"):
        check_kernel_inputs(*(x.float() for x in (t(1, 8, 64, 192), t(1, 8, 64, 192),
                                                  t(1, 8, 64, 128))))
    with pytest.raises(ValueError, match=r"\(192, 64\)"):
        check_kernel_inputs(t(1, 8, 64, 192), t(1, 8, 64, 192), t(1, 8, 64, 64))
    with pytest.raises(ValueError, match=r"\(128, 192\)"):
        check_kernel_inputs(t(1, 8, 64, 128), t(1, 8, 64, 128), t(1, 8, 64, 192))
    with pytest.raises(ValueError, match="v \\(B, Hkv, Sk, Dv\\)"):
        flash_attention(t(1, 8, 64, 192), t(1, 8, 64, 192), t(1, 8, 63, 128))
    with pytest.raises(ValueError, match="same batch and head_dim"):
        flash_attention(t(1, 8, 64, 192), t(1, 8, 64, 128), t(1, 8, 64, 128))


def test_output_is_laid_out_as_q():
    """The kernel's output (B, H, S, Dv) takes q's layout: for MLA's
    transposed (B, S, H, D) query view its transpose back is contiguous,
    so the output projection reads it without a copy."""
    q = torch.zeros(2, 40, 8, 192, dtype=torch.bfloat16).transpose(1, 2)
    out = _empty_out(q, 128)
    assert tuple(out.shape) == (2, 8, 40, 128)
    assert out.transpose(1, 2).is_contiguous()
    dense = _empty_out(torch.zeros(2, 8, 40, 64), 64)
    assert dense.is_contiguous() and dense.shape == (2, 8, 40, 64)
