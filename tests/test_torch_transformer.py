"""The port's dense decoder LM on the CPU against ``repro``'s: the same
weights (``params_from_jax``) and tokens through both packages'
``forward``, ``serve_step`` and ``prefill`` on the smoke configs of the
three dense archs, plus configs, building blocks and the parameter
count of the full qwen3-4b."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    forward as jax_forward,
    init_params as jax_init_params,
    prefill as jax_prefill,
    serve_step as jax_serve_step,
    init_kv_cache as jax_init_kv_cache,
)
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    MoEConfig,
    TransformerLM,
    cache_length,
    forward,
    init_kv_cache,
    init_params,
    loss_fn,
    prefill,
    serve_step,
)
from repro_torch.models.transformer.convert import (  # noqa: E402
    params_from_jax,
    to_tensor,
)
from repro_torch.models.transformer.model import _logits as model_logits  # noqa: E402

DENSE_ARCHS = ["qwen3-4b", "gemma-2b", "phi3-mini-3.8b"]


def _pair(name, **changes):
    """The smoke config of ``name`` in both packages, with ``changes``,
    and the same weights in both: the reference's init carried over."""
    jcfg = dataclasses.replace(jax_get_arch(name).smoke_config, **changes)
    cfg = dataclasses.replace(get_arch(name).smoke_config, **changes)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_configs_equal_the_reference(name):
    for attr in ("config", "smoke_config"):
        want = getattr(jax_get_arch(name), attr)
        got = getattr(get_arch(name), attr)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_params() == want.total_params()
        assert got.param_count_dense_layer() == want.param_count_dense_layer()


def test_unported_archs_raise_naming_the_roadmap_item():
    # Item 15 ported the MoE names: every registered name, mixtral-8x7b,
    # deepseek-v3-671b, egnn, mace and xdeepfm included, returns its
    # architecture, equal to the reference's; only an unknown name raises.
    moe_names = ("mixtral-8x7b", "deepseek-v3-671b")
    assert {"egnn", "mace", "xdeepfm", *moe_names} <= set(ARCH_NAMES)
    for name in ARCH_NAMES:
        assert get_arch(name).name == name
    for name in moe_names:
        for attr in ("config", "smoke_config"):
            want = getattr(jax_get_arch(name), attr)
            got = getattr(get_arch(name), attr)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.total_params() == want.total_params()
    with pytest.raises(KeyError):
        get_arch("llama")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_building_blocks_match_the_reference(dtype):
    r = np.random.default_rng(3)
    jx = jnp.asarray(r.normal(size=(2, 6, 4, 16)) * 2, jnp.dtype(dtype))
    jg = jnp.asarray(r.normal(size=(16,)) * 0.1, jnp.dtype(dtype))
    x, g = to_tensor(np.asarray(jx)), to_tensor(np.asarray(jg))
    tol = 2e-3 if dtype == "float32" else 3e-2

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol, atol=tol)

    close(common.rms_norm(x, g), jax_common.rms_norm(jx, jg))
    pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0)
    jcos, jsin = jax_common.rope_freqs(16, 1e6, jnp.asarray(pos))
    cos, sin = common.rope_freqs(16, 1e6, torch.from_numpy(pos))
    close(cos, jcos)
    close(sin, jsin)
    close(common.apply_rope(x, cos, sin), jax_common.apply_rope(jx, jcos, jsin))
    for act in ("silu", "gelu", "gelu_tanh", "relu"):
        want = jax_common.activation_fn(act)(jx)
        got = common.activation_fn(act)(x)
        if dtype == "bfloat16":  # op for op as jax.nn: the same bits
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
        close(got, want)


@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_forward_float32_matches_reference(name):
    jcfg, jparams, cfg, params = _pair(name)
    toks = _tokens(cfg, 2, 24)
    want = np.asarray(jax_forward(jparams, jcfg, jnp.asarray(toks)))
    got = forward(params, cfg, toks)
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_forward_bfloat16_matches_reference(name):
    """bf16 weights and activations at 3e-2. The reference is evaluated
    op by op (``jax.disable_jit``), as the port runs: inside its jitted
    layer scan XLA fuses elementwise ops and keeps some intermediates in
    float32 (excess precision) that op-by-op evaluation rounds to bf16,
    and on these inputs the reference's own jitted and op-by-op logits
    differ by up to 0.047, beyond the tolerance; the port's op-by-op
    bf16 follows the op-by-op reference to about 0.01."""
    jcfg, jparams, cfg, params = _pair(name, dtype="bfloat16")
    toks = _tokens(cfg, 2, 24)
    with jax.disable_jit():
        want = np.asarray(jax_forward(jparams, jcfg, jnp.asarray(toks)), np.float32)
    got = forward(params, cfg, toks)
    assert params.embed.dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_bfloat16_logits_are_float32_sums(name):
    """The unembedding of bf16 activations writes float32 sums, as the
    reference's ``preferred_element_type=float32``: on the same bf16
    hidden states both packages' logits agree to float32 rounding (a
    product rounded to bf16 is off by up to 2^-9 of each logit), so the
    greedy argmaxes are equal; and through the whole bf16 forward every
    row whose top-2 margin exceeds twice the tolerance has the
    reference's argmax."""
    jcfg, jparams, cfg, params = _pair(name, dtype="bfloat16")
    jx = jnp.asarray(np.random.default_rng(4).normal(size=(2, 24, cfg.d_model)),
                     jnp.bfloat16)
    unembed = jparams["embed"].T if jcfg.tie_embeddings else jparams["unembed"]
    want = np.asarray(jnp.einsum(
        "bsd,dv->bsv", jax_common.rms_norm(jx, jparams["final_norm"]), unembed,
        preferred_element_type=jnp.float32))
    got = model_logits(params, cfg, to_tensor(np.asarray(jx)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))

    toks = _tokens(cfg, 2, 24)
    with jax.disable_jit():
        ref = np.asarray(jax_forward(jparams, jcfg, jnp.asarray(toks)), np.float32)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 6e-2
    assert sure.sum() >= ref.shape[0] * ref.shape[1] // 4
    np.testing.assert_array_equal(
        forward(params, cfg, toks).argmax(-1).numpy()[sure], ref.argmax(-1)[sure])


@pytest.mark.parametrize("name,window", [
    ("qwen3-4b", None), ("gemma-2b", None), ("phi3-mini-3.8b", None),
    ("qwen3-4b", 8),
])
def test_serve_step_and_prefill_match_reference(name, window):
    # window=8 with 20 tokens and max_len 32: an 8-slot ring buffer that
    # wraps twice.
    jcfg, jparams, cfg, params = _pair(name, sliding_window=window)
    toks = _tokens(cfg, 2, 20, seed=1)
    jlogits, jcache = jax_prefill(jparams, jcfg, jnp.asarray(toks), 32)
    logits, cache = prefill(params, cfg, toks, 32)
    assert cache["dense"]["k"].shape == (
        cfg.num_layers, 2, cache_length(cfg, 32), cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=5e-3, atol=5e-3)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache["dense"][kv].numpy(),
                                   np.asarray(jcache["dense"][kv]),
                                   rtol=5e-3, atol=5e-3)
    # One more step from the same state in both packages.
    nxt = toks[:, :1]
    jl, _ = jax_serve_step(jparams, jcfg, jcache, jnp.asarray(nxt), jnp.int32(20))
    tl, _ = serve_step(params, cfg, cache, nxt, 20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-3, atol=5e-3)
    # Decode through the ring buffer agrees with the windowed forward.
    full = forward(params, cfg, toks)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_kv_cache_layout_matches_reference():
    cfg = dataclasses.replace(get_arch("qwen3-4b").smoke_config, sliding_window=8)
    jcfg = dataclasses.replace(jax_get_arch("qwen3-4b").smoke_config, sliding_window=8)
    cache = init_kv_cache(cfg, 3, 100, device="cpu")
    jcache = jax_init_kv_cache(jcfg, 3, 100)
    for kv in ("k", "v"):
        assert tuple(cache["dense"][kv].shape) == jcache["dense"][kv].shape
        assert not bool(cache["dense"][kv].any())


def test_full_qwen3_4b_parameter_count_on_meta():
    cfg = get_arch("qwen3-4b").config
    model = init_params(cfg, device="meta")
    assert isinstance(model, TransformerLM)
    matrices = sum(p.numel() for p in model.parameters() if p.dim() > 1)
    vectors = sum(p.numel() for p in model.parameters() if p.dim() == 1)
    assert matrices == cfg.total_params() == 4_411_228_160
    assert vectors == 196_096
    assert common.count_params(model) == 4_411_424_256
    assert model.embed.dtype == torch.bfloat16


def test_init_params_shapes_scales_and_seed():
    cfg = get_arch("gemma-2b").smoke_config
    a = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    c = init_params(cfg, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
        assert not pa.requires_grad
    assert not torch.equal(a.embed, c.embed)  # the default generator: seed 0
    assert a.unembed is None  # tied embeddings
    # The reference's tree, leaf for leaf (shapes transposed for Linear).
    jtree = jax.eval_shape(lambda: jax_init_params(
        jax.random.PRNGKey(0), jax_get_arch("gemma-2b").smoke_config))
    assert tuple(a.embed.shape) == jtree["embed"].shape
    wq = jtree["dense_layers"]["attn"]["wq"].shape
    assert tuple(a.dense_layers[0].attn.wq.weight.shape) == (wq[2], wq[1])
    assert abs(float(a.embed.std()) - 0.02) < 2e-3
    w_down = a.dense_layers[1].ffn.w_down.weight
    assert abs(float(w_down.std()) - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert all(not bool(layer.ln1.any()) for layer in a.dense_layers)


def test_params_from_jax_is_bit_exact_in_bfloat16():
    jcfg, jparams, cfg, params = _pair("qwen3-4b", dtype="bfloat16")
    want = np.asarray(jparams["dense_layers"]["attn"]["wk"][1]).astype(np.float32)
    got = params.dense_layers[1].attn.wk.weight.T.float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        params.unembed.weight.T.float().numpy(),
        np.asarray(jparams["unembed"]).astype(np.float32))


def test_unported_model_parts_raise():
    # MoE layers, MLA and the MTP head build and run since item 15, and
    # under a mesh since item 16: on a one-rank mesh every entry point
    # gives the meshless numbers, and serving on a mesh needs the cache
    # that init_kv_cache lays out for it.
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((1, 1), device="cpu")
    cfg = get_arch("qwen3-4b").smoke_config
    moe = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32)
    toks = _tokens(cfg, 1, 4)
    for changes in ({"moe": moe}, {"attention": "mla"}, {"mtp_depth": 1},
                    {"moe": moe, "num_dense_layers": 1, "attention": "mla",
                     "mtp_depth": 1}):
        c = dataclasses.replace(cfg, **changes)
        params = init_params(c, device="cpu")
        assert forward(params, c, toks).shape == (1, 4, c.vocab_size)
        assert (params.mtp_layer is not None) == bool(c.mtp_depth)
        assert len(params.moe_layers) == c.num_moe_layers()
        torch.testing.assert_close(forward(params, c, toks, mesh=mesh),
                                   forward(params, c, toks), rtol=0, atol=0)
        want, _ = serve_step(params, c, init_kv_cache(c, 1, 8, device="cpu"),
                             toks[:, :1], 0)
        got, _ = serve_step(params, c, init_kv_cache(c, 1, 8, device="cpu", mesh=mesh),
                            toks[:, :1], 0, mesh=mesh)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        with pytest.raises(ValueError, match="KVCache"):
            serve_step(params, c, init_kv_cache(c, 1, 8, device="cpu"), toks[:, :1], 0,
                       mesh=mesh)


def test_loss_fn_takes_only_the_rules_that_lay_the_lm_out():
    from repro_torch.distributed.sharding import LM_LONG_DECODE_RULES, LM_RULES
    from repro_torch.launch.mesh import make_test_mesh

    cfg = get_arch("qwen3-4b").smoke_config
    params = init_params(cfg, device="cpu")
    toks = _tokens(cfg, 2, 4)
    batch = {"tokens": toks, "labels": toks}
    mesh = make_test_mesh((1, 1), device="cpu")
    want = loss_fn(params, cfg, batch)
    assert torch.equal(loss_fn(params, cfg, batch, mesh=mesh, rules=LM_RULES), want)
    with pytest.raises(ValueError, match="LM_RULES"):
        loss_fn(params, cfg, batch, mesh=mesh, rules=LM_LONG_DECODE_RULES)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    cfg = get_arch("qwen3-4b").smoke_config
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_kv_cache(cfg, 1, 8)
