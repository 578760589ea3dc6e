"""Every loss of the port against the reference's on the CPU: the value
and the gradient of each parameter, the reference's from
``jax.value_and_grad`` on the same weights (``params_from_jax``, which
also carries the reference's gradient tree into the port's layout) and
the same batch. float32 at rtol 2e-3 with an atol of 2e-3 times the
leaf's rms; the bf16 LM per leaf in norm at 3e-2 against the op-by-op
reference (ROADMAP queue 3: its jitted bf16 forward keeps float32
intermediates). Also ``softmax_cross_entropy`` and ``node_nll`` alone,
the losses' sharded arguments raising, and the gradients of the two
hand kernels' autograd Functions on the CPU, their launches patched to
their plain versions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.gnn import extra as jax_extra  # noqa: E402
from repro.models.gnn import gat as jax_gat  # noqa: E402
from repro.models.gnn import gin as jax_gin  # noqa: E402
from repro.models.recsys import xdeepfm as jax_xdeepfm  # noqa: E402
from repro.models.transformer import init_params as jax_init_params  # noqa: E402
from repro.models.transformer import loss_fn as jax_lm_loss  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.data.lm import lm_batch  # noqa: E402
from repro_torch.data.recsys import recsys_batch  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
    attention_vjp_ref,
)
from repro_torch.kernels.segment_sum import ops as ss_ops  # noqa: E402
from repro_torch.kernels.segment_sum.ref import segment_sum_sorted_ref  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.gnn import convert as gnn_convert  # noqa: E402
from repro_torch.models.gnn import extra, gat, gin  # noqa: E402
from repro_torch.models.recsys import convert as recsys_convert  # noqa: E402
from repro_torch.models.recsys import xdeepfm  # noqa: E402
from repro_torch.models.transformer import loss_fn  # noqa: E402
from repro_torch.models.transformer import model as lm_model  # noqa: E402
from repro_torch.models.transformer.convert import params_from_jax  # noqa: E402
from repro_torch.train.tree import trainable  # noqa: E402

TOL = 2e-3
BF16_TOL = 3e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_value_and_grad(loss, params):
    """The reference's ``jax.value_and_grad`` of ``loss`` at ``params``,
    compiled once (op by op, each primitive compiles on its own)."""
    return jax.jit(jax.value_and_grad(loss))(params)


def _jax_init(init, cfg, seed):
    """The reference's ``init(PRNGKey(seed), cfg)`` as numpy, compiled
    once."""
    return _np(jax.jit(lambda key: init(key, cfg))(jax.random.PRNGKey(seed)))


def _port_value_and_grad(fn, params, *args, **kwargs):
    """``(loss, {name: grad})`` over ``params``' named parameters; a leaf
    the loss does not reach gets zeros, as JAX gives it."""
    trainable(params)
    names, leaves = zip(*params.named_parameters())
    loss = fn(params, *args, **kwargs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.item(), {n: torch.zeros_like(p) if g is None else g
                         for n, p, g in zip(names, leaves, grads)}


def _check_grads(got: dict, want_module, tol=TOL, normwise=False):
    want = dict(want_module.named_parameters())
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].detach().float().numpy()
        g = g.float().numpy()
        assert g.shape == w.shape, name
        if normwise:
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= tol, (name, err)
        else:
            rms = float(np.sqrt(np.mean(np.square(w)))) if w.size else 0.0
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol * rms + 1e-9,
                                       err_msg=name)


def test_softmax_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    want, want_g = jax.value_and_grad(jax_common.softmax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_()
    got = common.softmax_cross_entropy(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)
    # Every label ignored: the total is floored at 1, the loss is 0.
    none = common.softmax_cross_entropy(x, torch.full((3, 7), -1))
    assert none.item() == 0.0


def test_node_nll_matches_the_references_gin_loss_head():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(20, 5)).astype(np.float32)
    labels = rng.integers(-1, 5, 20).astype(np.int32)

    def ref(lg):
        logp = jax.nn.log_softmax(lg, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None].clip(0), axis=-1)[:, 0]
        mask = (jnp.asarray(labels) >= 0).astype(jnp.float32)
        return (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    want, want_g = jax.value_and_grad(ref)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = common.node_nll(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)


# --- the decoder LMs --------------------------------------------------------


def _lm_pair(name, dtype):
    changes = {"dtype": dtype}
    jcfg = dataclasses.replace(jax_get_arch(name).smoke_config, **changes)
    cfg = dataclasses.replace(get_arch(name).smoke_config, **changes)
    jparams = _jax_init(jax_init_params, jcfg, 0)
    return jcfg, jparams, cfg, params_from_jax(jparams, cfg, device="cpu")


def _lm_batch(cfg, b=2, s=16):
    batch = lm_batch(b, s, cfg.vocab_size, seed=3)
    labels = batch["labels"].copy()
    labels[0, -4:] = -1  # a padded tail
    return {"tokens": batch["tokens"], "labels": labels}


@pytest.mark.parametrize("name", ["qwen3-4b", "mixtral-8x7b", "deepseek-v3-671b"])
def test_lm_loss_and_grads_match_the_reference_float32(name):
    jcfg, jparams, cfg, params = _lm_pair(name, "float32")
    batch = _lm_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_g = _jax_value_and_grad(lambda p: jax_lm_loss(p, jcfg, jbatch), jparams)
    got, got_g = _port_value_and_grad(loss_fn, params, cfg, batch)
    np.testing.assert_allclose(got, float(want), rtol=TOL)
    _check_grads(got_g, params_from_jax(_np(want_g), cfg, device="cpu"))
    if name == "deepseek-v3-671b":  # the MTP term is there, and weighs 0.1
        assert cfg.mtp_depth and params.mtp_layer is not None
        plain, _ = _port_value_and_grad(loss_fn, params, cfg, batch, mtp_weight=0.0)
        assert got > plain


def test_lm_loss_and_grads_match_the_op_by_op_reference_bfloat16():
    jcfg, jparams, cfg, params = _lm_pair("qwen3-4b", "bfloat16")
    batch = _lm_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.disable_jit():
        want, want_g = jax.value_and_grad(lambda p: jax_lm_loss(p, jcfg, jbatch))(jparams)
    got, got_g = _port_value_and_grad(loss_fn, params, cfg, batch)
    np.testing.assert_allclose(got, float(want), rtol=BF16_TOL)
    _check_grads(got_g, params_from_jax(_np(want_g), cfg, device="cpu"),
                 tol=BF16_TOL, normwise=True)


def test_lm_remat_gives_the_same_grads_and_a_mesh_raises():
    _, _, cfg, params = _lm_pair("qwen3-4b", "float32")
    batch = _lm_batch(cfg)
    _, with_remat = _port_value_and_grad(loss_fn, params, dataclasses.replace(cfg, remat=True),
                                         batch)
    _, without = _port_value_and_grad(loss_fn, params, dataclasses.replace(cfg, remat=False),
                                      batch)
    for name, g in with_remat.items():
        torch.testing.assert_close(g, without[name], rtol=0, atol=0, msg=name)
    from repro_torch.launch.mesh import make_test_mesh

    on_mesh, _ = _port_value_and_grad(loss_fn, params, dataclasses.replace(cfg, remat=True),
                                      batch, mesh=make_test_mesh((1, 1), device="cpu"))
    assert on_mesh == _port_value_and_grad(loss_fn, params, cfg, batch)[0]


# --- the GNNs and xDeepFM ---------------------------------------------------


def _graph_pair(g):
    return {k: (v if k == "num_graphs" else jnp.asarray(v)) for k, v in g.items()}


@pytest.mark.parametrize("name,readout", [("gin-tu", "graph"), ("gin-tu", "node"),
                                          ("gat-cora", "node")])
def test_gin_and_gat_losses_match_the_reference(name, readout):
    port_mod, jax_mod = {"gin-tu": (gin, jax_gin), "gat-cora": (gat, jax_gat)}[name]
    cfg, jcfg = get_arch(name).smoke_config, jax_get_arch(name).smoke_config
    if name == "gin-tu":
        cfg = dataclasses.replace(cfg, readout=readout)
        jcfg = dataclasses.replace(jcfg, readout=readout)
    if readout == "graph":
        g = graphs.molecule_batch(6, d_feat=cfg.in_dim, seed=1)
        g["labels"] = np.random.default_rng(2).integers(
            -1, cfg.num_classes, g["num_graphs"]).astype(np.int32)
    else:
        g = graphs.full_graph(120, 600, cfg.in_dim, cfg.num_classes, seed=1)
        g["labels"] = np.where(np.arange(120) % 5 == 0, -1, g["labels"]).astype(np.int32)
    tree = _jax_init(jax_mod.init_params, jcfg, 4)
    jg = _graph_pair(g)
    want, want_g = _jax_value_and_grad(lambda p: jax_mod.loss_fn(p, jcfg, jg), tree)
    params = gnn_convert.params_from_jax(tree, cfg, device="cpu")
    got, got_g = _port_value_and_grad(port_mod.loss_fn, params, cfg, g)
    np.testing.assert_allclose(got, float(want), rtol=TOL)
    _check_grads(got_g, gnn_convert.params_from_jax(_np(want_g), cfg, device="cpu"))
    from repro_torch.launch.mesh import make_test_mesh

    with make_test_mesh((1, 1), device="cpu"):  # edge-parallel over one rank
        sharded, sharded_g = _port_value_and_grad(port_mod.loss_fn, params, cfg, g,
                                                  psum_axes=("data",))
    assert sharded == got
    for name, grad in sharded_g.items():
        torch.testing.assert_close(grad, got_g[name], rtol=0, atol=0, msg=name)


EXTRA = {
    "gcn": (extra.GCNConfig, extra.gcn_loss, jax_extra.GCNConfig, jax_extra.gcn_init,
            jax_extra.gcn_loss),
    "sage": (extra.SAGEConfig, extra.sage_loss, jax_extra.SAGEConfig, jax_extra.sage_init,
             jax_extra.sage_loss),
    "pna": (extra.PNAConfig, extra.pna_loss, jax_extra.PNAConfig, jax_extra.pna_init,
            jax_extra.pna_loss),
}


@pytest.mark.parametrize("name", list(EXTRA))
def test_gcn_sage_pna_losses_match_the_reference(name):
    cfg_cls, port_loss, jcfg_cls, jinit, jloss = EXTRA[name]
    kw = dict(num_layers=2, d_hidden=16, in_dim=12, num_classes=5)
    cfg, jcfg = cfg_cls(**kw), jcfg_cls(**kw)
    g = graphs.full_graph(150, 900, 12, 5, seed=2)
    g["labels"] = np.where(np.arange(150) % 7 == 0, -1, g["labels"]).astype(np.int32)
    tree = _jax_init(jinit, jcfg, 5)
    jg = _graph_pair(g)
    want, want_g = _jax_value_and_grad(lambda p: jloss(p, jcfg, jg), tree)
    params = gnn_convert.params_from_jax(tree, cfg, device="cpu")
    got, got_g = _port_value_and_grad(port_loss, params, cfg, g)
    np.testing.assert_allclose(got, float(want), rtol=TOL)
    _check_grads(got_g, gnn_convert.params_from_jax(_np(want_g), cfg, device="cpu"))


@pytest.mark.parametrize("name", ["egnn", "mace"])
def test_egnn_and_mace_losses_match_the_reference(name):
    cfg, jcfg = get_arch(name).smoke_config, jax_get_arch(name).smoke_config
    g = graphs.molecule_batch(4, d_feat=getattr(cfg, "in_dim", 16),
                              num_species=getattr(cfg, "num_species", 10), seed=3)
    g["labels"] = np.random.default_rng(3).normal(size=g["num_graphs"]).astype(np.float32)
    jmod, mod = jax_get_arch(name).module, get_arch(name).module
    tree = _jax_init(jmod.init_params, jcfg, 6)
    jg = _graph_pair(g)
    want, want_g = _jax_value_and_grad(lambda p: jmod.loss_fn(p, jcfg, jg), tree)
    params = gnn_convert.params_from_jax(tree, cfg, device="cpu")
    got, got_g = _port_value_and_grad(mod.loss_fn, params, cfg, g)
    np.testing.assert_allclose(got, float(want), rtol=TOL)
    _check_grads(got_g, gnn_convert.params_from_jax(_np(want_g), cfg, device="cpu"))


def test_xdeepfm_loss_matches_the_reference():
    cfg, jcfg = get_arch("xdeepfm").smoke_config, jax_get_arch("xdeepfm").smoke_config
    tree = _jax_init(jax_xdeepfm.init_params, jcfg, 7)
    batch = recsys_batch(64, cfg.n_fields, cfg.vocab_per_field, seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_g = _jax_value_and_grad(lambda p: jax_xdeepfm.loss_fn(p, jcfg, jbatch), tree)
    params = recsys_convert.params_from_jax(tree, cfg, device="cpu")
    got, got_g = _port_value_and_grad(xdeepfm.loss_fn, params, cfg, batch)
    np.testing.assert_allclose(got, float(want), rtol=TOL)
    _check_grads(got_g, recsys_convert.params_from_jax(_np(want_g), cfg, device="cpu"))


# --- the hand kernels' gradients --------------------------------------------


def _qkv(seed, b, hq, hkv, sq, sk, d, dv):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, w)).astype(np.float32)
            for h, s, w in ((hq, sq, d), (hkv, sk, d), (hkv, sk, dv), (hq, sq, dv))]


VJP_CASES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window)
    (2, 4, 2, 24, 24, 16, 16, True, None),     # GQA
    (1, 4, 1, 40, 40, 32, 32, True, 8),        # MQA, a sliding window
    (1, 2, 2, 30, 30, 192, 128, True, None),   # MLA's head dims
    (1, 2, 1, 20, 20, 16, 16, False, None),    # non-causal
    (1, 2, 2, 30, 10, 16, 16, True, 4),        # rows with no live key
    (1, 8, 1, 40, 40, 256, 256, True, None),   # gemma-2b's MQA and head dim
]


@pytest.mark.parametrize("case", VJP_CASES)
def test_attention_vjp_ref_matches_jax_vjp_of_the_reference(case):
    b, hq, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, dout = _qkv(sum(case[:7]), b, hq, hkv, sq, sk, d, dv)
    _, vjp = jax.vjp(lambda *x: jax_attention_ref(*x, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = attention_vjp_ref(*(torch.from_numpy(x) for x in (q, k, v, dout)),
                            causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", VJP_CASES)
def test_attention_bwd_ref_matches_jax_vjp_of_the_reference(case):
    # The backward as the kernel computes it, from the forward's output and
    # log-sum-exp (P = exp(S - lse); a row with no live key, lse = +inf,
    # weighs every key 1 / Sk), is the reference's VJP.
    b, hq, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, dout = _qkv(sum(case[:7]), b, hq, hkv, sq, sk, d, dv)
    _, vjp = jax.vjp(lambda *x: jax_attention_ref(*x, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    q, k, v, dout = (torch.from_numpy(x) for x in (q, k, v, dout))
    out = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    assert bool(torch.isinf(lse).any()) == (window is not None and sq >= sk + window)
    got = attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("groups", [2, 4, 8])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 8), (False, None)])
def test_attention_bwd_ref_in_head_groups_matches_jax_vjp_of_the_reference(causal, window,
                                                                           groups):
    # The second pass split over the MQA group, as the kernel runs it at
    # D = 256: dK and dV of each head group summed in float32, the groups'
    # partials then added in group order. The reference's VJP all the same.
    b, hq, hkv, s, d = 1, 8, 1, 40, 256
    q, k, v, dout = _qkv(groups + s, b, hq, hkv, s, s, d, d)
    _, vjp = jax.vjp(lambda *x: jax_attention_ref(*x, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    q, k, v, dout = (torch.from_numpy(x) for x in (q, k, v, dout))
    out = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    got = attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window,
                            groups=groups)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="groups must divide"):
        attention_bwd_ref(q, k, v, out, dout, lse, groups=3)


def _patched_attention(monkeypatch):
    """The kernel route of ``flash_attention`` on CPU tensors, its two
    launches replaced by the plain versions (counting as the launches
    do): the forward writes the log-sum-exp where it is handed one, and
    the backward takes it, as the kernels do."""
    monkeypatch.setattr(fa_ops, "resolve_impl", lambda impl, x: "cuda")

    def fwd(q, k, v, causal, window, lse=None):
        launch_counts["flash_attention"] += 1
        with torch.no_grad():
            if lse is not None:
                lse.copy_(attention_lse_ref(q, k, causal=causal, window=window))
            return attention_ref(q, k, v, causal=causal, window=window)

    def bwd(q, k, v, out, dout, lse, causal, window):
        launch_counts["flash_attention.bwd"] += 1
        return attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window)

    monkeypatch.setattr(fa_ops, "_forward_kernel", fwd)
    monkeypatch.setattr(fa_ops, "_backward_kernel", bwd)


def test_lm_grads_through_the_patched_kernel_route_equal_the_plain_route(monkeypatch):
    # The training path on the kernel route: each layer's attention goes
    # through the autograd Function (forward launch, and one more in the
    # remat recompute; one backward launch), and gives the plain route's
    # gradients.
    _, _, cfg, params = _lm_pair("qwen3-4b", "float32")
    cfg = dataclasses.replace(cfg, remat=True)
    batch = _lm_batch(cfg)
    _, plain = _port_value_and_grad(loss_fn, params, cfg, batch)
    _patched_attention(monkeypatch)
    before = dict(launch_counts)
    _, routed = _port_value_and_grad(loss_fn, params, cfg, batch)
    layers = cfg.num_layers
    assert launch_counts["flash_attention"] - before["flash_attention"] == 2 * layers
    assert launch_counts["flash_attention.bwd"] - before["flash_attention.bwd"] == layers
    for name, g in plain.items():
        torch.testing.assert_close(routed[name], g, rtol=1e-5, atol=1e-6, msg=name)


def test_segment_sum_vjp_is_a_gather_with_zero_rows_for_dropped_ids():
    ids = torch.tensor([-1, 0, 0, 2, 2, 2, 3, 5], dtype=torch.int32)
    grad = torch.arange(12.0).reshape(3, 4)
    got = ss_ops.segment_sum_vjp(grad, ids, 3)
    want = torch.zeros(8, 4)
    for i, s in enumerate(ids.tolist()):
        if 0 <= s < 3:
            want[i] = grad[s]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ss_ops.segment_sum_vjp(grad[:0], ids, 0).shape == (8, 4)
    # The plain version's autograd gives the same gradient.
    data = torch.randn(8, 4, requires_grad=True)
    segment_sum_sorted_ref(data, ids, 3).backward(grad)
    torch.testing.assert_close(data.grad, want, rtol=0, atol=0)


def test_gin_grads_through_the_patched_segment_sum_route(monkeypatch):
    # Every float segment sum of GIN's loss on the kernel route through
    # the autograd Function: one launch a layer and one for the readout,
    # and the plain route's gradients.
    cfg, jcfg = get_arch("gin-tu").smoke_config, jax_get_arch("gin-tu").smoke_config
    g = graphs.molecule_batch(5, d_feat=cfg.in_dim, seed=4)
    g["labels"] = np.random.default_rng(5).integers(0, cfg.num_classes,
                                                    g["num_graphs"]).astype(np.int32)
    tree = _jax_init(jax_gin.init_params, jcfg, 8)
    _, plain = _port_value_and_grad(
        gin.loss_fn, gnn_convert.params_from_jax(tree, cfg, device="cpu"), cfg, g)
    monkeypatch.setattr(ss_ops, "resolve_impl", lambda impl, x: "cuda")

    def launch(data, ids, n):
        launch_counts["segment_sum"] += 1
        return segment_sum_sorted_ref(data.detach(), ids, n), None

    monkeypatch.setattr(ss_ops, "segment_sum_and_pointers", launch)
    before = launch_counts["segment_sum"]
    _, routed = _port_value_and_grad(
        gin.loss_fn, gnn_convert.params_from_jax(tree, cfg, device="cpu"), cfg, g)
    assert launch_counts["segment_sum"] - before == cfg.num_layers + 1
    for name, grad in plain.items():
        torch.testing.assert_close(routed[name], grad, rtol=1e-5, atol=1e-6, msg=name)


def test_lm_model_exports_the_loss():
    assert lm_model.loss_fn is loss_fn
    assert flash_attention is fa_ops.flash_attention
