"""RecSys of the port against ``repro`` on the CPU: ``embedding_bag`` in
each mode (weights, pad bag ids, sorted and unsorted bags) and
``multi_field_lookup``; ``recsys_batch`` bit for bit; xDeepFM's
``forward`` and ``serve_step`` at rtol = atol = 2e-3 float32 from the
same weights, ``serve_retrieval``'s scores within that tolerance and its
top-k ids wherever the k-th and (k+1)-th scores differ; the chunked CIN
against the reference's one-shot einsum; and the registry."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data.recsys import recsys_batch as jax_recsys_batch  # noqa: E402
from repro.models.recsys import xdeepfm as jax_xdeepfm  # noqa: E402
from repro.ops.embedding_bag import embedding_bag as jax_embedding_bag  # noqa: E402
from repro.ops.embedding_bag import multi_field_lookup as jax_multi_field_lookup  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.recsys_family import RECSYS_SHAPES, RecsysArch  # noqa: E402
from repro_torch.data.recsys import recsys_batch  # noqa: E402
from repro_torch.models.recsys import xdeepfm  # noqa: E402
from repro_torch.models.recsys.convert import params_from_jax  # noqa: E402
from repro_torch.ops import embedding_bag as eb  # noqa: E402
from repro_torch.ops import segment as tseg  # noqa: E402



TOL = 2e-3


def _bags(seed, vocab=50, dim=6, nnz=200, bags=17, pad=0, sort=False):
    r = np.random.default_rng(seed)
    table = r.normal(size=(vocab, dim)).astype(np.float32)
    idx = r.integers(0, vocab, nnz).astype(np.int32)
    bag = r.integers(0, bags, nnz).astype(np.int32)
    bag[:pad] = bags + r.integers(0, 3, pad)  # padding: ids >= num_bags
    if sort:
        order = np.argsort(bag, kind="stable")
        idx, bag = idx[order], bag[order]
    w = r.uniform(0.5, 2.0, nnz).astype(np.float32)
    return table, idx, bag, w


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("pad", [0, 9])
@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True),
                                           ("mean", False), ("max", False)])
def test_embedding_bag_matches_the_reference(mode, weighted, pad, sort):
    table, idx, bag, w = _bags(3, pad=pad, sort=sort)
    kw = dict(mode=mode, indices_are_sorted=sort)
    got = eb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(bag), 17,
                           weights=torch.from_numpy(w) if weighted else None, **kw)
    want = jax_embedding_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bag),
                                17, weights=jnp.asarray(w) if weighted else None, **kw)
    assert tuple(got.shape) == want.shape == (17, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_embedding_bag_empty_bags_and_validation():
    table, idx, bag, w = _bags(1, nnz=20, bags=40)
    t, i, b = (torch.from_numpy(x) for x in (table, idx, bag))
    for mode in ("sum", "mean", "max"):
        out = eb.embedding_bag(t, i, b, 40, mode=mode)
        empty = np.setdiff1d(np.arange(40), bag)
        assert not bool(out[torch.from_numpy(empty)].any()), mode
    with pytest.raises(ValueError, match="mode='sum'"):
        eb.embedding_bag(t, i, b, 40, mode="mean", weights=torch.from_numpy(w))
    with pytest.raises(ValueError, match="unknown mode"):
        eb.embedding_bag(t, i, b, 40, mode="min")


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_sums_through_the_segment_sum_kernel(monkeypatch, mode):
    calls = []
    real = tseg.segment_sum_sorted

    def spy(data, ids, n, **kw):
        calls.append(bool((ids[1:] >= ids[:-1]).all()))
        return real(data, ids, n, **kw)

    monkeypatch.setattr(tseg, "segment_sum_sorted", spy)
    table, idx, bag, _ = _bags(2, pad=4)
    eb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                     torch.from_numpy(bag), 17, mode=mode)
    assert calls == [True]  # one sum, over ids sorted first


def test_multi_field_lookup_matches_the_reference():
    r = np.random.default_rng(0)
    tables = [r.normal(size=(v, 5)).astype(np.float32) for v in (7, 11, 3)]
    ids = np.stack([r.integers(0, v, 9) for v in (7, 11, 3)], axis=1).astype(np.int32)
    got = eb.multi_field_lookup([torch.from_numpy(t) for t in tables],
                                torch.from_numpy(ids))
    want = jax_multi_field_lookup([jnp.asarray(t) for t in tables], jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch,fields,vocab,seed,step", [
    (64, 8, 1000, 0, 0), (512, 39, 1_000_000, 1, 3), (5, 2, 7, 4, 11)])
def test_recsys_batch_equals_the_reference(batch, fields, vocab, seed, step):
    got = recsys_batch(batch, fields, vocab, seed=seed, step=step)
    want = jax_recsys_batch(batch, fields, vocab, seed=seed, step=step)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype


def _model(seed=0, **kw):
    cfg = dataclasses.replace(get_arch("xdeepfm").smoke_config, **kw)
    jcfg = dataclasses.replace(jax_get_arch("xdeepfm").smoke_config, **kw)
    tree = jax.tree.map(np.asarray, jax_xdeepfm.init_params(jax.random.PRNGKey(seed), jcfg))
    return cfg, jcfg, tree, params_from_jax(tree, cfg, device="cpu")


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_params_from_jax_is_exact():
    cfg, _, tree, params = _model(1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = params
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
    with pytest.raises(ValueError, match="fit"):
        params_from_jax(tree, dataclasses.replace(cfg, embed_dim=5), device="cpu")


@pytest.mark.parametrize("batch,seed", [(1, 0), (64, 1), (300, 2)])
def test_forward_and_serve_step_match_the_reference(batch, seed):
    cfg, jcfg, tree, params = _model(seed)
    b = recsys_batch(batch, cfg.n_fields, cfg.vocab_per_field, seed=seed)
    jtree = jax.tree.map(jnp.asarray, tree)
    for fn, jfn in ((xdeepfm.forward, jax_xdeepfm.forward),
                    (xdeepfm.serve_step, jax_xdeepfm.serve_step)):
        got, want = fn(params, cfg, b), jfn(jtree, jcfg, _jbatch(b))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (batch,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_forward_at_a_wider_config_matches_the_reference():
    # The published CIN and MLP widths over a small vocabulary.
    cfg, jcfg, tree, params = _model(2, n_fields=39, embed_dim=10,
                                     cin_layers=(200, 200, 200), mlp_layers=(400, 400),
                                     vocab_per_field=50, n_candidates=64,
                                     retrieval_dim=64)
    b = recsys_batch(32, 39, 50, seed=5)
    got = xdeepfm.forward(params, cfg, b)
    want = jax_xdeepfm.forward(jax.tree.map(jnp.asarray, tree), jcfg, _jbatch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("top_k", [1, 10, 100])
@pytest.mark.parametrize("seed", [0, 3])
def test_serve_retrieval_matches_the_reference(seed, top_k):
    cfg, jcfg, tree, params = _model(seed)
    b = recsys_batch(1, cfg.n_fields, cfg.vocab_per_field, seed=seed)
    scores, (vals, ids) = xdeepfm.serve_retrieval(params, cfg, b, top_k=top_k)
    jscores, (jvals, jids) = jax_xdeepfm.serve_retrieval(
        jax.tree.map(jnp.asarray, tree), jcfg, _jbatch(b), top_k=top_k)
    assert tuple(scores.shape) == (cfg.n_candidates,) and tuple(ids.shape) == (top_k,)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=TOL, atol=TOL)
    # Ties may be ordered otherwise: the ids agree as a set where the
    # k-th score stands apart from the (k+1)-th, and each id scores its value.
    ranked = np.sort(np.asarray(jscores))[::-1]
    if ranked[top_k - 1] != ranked[top_k]:
        assert set(ids.tolist()) == set(np.asarray(jids).tolist())
    np.testing.assert_array_equal(scores[ids].numpy(), vals.numpy())


@pytest.mark.parametrize("budget_rows", [1, 7, 64, None])
def test_chunked_cin_equals_the_one_shot_einsum(budget_rows):
    r = np.random.default_rng(budget_rows or 0)
    b, h, m, d, o = 50, 9, 5, 4, 6
    xk = torch.from_numpy(r.normal(size=(b, h, d)).astype(np.float32))
    x0 = torch.from_numpy(r.normal(size=(b, m, d)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(o, h, m)).astype(np.float32))
    kw = {} if budget_rows is None else {"budget": budget_rows * h * m * d * 4}
    if budget_rows is not None:
        assert xdeepfm.cin_chunk_rows(h, m, d, budget=kw["budget"]) == budget_rows
    got = xdeepfm.cin_layer(xk, x0, w, **kw)
    want = torch.einsum("bhd,bmd,ohm->bod", xk, x0, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    jwant = jnp.einsum("bhd,bmd,ohm->bod", *(jnp.asarray(x.numpy()) for x in (xk, x0, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=TOL, atol=TOL)


def test_cin_chunks_fit_the_budget_at_serve_bulk():
    cfg = get_arch("xdeepfm").config
    h_prev = cfg.n_fields
    for h in cfg.cin_layers:
        rows = xdeepfm.cin_chunk_rows(h_prev, cfg.n_fields, cfg.embed_dim)
        assert rows * h_prev * cfg.n_fields * cfg.embed_dim * 4 <= xdeepfm.CIN_CHUNK_BYTES
        assert rows >= 1024
        h_prev = h


def test_init_params_follow_the_reference_scales():
    cfg = dataclasses.replace(get_arch("xdeepfm").smoke_config, vocab_per_field=4000,
                              n_candidates=4000)
    a = xdeepfm.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = xdeepfm.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    for (key, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), key
    jcfg = dataclasses.replace(jax_get_arch("xdeepfm").smoke_config, vocab_per_field=4000,
                               n_candidates=4000)
    tree = jax.tree.map(np.asarray, jax_xdeepfm.init_params(jax.random.PRNGKey(0), jcfg))
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = a
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(node.shape) == leaf.shape, path
        if leaf.size > 1 and float(np.std(leaf)) > 0:
            assert 0.8 < float(node.std()) / float(np.std(leaf)) < 1.25, path
        else:
            assert not bool(node.any()), path


def test_registry_matches_the_reference():
    arch, jarch = get_arch("xdeepfm"), jax_get_arch("xdeepfm")
    assert isinstance(arch, RecsysArch)
    assert arch.name == jarch.name and arch.family == jarch.family == "recsys"
    assert arch.shapes() == jarch.shapes() == list(RECSYS_SHAPES)
    for attr in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(arch, attr)) == dataclasses.asdict(
            getattr(jarch, attr))
    for shape in RECSYS_SHAPES:
        assert arch.skip_reason(shape) == jarch.skip_reason(shape)
