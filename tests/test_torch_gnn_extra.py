"""GCN, GraphSAGE and PNA of the port (``models/gnn/extra.py``) against
``repro.models.gnn.extra`` on the CPU: ``params_from_jax`` exactly, and
the forwards at rtol = atol = 2e-3 float32 from the same weights, on
dst-sorted and shuffled graphs and on a sampled minibatch; each forward
sorts at most once, sums every aggregation over sorted ids, and raises
for sharded axes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import graphs as jax_graphs  # noqa: E402
from repro.models.gnn import extra as jax_extra  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.models.gnn import extra  # noqa: E402
from repro_torch.models.gnn import graph as gnn_graph  # noqa: E402
from repro_torch.models.gnn.convert import params_from_jax  # noqa: E402
from repro_torch.ops import segment as tseg  # noqa: E402



TOL = 2e-3
# name -> (port config, port init, port forward, reference config,
# reference init, reference forward, segment_sum launches a layer)
MODELS = {
    "gcn": (extra.GCNConfig, extra.gcn_init, extra.gcn_forward,
            jax_extra.GCNConfig, jax_extra.gcn_init, jax_extra.gcn_forward, 1),
    "sage": (extra.SAGEConfig, extra.sage_init, extra.sage_forward,
             jax_extra.SAGEConfig, jax_extra.sage_init, jax_extra.sage_forward, 1),
    "pna": (extra.PNAConfig, extra.pna_init, extra.pna_forward,
            jax_extra.PNAConfig, jax_extra.pna_init, jax_extra.pna_forward, 2),
}
NAMES = list(MODELS)


def _configs(name, **kw):
    cfg, _, _, jcfg, _, _, _ = MODELS[name]
    return cfg(**kw), jcfg(**kw)


def _tree(name, jcfg, seed):
    return jax.tree.map(np.asarray, MODELS[name][4](jax.random.PRNGKey(seed), jcfg))


def _shuffled(g, seed):
    perm = np.random.default_rng(seed).permutation(len(g["src"]))
    return dict(g, src=g["src"][perm], dst=g["dst"][perm])


def _check(name, cfg, jcfg, g, seed):
    tree = _tree(name, jcfg, seed)
    params = params_from_jax(tree, cfg, device="cpu")
    got = MODELS[name][2](params, cfg, g)
    jg = {k: (v if k == "num_graphs" else jnp.asarray(v)) for k, v in g.items()}
    want = MODELS[name][5](jax.tree.map(jnp.asarray, tree), jcfg, jg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    return got


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_is_exact(name):
    cfg, jcfg = _configs(name, in_dim=12, num_layers=3)
    tree = _tree(name, jcfg, 1)
    params = params_from_jax(tree, cfg, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    for i, layer in enumerate(tree["layers"]):
        for key, leaf in layer.items():
            np.testing.assert_array_equal(params["layers"][i][key].numpy(), leaf,
                                          err_msg=f"{i}/{key}")
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(tree, dataclasses.replace(cfg, num_layers=2), device="cpu")


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_the_reference(name, num_layers, order):
    cfg, jcfg = _configs(name, in_dim=10, num_classes=5, num_layers=num_layers,
                         d_hidden=16)
    g = graphs.full_graph(300, 2400, 10, 5, seed=num_layers)
    if order == "shuffled":
        g = _shuffled(g, seed=5)
        assert np.any(np.diff(g["dst"]) < 0)
    _check(name, cfg, jcfg, g, seed=num_layers + 7)


@pytest.mark.parametrize("name", NAMES)
def test_forward_on_isolated_nodes_matches_the_reference(name):
    # Nodes with no in-edges: PNA's empty max/min are 0, its attenuation
    # divides by 1e-6; SAGE's mean of nothing is 0.
    cfg, jcfg = _configs(name, in_dim=6, num_classes=3)
    g = graphs.full_graph(400, 150, 6, 3, seed=2)
    assert len(np.unique(g["dst"])) < 400
    _check(name, cfg, jcfg, g, seed=3)


def _minibatch():
    kw = dict(n_nodes=500, n_edges=3000, d_feat=8, batch_nodes=16, fanouts=[3, 2])
    g = graphs.sampled_minibatch(**kw)
    jg = jax_graphs.sampled_minibatch(**kw)
    for key in jg:
        np.testing.assert_array_equal(g[key], jg[key])
    return g


@pytest.mark.parametrize("name", ["gcn", "sage"])
def test_forward_on_a_sampled_minibatch_matches_the_reference(name):
    g = _minibatch()
    cfg, jcfg = _configs(name, in_dim=8, num_classes=41)
    out = _check(name, cfg, jcfg, g, seed=1)
    assert tuple(out.shape) == (len(g["node_feats"]), 41)


def test_pna_on_a_sampled_minibatch_matches_the_reference_layer_by_layer():
    # The sampled minibatch has 73 of its 134 nodes without in-edges and
    # destinations whose sampled messages repeat one row. There PNA's
    # second layer is ill-conditioned in float32: an isolated node's
    # attenuation scaler is 2.5 / 1e-6, so layer 1's outputs reach ~2e3,
    # and a repeated message's variance s2/k - mean^2 is a cancellation
    # of ~1e6-sized terms. So each layer is held at 2e-3 on the same
    # input. The end-to-end two-layer forward is held at 2e-3 on
    # full_graph above. Here the reference's own layer 2 moves past that
    # tolerance when its input is scaled by 1 + 2**-23 (one float32
    # rounding; the port's layer-1 output is that close to the
    # reference's), which is what the layer split is for.
    g = _minibatch()
    cfg, jcfg = _configs("pna", in_dim=8, num_classes=41)
    tree = _tree("pna", jcfg, 1)
    jg = {k: (v if k == "num_graphs" else jnp.asarray(v)) for k, v in g.items()}

    def one_layer(i, feats, port: bool):
        c, jc = (dataclasses.replace(x, num_layers=1, in_dim=feats.shape[1],
                                     num_classes=tree["layers"][i]["b"].shape[0])
                 for x in (cfg, jcfg))
        sub = {"layers": tree["layers"][i:i + 1]}
        if port:
            return extra.pna_forward(params_from_jax(sub, c, device="cpu"), c,
                                     dict(g, node_feats=feats)).numpy()
        return np.asarray(jax_extra.pna_forward(
            jax.tree.map(jnp.asarray, sub), jc, dict(jg, node_feats=jnp.asarray(feats))))

    h_port = np.maximum(one_layer(0, g["node_feats"], True), 0)
    h_ref = np.maximum(one_layer(0, g["node_feats"], False), 0)
    np.testing.assert_allclose(h_port, h_ref, rtol=TOL, atol=TOL)
    assert np.abs(h_port - h_ref).max() <= 1e-6 * np.abs(h_ref).max()
    np.testing.assert_allclose(one_layer(1, h_ref, True), one_layer(1, h_ref, False),
                               rtol=TOL, atol=TOL)
    want = one_layer(1, h_ref, False)
    nudged = (h_ref.astype(np.float64) * (1 + 2.0 ** -23)).astype(np.float32)
    moved = np.abs(one_layer(1, nudged, False) - want)
    assert (moved > TOL + TOL * np.abs(want)).any()


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_sorts_at_most_once_and_sums_sorted_ids(monkeypatch, name, order):
    cfg, _ = _configs(name, in_dim=8, num_layers=2)
    g = graphs.full_graph(200, 1500, 8, cfg.num_classes, seed=1)
    if order == "shuffled":
        g = _shuffled(g, seed=2)
    seen, sorts = [], []
    real_sum, real_sort = tseg.segment_sum_sorted, gnn_graph.sort_edges_by_dst

    def spy_sum(data, ids, num_segments, **kw):
        seen.append(bool((ids[1:] >= ids[:-1]).all()))
        return real_sum(data, ids, num_segments, **kw)

    def spy_sort(src, dst):
        sorts.append(1)
        return real_sort(src, dst)

    monkeypatch.setattr(tseg, "segment_sum_sorted", spy_sum)
    monkeypatch.setattr(gnn_graph, "sort_edges_by_dst", spy_sort)
    MODELS[name][2](MODELS[name][1](cfg, device="cpu"), cfg, g)
    assert seen == [True] * (MODELS[name][6] * cfg.num_layers)
    assert len(sorts) == (order == "shuffled")


@pytest.mark.parametrize("name", NAMES)
def test_sharded_axes_raise_naming_the_roadmap_items(name):
    cfg, _ = _configs(name, in_dim=4)
    g = graphs.full_graph(20, 60, 4, cfg.num_classes)
    params = MODELS[name][1](cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    # edge-parallel since item 16: the axes name axes of a mesh, so with
    # none given or active they raise; on a one-rank mesh the numbers are
    # the meshless ones
    with pytest.raises(ValueError, match="no mesh is given or active"):
        MODELS[name][2](params, cfg, g, psum_axes=("data",))
    from repro_torch.launch.mesh import make_test_mesh

    with make_test_mesh((1, 1), device="cpu"):
        got = MODELS[name][2](params, cfg, g, psum_axes=("data",))
    torch.testing.assert_close(got, MODELS[name][2](params, cfg, g), rtol=0, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_init_params_follow_the_reference_scales(name):
    cfg, _ = _configs(name, in_dim=256)
    init = MODELS[name][1]
    a = init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    for (key, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), key
    layer = a["layers"][0]
    w = layer["w_self"] if name == "sage" else layer["w"]
    fan_in = w.shape[0]
    # A normal truncated to [-2, 2] has variance 0.774 of the normal's.
    assert abs(float(w.var()) / (2.0 / fan_in) - 0.774) < 0.05
    assert not bool(layer["b"].any())
