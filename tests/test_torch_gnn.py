"""GNN inference of the port against ``repro`` on the CPU: the graph
generators bit for bit, ``params_from_jax`` exactly, and the GIN (node and
graph readout) and GAT forwards at rtol = atol = 2e-3 float32, on
dst-sorted graphs and on shuffled copies of the same graphs. Also the
registry, and that each forward sorts at most once and sums every
aggregation over sorted ids."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import graphs as jax_graphs  # noqa: E402
from repro.models.gnn import gat as jax_gat  # noqa: E402
from repro.models.gnn import gin as jax_gin  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.gnn_family import GNN_SHAPES  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.models.gnn import gat, gin  # noqa: E402
from repro_torch.models.gnn import graph as gnn_graph  # noqa: E402
from repro_torch.models.gnn.convert import params_from_jax  # noqa: E402
from repro_torch.ops import segment as tseg  # noqa: E402

TOL = 2e-3
MODULES = {"gin-tu": (gin, jax_gin), "gat-cora": (gat, jax_gat)}


@pytest.mark.parametrize("with_positions", [False, True])
def test_full_graph_equals_the_reference(with_positions):
    kw = dict(with_positions=with_positions, seed=3)
    got = graphs.full_graph(700, 5000, 12, 9, **kw)
    want = jax_graphs.full_graph(700, 5000, 12, 9, **kw)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


@pytest.mark.parametrize("batch,seed", [(3, 0), (16, 2)])
def test_molecule_batch_equals_the_reference(batch, seed):
    got = graphs.molecule_batch(batch, seed=seed)
    want = jax_graphs.molecule_batch(batch, seed=seed)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


def _configs(name):
    """The smoke config and a narrow ogb_products one (few layers, the
    shape's in_dim and classes), for the port and the reference."""
    narrow = (dict(num_layers=2, d_hidden=16) if name == "gin-tu"
              else dict(d_hidden=4, num_heads=2))
    return [
        (get_arch(name).smoke_config, jax_get_arch(name).smoke_config),
        (dataclasses.replace(get_arch(name).config_for("ogb_products"), **narrow),
         dataclasses.replace(jax_get_arch(name).config_for("ogb_products"), **narrow)),
    ]


def _jax_params(name, jcfg, seed):
    params = MODULES[name][1].init_params(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", ["gin-tu", "gat-cora"])
def test_params_from_jax_is_exact(name):
    for cfg, jcfg in _configs(name):
        tree = _jax_params(name, jcfg, 1)
        model = params_from_jax(tree, cfg, device="cpu")
        assert not any(p.requires_grad for p in model.parameters())
        for i, layer in enumerate(tree["layers"]):
            mod = model.layers[i]
            for key, leaf in layer.items():
                got = {"w1": mod.w1.weight.T, "b1": mod.w1.bias,
                       "w2": mod.w2.weight.T, "b2": mod.w2.bias,
                       } if name == "gin-tu" else {"w": mod.w.weight.T}
                got = got.get(key, getattr(mod, key, None))
                assert got is not None and got.shape == leaf.shape, (i, key)
                np.testing.assert_array_equal(got.numpy(), leaf, err_msg=f"{i}/{key}")
        if name == "gin-tu":
            np.testing.assert_array_equal(model.head.weight.T.numpy(), tree["head_w"])
            np.testing.assert_array_equal(model.head.bias.numpy(), tree["head_b"])


def test_params_from_jax_rejects_a_wrong_depth():
    cfg, jcfg = _configs("gin-tu")[0]
    tree = _jax_params("gin-tu", jcfg, 0)
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(tree, dataclasses.replace(cfg, num_layers=3), device="cpu")


def _shuffled(g, seed):
    """The same graph with its edges in a random order."""
    perm = np.random.default_rng(seed).permutation(len(g["src"]))
    return dict(g, src=g["src"][perm], dst=g["dst"][perm])


def _relabelled(g, seed):
    """The same batch of graphs with its nodes in a random order, so
    ``graph_ids`` is unsorted too."""
    n = len(g["graph_ids"])
    perm = np.random.default_rng(seed).permutation(n)
    inv = np.empty(n, np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    return dict(g, node_feats=g["node_feats"][perm], graph_ids=g["graph_ids"][perm],
                src=inv[g["src"]], dst=inv[g["dst"]])


def _graph_for(cfg, seed):
    if getattr(cfg, "readout", "node") == "graph":
        return graphs.molecule_batch(6, d_feat=cfg.in_dim, seed=seed)
    return graphs.full_graph(300, 2400, cfg.in_dim, cfg.num_classes, seed=seed)


def _check_forward(name, cfg, jcfg, g, seed):
    tree = _jax_params(name, jcfg, seed)
    model = params_from_jax(tree, cfg, device="cpu")
    got = MODULES[name][0].forward(model, cfg, g)
    jg = {k: (v if k == "num_graphs" else jnp.asarray(v)) for k, v in g.items()}
    want = MODULES[name][1].forward(jax.tree.map(jnp.asarray, tree), jcfg, jg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    return got


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("which", [0, 1], ids=["smoke", "narrow-ogb"])
@pytest.mark.parametrize("name", ["gin-tu", "gat-cora"])
def test_forward_matches_the_reference(name, which, order):
    cfg, jcfg = _configs(name)[which]
    g = _graph_for(cfg, seed=which)
    assert np.all(np.diff(g["dst"]) >= 0)
    if order == "shuffled":
        g = _shuffled(g, seed=5)
        assert np.any(np.diff(g["dst"]) < 0)
    _check_forward(name, cfg, jcfg, g, seed=which + 7)


@pytest.mark.parametrize("order", ["sorted", "relabelled"])
def test_gin_graph_readout_matches_the_reference(order):
    cfg = get_arch("gin-tu").config_for("molecule")
    jcfg = jax_get_arch("gin-tu").config_for("molecule")
    assert cfg.readout == "graph"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg, jcfg = (dataclasses.replace(c, num_layers=2, d_hidden=16) for c in (cfg, jcfg))
    g = graphs.molecule_batch(8, seed=4)
    if order == "relabelled":
        g = _relabelled(g, seed=6)
        assert np.any(np.diff(g["graph_ids"]) < 0)
    got = _check_forward("gin-tu", cfg, jcfg, g, seed=2)
    assert tuple(got.shape) == (8, 2)


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("name,calls", [("gin-tu", 2), ("gat-cora", 4)])
def test_forward_sorts_at_most_once_and_sums_sorted_ids(monkeypatch, name, calls, order):
    cfg, _ = _configs(name)[1]
    g = _graph_for(cfg, seed=1)
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
    mod = MODULES[name][0]
    mod.forward(mod.init_params(cfg, device="cpu"), cfg, g)
    assert seen == [True] * calls
    assert len(sorts) == (order == "shuffled")


def test_forward_runs_where_its_parameters_live():
    cfg = get_arch("gin-tu").smoke_config
    model = gin.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    g = graphs.molecule_batch(2, d_feat=cfg.in_dim)
    out = model(g)  # numpy arrays go to the parameters' device
    assert out.device.type == "cpu" and tuple(out.shape) == (2, cfg.num_classes)
    moved = dict(g, node_feats=torch.from_numpy(g["node_feats"]).to("meta"))
    with pytest.raises(ValueError, match="parameters are on cpu"):
        gin.forward(model, cfg, moved)


@pytest.mark.parametrize("name", ["gin-tu", "gat-cora"])
def test_init_params_follow_the_reference_scales(name):
    cfg = get_arch(name).config_for("ogb_products")
    mod = MODULES[name][0]
    a = mod.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = mod.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    for (key, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), key  # the generator decides every draw
    w = a.layers[0].w1.weight if name == "gin-tu" else a.layers[0].w.weight
    fan_in = cfg.in_dim
    scale = (2.0 if name == "gin-tu" else 1.0) / fan_in
    # A normal truncated to [-2, 2] has variance 0.774 of the normal's.
    assert abs(float(w.var()) / scale - 0.774) < 0.05
    assert float(w.abs().max()) <= 2 * scale ** 0.5 + 1e-6


@pytest.mark.parametrize("name", ["gin-tu", "gat-cora"])
def test_registry_matches_the_reference(name):
    arch, jarch = get_arch(name), jax_get_arch(name)
    assert arch.name == jarch.name and arch.shapes() == jarch.shapes()
    for attr in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(arch, attr)) == dataclasses.asdict(
            getattr(jarch, attr))
    for shape in GNN_SHAPES:
        assert dataclasses.asdict(arch.config_for(shape)) == dataclasses.asdict(
            jarch.config_for(shape))
        assert arch.label_kind(shape) == jarch.label_kind(shape)
        assert arch.skip_reason(shape) == jarch.skip_reason(shape)
    assert arch.module is MODULES[name][0]


def test_other_gnns_still_raise_naming_the_roadmap_item():
    for name in ("egnn", "mace"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 13"):
            get_arch(name)
