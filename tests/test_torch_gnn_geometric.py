"""EGNN, MACE and ``so3`` of the port against ``repro`` on the CPU: the
Clebsch-Gordan tensors bit for bit, the spherical harmonics at 1e-6,
EGNN's readout and positions and MACE's energies at rtol = atol = 2e-3
float32 from the same weights (smoke configs on ``molecule_batch``, and
the full-width configs on a two-graph batch), rotation invariance and
equivariance in the port, and the geometric ``GNNArch`` against the
reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.gnn import so3 as jax_so3  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.gnn_family import GNN_SHAPES, GNNArch  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.models.gnn import egnn, mace, so3  # noqa: E402
from repro_torch.models.gnn import graph as gnn_graph  # noqa: E402
from repro_torch.models.gnn.convert import params_from_jax  # noqa: E402
from repro_torch.ops import segment as tseg  # noqa: E402



TOL = 2e-3
ROT_TOL = 1e-3  # relative, the rotation checks in the port
NAMES = ["egnn", "mace"]


def _triples(l_max):
    r = range(l_max + 1)
    return [(a, b, c) for a in r for b in r for c in r]


@pytest.mark.parametrize("l1,l2,l3", _triples(3))
def test_clebsch_gordan_equals_the_reference_bit_for_bit(l1, l2, l3):
    got = so3.clebsch_gordan_real(l1, l2, l3)
    want = jax_so3.clebsch_gordan_real(l1, l2, l3)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and np.array_equal(got, want)
    t = so3.cg_tensor(l1, l2, l3, torch.float32, "cpu")
    np.testing.assert_array_equal(t.numpy(), want.astype(np.float32))
    assert so3.cg_tensor(l1, l2, l3, torch.float32, "cpu") is t  # cached


def test_cg_coefficients_are_equivariant_in_the_port():
    rng = np.random.default_rng(3)
    for l1, l2, l3 in [(1, 1, 2), (2, 1, 1), (2, 2, 2), (1, 1, 0), (2, 2, 1)]:
        c = so3.clebsch_gordan_real(l1, l2, l3)
        rot = so3._rand_rotation(rng)
        d1, d2, d3 = (so3.wigner_d_real(l, rot) for l in (l1, l2, l3))
        lhs = np.einsum("abc,ax,by->xyc", c, d1, d2)
        rhs = np.einsum("abz,cz->abc", c, d3)
        assert np.abs(lhs - rhs).max() < 1e-10


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_real_sph_harm_matches_the_reference(l):
    rng = np.random.default_rng(l)
    v = rng.normal(size=(257, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    np.testing.assert_array_equal(so3.real_sph_harm_np(l, v),
                                  jax_so3.real_sph_harm_np(l, v))
    if l == 3:
        with pytest.raises(NotImplementedError):
            so3.real_sph_harm(l, torch.from_numpy(v).float())
        return
    vf = v.astype(np.float32)
    got = so3.real_sph_harm(l, torch.from_numpy(vf)).numpy()
    want = np.asarray(jax_so3.real_sph_harm(l, jnp.asarray(vf)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _pair(name, full: bool):
    if full:
        return get_arch(name).config_for("molecule"), jax_get_arch(name).config_for("molecule")
    return get_arch(name).smoke_config, jax_get_arch(name).smoke_config


def _batch(cfg, batch, seed):
    species = getattr(cfg, "num_species", 10)
    return graphs.molecule_batch(batch, d_feat=getattr(cfg, "in_dim", 16),
                                 num_species=species, seed=seed)


def _jax_forward(name, tree, jcfg, g):
    jg = {k: (v if k == "num_graphs" else jnp.asarray(v)) for k, v in g.items()}
    mod = jax_get_arch(name).module
    return mod.forward(jax.tree.map(jnp.asarray, tree), jcfg, jg)


def _tree(name, jcfg, seed):
    mod = jax_get_arch(name).module
    return jax.tree.map(np.asarray, mod.init_params(jax.random.PRNGKey(seed), jcfg))


def _close(got, want):
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _check(name, cfg, jcfg, g, seed):
    tree = _tree(name, jcfg, seed)
    params = params_from_jax(tree, cfg, device="cpu")
    got = get_arch(name).module.forward(params, cfg, g)
    want = _jax_forward(name, tree, jcfg, g)
    if name == "egnn":
        _close(got[0], want[0])  # readout
        _close(got[1], want[1])  # positions
    else:
        _close(got, want)  # energies
    return got


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("batch,seed", [(3, 0), (8, 2)])
@pytest.mark.parametrize("name", NAMES)
def test_smoke_forward_matches_the_reference(name, batch, seed, order):
    cfg, jcfg = _pair(name, full=False)
    g = _batch(cfg, batch, seed)
    if order == "shuffled":
        perm = np.random.default_rng(seed).permutation(len(g["src"]))
        g = dict(g, src=g["src"][perm], dst=g["dst"][perm])
    out = _check(name, cfg, jcfg, g, seed + 1)
    energies = out[0] if name == "egnn" else out
    assert energies.shape[0] == batch


@pytest.mark.parametrize("name", NAMES)
def test_full_width_forward_matches_the_reference(name):
    # The published widths (EGNN 4 x 64, MACE 2 layers x 128 channels,
    # 64 species) on a batch of two molecules.
    cfg, jcfg = _pair(name, full=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _check(name, cfg, jcfg, _batch(cfg, 2, 5), seed=3)


def test_egnn_node_readout_matches_the_reference():
    cfg, jcfg = (dataclasses.replace(c, readout="node") for c in _pair("egnn", False))
    out = _check("egnn", cfg, jcfg, _batch(cfg, 4, 1), seed=2)
    assert tuple(out[0].shape) == (4 * 30, 1)


def _rotation(seed):
    return so3._rand_rotation(np.random.default_rng(seed)).astype(np.float32)


def _rel_close(got, want, what):
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= ROT_TOL * max(scale, 1e-30), what


@pytest.mark.parametrize("name", NAMES)
def test_rotation_invariance_and_equivariance_in_the_port(name):
    arch = get_arch(name)
    for full in (False, True):
        cfg = _pair(name, full)[0]
        g = _batch(cfg, 3, 4)
        if name == "egnn":  # centred positions keep random weights tame
            g = dict(g, positions=(g["positions"] - 5.0) / 5.0)
        params = arch.module.init_params(cfg, generator=torch.Generator().manual_seed(1),
                                         device="cpu")
        rot = _rotation(11)
        g_rot = dict(g, positions=(g["positions"] @ rot.T).astype(np.float32))
        base, turned = (arch.module.forward(params, cfg, x) for x in (g, g_rot))
        if name == "egnn":
            _rel_close(turned[0].numpy(), base[0].numpy(), "readout invariant")
            _rel_close(turned[1].numpy(), base[1].numpy() @ rot.T, "positions rotate")
        else:
            _rel_close(turned.numpy(), base.numpy(), "energies invariant")


@pytest.mark.parametrize("name,calls", [("egnn", 1 + 2 * 2 + 1), ("mace", 3 + 1)])
def test_forward_sums_sorted_ids_and_sorts_at_most_once(monkeypatch, name, calls):
    cfg = get_arch(name).smoke_config
    g = _batch(cfg, 4, 0)
    perm = np.random.default_rng(0).permutation(len(g["src"]))
    shuffled = dict(g, src=g["src"][perm], dst=g["dst"][perm])
    params = get_arch(name).module.init_params(cfg, device="cpu")
    real_sum, real_sort = tseg.segment_sum_sorted, gnn_graph.sort_edges_by_dst
    for graph, want_sorts in ((g, 0), (shuffled, 1)):
        seen, sorts = [], []

        def spy_sum(data, ids, num_segments, **kw):
            seen.append(bool((ids[1:] >= ids[:-1]).all()))
            return real_sum(data, ids, num_segments, **kw)

        def spy_sort(src, dst):
            sorts.append(1)
            return real_sort(src, dst)

        monkeypatch.setattr(tseg, "segment_sum_sorted", spy_sum)
        monkeypatch.setattr(gnn_graph, "sort_edges_by_dst", spy_sort)
        get_arch(name).module.forward(params, cfg, graph)
        assert seen == [True] * calls and len(sorts) == want_sorts


def test_mace_refuses_a_sharding_hook_and_sharded_axes():
    cfg = get_arch("mace").smoke_config
    g = _batch(cfg, 2, 0)
    # Since item 16 MACE applies the hook where the reference does (a
    # layout hook: values unchanged) and both models run edge-parallel;
    # sharded axes need a mesh (tests/test_torch_sharded_train.py holds them
    # on several ranks).
    from repro_torch.launch.mesh import make_test_mesh

    params = mace.init_params(cfg, device="cpu")
    want = mace.forward(params, cfg, g)
    kinds = []
    got = mace.forward(params, cfg, g, constrain=lambda t, kind: kinds.append(kind) or t)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert set(kinds) == {"mix_in", "node", "edge"}
    with pytest.raises(ValueError, match="no mesh is given or active"):
        mace.forward(params, cfg, g, psum_axes=("data",))
    ecfg = get_arch("egnn").smoke_config
    eparams = egnn.init_params(ecfg, device="cpu")
    with pytest.raises(ValueError, match="no mesh is given or active"):
        egnn.forward(eparams, ecfg, _batch(ecfg, 2, 0), psum_axes=("data",))
    with make_test_mesh((1, 1), device="cpu"):
        torch.testing.assert_close(mace.forward(params, cfg, g, psum_axes=("data",)),
                                   want, rtol=0, atol=0)
        got = egnn.forward(eparams, ecfg, _batch(ecfg, 2, 0), psum_axes=("data",))
    for a, b in zip(got, egnn.forward(eparams, ecfg, _batch(ecfg, 2, 0))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _leaf(params, path):
    node = params
    for k in path:
        node = node[getattr(k, "key", getattr(k, "idx", None))]
    return node


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_is_exact(name):
    cfg, jcfg = _pair(name, full=False)
    tree = _tree(name, jcfg, 4)
    params = params_from_jax(tree, cfg, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(_leaf(params, path).numpy(), leaf,
                                      err_msg=str(path))
    assert sum(p.numel() for p in params.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("name", NAMES)
def test_init_params_draw_from_the_generator(name):
    cfg = get_arch(name).config_for("molecule")
    mod = get_arch(name).module
    a = mod.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = mod.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    for (key, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), key
    want = _tree(name, jax_get_arch(name).config_for("molecule"), 0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        got = _leaf(a, path)
        assert tuple(got.shape) == leaf.shape, path
        if leaf.size > 1 and float(np.std(leaf)) > 0:  # the reference's scale
            assert 0.8 < float(got.std()) / float(np.std(leaf)) < 1.25, path
        else:
            assert float(got.abs().max()) <= 3 * float(np.abs(leaf).max()) + 1e-12, path


@pytest.mark.parametrize("name", NAMES)
def test_registry_matches_the_reference(name):
    arch, jarch = get_arch(name), jax_get_arch(name)
    assert isinstance(arch, GNNArch) and arch.geometric == jarch.geometric is True
    assert arch.name == jarch.name and arch.family == jarch.family
    assert arch.shapes() == jarch.shapes() == list(GNN_SHAPES)
    for attr in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(arch, attr)) == dataclasses.asdict(
            getattr(jarch, attr))
    for shape in GNN_SHAPES:
        assert dataclasses.asdict(arch.config_for(shape)) == dataclasses.asdict(
            jarch.config_for(shape))
        assert arch.label_kind(shape) == jarch.label_kind(shape) == "graph_float"
        assert arch.skip_reason(shape) == jarch.skip_reason(shape)
    assert arch.module is {"egnn": egnn, "mace": mace}[name]
