"""Sharded training on gloo ranks: the LM under a mesh and the
edge-parallel GNNs.

The LM under a mesh (``repro_torch.models.transformer`` with
``mesh=``) on gloo ranks: ``loss_fn``'s value and gradients against the
meshless reference's ``jax.value_and_grad``, and ``prefill`` /
``serve_step`` against the meshless port.

* Meshes (1, 1) in this process and (2, 2) on four spawned ranks, every
  case inside that one spawn (``test_torch_sharding.py`` runs (1, 2) and
  (2, 1)).
* GQA with a sliding window and MoE (mixtral), MLA with MoE over
  ``("data", "model")`` and the MTP term (deepseek-v3), qk-norm (qwen3),
  MQA with tied embeddings (gemma), at a capacity factor where no chunk
  drops a token, so every MoE schedule computes the meshless function;
  ``labels`` with -1 spread unevenly over the data shards.
* Gradients: each rank's after ``reduce_gradients`` over the batch
  axes, gathered to full tensors, against the reference's at rtol 2e-3
  (atol 2e-3 times the leaf's rms) in float32. In bf16 the oracle is the
  meshless port's ``value_and_grad``, per leaf in norm at 3e-2: the
  reference's jitted bf16 keeps float32 intermediates (ROADMAP queue
  3), its op-by-op run takes half a minute, and
  ``test_torch_losses.py`` holds the meshless bf16 LM to it. Every
  rank's loss is the same number.
* Decode: the last logits and the gathered caches of ``prefill(mesh=)``
  (which runs ``serve_step``, the MoE layers on the psum schedule)
  against the meshless port's at 2e-3.

The GNNs edge-parallel (``psum_axes``) on gloo ranks against the
meshless reference: every node on every rank, this rank's block of the
edges, the partial aggregates summed (and PNA's and GAT's extremes
maxed) over the mesh axes by ``ops/segment.py``'s ``_dist``
reductions.

GIN, GAT, SAGE, PNA, EGNN and MACE (random weights in the reference's
trees): the loss and every gradient (each rank's after
``reduce_gradients`` over the edge axes) against ``jax.value_and_grad`` of the reference's loss
on the whole graph, at rtol 2e-3 (atol 2e-3 times the leaf's rms); every
rank holds the same loss and gradients. Meshes (1, 1) in this process
and (2, 2) on the four spawned ranks, the edges split over both axes; MACE runs with a ``constrain`` hook that records the kinds it
sees."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_sharding import collect, cpu_mesh, start_ranks  # noqa: E402

TOL = 2e-3
BF16_TOL = 3e-2
# (1, 2) and (2, 1) run in test_torch_sharding.py (the MoE schedules,
# the lookup, layouts): here the world sizes are 1 and 4, so each spawn
# is one group of four beside the other test files.
MESHES = {1: [(1, 1)], 4: [(2, 2)]}
# name -> (arch, dtype, config changes); the MoE ones at capacity 16
CONFIGS = {
    "mixtral": ("mixtral-8x7b", "float32", {}),
    "deepseek": ("deepseek-v3-671b", "float32", {"ep_axes": ("data", "model")}),
    "qwen3": ("qwen3-4b", "float32", None),
    "gemma": ("gemma-2b", "float32", None),
    "mixtral_bf16": ("mixtral-8x7b", "bfloat16", {}),
}
BF16_MESHES = {(2, 2)}


def _cfg(name, pkg):
    arch, dtype, moe = CONFIGS[name]
    if pkg == "port":
        from repro_torch.configs import get_arch
    else:
        from repro.configs import get_arch
    cfg = dataclasses.replace(get_arch(arch).smoke_config, dtype=dtype)
    if moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0, **moe))
    return cfg


def _batch(cfg):
    r = np.random.default_rng(3)
    tokens = r.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    labels = r.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    labels[0, :7] = -1  # the first data shard counts far fewer positions
    labels[2, ::2] = -1
    return {"tokens": tokens, "labels": labels}


def _cases(size):
    """Every config on every mesh, bf16 only on (2, 2)."""
    return [(name, shape) for shape in MESHES[size] for name in CONFIGS
            if not name.endswith("bf16") or shape in BF16_MESHES]


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _train_case(name, trees, mesh):
    """(loss, the gathered gradients on rank 0 else None, the MoE
    schedules that ran)."""
    from repro_torch.configs.lm_family import lm_param_specs
    from repro_torch.distributed.sharding import gather_tree, reduce_gradients, shard_tree
    from repro_torch.models.transformer import loss_fn, moe
    from repro_torch.models.transformer.convert import params_from_jax
    from repro_torch.models.transformer.model import batch_axes

    cfg = _cfg(name, "port")
    full = params_from_jax(trees[name], cfg, device="cpu")
    specs = lm_param_specs(full, cfg, mesh)
    params = shard_tree(full, specs, mesh).requires_grad_(True)
    batch = _batch(cfg)
    ran = set()
    saved = {s: getattr(moe, s) for s in ("_moe_a2a", "_moe_psum", "_moe_expert_tp")}

    def spy(sname):
        def call(*a, **k):
            ran.add(sname)
            return saved[sname](*a, **k)
        return call

    try:
        for s in saved:
            setattr(moe, s, spy(s))
        loss = loss_fn(params, cfg, batch, mesh=mesh)
        loss.backward()
    finally:
        for s, fn in saved.items():
            setattr(moe, s, fn)
    reduce_gradients(params, specs, mesh,
                     batch_axes(mesh, batch["tokens"].shape[0]))
    grads = gather_tree({n: p.grad for n, p in params.named_parameters()}, specs, mesh)
    keep = mesh.rank == 0
    return (loss.item(), {n: g.float().numpy() for n, g in grads.items()} if keep
            else None, sorted(ran))


def _decode_case(name, trees, mesh):
    """The last logits (this rank's block), the block's index and the
    gathered caches of ``prefill(mesh=)``."""
    from repro_torch.configs.lm_family import lm_param_specs
    from repro_torch.distributed.sharding import gather_tensor, shard_tree
    from repro_torch.models.transformer import prefill
    from repro_torch.models.transformer.convert import params_from_jax

    cfg = _cfg(name, "port")
    full = params_from_jax(trees[name], cfg, device="cpu")
    params = shard_tree(full, lm_param_specs(full, cfg, mesh), mesh)
    tokens = _batch(cfg)["tokens"][:2, :5]
    with torch.no_grad():
        logits, cache = prefill(params, cfg, tokens, 8, mesh=mesh)
    caches = {f"{g}/{k}": gather_tensor(v, cache.specs[g][k], mesh).float().numpy()
              for g, c in cache.items() for k, v in c.items()}
    dp = cache.batch_axes
    return logits.float().numpy(), mesh.axis_index(dp) if dp else 0, caches


def _lm_rank_cases(rank, size, trees):
    out = {}
    for name, shape in _cases(size):
        mesh = cpu_mesh(shape)
        out[(name, shape)] = _train_case(name, trees, mesh)
        if not name.endswith("bf16"):
            out[(name, shape, "decode")] = _decode_case(name, trees, mesh)
    return out


# ---------------------------------------------------------------------------
# the fixture and the tests
# ---------------------------------------------------------------------------


def _reference(name, tree):
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import loss_fn as jax_loss

    jcfg = _cfg(name, "ref")
    jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_loss(p, jcfg, jbatch)))(tree)
    return float(loss), jax.tree.map(np.asarray, grads)


def _tree(name, seed):
    """Random weights in the reference's tree, laid out from the port's
    leaves (``lm_family._port_leaves``; no JAX trace): each matrix
    normal times its fan-in ** -0.5, the embedding times 0.02, each norm
    gain and vector times 0.1."""
    import ml_dtypes

    from repro_torch.configs.lm_family import _port_leaves
    from repro_torch.models.transformer import init_params

    cfg = _cfg(name, "port")
    meta = {n: p for n, p in init_params(cfg, device="meta").named_parameters()}
    leaves = {}
    for port_name, path, stacked, transposed in _port_leaves(cfg):
        p = meta[port_name]
        shape = tuple(p.shape)[::-1] if transposed else tuple(p.shape)
        if stacked:
            layers = leaves.get(path, (None, None, 0))[2] + 1
            leaves[path] = ((layers,) + shape, p.dtype, layers)
        else:
            leaves[path] = (shape, p.dtype, 0)
    r = np.random.default_rng(seed)
    tree = {}
    for path, (shape, dtype, _) in leaves.items():
        key = path.split("/")[-1]
        if len(shape) == 1 or "norm" in key or key in ("ln1", "ln2"):
            scale = 0.1
        elif key == "embed":
            scale = 0.02
        else:
            scale = shape[-2] ** -0.5
        a = (r.normal(size=shape) * scale).astype(np.float32)
        if dtype == torch.bfloat16:
            a = a.astype(ml_dtypes.bfloat16)
        node = tree
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[key] = a
    return tree


_LM_REF_SCRIPT = """
import pickle, sys
sys.path.insert(0, {tests!r})
import test_torch_sharded_train as t
with open({inp!r}, "rb") as f:
    trees = pickle.load(f)
out = {{name: t._reference(name, trees[name]) for name in t.CONFIGS
        if not name.endswith("bf16")}}
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
"""


def _start_lm_reference(tmp, trees):
    """The reference's ``jax.value_and_grad`` of every float32 config, in a
    subprocess beside this one's work; returns (process, output file)."""
    import os
    import pickle
    import subprocess
    import sys

    from test_torch_sharding import ROOT

    with open(tmp / "lm_trees.pkl", "wb") as f:
        pickle.dump(trees, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    script = _LM_REF_SCRIPT.format(tests=str(ROOT / "tests"), inp=str(tmp / "lm_trees.pkl"),
                                   out=str(tmp / "lm_ref.pkl"))
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp / "lm_ref.pkl"


def _rank_cases(rank, size, payload):
    return _lm_rank_cases(rank, size, payload["lm"]) | _gnn_rank_cases(
        rank, size, payload["gnn"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The references, and ``{size: [per-rank results]}`` of 2 and 4
    spawned ranks and of this process's one."""
    import pickle

    from test_torch_sharding import TIMEOUT

    tmp = tmp_path_factory.mktemp("train")
    trees = {name: _tree(name, i) for i, name in enumerate(CONFIGS)}
    proc, out = _start_lm_reference(tmp, trees)
    try:
        gnn_trees = {name: _gnn_init(name) for name in GNN_MODELS}
        payload = {"lm": trees, "gnn": gnn_trees}
        handle = start_ranks(tmp, 4, _rank_cases, payload)
        # the references compile while the ranks work
        gnn_refs = {name: _gnn_reference(name, gnn_trees[name]) for name in GNN_MODELS}
        ranks = {4: collect(handle), 1: [_rank_cases(0, 1, payload)]}
        log, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    with open(out, "rb") as f:
        refs = pickle.load(f)
    return {"trees": trees, "refs": refs, "gnn_refs": gnn_refs, "ranks": ranks}


def _meshless_port(name, tree):
    from repro_torch.models.transformer import loss_fn
    from repro_torch.models.transformer.convert import params_from_jax

    cfg = _cfg(name, "port")
    params = params_from_jax(tree, cfg, device="cpu").requires_grad_(True)
    loss = loss_fn(params, cfg, _batch(cfg))
    loss.backward()
    return loss.item(), {n: p.grad.float().numpy() for n, p in params.named_parameters()}


def _want_grads(name, grads):
    from repro_torch.models.transformer.convert import params_from_jax

    module = params_from_jax(grads, _cfg(name, "port"), device="cpu")
    return {n: p.float().numpy() for n, p in module.named_parameters()}


ALL = [(size, name, shape) for size in MESHES for name, shape in _cases(size)]


@pytest.mark.parametrize("size,name,shape", ALL)
def test_sharded_loss_and_grads_match_the_meshless_reference(runs, size, name, shape):
    trees, refs, ranks = runs["trees"], runs["refs"], runs["ranks"]
    results = [r[(name, shape)] for r in ranks[size]]
    bf16 = name.endswith("bf16")
    if bf16:
        want, want_g = _meshless_port(name, trees[name])
    else:
        want, want_g = refs[name]
        want_g = _want_grads(name, want_g)
    tol = BF16_TOL if bf16 else TOL
    losses = [loss for loss, _, _ in results]
    assert len(set(losses)) == 1, losses  # every rank holds the whole loss
    np.testing.assert_allclose(losses[0], want, rtol=tol)
    got_g = results[0][1]
    assert set(got_g) == set(want_g)
    for n, w in want_g.items():
        g = got_g[n]
        assert g.shape == w.shape, n
        if bf16:
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= tol, (n, err)
        else:
            rms = float(np.sqrt(np.mean(np.square(w))))
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol * rms + 1e-9, err_msg=n)


def test_the_meshes_reach_every_training_schedule(runs):
    ranks = runs["ranks"]
    ran = {(key[0], key[1]): res[2] for size in MESHES for r in ranks[size]
           for key, res in r.items() if isinstance(key, tuple) and len(key) == 2}
    assert ran[("deepseek", (2, 2))] == ["_moe_a2a"]  # experts over data and model
    assert ran[("mixtral", (2, 2))] == ["_moe_a2a"]
    assert ran[("mixtral_bf16", (2, 2))] == ["_moe_a2a"]
    assert ran[("mixtral", (1, 1))] == ["_moe_expert_tp"]
    assert ran[("qwen3", (2, 2))] == []


DECODE = [(size, name, shape) for size, name, shape in ALL if not name.endswith("bf16")]


@pytest.mark.parametrize("size,name,shape", DECODE)
def test_sharded_decode_matches_the_meshless_port(runs, size, name, shape):
    from repro_torch.models.transformer import prefill
    from repro_torch.models.transformer.convert import params_from_jax

    trees, ranks = runs["trees"], runs["ranks"]
    cfg = _cfg(name, "port")
    params = params_from_jax(trees[name], cfg, device="cpu")
    tokens = _batch(cfg)["tokens"][:2, :5]
    with torch.no_grad():
        want, cache = prefill(params, cfg, tokens, 8)
    want = want.numpy()
    for r in ranks[size]:
        logits, block, caches = r[(name, shape, "decode")]
        rows = logits.shape[0]
        assert rows == 2 // shape[0]  # the batch of 2 splits over "data"
        np.testing.assert_allclose(logits, want[block * rows:(block + 1) * rows],
                                   rtol=TOL, atol=TOL, err_msg=name)
        for key, got in caches.items():
            g, k = key.split("/")
            np.testing.assert_allclose(got, cache[g][k].numpy(), rtol=TOL, atol=TOL,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# the edge-parallel GNNs
# ---------------------------------------------------------------------------

AXES = ("data", "model")
GNN_MESHES = {1: (1, 1), 4: (2, 2)}
EXTRA_KW = dict(num_layers=2, d_hidden=16, in_dim=12, num_classes=5)
GNN_MODELS = ["gin_node", "gat", "sage", "pna", "egnn", "mace"]


def _gnn_graph(name):
    from repro_torch.data import graphs

    if name in ("gin_graph", "egnn", "mace"):
        if name == "gin_graph":
            g = graphs.molecule_batch(6, d_feat=_gnn_cfg(name, "port").in_dim, seed=1)
            g["labels"] = np.random.default_rng(2).integers(
                -1, 3, g["num_graphs"]).astype(np.int32)
            return g
        cfg = _gnn_cfg(name, "port")
        g = graphs.molecule_batch(4, d_feat=getattr(cfg, "in_dim", 16),
                                  num_species=getattr(cfg, "num_species", 10), seed=3)
        g["labels"] = np.random.default_rng(3).normal(
            size=g["num_graphs"]).astype(np.float32)
        return g
    if name in ("gcn", "sage", "pna"):
        g = graphs.full_graph(150, 900, 12, 5, seed=2)
        g["labels"] = np.where(np.arange(150) % 7 == 0, -1, g["labels"]).astype(np.int32)
        return g
    cfg = _gnn_cfg(name, "port")
    g = graphs.full_graph(120, 600, cfg.in_dim, cfg.num_classes, seed=1)
    g["labels"] = np.where(np.arange(120) % 5 == 0, -1, g["labels"]).astype(np.int32)
    return g


def _gnn_cfg(name, pkg):
    if pkg == "port":
        from repro_torch.configs import get_arch
        from repro_torch.models.gnn import extra
    else:
        from repro.configs import get_arch
        from repro.models.gnn import extra
    if name in ("gcn", "sage", "pna"):
        return getattr(extra, f"{name.upper()}Config")(**EXTRA_KW)
    arch = {"gin_node": "gin-tu", "gin_graph": "gin-tu", "gat": "gat-cora"}.get(name, name)
    cfg = get_arch(arch).smoke_config
    if name.startswith("gin"):
        cfg = dataclasses.replace(cfg, readout=name[4:])
    return cfg


def _gnn_loss(name, pkg):
    if pkg == "port":
        from repro_torch.configs import get_arch
        from repro_torch.models.gnn import extra, gat, gin
    else:
        from repro.configs import get_arch
        from repro.models.gnn import extra, gat, gin
    if name in ("gcn", "sage", "pna"):
        return getattr(extra, f"{name}_loss")
    if name.startswith("gin"):
        return gin.loss_fn
    if name == "gat":
        return gat.loss_fn
    return get_arch(name).module.loss_fn


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _gnn_port(name, tree, mesh, part, parts, axes=AXES):
    """(loss, {name: gradient}, the kinds MACE's hook saw) on this rank's
    block ``part`` of ``parts`` of the edges."""
    from repro_torch.distributed.sharding import reduce_gradients
    from repro_torch.models.gnn.convert import params_from_jax

    cfg = _gnn_cfg(name, "port")
    g = _gnn_graph(name)
    blocks = np.array_split(np.arange(len(g["src"])), parts)[part]
    g = dict(g, src=g["src"][blocks], dst=g["dst"][blocks])
    params = params_from_jax(tree, cfg, device="cpu").requires_grad_(True)
    kinds = set()
    kw = {}
    if name == "mace":
        kw["constrain"] = lambda t, kind: kinds.add(kind) or t
    with mesh:
        loss = _gnn_loss(name, "port")(params, cfg, g, psum_axes=axes, **kw)
    loss.backward()
    reduce_gradients(params, {}, mesh, axes)
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
             for n, p in params.named_parameters()}  # an unused leaf's is 0, as in JAX
    return loss.item(), grads, sorted(kinds)


def _gnn_rank_cases(rank, size, trees):
    mesh = cpu_mesh(GNN_MESHES[size])
    return {name: _gnn_port(name, trees[name], mesh, rank, size) for name in GNN_MODELS}


# ---------------------------------------------------------------------------
# the fixture and the tests
# ---------------------------------------------------------------------------


def _gnn_init(name):
    import jax

    from repro.configs import get_arch
    from repro.models.gnn import extra

    cfg = _gnn_cfg(name, "ref")
    if name in ("gcn", "sage", "pna"):
        init = getattr(extra, f"{name}_init")
    elif name.startswith("gin") or name == "gat":
        init = get_arch("gin-tu" if name.startswith("gin") else "gat-cora").module.init_params
    else:
        init = get_arch(name).module.init_params
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    r = np.random.default_rng(GNN_MODELS.index(name))

    def draw(path, leaf):
        """Random weights in the reference's tree (no compile): matrices
        normal times fan-in ** -0.5, vectors and scalars normal times
        0.1, LayerNorm gains about 1."""
        key = jax.tree_util.keystr(path)
        if len(leaf.shape) >= 2:
            return (r.normal(size=leaf.shape) * leaf.shape[-2] ** -0.5).astype(np.float32)
        a = (r.normal(size=leaf.shape) * 0.1).astype(np.float32)
        return a + 1 if "ln_g" in key else a

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _gnn_reference(name, tree):
    import jax
    import jax.numpy as jnp

    cfg = _gnn_cfg(name, "ref")
    g = {k: (v if k == "num_graphs" else jnp.asarray(v)) for k, v in _gnn_graph(name).items()}
    loss = _gnn_loss(name, "ref")
    want, grads = jax.jit(jax.value_and_grad(lambda p: loss(p, cfg, g)))(tree)
    return float(want), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("size", list(GNN_MESHES))
@pytest.mark.parametrize("name", GNN_MODELS)
def test_edge_parallel_loss_and_grads_match_the_meshless_reference(runs, name, size):
    from repro_torch.models.gnn.convert import params_from_jax

    refs, ranks = runs["gnn_refs"], runs["ranks"]
    want, want_g = refs[name]
    want_g = {n: p.detach().numpy() for n, p in params_from_jax(
        want_g, _gnn_cfg(name, "port"), device="cpu").named_parameters()}
    first = ranks[size][0][name]
    for loss, grads, kinds in (r[name] for r in ranks[size]):
        assert loss == first[0]
        np.testing.assert_allclose(loss, want, rtol=TOL)
        assert set(grads) == set(want_g)
        for n, w in want_g.items():
            np.testing.assert_array_equal(grads[n], first[1][n], err_msg=n)
            rms = float(np.sqrt(np.mean(np.square(w)))) if w.size else 0.0
            np.testing.assert_allclose(grads[n], w, rtol=TOL, atol=TOL * rms + 1e-9,
                                       err_msg=f"{name}/{n}")
        if name == "mace":
            assert kinds == ["edge", "mix_in", "node"]


def test_dist_reductions_without_a_mesh_raise_and_without_axes_are_local():
    from repro_torch.ops.segment import segment_max, segment_max_dist, segment_sum_dist

    data = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    ids = torch.tensor([0, 0, 2])
    assert torch.equal(segment_max_dist(data, ids, 3), segment_max(data, ids, 3))
    with pytest.raises(ValueError, match="no mesh is given or active"):
        segment_sum_dist(data, ids, 3, ("data",))
    mesh = cpu_mesh((1, 1))
    got = segment_sum_dist(data, ids, 3, ("data",), mesh=mesh)
    np.testing.assert_array_equal(got.numpy(), [[2, 4], [0, 0], [4, 5]])
