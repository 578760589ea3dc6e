"""The built train steps (``configs/*_family.py::build``) run with values
on gloo ranks, and ``collectives.reduce_scatter``.

Each spec's step (``make_train_step`` with ``configs/common.py::
ShardedUpdate``) runs twice on ``shard_args`` of the same seeded
arguments on meshes (2, 2) and (1, 2), under ``REPRO_OPT_LEVEL`` 0 and
1, for a dense LM (qwen3-4b), an MoE LM (mixtral-8x7b, at a capacity
where no chunk drops a token), gin-tu, MACE and xDeepFM at their smoke
configs (float32), the shape tables cut to a few rows. The loss of each
step, every gathered parameter and both gathered AdamW moments are held
to ``make_train_step`` run meshless on the whole batch, which
``test_torch_train.py`` holds to ``jax.value_and_grad``: per leaf in
norm at ``TOL``. The LM steps run their microbatches (4 at level 0, and
2 for the dense LM at 1), each rank slicing its own block, so the meshless
step reads the batch with microbatch ``i`` made of every rank's ``i``-th
slice. The AdamW settings clip (``grad_clip`` 0.01), so the global norm
shows in the moments, and start at the peak rate, so the parameters
move. Every rank holds the same losses.

``reduce_scatter`` over each tuple of axes and along dims 0 and 1 equals
``chunk`` of ``all_reduce`` bit for bit (integer-valued float32, so any
order of the sums is exact)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_sharding import collect, cpu_mesh, start_ranks  # noqa: E402

# float32 sums in other orders (the MoE's exchanges, the gradients'
# reductions): the worst leaf of the MoE LM's second moment at 3.0e-4,
# the median 1.6e-7; a wrong norm or block is off by O(1)
TOL = 1e-3
STEPS = 2
MESHES = {4: (2, 2), 2: (1, 2)}
LEVELS = (0, 1)
# name -> (arch, shape)
ARCHS = {
    "dense_lm": ("qwen3-4b", "train_4k"),
    "moe_lm": ("mixtral-8x7b", "train_4k"),
    "gin": ("gin-tu", "ogb_products"),
    "mace": ("mace", "ogb_products"),
    "xdeepfm": ("xdeepfm", "train_batch"),
}
# the shape tables cut to a few rows (edges divide over four ranks)
SMALL = {
    "train_4k": dict(kind="train", seq=8, batch=16),
    "ogb_products": dict(n=48, m=160, d=12, classes=5),
    "train_batch": dict(kind="train", batch=16),
}
RS_AXES = [("data",), ("model",), ("data", "model")]


class _small_shapes:
    """The family tables' cells of ``SMALL`` replaced while inside."""

    def __enter__(self):
        from repro_torch.configs import gnn_family, lm_family, recsys_family

        self.saved = []
        for table in (lm_family.LM_SHAPES, gnn_family.GNN_SHAPES,
                      recsys_family.RECSYS_SHAPES):
            for key, info in SMALL.items():
                if key in table:
                    self.saved.append((table, key, table[key]))
                    table[key] = info
        return self

    def __exit__(self, *exc):
        for table, key, info in self.saved:
            table[key] = info


def _arch(name):
    """The arch at its smoke config (float32; the MoE at capacity 16),
    with AdamW settings that clip and start at the peak rate."""
    from repro_torch.configs import get_arch

    arch = get_arch(ARCHS[name][0])
    cfg = arch.smoke_config
    if arch.family == "lm":
        cfg = dataclasses.replace(cfg, dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=16.0))
    arch = dataclasses.replace(arch, config=cfg)
    if arch.family == "lm":
        arch = dataclasses.replace(arch, train_microbatches=4)
    opt = dataclasses.replace(arch.opt_config(), lr=1e-3, warmup_steps=1,
                              grad_clip=1e-2)
    arch.opt_config = lambda: opt
    return arch


def _inputs(name, arch):
    """(params, batch) from seeds, the batch whole."""
    from repro_torch.configs.gnn_family import GNN_SHAPES

    gen = torch.Generator().manual_seed(5)
    r = np.random.default_rng(7)
    if arch.family == "lm":
        from repro_torch.models.transformer import init_params

        cfg, info = arch.config, SMALL["train_4k"]
        b, s = info["batch"], info["seq"]
        labels = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        labels[1, :5] = -1  # microbatches count different positions
        labels[6, ::2] = -1
        batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 "labels": labels}
        return init_params(cfg, device="cpu", generator=gen), _tensors(batch)
    if arch.family == "gnn":
        shape = ARCHS[name][1]
        cfg, info = arch.config_for(shape), GNN_SHAPES[shape]
        n, m = info["n"], info["m"]
        dst = np.sort(r.integers(0, n, m))
        g = {"src": ((dst + r.integers(1, n, m)) % n).astype(np.int32),
             "dst": dst.astype(np.int32),
             "graph_ids": np.zeros(n, np.int32),
             "node_feats": r.normal(size=(n, info["d"])).astype(np.float32)}
        if arch.geometric:
            g["positions"] = r.normal(size=(n, 3)).astype(np.float32)
            g["species"] = r.integers(0, cfg.num_species, n).astype(np.int32)
            g["labels"] = r.normal(size=(1,)).astype(np.float32)
        else:
            g["labels"] = r.integers(0, cfg.num_classes, n).astype(np.int32)
        return arch.module.init_params(cfg, device="cpu", generator=gen), _tensors(g)
    from repro_torch.models.recsys import xdeepfm as xm

    cfg, b = arch.config, SMALL["train_batch"]["batch"]
    batch = {"sparse_ids": r.integers(0, cfg.vocab_per_field,
                                      (b, cfg.n_fields)).astype(np.int32),
             "labels": r.integers(0, 2, b).astype(np.int32)}
    return xm.init_params(cfg, device="cpu", generator=gen), _tensors(batch)


def _tensors(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _named(tree):
    if isinstance(tree, torch.nn.Module):
        return {n: p.detach().float().numpy().copy() for n, p in tree.named_parameters()}
    return {n: t.detach().float().numpy().copy() for n, t in tree.items()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _built_case(name, mesh):
    """(the losses of ``STEPS`` steps, and on rank 0 the gathered
    parameters and moments)."""
    from repro_torch.configs.common import shard_args
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.train.optimizer import init_opt_state

    arch = _arch(name)
    spec = arch.build(ARCHS[name][1], mesh)
    params, batch = _inputs(name, arch)
    opt = init_opt_state(params, arch.opt_config())
    local = shard_args((params, opt, batch), spec.in_specs, mesh)
    p, o, b = local
    losses = []
    with mesh:
        for _ in range(STEPS):
            p, o, loss = spec.fn(p, o, b)
            losses.append(float(loss))
    pspecs, ospecs = spec.in_specs[0], spec.in_specs[1]
    got = {"params": gather_tree(p, pspecs, mesh),
           "m": gather_tree(o["m"], ospecs["m"], mesh),
           "v": gather_tree(o["v"], ospecs["v"], mesh)}
    if mesh.rank:
        return losses, None
    return losses, {k: _named(v) for k, v in got.items()}


def _reduce_scatter_case(mesh, axes, dim):
    """``reduce_scatter`` and ``chunk`` of ``all_reduce`` of the same
    integer-valued tensor (this rank's own)."""
    from repro_torch.distributed.collectives import all_reduce, chunk, reduce_scatter

    r = np.random.default_rng(100 + mesh.rank)
    x = torch.from_numpy(r.integers(-50, 50, (4, 8, 3)).astype(np.float32))
    return (reduce_scatter(x, mesh, axes, dim).numpy(),
            chunk(all_reduce(x, mesh, axes), mesh, axes, dim).numpy())


def _rank_cases(rank, size, payload):
    import os

    mesh = cpu_mesh(MESHES[size])
    out = {}
    with _small_shapes():
        for level in LEVELS:
            os.environ["REPRO_OPT_LEVEL"] = str(level)
            for name in ARCHS:
                out[(name, level)] = _built_case(name, mesh)
    for axes in RS_AXES:
        for dim in (0, 1):
            out[("rs", axes, dim)] = _reduce_scatter_case(mesh, axes, dim)
    return out


# ---------------------------------------------------------------------------
# the meshless step, the fixture and the tests
# ---------------------------------------------------------------------------


def _microbatch_major(batch, ranks, n):
    """The whole batch reordered so that microbatch ``i`` of the meshless
    step holds each of the ``ranks`` blocks' ``i``-th slice."""
    rows = next(iter(batch.values())).shape[0]
    per = rows // ranks // n
    order = [r * (rows // ranks) + i * per + j
             for i in range(n) for r in range(ranks) for j in range(per)]
    return {k: v[order] for k, v in batch.items()}


def _meshless(name, level, size):
    """``make_train_step`` on the whole batch, in the order of the mesh of
    ``size`` ranks: the losses of ``STEPS`` steps, the parameters and
    moments after them, and the parameters before."""
    from repro_torch.configs.gnn_family import GNN_SHAPES
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_opt_state

    arch = _arch(name)
    params, batch = _inputs(name, arch)
    before = _named(params)
    nmb = 1
    if arch.family == "lm":
        from repro_torch.models.transformer import loss_fn

        cfg, nmb = arch.config, arch.microbatches()
        batch = _microbatch_major(batch, MESHES[size][0], nmb)

        def loss(p, b):
            return loss_fn(p, cfg, b)
    elif arch.family == "gnn":
        key = ARCHS[name][1]
        cfg = arch.config_for(key)
        graphs = GNN_SHAPES[key].get("graphs", 1)

        def loss(p, g):
            return arch.module.loss_fn(p, cfg, dict(g, num_graphs=graphs))
    else:
        from repro_torch.models.recsys import xdeepfm as xm

        cfg = arch.config

        def loss(p, b):
            return xm.loss_fn(p, cfg, b)
    opt_cfg = arch.opt_config()
    step = make_train_step(loss, opt_cfg, num_microbatches=nmb)
    opt = init_opt_state(params, opt_cfg)
    losses = []
    for _ in range(STEPS):
        params, opt, _, metrics = step(params, opt, None, batch)
        losses.append(float(metrics["loss"]))
    return losses, {"params": _named(params), "m": _named(opt["m"]),
                    "v": _named(opt["v"])}, before


class _opt_level:
    """``REPRO_OPT_LEVEL`` set while inside."""

    def __init__(self, level):
        self.level = str(level)

    def __enter__(self):
        import os

        self.saved = os.environ.get("REPRO_OPT_LEVEL")
        os.environ["REPRO_OPT_LEVEL"] = self.level

    def __exit__(self, *exc):
        import os

        if self.saved is None:
            os.environ.pop("REPRO_OPT_LEVEL")
        else:
            os.environ["REPRO_OPT_LEVEL"] = self.saved


CASES = [(size, name, level) for size in MESHES for level in LEVELS for name in ARCHS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{size: [per-rank results]}`` of 4 and 2 spawned ranks, and the
    meshless step of every case (each distinct one run once, while the
    ranks work)."""
    tmp = tmp_path_factory.mktemp("built")
    handles = {size: start_ranks(tmp, size, _rank_cases, None) for size in MESHES}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops, beside the ranks
    try:
        want, memo = {}, {}
        with _small_shapes():
            for size, name, level in CASES:
                with _opt_level(level):
                    arch = _arch(name)
                    key = ((name, arch.microbatches(), MESHES[size][0])
                           if arch.family == "lm" else (name,))
                    if key not in memo:
                        memo[key] = _meshless(name, level, size)
                want[(size, name, level)] = memo[key]
    finally:
        torch.set_num_threads(threads)
        got = {size: collect(h) for size, h in handles.items()}
    return got, want


def _err(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("size,name,level", CASES)
def test_built_step_matches_the_meshless_step(runs, size, name, level):
    want_losses, want, before = runs[1][(size, name, level)]
    results = [r[(name, level)] for r in runs[0][size]]
    losses = [loss for loss, _ in results]
    assert all(x == losses[0] for x in losses), losses  # every rank the same
    np.testing.assert_allclose(losses[0], want_losses, rtol=TOL)
    got = results[0][1]
    for group in ("params", "m", "v"):
        assert set(got[group]) == set(want[group]), group
        for leaf, w in want[group].items():
            g = got[group][leaf]
            assert g.shape == w.shape, (group, leaf)
            if group == "params":  # what the steps moved it by
                g, w = g - before[leaf], w - before[leaf]
            assert _err(g, w) <= TOL, (group, leaf, _err(g, w))
    assert any(np.any(w != before[leaf]) for leaf, w in want["params"].items())


@pytest.mark.parametrize("size", list(MESHES))
@pytest.mark.parametrize("axes", RS_AXES)
@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_scatter_is_the_chunk_of_the_all_reduce(runs, size, axes, dim):
    for r in runs[0][size]:
        got, want = r[("rs", axes, dim)]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
