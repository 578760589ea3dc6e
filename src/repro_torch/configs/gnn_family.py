"""The GNN family of the port's registry (gin-tu, gat-cora, egnn, mace):
the shape table and ``GNNArch`` of ``repro/configs/gnn_family.py``.

Shapes (per assignment):
  full_graph_sm   n=2,708    m=10,556       d_feat=1,433  (full-batch, Cora)
  minibatch_lg    n=232,965  m=114,615,892  batch=1,024 fanout 15-10 (Reddit)
  ogb_products    n=2,449,029 m=61,859,140  d_feat=100    (full-batch-large)
  molecule        n=30 m=64 per graph, batch=128          (batched-small)

The table is copied, not imported: the reference module imports jax. A
``geometric`` architecture (EGNN, MACE) reads positions and species and
reads out one energy-style float a graph on every shape.

Distribution (``GNNArch.build``): edges sharded over every mesh axis
(the irregular dimension; the data pipeline pre-sorts them by dst),
node tensors, parameters and AdamW's moments replicated; each layer
sums its partial aggregates over the edge axes (``psum_axes``). Under
``REPRO_OPT_LEVEL`` != 0 MACE on the big graphs shards its edges over
the data axes only and passes the reference's channel-sharding hook
(``constrain=``), as the reference does; on explicit ranks a tensor's
layout is fixed where it is made, so the hook returns its input and the
channel split stays in the record's note.
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Any

from repro_torch.configs.common import (
    DryRunSpec,
    ShardedUpdate,
    dp_axes,
    flat_axes,
    meta,
    pad_to,
)
from repro_torch.distributed.sharding import normalize
from repro_torch.launch import perfmodel as pm

# minibatch_lg sampled-block sizes (batch 1024, fanout 15 then 10):
#   frontier: 1024 -> 15,360 -> 153,600 ; padded union of nodes; edges
_MB_NODES = 1024 + 15360 + 153600
_MB_EDGES = 15360 + 153600

GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, m=10556, d=1433, classes=7),
    "minibatch_lg": dict(n=_MB_NODES, m=_MB_EDGES, d=602, classes=41),
    "ogb_products": dict(n=2449029, m=61859140, d=100, classes=47),
    "molecule": dict(n=30 * 128, m=64 * 128, d=16, classes=1, graphs=128),
}


def _graph_abs(info, *, geometric: bool, label_kind: str, mesh) -> tuple[dict, dict]:
    """(meta graph, spec graph). num_graphs is static and injected by the
    step closure, not part of the arguments."""
    import torch

    n, m, d = info["n"], info["m"], info["d"]
    graphs = info.get("graphs", 1)
    ea = flat_axes(mesh)
    esz = math.prod(mesh.shape[a] for a in ea)
    mp = pad_to(m, esz)
    i32, f32 = torch.int32, torch.float32
    g = {
        "src": meta((mp,), i32),
        "dst": meta((mp,), i32),
        "graph_ids": meta((n,), i32),
        "node_feats": meta((n, d), f32),
    }
    s = {"src": normalize((ea,)), "dst": normalize((ea,)), "graph_ids": (),
         "node_feats": ()}
    if geometric:
        g["positions"] = meta((n, 3), f32)
        g["species"] = meta((n,), i32)
        s |= {"positions": (), "species": ()}
    if label_kind == "node_int":
        g["labels"] = meta((n,), i32)
    elif label_kind == "graph_int":
        g["labels"] = meta((graphs,), i32)
    else:  # graph_float
        g["labels"] = meta((graphs,), f32)
    s["labels"] = ()
    return g, s


def _meta_params(mod, cfg):
    """The model's parameters on the meta device (shapes only)."""
    import torch

    if hasattr(mod, "empty_params"):
        return mod.empty_params(cfg, "meta")
    from repro_torch.models.tree import empty_tree

    return empty_tree(mod.param_spec(cfg), "meta", getattr(torch, cfg.dtype))


@dataclass
class GNNArch:
    """One GNN architecture: its model module (``init_params``,
    ``forward``), its published config and the small one the tests
    run."""

    name: str
    module: Any
    config: Any
    smoke_config: Any
    geometric: bool = False  # needs positions/species
    family: str = "gnn"

    def shapes(self):
        return list(GNN_SHAPES)

    def skip_reason(self, shape: str) -> str | None:
        return None

    def config_for(self, shape: str):
        """Specialize in_dim / readout / classes per shape."""
        info = GNN_SHAPES[shape]
        cfg = self.config
        kw: dict = {}
        if hasattr(cfg, "in_dim"):
            kw["in_dim"] = info["d"]
        if hasattr(cfg, "num_classes"):
            kw["num_classes"] = max(info["classes"], 2)
        if hasattr(cfg, "readout"):
            if self.geometric:
                kw["readout"] = "graph"  # energy-style regression
            else:
                kw["readout"] = "graph" if shape == "molecule" else "node"
        return dataclasses.replace(cfg, **kw)

    def label_kind(self, shape: str) -> str:
        if self.geometric:
            return "graph_float"
        cfg = self.config_for(shape)
        if getattr(cfg, "readout", "node") == "graph":
            return "graph_int"
        return "node_int"

    def opt_config(self):
        """The AdamW settings of ``build``'s train step."""
        from repro_torch.train.optimizer import AdamWConfig

        return AdamWConfig(lr=1e-3, weight_decay=0.0)

    def build(self, shape: str, mesh) -> DryRunSpec:
        """The cell's training step on ``mesh`` (see the module docstring)."""
        from repro_torch.train.loop import make_train_step
        from repro_torch.train.optimizer import init_opt_state

        info = GNN_SHAPES[shape]
        cfg = self.config_for(shape)
        mod = self.module
        graph_abs, graph_specs = _graph_abs(
            info, geometric=self.geometric,
            label_kind=self.label_kind(shape), mesh=mesh,
        )
        graphs = info.get("graphs", 1)

        params = _meta_params(mod, cfg)
        # params replicated (tiny); moments too.
        pspecs = {name: () for name, _ in params.named_parameters()}
        opt_cfg = self.opt_config()
        opt = init_opt_state(params, opt_cfg)
        ospecs = {"step": (), "m": dict(pspecs), "v": dict(pspecs)}

        # Beyond-paper hillclimb (REPRO_OPT_LEVEL!=0): MACE's tensor
        # products are channel-elementwise, so on the big graphs the
        # reference shards the node irrep tensors' CHANNEL dim over
        # "model" while edges shard over the data axes.
        opt_level = int(os.environ.get("REPRO_OPT_LEVEL", "1"))
        msize = mesh.shape.get("model", 1)
        channel_shard = (
            bool(opt_level)
            and self.name == "mace"
            and shape in ("ogb_products", "minibatch_lg")
            and msize > 1
            and getattr(cfg, "channels", 0) % msize == 0
        )
        edge_axes = flat_axes(mesh)
        constrain = None
        if channel_shard:
            edge_axes = dp_axes(mesh)
            graph_specs["src"] = normalize((edge_axes,))
            graph_specs["dst"] = normalize((edge_axes,))

            def constrain(t, kind):
                # The reference pins node tensors to (None, "model", None),
                # mixes' inputs to (dp, None, None) and edge tensors to
                # (dp, "model", None); here a layout is fixed where a
                # tensor is made, so the hook keeps the tensor as it is.
                return t

        def loss_of(p, g):
            kw = {"psum_axes": edge_axes}
            if constrain is not None:
                kw["constrain"] = constrain
            return mod.loss_fn(p, cfg, dict(g, num_graphs=graphs), **kw)

        step = make_train_step(
            loss_of, opt_cfg, sharded=ShardedUpdate(mesh, pspecs, pspecs, edge_axes))

        def train_step(params, opt_state, g):
            params, opt_state, _, metrics = step(params, opt_state, None, g)
            return params, opt_state, metrics["loss"]

        flops = pm.gnn_train_flops(self.name, cfg, info["n"], info["m"], info["d"])
        chips = math.prod(mesh.shape.values())
        return DryRunSpec(
            fn=train_step,
            args=(params, opt, graph_abs),
            in_specs=(pspecs, ospecs, graph_specs),
            donate_argnums=(0, 1),
            model_flops_total=flops,
            flops_total=flops,
            hbm_bytes_per_device=pm.gnn_train_bytes_per_device(
                self.name, cfg, info["n"], info["m"], info["d"], chips
            ),
            note=(
                f"edge-parallel; channel_shard={channel_shard} "
                f"(REPRO_OPT_LEVEL={opt_level})"
            ),
        )
