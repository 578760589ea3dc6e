"""The GNN family of the port's registry (gin-tu, gat-cora): the shape
table and ``GNNArch`` of ``repro/configs/gnn_family.py``.

Shapes (per assignment):
  full_graph_sm   n=2,708    m=10,556       d_feat=1,433  (full-batch, Cora)
  minibatch_lg    n=232,965  m=114,615,892  batch=1,024 fanout 15-10 (Reddit)
  ogb_products    n=2,449,029 m=61,859,140  d_feat=100    (full-batch-large)
  molecule        n=30 m=64 per graph, batch=128          (batched-small)

The table is copied, not imported: the reference module imports jax.
``GNNArch.build`` (the dry-run spec, sharding and AdamW) is launch and
training work and waits for ROADMAP queue 1, items 16 and 17. The
reference's ``geometric`` flag (positions and species, energy-style
graph readout) comes with EGNN and MACE, queue 1, item 13.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

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


@dataclass
class GNNArch:
    """One GNN architecture: its model module (``init_params``,
    ``forward``), its published config and the small one the tests
    run."""

    name: str
    module: Any
    config: Any
    smoke_config: Any

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
            kw["readout"] = "graph" if shape == "molecule" else "node"
        return dataclasses.replace(cfg, **kw)

    def label_kind(self, shape: str) -> str:
        cfg = self.config_for(shape)
        if getattr(cfg, "readout", "node") == "graph":
            return "graph_int"
        return "node_int"
