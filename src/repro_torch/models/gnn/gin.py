"""GIN (Graph Isomorphism Network), arXiv:1810.00826, the port of
``repro/models/gnn/gin.py``.

h_v^{k} = MLP_k( (1 + eps_k) h_v^{k-1} + sum_{u in N(v)} h_u^{k-1} )

The sum aggregator is the ``segment_sum`` kernel over edges sorted by
destination (``graph.dst_sorted_edges``): one launch per layer, and one
more for the graph readout. BatchNorm is LayerNorm, as in the
reference. The MLPs are float32 ``nn.Linear`` products (no TF32 on the
card, where ``torch.backends.cuda.matmul.allow_tf32`` stays False).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import he_init, input_tensor, layer_norm, node_nll
from repro_torch.models.gnn.graph import dst_sorted_edges, is_sorted
from repro_torch.ops.segment import edge_parallel_loss, segment_sum, segment_sum_dist


@dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    num_layers: int = 5
    d_hidden: int = 64
    in_dim: int = 64
    num_classes: int = 2
    readout: str = "graph"  # "graph" (TU datasets) or "node"
    eps_learnable: bool = True
    dtype: str = "float32"


class GINLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, *, dtype=None):
        super().__init__()
        self.w1 = nn.Linear(d_in, d_hidden, dtype=dtype)
        self.w2 = nn.Linear(d_hidden, d_hidden, dtype=dtype)
        self.ln_g = nn.Parameter(torch.empty(d_hidden, dtype=dtype))
        self.ln_b = nn.Parameter(torch.empty(d_hidden, dtype=dtype))
        self.eps = nn.Parameter(torch.empty((), dtype=dtype))


class GIN(nn.Module):
    """The parameters of a GIN: ``layers[i].{w1,w2}`` (``nn.Linear``,
    weights ``(out, in)``), ``ln_g``, ``ln_b``, ``eps``, and the
    jumping-knowledge ``head`` over the concatenated layer outputs."""

    def __init__(self, cfg: GINConfig, *, dtype=None):
        super().__init__()
        self.cfg = cfg
        d_ins = [cfg.in_dim] + [cfg.d_hidden] * (cfg.num_layers - 1)
        self.layers = nn.ModuleList(
            GINLayer(d_in, cfg.d_hidden, dtype=dtype) for d_in in d_ins
        )
        self.head = nn.Linear(cfg.d_hidden * cfg.num_layers, cfg.num_classes,
                              dtype=dtype)

    def forward(self, graph: dict) -> torch.Tensor:
        return forward(self, self.cfg, graph)


def empty_params(cfg: GINConfig, device) -> GIN:
    """A ``GIN`` with uninitialised storage on ``device``, outside
    autograd (the training step makes its leaves require grad:
    ``train.tree.trainable``)."""
    with torch.device("meta"):
        model = GIN(cfg, dtype=getattr(torch, cfg.dtype))
    return model.to_empty(device=device).requires_grad_(False)


@torch.no_grad()
def init_params(cfg: GINConfig, *, generator: torch.Generator | None = None,
                device=None) -> GIN:
    """Random parameters with the reference's scales: He-truncated
    normal weights, zero biases, unit LayerNorm gains, ``eps`` 0. Drawn
    from ``generator`` (else one seeded with 0 on ``device``)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    model = empty_params(cfg, dev)
    dtype = getattr(torch, cfg.dtype)
    for layer in model.layers:
        for lin in (layer.w1, layer.w2):
            lin.weight.copy_(he_init(gen, lin.weight.shape, lin.in_features, dtype))
            lin.bias.zero_()
        layer.ln_g.fill_(1.0)
        layer.ln_b.zero_()
        layer.eps.zero_()
    head = model.head
    head.weight.copy_(he_init(gen, head.weight.shape, head.in_features, dtype))
    head.bias.zero_()
    return model


def forward(params: GIN, cfg: GINConfig, graph: dict, *,
            psum_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """graph: ``node_feats`` (n, d), ``src``/``dst`` (m,), and for the
    graph readout ``graph_ids`` (n,) and ``num_graphs``. Returns logits
    (n, classes) for the node readout, (num_graphs, classes) for the
    graph readout, on the parameters' device."""
    dev = params.head.weight.device
    h = input_tensor(graph, "node_feats", dev)
    n = h.shape[0]
    src, dst = dst_sorted_edges(graph, dev)
    reps = []
    for layer in params.layers:
        agg = segment_sum_dist(h.index_select(0, src), dst, n, psum_axes,
                               indices_are_sorted=True)
        eps = layer.eps if cfg.eps_learnable else 0.0
        z = (1.0 + eps) * h + agg
        z = layer.w2(F.relu(layer.w1(z)))
        h = layer_norm(z, layer.ln_g, layer.ln_b)
        reps.append(h)
    hcat = torch.cat(reps, dim=-1)
    if cfg.readout == "graph":
        gid = input_tensor(graph, "graph_ids", dev)
        pooled = segment_sum(hcat, gid, int(graph["num_graphs"]),
                             indices_are_sorted=is_sorted(gid))
        return params.head(pooled)
    return params.head(hcat)


def loss_fn(params: GIN, cfg: GINConfig, graph: dict, *,
            psum_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """Mean node (or graph) NLL over the rows whose ``graph["labels"]``
    is >= 0. With ``psum_axes`` (the edge-sharded form: this rank's
    edges in ``graph``, every node) the layers sum their partial
    aggregates over those mesh axes (see ``ops/segment.py``)."""
    logits = forward(params, cfg, graph, psum_axes=psum_axes)
    loss = node_nll(logits, input_tensor(graph, "labels", logits.device))
    return edge_parallel_loss(loss, psum_axes)
