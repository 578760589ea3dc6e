"""EGNN (E(n)-equivariant GNN), arXiv:2102.09844, the port of
``repro/models/gnn/egnn.py``: forward and ``loss_fn``. Config: 4 layers,
d = 64.

m_ij   = phi_e(h_i, h_j, ||x_i - x_j||^2)
x_i'   = x_i + (1/deg_i) sum_j (x_i - x_j) phi_x(m_ij)
h_i'   = h_i + phi_h(h_i, sum_j m_ij)

Scalars are invariant and coordinates equivariant by construction. The
sums over edges run through the ``segment_sum`` kernel over edges sorted
by destination (checked once a forward, sorted once if not): the degree
count at (m, 1), then each layer's coordinate update at (m, 3) and its
messages at (m, d); the graph readout is one more launch over
``graph_ids``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import input_tensor
from repro_torch.models.gnn.graph import dst_sorted_edges, is_sorted
from repro_torch.models.tree import ParamTree, empty_tree, generator_on, he_or_zero
from repro_torch.ops.segment import edge_parallel_loss, segment_sum, segment_sum_dist


@dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    num_layers: int = 4
    d_hidden: int = 64
    in_dim: int = 64
    out_dim: int = 1  # per-graph scalar (energy-style) or per-node
    readout: str = "graph"
    dtype: str = "float32"


def _mlp_spec(dims) -> list[dict]:
    return [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
            for i in range(len(dims) - 1)]


def _mlp(layers, x, last_act=False):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or last_act:
            x = F.silu(x)
    return x


def param_spec(cfg: EGNNConfig) -> dict:
    d = cfg.d_hidden
    return {
        "embed": _mlp_spec((cfg.in_dim, d)),
        "layers": [
            {
                "edge_mlp": _mlp_spec((2 * d + 1, d, d)),
                "coord_mlp": _mlp_spec((d, d, 1)),
                "node_mlp": _mlp_spec((2 * d, d, d)),
            }
            for _ in range(cfg.num_layers)
        ],
        "head": _mlp_spec((d, d, cfg.out_dim)),
    }


def init_params(cfg: EGNNConfig, *, generator: torch.Generator | None = None,
                device=None) -> ParamTree:
    """Random parameters with the reference's scales (He-truncated
    normal weights, zero biases), drawn from ``generator`` (else one
    seeded with 0 on ``device``)."""
    dev = resolve_device(device)
    params = empty_tree(param_spec(cfg), dev, getattr(torch, cfg.dtype))
    return he_or_zero(params, generator_on(generator, dev))


def forward(params: ParamTree, cfg: EGNNConfig, graph: dict, *,
            psum_axes: tuple[str, ...] = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """graph: ``node_feats`` (n, in_dim), ``positions`` (n, 3),
    ``src``/``dst`` (m,), and for the graph readout ``graph_ids`` and
    ``num_graphs``. Returns (readout, updated positions): the readout is
    (num_graphs, out_dim), or (n, out_dim) for the node readout."""
    dev = params["head"][0]["b"].device
    h = _mlp(params["embed"], input_tensor(graph, "node_feats", dev))
    x = input_tensor(graph, "positions", dev).float()
    n = h.shape[0]
    src, dst = dst_sorted_edges(graph, dev)
    deg = segment_sum_dist(torch.ones((src.shape[0], 1), dtype=h.dtype, device=dev),
                           dst, n, psum_axes, indices_are_sorted=True)
    inv_deg = 1.0 / deg.clamp_min(1.0)
    for layer in params["layers"]:
        dx = x.index_select(0, dst) - x.index_select(0, src)  # (m, 3)
        dist2 = torch.sum(dx * dx, dim=-1, keepdim=True).to(h.dtype)
        m_ij = _mlp(
            layer["edge_mlp"],
            torch.cat([h.index_select(0, dst), h.index_select(0, src), dist2], dim=-1),
            last_act=True,
        )
        coord_w = _mlp(layer["coord_mlp"], m_ij)  # (m, 1)
        x = x + segment_sum_dist(dx * coord_w.float(), dst, n, psum_axes,
                                 indices_are_sorted=True) * inv_deg
        agg = segment_sum_dist(m_ij, dst, n, psum_axes, indices_are_sorted=True)
        del dx, m_ij, coord_w
        h = h + _mlp(layer["node_mlp"], torch.cat([h, agg], dim=-1))
    node_out = _mlp(params["head"], h)
    if cfg.readout == "graph":
        gid = input_tensor(graph, "graph_ids", dev)
        out = segment_sum(node_out, gid, int(graph["num_graphs"]),
                          indices_are_sorted=is_sorted(gid))
    else:
        out = node_out
    return out, x


def loss_fn(params: ParamTree, cfg: EGNNConfig, graph: dict, *,
            psum_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """Mean squared error of the readout against ``graph["labels"]``."""
    pred, _x = forward(params, cfg, graph, psum_axes=psum_axes)
    target = input_tensor(graph, "labels", pred.device).float()
    return edge_parallel_loss(
        torch.mean((pred.squeeze(-1).float() - target) ** 2), psum_axes)
