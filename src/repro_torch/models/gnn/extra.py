"""GCN [arXiv:1609.02907], GraphSAGE [arXiv:1706.02216] and PNA
[arXiv:2004.05718], the port of ``repro/models/gnn/extra.py``:
forwards and losses (``gcn_loss``, ``sage_loss``, ``pna_loss``).

Every float sum over edges is the ``segment_sum`` kernel over edges
sorted by destination (``graph.dst_sorted_edges``: checked once a
forward, sorted once if not): GCN one launch a layer, GraphSAGE one a
layer (its mean), PNA two a layer (its sums and sums of squares); PNA's
extremes and the degree counts are scatters, as in the reference.
With ``psum_axes`` (edge-parallel: this rank's edges, every node) the
partial sums, extremes and degree counts are reduced over those mesh
axes; the reference counts GCN's and PNA's degrees on the local edges
there, the port over every rank's.
Parameters are ``ParamTree``s under the reference's keys, matrices
``(in, out)``. Like the reference, nothing registers these three in the
architecture table.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import input_tensor, node_nll
from repro_torch.models.gnn.graph import dst_sorted_edges
from repro_torch.models.tree import ParamTree, empty_tree, generator_on, he_or_zero
from repro_torch.ops.segment import (
    edge_parallel_loss,
    segment_count_dist,
    segment_max_dist,
    segment_mean,
    segment_sum_dist,
)


def _dims(cfg) -> list[int]:
    return [cfg.in_dim] + [cfg.d_hidden] * (cfg.num_layers - 1) + [cfg.num_classes]


def _init(spec: dict, cfg, generator, device) -> ParamTree:
    """A tree of ``spec`` on ``device``: weights He-initialised, biases
    zero, as the reference's."""
    dev = resolve_device(device)
    params = empty_tree(spec, dev, getattr(torch, cfg.dtype))
    return he_or_zero(params, generator_on(generator, dev))


def _node_ce(logits: torch.Tensor, graph: dict) -> torch.Tensor:
    """Mean node NLL over the rows whose ``graph["labels"]`` is >= 0."""
    return node_nll(logits, input_tensor(graph, "labels", logits.device))


def _edges(params: ParamTree, graph: dict):
    dev = params["layers"][0]["b"].device
    h = input_tensor(graph, "node_feats", dev)
    src, dst = dst_sorted_edges(graph, dev)
    return h, src, dst


# ---------------------------------------------------------------------------
# GCN: h' = D^-1/2 A D^-1/2 h W  (symmetric-normalized SpMM)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn"
    num_layers: int = 2
    d_hidden: int = 64
    in_dim: int = 64
    num_classes: int = 7
    dtype: str = "float32"


def gcn_spec(cfg: GCNConfig) -> dict:
    dims = _dims(cfg)
    return {"layers": [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
                       for i in range(cfg.num_layers)]}


def gcn_init(cfg: GCNConfig, *, generator: torch.Generator | None = None,
             device=None) -> ParamTree:
    return _init(gcn_spec(cfg), cfg, generator, device)


def gcn_forward(params: ParamTree, cfg: GCNConfig, graph: dict, *,
                psum_axes=()) -> torch.Tensor:
    """Logits (n, num_classes) on the parameters' device."""
    h, src, dst = _edges(params, graph)
    n = h.shape[0]
    deg = segment_count_dist(dst, n, psum_axes).float() + 1.0  # +self loop
    inv_sqrt = torch.rsqrt(deg)
    norm = inv_sqrt.index_select(0, src) * inv_sqrt.index_select(0, dst)
    layers = params["layers"]
    for i, layer in enumerate(layers):
        z = h @ layer["w"] + layer["b"]
        agg = segment_sum_dist(z.index_select(0, src) * norm[:, None], dst, n,
                               psum_axes, indices_are_sorted=True)
        h = agg + z * (inv_sqrt * inv_sqrt)[:, None]  # self loop
        if i < len(layers) - 1:
            h = F.relu(h)
    return h


# ---------------------------------------------------------------------------
# GraphSAGE (mean aggregator): h' = act(W_self h + W_neigh mean_j h_j)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage"
    num_layers: int = 2
    d_hidden: int = 64
    in_dim: int = 64
    num_classes: int = 41
    dtype: str = "float32"


def sage_spec(cfg: SAGEConfig) -> dict:
    dims = _dims(cfg)
    return {"layers": [{"w_self": (dims[i], dims[i + 1]),
                        "w_neigh": (dims[i], dims[i + 1]),
                        "b": (dims[i + 1],)}
                       for i in range(cfg.num_layers)]}


def sage_init(cfg: SAGEConfig, *, generator: torch.Generator | None = None,
              device=None) -> ParamTree:
    return _init(sage_spec(cfg), cfg, generator, device)


def sage_forward(params: ParamTree, cfg: SAGEConfig, graph: dict, *,
                 psum_axes=()) -> torch.Tensor:
    """Logits (n, num_classes) on the parameters' device."""
    h, src, dst = _edges(params, graph)
    n = h.shape[0]
    layers = params["layers"]
    for i, layer in enumerate(layers):
        msgs = h.index_select(0, src)
        if psum_axes:  # a mean of partials needs sum and count psums
            s = segment_sum_dist(msgs, dst, n, psum_axes, indices_are_sorted=True)
            c = segment_sum_dist(torch.ones_like(msgs[:, :1]), dst, n, psum_axes,
                                 indices_are_sorted=True)
            neigh = s / c.clamp_min(1.0)
        else:
            neigh = segment_mean(msgs, dst, n, indices_are_sorted=True)
        del msgs
        h = h @ layer["w_self"] + neigh @ layer["w_neigh"] + layer["b"]
        if i < len(layers) - 1:
            h = F.relu(h)
            # L2 normalise, as GraphSAGE does
            h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp_min(1e-6)
    return h


# ---------------------------------------------------------------------------
# PNA: 4 aggregators (mean/min/max/std) x 3 degree scalers, then linear
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    num_layers: int = 2
    d_hidden: int = 32
    in_dim: int = 32
    num_classes: int = 7
    delta: float = 2.5  # avg log-degree normalizer
    dtype: str = "float32"


def pna_spec(cfg: PNAConfig) -> dict:
    dims = _dims(cfg)
    # 4 aggregators x 3 scalers + self = 13 x d_in -> d_out
    return {"layers": [{"w": (13 * dims[i], dims[i + 1]), "b": (dims[i + 1],)}
                       for i in range(cfg.num_layers)]}


def pna_init(cfg: PNAConfig, *, generator: torch.Generator | None = None,
             device=None) -> ParamTree:
    return _init(pna_spec(cfg), cfg, generator, device)


def pna_forward(params: ParamTree, cfg: PNAConfig, graph: dict, *,
                psum_axes=()) -> torch.Tensor:
    """Logits (n, num_classes) on the parameters' device. An empty
    segment's max and min (``-inf``/``+inf``) count as 0."""
    h, src, dst = _edges(params, graph)
    n = h.shape[0]
    deg = segment_count_dist(dst, n, psum_axes).float()
    logd = torch.log1p(deg)[:, None]
    scalers = [
        torch.ones_like(logd),
        logd / cfg.delta,  # amplification
        cfg.delta / logd.clamp_min(1e-6),  # attenuation
    ]
    cnt = deg.clamp_min(1.0)[:, None]
    layers = params["layers"]
    for li, layer in enumerate(layers):
        msgs = h.index_select(0, src)
        s1 = segment_sum_dist(msgs, dst, n, psum_axes, indices_are_sorted=True)
        mean = s1 / cnt
        s2 = segment_sum_dist(msgs * msgs, dst, n, psum_axes,
                              indices_are_sorted=True)
        var = (s2 / cnt - mean * mean).clamp_min(0.0)
        std = torch.sqrt(var + 1e-6)
        mx = segment_max_dist(msgs, dst, n, psum_axes)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        mn = -segment_max_dist(-msgs, dst, n, psum_axes)
        mn = torch.where(torch.isfinite(mn), mn, 0.0)
        del msgs
        aggs = [mean, mn, mx, std]
        feats = [h] + [a * s for a in aggs for s in scalers]
        h = torch.cat(feats, dim=-1) @ layer["w"] + layer["b"]
        if li < len(layers) - 1:
            h = F.relu(h)
    return h


def gcn_loss(params: ParamTree, cfg: GCNConfig, graph: dict, *, psum_axes=()):
    return edge_parallel_loss(
        _node_ce(gcn_forward(params, cfg, graph, psum_axes=psum_axes), graph),
        psum_axes)


def sage_loss(params: ParamTree, cfg: SAGEConfig, graph: dict, *, psum_axes=()):
    return edge_parallel_loss(
        _node_ce(sage_forward(params, cfg, graph, psum_axes=psum_axes), graph),
        psum_axes)


def pna_loss(params: ParamTree, cfg: PNAConfig, graph: dict, *, psum_axes=()):
    return edge_parallel_loss(
        _node_ce(pna_forward(params, cfg, graph, psum_axes=psum_axes), graph),
        psum_axes)
