"""GAT (Graph Attention Network), arXiv:1710.10903, the port of
``repro/models/gnn/gat.py``. Cora config: 2 layers, 8 hidden units, 8
heads, attention aggregation.

Per layer: gather both endpoints' scores, LeakyReLU, a segment softmax
over the destination (a scatter max, then the ``segment_sum`` kernel
for the denominators), and the weighted messages summed by the kernel:
two launches a layer, over edges sorted by destination
(``graph.dst_sorted_edges``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import input_tensor, lecun_init, node_nll
from repro_torch.models.gnn.graph import dst_sorted_edges
from repro_torch.ops.segment import (
    edge_parallel_loss,
    segment_softmax_dist,
    segment_sum_dist,
)


@dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    num_layers: int = 2
    d_hidden: int = 8
    num_heads: int = 8
    in_dim: int = 1433
    num_classes: int = 7
    negative_slope: float = 0.2
    dtype: str = "float32"


def layer_dims(cfg: GATConfig) -> list[tuple[int, int, int]]:
    """``(d_in, heads, d_out)`` of each layer: ``num_heads`` heads of
    ``d_hidden``, then one head of ``num_classes``."""
    dims, d_in = [], cfg.in_dim
    for i in range(cfg.num_layers):
        last = i == cfg.num_layers - 1
        heads = 1 if last else cfg.num_heads
        d_out = cfg.num_classes if last else cfg.d_hidden
        dims.append((d_in, heads, d_out))
        d_in = heads * d_out if not last else d_out
    return dims


class GATLayer(nn.Module):
    def __init__(self, d_in: int, heads: int, d_out: int, *, dtype=None):
        super().__init__()
        self.w = nn.Linear(d_in, heads * d_out, bias=False, dtype=dtype)
        self.a_src = nn.Parameter(torch.empty(heads, d_out, dtype=dtype))
        self.a_dst = nn.Parameter(torch.empty(heads, d_out, dtype=dtype))
        self.b = nn.Parameter(torch.empty(heads * d_out, dtype=dtype))


class GAT(nn.Module):
    """The parameters of a GAT: ``layers[i].w`` (``nn.Linear`` without
    bias, weight ``(heads * d_out, in)``), ``a_src``/``a_dst`` (heads,
    d_out) and the bias ``b``, which the last layer does not add."""

    def __init__(self, cfg: GATConfig, *, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            GATLayer(*dims, dtype=dtype) for dims in layer_dims(cfg)
        )

    def forward(self, graph: dict) -> torch.Tensor:
        return forward(self, self.cfg, graph)


def empty_params(cfg: GATConfig, device) -> GAT:
    """A ``GAT`` with uninitialised storage on ``device``, outside
    autograd (the training step makes its leaves require grad:
    ``train.tree.trainable``)."""
    with torch.device("meta"):
        model = GAT(cfg, dtype=getattr(torch, cfg.dtype))
    return model.to_empty(device=device).requires_grad_(False)


@torch.no_grad()
def init_params(cfg: GATConfig, *, generator: torch.Generator | None = None,
                device=None) -> GAT:
    """Random parameters with the reference's scales: LeCun-truncated
    normal ``w``, ``a_src`` and ``a_dst``, zero ``b``. Drawn from
    ``generator`` (else one seeded with 0 on ``device``)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    model = empty_params(cfg, dev)
    dtype = getattr(torch, cfg.dtype)
    for layer, (d_in, _heads, d_out) in zip(model.layers, layer_dims(cfg)):
        layer.w.weight.copy_(lecun_init(gen, layer.w.weight.shape, d_in, dtype))
        layer.a_src.copy_(lecun_init(gen, layer.a_src.shape, d_out, dtype))
        layer.a_dst.copy_(lecun_init(gen, layer.a_dst.shape, d_out, dtype))
        layer.b.zero_()
    return model


def _gat_layer(layer: GATLayer, cfg: GATConfig, h, src, dst, n, heads, d_out,
               psum_axes, last):
    wh = layer.w(h).reshape(n, heads, d_out)
    s_src = torch.einsum("nhd,hd->nh", wh, layer.a_src)
    s_dst = torch.einsum("nhd,hd->nh", wh, layer.a_dst)
    e = F.leaky_relu(s_src.index_select(0, src) + s_dst.index_select(0, dst),
                     negative_slope=cfg.negative_slope)  # (m, heads)
    num, den = segment_softmax_dist(e, dst, n, psum_axes, indices_are_sorted=True)
    del e
    # (m, heads, d_out), weighted in place: the gather is a fresh tensor.
    msgs = wh.index_select(0, src).mul_(num[..., None])
    del num
    agg = segment_sum_dist(msgs, dst, n, psum_axes, indices_are_sorted=True)
    del msgs
    out = agg / den[..., None]
    if last:
        return out.mean(dim=1)  # average heads -> logits
    return F.elu(out.reshape(n, heads * d_out) + layer.b)


def forward(params: GAT, cfg: GATConfig, graph: dict, *,
            psum_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """graph: ``node_feats`` (n, d), ``src``/``dst`` (m,). Returns
    logits (n, num_classes) on the parameters' device."""
    dev = params.layers[0].w.weight.device
    h = input_tensor(graph, "node_feats", dev)
    n = h.shape[0]
    src, dst = dst_sorted_edges(graph, dev)
    for i, (layer, (_d_in, heads, d_out)) in enumerate(
            zip(params.layers, layer_dims(cfg))):
        last = i == cfg.num_layers - 1
        h = _gat_layer(layer, cfg, h, src, dst, n, heads, d_out, psum_axes, last)
    return h


def loss_fn(params: GAT, cfg: GATConfig, graph: dict, *,
            psum_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """Mean node NLL over the rows whose ``graph["labels"]`` is >= 0.
    With ``psum_axes`` the edge-sharded form (see ``gin.loss_fn``)."""
    logits = forward(params, cfg, graph, psum_axes=psum_axes)
    loss = node_nll(logits, input_tensor(graph, "labels", logits.device))
    return edge_parallel_loss(loss, psum_axes)
