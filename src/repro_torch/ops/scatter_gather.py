"""Edge-index message passing of the port: gather -> compute ->
segment-reduce, the counterpart of ``repro/ops/scatter_gather.py``.

Sorting the edges by destination (``sort_edges_by_dst``) makes each
node's incoming messages contiguous, which is what the ``segment_sum``
kernel sums without atomics.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.ops.segment import segment_max, segment_mean, segment_sum

_REDUCERS: dict[str, Callable[..., torch.Tensor]] = {
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
}


def sort_edges_by_dst(
    src: torch.Tensor, dst: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort of the edge list by destination. Returns
    ``(src_sorted, dst_sorted, perm)``; ``perm`` reorders edge
    features."""
    perm = torch.sort(dst, stable=True).indices
    return src[perm], dst[perm], perm


def gather_messages(node_feats: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Gather source-node features along edges (the irregular read)."""
    return node_feats.index_select(0, src)


def scatter_reduce(
    messages: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    *,
    reducer: str = "sum",
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Reduce edge messages into destination nodes (the irregular
    write). With ``"max"``, isolated nodes read 0."""
    try:
        fn = _REDUCERS[reducer]
    except KeyError:
        raise ValueError(f"unknown reducer {reducer!r}") from None
    out = fn(messages, dst, num_nodes, indices_are_sorted=indices_are_sorted)
    if reducer == "max":
        out = torch.where(torch.isfinite(out), out, 0.0)
    return out


def mpnn_aggregate(
    node_feats: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    *,
    message_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    edge_feats: torch.Tensor | None = None,
    reducer: str = "sum",
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """One message-passing sweep: ``h'_i = reduce_{j->i} msg(h_j [, e_ji])``."""
    msgs = gather_messages(node_feats, src)
    if edge_feats is not None:
        msgs = torch.cat([msgs, edge_feats], dim=-1)
    if message_fn is not None:
        msgs = message_fn(msgs)
    return scatter_reduce(msgs, dst, num_nodes, reducer=reducer,
                          indices_are_sorted=indices_are_sorted)
