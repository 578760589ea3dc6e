"""Graph inputs of the port's GNN forwards.

``forward`` runs where its parameters live: numpy graph arrays go to
that device, and tensors must already be on it, or the call raises.

The reference's models sum ``h[src]`` into ``dst`` and rely on the data
pipeline's sort by destination for speed only. The port must be right
on unsorted edges too without sorting at every aggregation, so each
forward checks once, at entry, whether ``dst`` is non-decreasing (one
O(m) pass and one host read), sorts the edges once (stably) if it is
not, and then runs every aggregation with ``indices_are_sorted=True``.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import input_tensor
from repro_torch.ops.scatter_gather import sort_edges_by_dst


def is_sorted(ids: torch.Tensor) -> bool:
    """Whether ``ids`` is non-decreasing (one pass, one host read)."""
    return ids.numel() < 2 or bool((ids[1:] >= ids[:-1]).all())


def dst_sorted_edges(graph: dict, device: torch.device):
    """``(src, dst)`` of ``graph`` on ``device``, sorted by ``dst``: as
    given when they already are, else stably sorted once."""
    src = input_tensor(graph, "src", device)
    dst = input_tensor(graph, "dst", device)
    if is_sorted(dst):
        return src, dst
    src, dst, _ = sort_edges_by_dst(src, dst)
    return src, dst
