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

import numpy as np
import torch

from repro_torch.ops.scatter_gather import sort_edges_by_dst


def graph_tensor(graph: dict, key: str, device: torch.device) -> torch.Tensor:
    """``graph[key]`` as a tensor on ``device``: a numpy array is copied
    there; a tensor elsewhere raises."""
    x = graph[key]
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(
                f"graph[{key!r}] is on {x.device} but the parameters are on "
                f"{device}; move it there first"
            )
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def is_sorted(ids: torch.Tensor) -> bool:
    """Whether ``ids`` is non-decreasing (one pass, one host read)."""
    return ids.numel() < 2 or bool((ids[1:] >= ids[:-1]).all())


def dst_sorted_edges(graph: dict, device: torch.device):
    """``(src, dst)`` of ``graph`` on ``device``, sorted by ``dst``: as
    given when they already are, else stably sorted once."""
    src = graph_tensor(graph, "src", device)
    dst = graph_tensor(graph, "dst", device)
    if is_sorted(dst):
        return src, dst
    src, dst, _ = sort_edges_by_dst(src, dst)
    return src, dst
