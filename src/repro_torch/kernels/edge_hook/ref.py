"""Plain PyTorch version of the edge_hook kernel (the unfused SV2/SV3
phases), in the ``n + 1`` drop-buffer form of ``repro``'s oracle."""
from __future__ import annotations

import torch


def drop_scatter_min(
    target: torch.Tensor, index: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """``target`` with ``values`` min-scattered at ``index``; index ``n``
    (one past the end) is the no-op lane. The counterpart of JAX's
    ``.at[index].min(values, mode="drop")``: the old value takes part in
    the min, and the drop lane is a scratch slot cut off afterwards."""
    n = target.shape[0]
    buf = torch.cat([target, target.new_full((1,), n)])
    buf.scatter_reduce_(0, index.long(), values, "amin", include_self=True)
    return buf[:n]


def drop_scatter_fill(
    target: torch.Tensor, index: torch.Tensor, value: int
) -> torch.Tensor:
    """``target`` with the one scalar ``value`` stored at ``index``; index
    ``n`` is the no-op lane. Every lane writes the same value, so
    duplicate indices commute."""
    n = target.shape[0]
    buf = torch.cat([target, target.new_zeros(1)])
    buf.index_fill_(0, index.long(), value)
    return buf[:n]


def edge_hook_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    labels: torch.Tensor,
    labels_prev: torch.Tensor,
    stamps: torch.Tensor,
    s: int,
    *,
    mode: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """sv2 returns ``(labels_out, stamps_out)``; sv3 returns
    ``(labels_out, live)`` with ``live = labels[a] != labels[b]``."""
    n = labels.shape[0]
    Da, Db = labels[a], labels[b]
    if mode == "sv2":
        cond = (Da == labels_prev[a]) & (Db < Da)
        out = drop_scatter_min(
            labels, torch.where(cond, Da, n), torch.where(cond, Db, n)
        )
        return out, drop_scatter_fill(stamps, torch.where(cond, Db, n), s)
    if mode == "sv3":
        live = Da != Db
        cond = (stamps[Da] < s) & (labels[Da] == Da) & live
        out = drop_scatter_min(
            labels, torch.where(cond, Da, n), torch.where(cond, Db, n)
        )
        return out, live
    raise ValueError(f"unknown mode {mode!r}")
