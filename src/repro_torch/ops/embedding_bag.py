"""EmbeddingBag from a row gather and a segment reduction, the port of
``repro/ops/embedding_bag.py``.

The multi-hot lookup is the paper's irregular-gather regime; the bag
reduction is its concurrent-write phase, resolved by segment reduction.
``sum`` and ``mean`` go through ``ops/segment.py::segment_sum``, so
through the ``segment_sum`` kernel on the card (after a stable sort of
the bag ids unless ``indices_are_sorted``); ``max`` is a scatter, as in
the reference.
"""
from __future__ import annotations

import torch

from repro_torch.ops.segment import segment_max, segment_mean, segment_sum


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor,
    bag_ids: torch.Tensor,
    num_bags: int,
    *,
    mode: str = "sum",
    weights: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Gather ``table[indices]`` and reduce rows sharing ``bag_ids``.

    Args:
        table: (vocab, dim) embedding table.
        indices: (nnz,) row indices into the table (flattened multi-hot).
        bag_ids: (nnz,) which output bag each index belongs to; padding
            entries use ``bag_ids >= num_bags``, which contribute nothing.
        num_bags: number of output rows.
        mode: sum | mean | max (an empty bag's max is 0).
        weights: optional (nnz,) per-sample weights (sum mode only).
    """
    rows = table.index_select(0, indices.long())
    if weights is not None:
        if mode != "sum":
            raise ValueError("per-sample weights require mode='sum'")
        rows = rows * weights[:, None]
    if mode == "sum":
        return segment_sum(rows, bag_ids, num_bags,
                           indices_are_sorted=indices_are_sorted)
    if mode == "mean":
        return segment_mean(rows, bag_ids, num_bags,
                            indices_are_sorted=indices_are_sorted)
    if mode == "max":
        out = segment_max(rows, bag_ids, num_bags)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(f"unknown mode {mode!r}")


def multi_field_lookup(
    tables: list[torch.Tensor],
    field_indices: torch.Tensor,
) -> torch.Tensor:
    """Dense one-index-per-field lookup (xDeepFM's 39 sparse fields):
    ``tables`` one (vocab_f, dim) table a field, ``field_indices``
    (batch, n_fields) -> (batch, n_fields, dim)."""
    idx = field_indices.long()
    return torch.stack(
        [t.index_select(0, idx[:, f]) for f, t in enumerate(tables)], dim=1)
