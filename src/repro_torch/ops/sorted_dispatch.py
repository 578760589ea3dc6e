"""Sort-based grouping: ragged groups made contiguous by one stable sort.

The port of ``repro.ops.sorted_dispatch``. Edges grouped by node (the
Euler tour's adjacency), tokens by expert or bag items by table become
dense contiguous blocks once they are sorted by their key, so every
later operation is a contiguous range instead of a scatter.
"""
from __future__ import annotations

import torch


def sort_by_key(keys: torch.Tensor, *values: torch.Tensor) -> tuple:
    """Stable sort by key; returns ``(sorted_keys, perm, *sorted_values)``.
    ``perm`` is int64 (PyTorch's index type); equal keys keep their
    order."""
    sorted_keys, perm = torch.sort(keys, stable=True)
    return (sorted_keys, perm) + tuple(v[perm] for v in values)


def grouped_offsets(sorted_keys: torch.Tensor, num_groups: int):
    """Int32 counts and exclusive-prefix offsets per group for sorted
    keys; keys outside ``[0, num_groups)`` are counted in no group."""
    k = sorted_keys.long()
    valid = (k >= 0) & (k < num_groups)
    counts = torch.zeros(num_groups + 1, dtype=torch.int32, device=k.device)
    counts.scatter_add_(0, torch.where(valid, k, num_groups),
                        torch.ones_like(k, dtype=torch.int32))
    counts = counts[:num_groups]
    offsets = torch.zeros(num_groups, dtype=torch.int32, device=k.device)
    offsets[1:] = torch.cumsum(counts, 0)[:-1]
    return counts, offsets


def position_in_group(keys: torch.Tensor, num_groups: int) -> torch.Tensor:
    """For each element, its 0-based arrival position within its key
    group, as cumulative one-hot sums: O(n * num_groups) work, for few
    groups (MoE capacity assignment, where groups are experts)."""
    onehot = torch.nn.functional.one_hot(keys.long(), num_groups).to(torch.int32)
    cum = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
    return (cum * onehot).sum(-1, dtype=torch.int32)


def take_grouped(
    values: torch.Tensor,
    keys: torch.Tensor,
    num_groups: int,
    capacity: int,
    *,
    fill_value=0,
):
    """Pack ``values`` into a dense ``(num_groups, capacity, ...)`` buffer.

    Elements beyond ``capacity`` in their group are dropped. Returns
    ``(buffer, slot, kept)``: ``slot[i]`` is the flat row element ``i``
    went to (``num_groups * capacity`` when dropped) and ``kept[i]``
    marks the elements kept. Dropped elements write to one scratch row
    past the end, which is cut off."""
    pos = position_in_group(keys, num_groups)
    kept = pos < capacity
    flat_slot = keys.to(torch.int32) * capacity + pos
    flat_slot = torch.where(kept, flat_slot, num_groups * capacity)
    buf = torch.full(
        (num_groups * capacity + 1,) + tuple(values.shape[1:]), fill_value,
        dtype=values.dtype, device=values.device,
    )
    buf[flat_slot.long()] = values
    buf = buf[: num_groups * capacity]
    return (buf.reshape((num_groups, capacity) + tuple(values.shape[1:])),
            flat_slot, kept)
