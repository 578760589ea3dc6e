"""Plain PyTorch version of the ordered_fold kernel: the same slot-order
fold, bit for bit, on any device.

Step ``k`` adds the ``k``-th value of every group with more than ``k``
values, in one vectorised operation, so each group's adds run in slot
order and the number of steps is the largest degree. Groups are visited
in order of falling degree, so the groups still live at step ``k`` are
a prefix of that order. It does not rely on ``index_add_``, whose order
of adds is not fixed on the card. It reads the degrees to the host once.
"""
from __future__ import annotations

import torch


def ordered_fold_ref(
    base: torch.Tensor,
    row_ptr: torch.Tensor,
    perm: torch.Tensor,
    values: torch.Tensor,
) -> torch.Tensor:
    """``out[v] = base[v] + values[perm[s]] + ...`` over
    ``s in [row_ptr[v], row_ptr[v + 1])``, added left to right."""
    out = base.clone()
    n = base.shape[0]
    if n == 0 or perm.numel() == 0:
        return out
    start = row_ptr[:-1].long()
    deg = row_ptr[1:].long() - start
    order = torch.argsort(deg, descending=True, stable=True)
    deg_desc = deg[order]
    max_deg = int(deg_desc[0])
    # live[k]: how many groups have more than k values.
    live = torch.searchsorted(
        -deg_desc, -torch.arange(max_deg, device=deg.device), side="left"
    ).tolist()
    vals = values[perm.long()]
    for k, count in enumerate(live):
        g = order[:count]
        out[g] = out[g] + vals[start[g] + k]
    return out


def ordered_fold_gathered_ref(
    base: torch.Tensor,
    row_ptr: torch.Tensor,
    idx: torch.Tensor,
    node: torch.Tensor,
    weight: torch.Tensor,
    scale: torch.Tensor,
) -> torch.Tensor:
    """``ordered_fold_ref`` of ``scale * (node[idx] * weight)`` in slot
    order: the gather and the two multiplies as the kernel does them, then
    the fold with the identity permutation. Every ``idx`` must index
    ``node``."""
    vals = scale * (node[idx.long()] * weight)
    slots = torch.arange(idx.numel(), dtype=torch.int32, device=idx.device)
    return ordered_fold_ref(base, row_ptr, slots, vals)
