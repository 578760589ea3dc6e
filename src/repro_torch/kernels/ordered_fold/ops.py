"""Wrapper of the slot-order fold kernel (``csrc/ordered_fold.cu``).

Port-only: the reference has no Pallas kernel here. Its ``ADD`` monoid
(``repro/core/operators.py``) is a scatter-add that XLA's CPU and TPU
backends fold in edge-slot order, which is what keeps PageRank bit-equal
to its numpy oracle (``np.add.at``). On the card ``index_add_`` folds
through atomics in no fixed order, so the port folds explicitly: the
index is sorted stably once (``fold_plan``), and each target adds its
values onto its base in slot order (``ordered_fold_sorted``).

What bounds it on the H100 is memory: 8 bytes an arc (``perm`` and
``values``) and 12 a node (``row_ptr``, ``base``, the output). The
kernel gives each target one thread, which walks its range in order, so
a hub folds serially: a target with 2^20 arcs is 2^20 dependent adds.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import (
    check_int32,
    check_status,
    launch_counts,
    resolve_impl,
)
from repro_torch.kernels.ordered_fold.ref import ordered_fold_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


class FoldPlan(NamedTuple):
    """An index sorted stably: ``perm`` lists the slots in order of their
    index (equal indices in slot order), and the slots of group ``v`` are
    ``perm[row_ptr[v]:row_ptr[v + 1]]``."""

    row_ptr: torch.Tensor  # (num_groups + 1,) int32
    perm: torch.Tensor  # (m,) int32


def fold_plan(index: torch.Tensor, num_groups: int) -> FoldPlan:
    """The ``FoldPlan`` of ``index`` over ``num_groups`` groups: one
    stable sort and one ``searchsorted``, with no read to the host.
    Indices outside ``[0, num_groups)`` fall in no group and are
    dropped."""
    idx = index.reshape(-1)
    if idx.numel() >= 1 << 31:
        raise ValueError(f"fold_plan takes fewer than 2**31 slots, got {idx.numel()}")
    keys, perm = torch.sort(idx, stable=True)
    bounds = torch.arange(num_groups + 1, dtype=keys.dtype, device=keys.device)
    row_ptr = torch.searchsorted(keys, bounds, side="left")
    return FoldPlan(row_ptr.to(torch.int32), perm.to(torch.int32))


def ordered_fold_sorted(
    base: torch.Tensor,
    row_ptr: torch.Tensor,
    perm: torch.Tensor,
    values: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """``out[v] = (((base[v] + values[perm[s]]) + values[perm[s + 1]])
    + ...)`` over ``s in [row_ptr[v], row_ptr[v + 1])``: float32, every
    add rounded on its own, in slot order."""
    if resolve_impl(impl, base) == "torch":
        return ordered_fold_ref(base, row_ptr, perm, values)
    from repro_torch.kernels.build import function

    dev = base.device
    for name, x in (("base", base), ("values", values)):
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev:
            raise ValueError(
                f"{name} must be a contiguous float32 tensor on {dev}; got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    check_int32("row_ptr", row_ptr, dev)
    check_int32("perm", perm, dev)
    n = base.shape[0]
    if base.dim() != 1 or row_ptr.shape != (n + 1,):
        raise ValueError(
            f"ordered_fold: base must be (n,) and row_ptr (n + 1,); got "
            f"{tuple(base.shape)} and {tuple(row_ptr.shape)}"
        )
    if perm.shape != values.reshape(-1).shape:
        raise ValueError(
            f"ordered_fold: perm has {perm.numel()} slots, values {values.numel()}"
        )
    if n == 0 or perm.numel() == 0:
        return base.clone()
    out = torch.empty_like(base)
    fn = function("ordered_fold", "ordered_fold_run", (_P, _P, _P, _P, _P, _I, _P))
    check_status("ordered_fold", fn(
        base.data_ptr(), row_ptr.data_ptr(), perm.data_ptr(), values.data_ptr(),
        out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
    ))
    launch_counts["ordered_fold"] += 1
    return out
