"""Wrappers of the slot-order fold kernel (``csrc/ordered_fold.cu``).

Port-only: the reference has no Pallas kernel here. Its ``ADD`` monoid
(``repro/core/operators.py``) is a scatter-add that XLA's CPU and TPU
backends fold in edge-slot order, which is what keeps PageRank bit-equal
to its numpy oracle (``np.add.at``). On the card ``index_add_`` folds
through atomics in no fixed order, so the port folds explicitly: the
index is sorted stably once (``fold_plan``), and each target adds its
values onto its base in slot order.

Two wrappers launch the one kernel. ``ordered_fold_sorted`` folds
``values[perm[s]]``; ``ordered_fold_gathered`` folds
``scale * (node[idx[s]] * weight[s])``, gathering and multiplying its own
values from arrays already in slot order (PageRank's mass step, with no
m2-long intermediate). Both count under ``launch_counts["ordered_fold"]``.

The kernel gives each warp 32 consecutive targets and walks the union of
their slot ranges in chunks of ``CHUNK`` slots: coalesced index loads, the
chunk's random gathers issued together, and lane ``i`` folding target
``v0 + i`` from shared memory. A target with more than ``HEAVY`` slots gets
a warp of its own, so a hub's loads spread over 32 lanes and only its adds
are serial: its floor is its degree times the latency of one add.
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
from repro_torch.kernels.ordered_fold.ref import (
    ordered_fold_gathered_ref,
    ordered_fold_ref,
)

_P, _I = ctypes.c_void_p, ctypes.c_int

CHUNK = 512  # slots a warp walks a chunk: kChunk in the .cu, which checks it
HEAVY = 2048  # a target with more slots is folded by a warp of its own


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


def _check_float(name: str, x: torch.Tensor, dev: torch.device) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev:
        raise ValueError(
            f"{name} must be a contiguous float32 tensor on {dev}; got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )


def _launch(base, row_ptr, idx, node, weight, scale) -> torch.Tensor:
    """Check the inputs and launch the kernel: the plain fold when
    ``weight`` and ``scale`` are None, else the scaled one."""
    from repro_torch.kernels.build import function

    dev = base.device
    _check_float("base", base, dev)
    _check_float("node", node, dev)
    check_int32("row_ptr", row_ptr, dev)
    check_int32("idx", idx, dev)
    n, m = base.shape[0], idx.shape[0]
    if base.dim() != 1 or row_ptr.shape != (n + 1,) or idx.dim() != 1:
        raise ValueError(
            f"ordered_fold: base must be (n,), row_ptr (n + 1,) and idx (m,); "
            f"got {tuple(base.shape)}, {tuple(row_ptr.shape)} and {tuple(idx.shape)}"
        )
    scaled = weight is not None
    if scaled:
        _check_float("weight", weight, dev)
        _check_float("scale", scale, dev)
        if weight.shape != (m,) or scale.numel() != 1:
            raise ValueError(
                f"ordered_fold: weight must have idx's {m} slots and scale one "
                f"value; got {weight.numel()} and {scale.numel()}"
            )
    if n == 0 or m == 0:
        return base.clone()
    out = torch.empty_like(base)
    fn = function("ordered_fold", "ordered_fold_run", (_P,) * 7 + (_I,) * 5 + (_P,))
    check_status("ordered_fold", fn(
        base.data_ptr(), row_ptr.data_ptr(), idx.data_ptr(), node.data_ptr(),
        weight.data_ptr() if scaled else 0, scale.data_ptr() if scaled else 0,
        out.data_ptr(), n, m, int(scaled), CHUNK, HEAVY,
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    launch_counts["ordered_fold"] += 1
    return out


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
    if perm.shape != values.reshape(-1).shape:
        raise ValueError(
            f"ordered_fold: perm has {perm.numel()} slots, values {values.numel()}"
        )
    return _launch(base, row_ptr, perm, values, None, None)


def ordered_fold_gathered(
    base: torch.Tensor,
    row_ptr: torch.Tensor,
    idx_sorted: torch.Tensor,
    node: torch.Tensor,
    weight_sorted: torch.Tensor,
    scale: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """The fold of ``x[s] = scale * (node[idx_sorted[s]] * weight_sorted[s])``,
    each multiply rounded on its own, over ``s in [row_ptr[v], row_ptr[v +
    1])`` onto ``base[v]``, in slot order: ``idx_sorted`` and
    ``weight_sorted`` are already in the plan's slot order, and ``scale``
    is a one-value float32 tensor (read on the card, never on the
    host)."""
    if resolve_impl(impl, base) == "torch":
        return ordered_fold_gathered_ref(base, row_ptr, idx_sorted, node,
                                         weight_sorted, scale)
    return _launch(base, row_ptr, idx_sorted, node, weight_sorted, scale)
