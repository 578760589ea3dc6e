"""Plain PyTorch version of the sorted segment sum kernel, the
counterpart of ``repro/kernels/segment_sum/ref.py::segment_sum_sorted_ref``.
It does not need the ids sorted."""
from __future__ import annotations

import torch


def segment_sum_sorted_ref(
    data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``out[s] = sum(data[i] for ids[i] == s)``, shape
    ``(num_segments, *data.shape[1:])``. Ids outside
    ``[0, num_segments)`` go to a drop row, cut off afterwards, so they
    contribute nothing, as in ``jax.ops.segment_sum``. Floats narrower
    than float32 are summed in float32 and rounded once."""
    acc = (torch.promote_types(data.dtype, torch.float32)
           if data.is_floating_point() else data.dtype)
    ids = seg_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=acc,
                      device=data.device)
    out.index_add_(0, ids, data.to(acc))
    return out[:num_segments].to(data.dtype)
