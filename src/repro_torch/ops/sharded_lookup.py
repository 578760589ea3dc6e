"""Distributed row gather from a row-sharded table (the embedding
lookup): the port of ``repro/ops/sharded_lookup.py``.

Each rank gathers the rows it owns (a branch-free mask) and a sum over
the row axis combines the partials: the paper's concurrent-write
arbitration lifted to the collective level.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import reduce_from


def sharded_row_gather(
    table: torch.Tensor,  # (rows / n, dim): this rank's block of rows
    idx: torch.Tensor,  # any int shape: this rank's indices
    mesh=None,
    row_axis: str | None = "model",
) -> torch.Tensor:
    """``full_table[idx]``, shape ``idx.shape + (dim,)``, from this
    rank's block of rows (block ``i`` of ``row_axis`` holds rows ``[i *
    per, (i + 1) * per)``). The sum over ``row_axis`` passes the gradient
    through, as every rank of the axis uses the result alike, so each
    rank's table gradient is its block of ``index_add_``'s. With no mesh,
    no ``row_axis`` on it, or one rank on the axis, a plain
    ``F.embedding`` (the meshless lookup) of ``table``."""
    if (mesh is None or mesh.empty or row_axis not in mesh.axis_names
            or mesh.shape[row_axis] == 1):
        return F.embedding(idx.long(), table)
    per = table.shape[0]
    loc = idx.long() - mesh.axis_index(row_axis) * per
    ok = (loc >= 0) & (loc < per)
    vals = table.index_select(0, loc.clamp(0, per - 1).reshape(-1))
    vals = vals.reshape(*idx.shape, table.shape[-1])
    vals = torch.where(ok[..., None], vals, 0)
    return reduce_from(vals, mesh, row_axis)
