"""Plain PyTorch version of the splitter_aggregate kernel."""
from __future__ import annotations

import torch


def splitter_aggregate_ref(
    packed: torch.Tensor, sprank: torch.Tensor
) -> torch.Tensor:
    return sprank[packed[:, 1]] - packed[:, 0]
