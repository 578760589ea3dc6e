"""Plain PyTorch version of the pointer_jump kernel."""
from __future__ import annotations

import torch


def pointer_jump_ref(
    nxt: torch.Tensor, w: torch.Tensor, *, iters: int
) -> tuple[torch.Tensor, torch.Tensor]:
    rank = w
    for _ in range(iters):
        rank, nxt = rank + rank[nxt], nxt[nxt]
    return rank, nxt
