"""Where the port's inputs live.

Torch tensors keep their device. numpy arrays and lists go to the
``device=`` the caller names, which defaults to the CUDA card. A run that
was not asked for the CPU never continues there quietly: without CUDA it
raises.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The device for host inputs: ``device`` or the card. Raises if the
    card is asked for (or defaulted to) and CUDA is not available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU"
        )
    return dev


def as_int32(x, device=None) -> torch.Tensor:
    """``x`` as a flat int32 tensor: a tensor stays on its device, any
    other input goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).to(torch.int32)
    arr = np.asarray(x).reshape(-1).astype(np.int32)
    return torch.from_numpy(arr).to(resolve_device(device))
