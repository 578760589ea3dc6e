"""Gradient compression: int8 quantization with error feedback, the port
of ``repro.train.compression``.

Gradients are quantized to int8 with a per-tensor scale and the
quantization error is carried into the next step (error feedback). On
one card nothing crosses a wire: ``compress_decompress`` is the
simulated compressed all-reduce, numerically the local quantize ->
dequantize, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.train.tree import leaves, like, map_tree


def init_error_feedback(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads, error_feedback):
    """Returns ``(decompressed grads, new error feedback)``, each in the
    structure of ``grads`` (a module's as the dict of its parameters)."""
    new_g, new_e = [], []
    for g, e in zip(leaves(grads), leaves(error_feedback)):
        corrected = g.float() + e
        q, scale = quantize_int8(corrected)
        deq = dequantize_int8(q, scale)
        new_g.append(deq.to(g.dtype))
        new_e.append(corrected - deq)
    return like(grads, new_g), like(error_feedback, new_e)
