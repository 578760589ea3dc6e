"""Shared model building blocks of the port: RMS norm, rotary embedding,
activations. The port's copy of the parts of ``repro.models.common``
that the decoder LM uses; the GNN inits and ``softmax_cross_entropy``
come with the slices that call them."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32 and scaled by
    ``1 + gamma`` (zero-initialised gammas are the identity scale)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def rope_freqs(
    head_dim: int, theta: float, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding; positions (..., seq) ->
    two float32 tensors (..., seq, head_dim / 2)."""
    exponents = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device
    ) / head_dim
    inv = 1.0 / (theta ** exponents)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim / 2).
    Rotates the two halves of the head (not interleaved pairs)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# The activations are written op for op as jax.nn defines them, each op
# rounding to the input dtype and each constant cast to it, as XLA does
# for bf16 (torch's fused F.silu / F.gelu round once, and differ from
# the reference in about 40% of bf16 outputs).


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: ``x * (1 / (1 + exp(-x)))``."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True):
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))))``."""
    inner = _const(x, math.sqrt(2 / math.pi)) * (
        x + _const(x, 0.044715) * (x * x * x))
    return x * (_const(x, 0.5) * (1.0 + torch.tanh(inner)))


# jax.nn.gelu defaults to the tanh approximation, so "gelu" and
# "gelu_tanh" are the same function in the reference.
_ACTIVATIONS = {
    "silu": _silu,
    "gelu": _gelu_tanh,
    "relu": F.relu,
    "gelu_tanh": _gelu_tanh,
}


def activation_fn(name: str):
    return _ACTIVATIONS[name]


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
