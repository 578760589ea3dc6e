"""Plain PyTorch version of the flash_attention kernel: materialised-score
attention with GQA, causal and sliding-window masks, the port's copy of
``repro.kernels.flash_attention.ref.attention_ref``.

GQA repeats each KV head ``Hq // Hkv`` times; scores are float32 and
divided by ``sqrt(D)``; masked scores are set to ``-1e30`` before a
float32 softmax; ``p @ v`` is float32 and the result is cast to ``q``'s
dtype. A row with no live key (only reachable with ``q_offset``, or with
a window and ``Sq >= Sk + window``) gets equal weights on every key: the
mean of ``v``.

``attention_vjp_ref`` is the VJP of ``attention_ref`` by autograd, the
plain version of the backward kernel (``csrc/flash_attention_bwd.cu``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float())
    s = s.div_(d ** 0.5)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = s.masked_fill_(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # torch's einsum does not promote mixed dtypes (JAX's does): cast v.
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.float()).to(q.dtype)


def attention_vjp_ref(
    q: torch.Tensor,     # (B, Hq, Sq, D)
    k: torch.Tensor,     # (B, Hkv, Sk, D)
    v: torch.Tensor,     # (B, Hkv, Sk, Dv)
    dout: torch.Tensor,  # (B, Hq, Sq, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the VJP of ``attention_ref`` at ``dout``, by
    autograd through it (materialised scores, ``(B, Hq, Sq, Sk)``
    float32), in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, dout)
