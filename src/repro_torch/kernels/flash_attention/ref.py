"""Plain PyTorch version of the flash_attention kernel: materialised-score
attention with GQA, causal and sliding-window masks, the port's copy of
``repro.kernels.flash_attention.ref.attention_ref``.

GQA repeats each KV head ``Hq // Hkv`` times; scores are float32 and
divided by ``sqrt(D)``; masked scores are set to ``-1e30`` before a
float32 softmax; ``p @ v`` is float32 and the result is cast to ``q``'s
dtype. A row with no live key (only reachable with ``q_offset``, or with
a window and ``Sq >= Sk + window``) gets equal weights on every key: the
mean of ``v``.

``attention_lse_ref`` is the plain version of the forward kernel's second
output, each row's log-sum-exp. ``attention_vjp_ref`` is the VJP of
``attention_ref`` by autograd, the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``) that the card check holds it to;
``attention_bwd_ref`` is the same function written as the kernel
computes it, from the forward's output and log-sum-exp, with dK and dV
summed over each KV head's query heads in head groups as the kernel's
second pass splits them (``ops.py::bwd_head_groups``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, causal, window, q_offset):
    """attention_ref's float32 scores, scaled by ``1 / sqrt(D)`` and set to
    ``NEG_INF`` where masked, and its mask ``(Sq, Sk)``, True where a
    (query, key) pair scores."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float())
    s = s.div_(d ** 0.5)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return s.masked_fill_(~mask, NEG_INF), mask


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    s, _ = _scores(q, k, causal, window, q_offset)
    p = torch.softmax(s, dim=-1)
    vr = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    # torch's einsum does not promote mixed dtypes (JAX's does): cast v.
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.float()).to(q.dtype)


def attention_lse_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``(B, Hq, Sq)`` float32: each row's log-sum-exp of ``attention_ref``'s
    scaled scores over its live keys, in natural log units, and ``+inf``
    for a row with no live key. The plain version of what the forward
    kernel writes beside its output for a backward."""
    s, mask = _scores(q, k, causal, window, q_offset)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.where(mask.any(dim=-1), lse, torch.full_like(lse, float("inf")))


def attention_bwd_ref(
    q: torch.Tensor,     # (B, Hq, Sq, D)
    k: torch.Tensor,     # (B, Hkv, Sk, D)
    v: torch.Tensor,     # (B, Hkv, Sk, Dv)
    out: torch.Tensor,   # (B, Hq, Sq, Dv): attention_ref(q, k, v)
    dout: torch.Tensor,  # (B, Hq, Sq, Dv)
    lse: torch.Tensor,   # (B, Hq, Sq): attention_lse_ref(q, k)
    *,
    causal: bool = True,
    window: int | None = None,
    groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` as the backward kernel takes them, from the
    forward's ``out`` and ``lse``, in float32 and then the inputs' dtypes:
    P = exp(S - lse) on live pairs, ``1 / Sk`` on every key of a row with
    no live key (``lse = +inf``) and 0 elsewhere; D_i = rowsum(dout o
    out); dS = P o (dout V^T - D_i) on live pairs, 0 elsewhere; dq = dS K /
    sqrt(D), dk = dS^T Q / sqrt(D) and dv = P^T dout, dk and dv summed over
    each KV head's query heads: within each of ``groups`` consecutive
    groups of them (a divisor of Hq / Hkv), then the groups' float32
    partials added in group order, as the kernel's second pass and its
    third launch do. The same function as ``attention_vjp_ref``, written
    as the kernel computes it."""
    b, hq, sq, d = q.shape
    hkv, sk, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    group = hq // hkv
    if groups < 1 or group % groups:
        raise ValueError(f"groups must divide Hq / Hkv = {group}, got {groups}")
    s, mask = _scores(q, k, causal, window, 0)
    dead = torch.isinf(lse)[..., None]
    live = mask & ~dead
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    p = torch.where(dead, 1.0 / sk, p)
    dof = dout.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float().repeat_interleave(group, dim=1))
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = torch.where(live, p * (dp - delta), 0.0) / d ** 0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float().repeat_interleave(group, dim=1))
    heads = group // groups

    def by_groups(x, width):
        part = x.reshape(b, hkv, groups, heads, sk, width).sum(3)
        acc = part[:, :, 0]
        for g in range(1, groups):
            acc = acc + part[:, :, g]
        return acc

    dk = by_groups(torch.einsum("bhqk,bhqd->bhkd", ds, q.float()), d)
    dv = by_groups(torch.einsum("bhqk,bhqd->bhkd", p, dof), dv_dim)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
