"""GQA/MQA/MHA attention of the port: the prefill path through the
``flash_attention`` kernel and the one-token decode over a ring-buffer
KV cache. The port's copy of the GQA half of
``repro.models.transformer.attention``; MLA waits for ROADMAP queue 1,
item 15.

Weights keep ``nn.Linear``'s ``(out, in)`` layout (``convert.py``
transposes the reference's ``(in, out)`` arrays), so ``x @ W`` of the
reference is ``F.linear(x, W)`` here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.common import apply_rope, rms_norm, rope_freqs
from repro_torch.models.transformer.config import TransformerConfig


def no_mesh(mesh) -> None:
    """The port runs on one card: a ``mesh=`` raises."""
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch runs on one card: sharded attention and embedding "
            "wait for distributed/sharding.py (ROADMAP queue 1, item 16)"
        )


class GQAttention(nn.Module):
    """The parameters of one GQA attention block."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        kw = dict(bias=False, device=device, dtype=dtype)
        self.wq = nn.Linear(d, hq * hd, **kw)
        self.wk = nn.Linear(d, hkv * hd, **kw)
        self.wv = nn.Linear(d, hkv * hd, **kw)
        self.wo = nn.Linear(hq * hd, d, **kw)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(hd, device=device, dtype=dtype))
            self.k_norm = nn.Parameter(torch.zeros(hd, device=device, dtype=dtype))
        else:
            self.q_norm = self.k_norm = None


def init_gqa_params(
    p: GQAttention, cfg: TransformerConfig, generator: torch.Generator
) -> None:
    """Draw ``p``'s weights in place: normal with the reference's scales
    (``d ** -0.5`` for q, k, v; ``(Hq * hd) ** -0.5`` for the output),
    drawn in float32 and cast; qk-norm gammas are zero."""
    d = cfg.d_model
    for lin, scale in ((p.wq, d ** -0.5), (p.wk, d ** -0.5),
                       (p.wv, d ** -0.5),
                       (p.wo, (cfg.num_heads * cfg.head_dim) ** -0.5)):
        normal_(lin.weight, scale, generator)
    if cfg.qk_norm:
        p.q_norm.data.zero_()
        p.k_norm.data.zero_()


@torch.no_grad()
def normal_(w: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """Fill ``w`` with ``N(0, 1) * scale``, drawn in float32 and cast to
    ``w``'s dtype, as the reference's ``(normal * scale).astype``."""
    if w.is_meta:
        return
    draw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    draw.normal_(generator=generator)
    w.copy_(draw.mul_(scale))


def qkv_projections(p: GQAttention, cfg: TransformerConfig,
                    x: torch.Tensor, positions: torch.Tensor):
    """Projected, qk-normed and rotated q (B, S, Hq, hd), k and v
    (B, S, Hkv, hd)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = F.linear(x, p.wq.weight).reshape(b, s, hq, hd)
    k = F.linear(x, p.wk.weight).reshape(b, s, hkv, hd)
    v = F.linear(x, p.wv.weight).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_attention(
    p: GQAttention, cfg: TransformerConfig, x: torch.Tensor,
    positions: torch.Tensor, *, mesh=None,
) -> torch.Tensor:
    """Prefill attention through the flash_attention kernel.
    x: (B, S, d); positions: (B, S)."""
    no_mesh(mesh)
    b, s, _ = x.shape
    q, k, v = qkv_projections(p, cfg, x, positions)
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=cfg.sliding_window,
    )
    return F.linear(
        out.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim),
        p.wo.weight,
    )


def gqa_decode(
    p: GQAttention, cfg: TransformerConfig, x: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, d); cache_k/v: (B, L, Hkv, hd); pos:
    the new token's index.

    The new k and v are written into the caches IN PLACE (the reference
    returns updated copies; a copy of the cache per token and layer is
    what the in-place write saves), and the caches are returned. With a
    sliding window the cache is a ring buffer of length min(window, L)
    and writes wrap (``slot = pos % cache_len``)."""
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache_len = cache_k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = qkv_projections(p, cfg, x, positions)

    slot = pos % cache_len  # ring-buffer write (no-op when cache covers seq)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]

    # Query head h reads KV head h // group: (B, Hkv, group, hd) queries
    # against (B, L, Hkv, hd) keys, with no repeated cache.
    group = hq // hkv
    qg = q.reshape(b, hkv, group, hd).float()
    scores = torch.einsum("bkgd,blkd->bkgl", qg, cache_k.float()) / (hd ** 0.5)
    # Valid cache slots: slot l holds some position <= pos, and with
    # window w only the last min(pos + 1, w) slots are live.
    idx = torch.arange(cache_len, device=x.device)
    if cfg.sliding_window is not None and cache_len <= cfg.sliding_window:
        live = idx < min(pos + 1, cache_len)
    else:
        live = idx <= pos
        if cfg.sliding_window is not None:
            live &= idx > pos - cfg.sliding_window
    scores = scores.masked_fill_(~live, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgl,blkd->bkgd", probs, cache_v.float())
    out = F.linear(ctx.to(x.dtype).reshape(b, 1, hq * hd), p.wo.weight)
    return out, cache_k, cache_v
