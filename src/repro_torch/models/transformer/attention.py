"""Attention of the port: GQA/MQA/MHA (gemma, phi3, qwen3, mixtral) and
MLA (DeepSeek-V3), the port's copy of
``repro.models.transformer.attention``. Each has a prefill path through
the ``flash_attention`` kernel and a one-token decode over a KV cache:
GQA's a ring buffer of keys and values, MLA's the compressed latent and
rope keys, read by the absorbed-matmul decode.

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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


class MLAttention(nn.Module):
    """The parameters of one MLA block: the low-rank query (``wq_a``,
    ``q_norm``, ``wq_b``; or one ``wq`` without ``q_lora_rank``), the
    compressed key/value latent with its rope key (``wkv_a``,
    ``kv_norm``), its expansion into per-head keys and values
    (``wkv_b``) and the output projection."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
        kw = dict(bias=False, device=device, dtype=dtype)
        if qr:
            self.wq_a = nn.Linear(d, qr, **kw)
            self.q_norm = nn.Parameter(torch.zeros(qr, device=device, dtype=dtype))
            self.wq_b = nn.Linear(qr, h * (dn + dr), **kw)
            self.wq = None
        else:
            self.wq_a = self.q_norm = self.wq_b = None
            self.wq = nn.Linear(d, h * (dn + dr), **kw)
        self.wkv_a = nn.Linear(d, kr + dr, **kw)
        self.kv_norm = nn.Parameter(torch.zeros(kr, device=device, dtype=dtype))
        self.wkv_b = nn.Linear(kr, h * (dn + dv), **kw)
        self.wo = nn.Linear(h * dv, d, **kw)


def init_mla_params(
    p: MLAttention, cfg: TransformerConfig, generator: torch.Generator
) -> None:
    """Draw ``p``'s weights in place with the reference's scales: the
    inverse square root of each matrix's input width; norm gammas zero."""
    d, kr = cfg.d_model, cfg.kv_lora_rank
    if cfg.q_lora_rank:
        normal_(p.wq_a.weight, d ** -0.5, generator)
        normal_(p.wq_b.weight, cfg.q_lora_rank ** -0.5, generator)
        p.q_norm.data.zero_()
    else:
        normal_(p.wq.weight, d ** -0.5, generator)
    normal_(p.wkv_a.weight, d ** -0.5, generator)
    normal_(p.wkv_b.weight, kr ** -0.5, generator)
    normal_(p.wo.weight, (cfg.num_heads * cfg.v_head_dim) ** -0.5, generator)
    p.kv_norm.data.zero_()


def _mla_qkv(p: MLAttention, cfg: TransformerConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """``(q_nope (B, S, H, dn), q_rope (B, S, H, dr) rotated, c_kv (B, S,
    kv_lora) normed, k_rope (B, S, dr) rotated)``."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        q = F.linear(rms_norm(F.linear(x, p.wq_a.weight), p.q_norm), p.wq_b.weight)
    else:
        q = F.linear(x, p.wq.weight)
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_freqs(dr, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)

    kv = F.linear(x, p.wkv_a.weight)  # (b, s, kv_lora + dr)
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], p.kv_norm)
    k_rope = apply_rope(kv[..., cfg.kv_lora_rank:][:, :, None, :], cos, sin)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def mla_attention(
    p: MLAttention, cfg: TransformerConfig, x: torch.Tensor,
    positions: torch.Tensor, *, mesh=None,
) -> torch.Tensor:
    """Prefill MLA: expand the latent into per-head keys and values and
    run causal attention through the flash_attention kernel, with a
    query/key head dim of ``qk_nope + qk_rope`` and a value head dim of
    ``v_head_dim`` (the reference calls ``attention_ref`` here, the
    plain version, which the kernel's CPU route runs). The rope key is
    shared by every head; ``torch.cat`` writes it into each head's key,
    the one copy on this path."""
    no_mesh(mesh)
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    kv = F.linear(c_kv, p.wkv_b.weight).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True)
    return F.linear(out.transpose(1, 2).reshape(b, s, h * dv), p.wo.weight)


def mla_decode(
    p: MLAttention, cfg: TransformerConfig, x: torch.Tensor,
    cache_ckv: torch.Tensor, cache_krope: torch.Tensor, pos: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-matmul MLA decode over the compressed cache. x: (B, 1, d);
    cache_ckv: (B, L, kv_lora); cache_krope: (B, L, dr); pos: the new
    token's index.

    Scores are taken against the latent directly (q absorbed through
    W_uk) and the context is read in latent space and expanded through
    W_uv afterwards, in float32 (the bf16 weights widened, as JAX widens
    them against float32 operands). As ``gqa_decode``, the new entries
    are written into the caches IN PLACE, and the caches returned."""
    b = x.shape[0]
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, cfg, x, positions)
    cache_ckv[:, pos] = c_kv_new[:, 0]
    cache_krope[:, pos] = k_rope_new[:, 0]

    # wkv_b.weight is (H * (dn + dv), kv_lora): the reference's (kv_lora,
    # H, dn + dv) matrix transposed.
    wkv_b = p.wkv_b.weight.t().reshape(kr, h, dn + dv).float()
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    ckv = cache_ckv.float()
    q_eff = torch.einsum("bqhd,khd->bqhk", q_nope.float(), w_uk)
    s_nope = torch.einsum("bqhk,blk->bhql", q_eff, ckv)
    s_rope = torch.einsum("bqhd,bld->bhql", q_rope.float(), cache_krope.float())
    scores = (s_nope + s_rope) / ((dn + dr) ** 0.5)
    live = torch.arange(cache_ckv.shape[1], device=x.device) <= pos
    scores = scores.masked_fill_(~live, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhql,blk->bqhk", probs, ckv)
    ctx = torch.einsum("bqhk,khd->bqhd", ctx_lat, w_uv)
    out = F.linear(ctx.to(x.dtype).reshape(b, 1, h * dv), p.wo.weight)
    return out, cache_ckv, cache_krope
