"""Attention of the port: GQA/MQA/MHA (gemma, phi3, qwen3, mixtral) and
MLA (DeepSeek-V3), the port's copy of
``repro.models.transformer.attention``. Each has a prefill path through
the ``flash_attention`` kernel and a one-token decode over a KV cache:
GQA's a ring buffer of keys and values, MLA's the compressed latent and
rope keys, read by the absorbed-matmul decode.

Weights keep ``nn.Linear``'s ``(out, in)`` layout (``convert.py``
transposes the reference's ``(in, out)`` arrays), so ``x @ W`` of the
reference is ``F.linear(x, W)`` here.

With a ``mesh`` whose ``"model"`` axis has more than one rank, the
weights are this rank's blocks (``configs/lm_family.py::
lm_param_specs``): the q/k/v (and MLA's ``wq_a``, ``wq_b``, ``wkv_b``)
projections column-sliced, ``wo`` row-sliced. As the reference's
``_attn_shardings`` picks, query heads run on the rank that holds them
when the axis divides the head count (and key/value heads too where it
divides theirs); otherwise the projections are gathered and attention
runs on every head, batch-only. ``column`` and ``row`` are the sliced
products, with the gradients of ``distributed/collectives.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.collectives import (
    all_gather,
    all_reduce,
    copy_to,
    gather_from,
    reduce_from,
    scatter_to,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.common import apply_rope, rms_norm, rope_freqs
from repro_torch.models.transformer.config import TransformerConfig


MODEL = "model"


def tp_size(mesh) -> int:
    """Ranks on the mesh's ``"model"`` axis (1 without a mesh or axis)."""
    if mesh is None or MODEL not in mesh.axis_names:
        return 1
    return mesh.shape[MODEL]


def column(x: torch.Tensor, w: torch.Tensor, mesh, full_out: int, *,
           gather: bool) -> torch.Tensor:
    """``F.linear(x, w)`` with ``w`` this rank's rows of a ``(full_out,
    in)`` weight: this rank's slice of the output, or the whole output
    gathered over ``"model"`` with ``gather``. A whole ``w`` gives the
    whole output."""
    if w.shape[0] == full_out:
        return F.linear(x, w)
    y = F.linear(copy_to(x, mesh, MODEL), w)
    return gather_from(y, mesh, MODEL, -1) if gather else y


def row(h: torch.Tensor, w: torch.Tensor, mesh, full_in: int) -> torch.Tensor:
    """``F.linear(h, W)`` for the ``(out, full_in)`` weight ``W`` of which
    ``w`` is this rank's columns (or all of it), summed over ``"model"``;
    ``h`` is this rank's slice of the input, or the whole of it."""
    local = h.shape[-1] != full_in
    if w.shape[1] == full_in:
        return F.linear(gather_from(h, mesh, MODEL, -1) if local else h, w)
    if not local:
        h = scatter_to(h, mesh, MODEL, -1)
    return reduce_from(F.linear(h, w), mesh, MODEL)


def _first_head(mesh, local_heads: int, heads: int) -> int:
    """The first of this rank's heads (0 when it runs every head)."""
    if local_heads == heads:
        return 0
    return mesh.coords[MODEL] * local_heads


def kv_for_heads(k, v, h0: int, hq_local: int, group: int):
    """The key/value heads (dim 1 of (B, Hkv, S, D)) that query heads
    ``h0 .. h0 + hq_local - 1`` read (head ``h`` reads ``h // group``),
    and the group size among them."""
    if hq_local % group == 0:
        sl = slice(h0 // group, (h0 + hq_local) // group)
        return k[:, sl], v[:, sl], group
    if group % hq_local == 0:
        sl = slice(h0 // group, h0 // group + 1)
        return k[:, sl], v[:, sl], hq_local
    idx = torch.arange(h0, h0 + hq_local, device=k.device) // group
    return k.index_select(1, idx), v.index_select(1, idx), 1


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
                    x: torch.Tensor, positions: torch.Tensor, mesh=None, *,
                    gather_q: bool = True, gather_kv: bool = True):
    """Projected, qk-normed and rotated q (B, S, Hq, hd), k and v
    (B, S, Hkv, hd): every head, or this rank's where its projection is
    sliced and ``gather_q`` / ``gather_kv`` is False."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = column(x, p.wq.weight, mesh, hq * hd, gather=gather_q).reshape(b, s, -1, hd)
    k = column(x, p.wk.weight, mesh, hkv * hd, gather=gather_kv).reshape(b, s, -1, hd)
    v = column(x, p.wv.weight, mesh, hkv * hd, gather=gather_kv).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, _replicated(p.q_norm, q.shape[2] != hq, mesh))
        k = rms_norm(k, _replicated(p.k_norm, k.shape[2] != hkv, mesh))
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _replicated(t: torch.Tensor, local: bool, mesh) -> torch.Tensor:
    """``t``, which every rank holds alike, marked with ``copy_to`` where
    it meets this rank's heads (``local``), so its gradient sums the
    ranks'."""
    return copy_to(t, mesh, MODEL) if local else t


def gqa_attention(
    p: GQAttention, cfg: TransformerConfig, x: torch.Tensor,
    positions: torch.Tensor, *, mesh=None,
) -> torch.Tensor:
    """Prefill attention through the flash_attention kernel.
    x: (B, S, d); positions: (B, S). With a ``mesh``, on this rank's
    heads where ``"model"`` divides them (see the module docstring)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = tp_size(mesh)
    q_local = tp > 1 and hq % tp == 0
    q, k, v = qkv_projections(p, cfg, x, positions, mesh, gather_q=not q_local,
                              gather_kv=not (q_local and hkv % tp == 0))
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.shape[1] != hq and k.shape[1] == hkv:
        k, v, _ = kv_for_heads(_replicated(k, True, mesh), _replicated(v, True, mesh),
                               _first_head(mesh, q.shape[1], hq), q.shape[1], hq // hkv)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return row(out.transpose(1, 2).reshape(b, s, -1), p.wo.weight, mesh, hq * hd)


def decode_attend(scores, values, live, mesh, seq_split: bool, spec: str):
    """``softmax(scores) @ values`` over the cache positions (the last dim
    of ``scores``), dead positions masked; ``spec`` is the einsum of
    probabilities and values. With ``seq_split`` this rank holds its
    slice of the positions, and the softmax is combined over
    ``"model"`` (a max, then sums of the weights and of the weighted
    values)."""
    scores = scores.masked_fill_(~live, NEG_INF)
    if not seq_split:
        return torch.einsum(spec, torch.softmax(scores, dim=-1), values)
    top = all_reduce(scores.amax(dim=-1, keepdim=True), mesh, MODEL,
                     torch.distributed.ReduceOp.MAX)
    w = torch.exp(scores - top)
    den = all_reduce(w.sum(dim=-1, keepdim=True), mesh, MODEL)
    ctx = all_reduce(torch.einsum(spec, w, values), mesh, MODEL)
    return ctx / _ctx_shape(den, spec)


def _ctx_shape(den, spec: str):
    """The softmax denominators (..., 1) laid out like the context."""
    out = spec.split("->")[1]
    if out == "bkgd":  # GQA: den (B, Hkv, g, 1)
        return den
    return den.permute(0, 2, 1, 3)  # MLA: den (B, H, 1, 1) -> (B, 1, H, 1)


def _seq_slice(mesh, cache_len: int, seq_split: bool) -> int:
    """The first cache position this rank holds."""
    return mesh.coords[MODEL] * cache_len if seq_split else 0


def gqa_decode(
    p: GQAttention, cfg: TransformerConfig, x: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int, *,
    mesh=None, seq_split: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, d); cache_k/v: (B, L, Hkv, hd); pos:
    the new token's index.

    The new k and v are written into the caches IN PLACE (the reference
    returns updated copies; a copy of the cache per token and layer is
    what the in-place write saves), and the caches are returned. With a
    sliding window the cache is a ring buffer of length min(window, L)
    and writes wrap (``slot = pos % cache_len``).

    With a ``mesh`` the caches are this rank's blocks as
    ``lm_family._cache_specs`` lays them out: its key/value heads (when
    they divide over ``"model"``; queries then run on this rank's heads
    too) or, with ``seq_split``, its slice of the positions (every head
    runs, and the softmax is combined over ``"model"``)."""
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    heads_local = cache_k.shape[2] != hkv
    cache_len = cache_k.shape[1]
    full_len = cache_len * (tp_size(mesh) if seq_split else 1)
    start = _seq_slice(mesh, cache_len, seq_split)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = qkv_projections(p, cfg, x, positions, mesh, gather_q=not heads_local,
                              gather_kv=not heads_local)

    slot = pos % full_len  # ring-buffer write (no-op when cache covers seq)
    if start <= slot < start + cache_len:
        cache_k[:, slot - start] = k[:, 0]
        cache_v[:, slot - start] = v[:, 0]

    # Query head h reads KV head h // group: (B, Hkv, group, hd) queries
    # against (B, L, Hkv, hd) keys, with no repeated cache.
    hkv_l = k.shape[2]
    group = q.shape[2] // hkv_l
    qg = q.reshape(b, hkv_l, group, hd).float()
    scores = torch.einsum("bkgd,blkd->bkgl", qg, cache_k.float()) / (hd ** 0.5)
    # Valid cache slots: slot l holds some position <= pos, and with
    # window w only the last min(pos + 1, w) slots are live.
    idx = torch.arange(start, start + cache_len, device=x.device)
    if cfg.sliding_window is not None and full_len <= cfg.sliding_window:
        live = idx < min(pos + 1, full_len)
    else:
        live = idx <= pos
        if cfg.sliding_window is not None:
            live &= idx > pos - cfg.sliding_window
    ctx = decode_attend(scores, cache_v.float(), live, mesh, seq_split,
                        "bkgl,blkd->bkgd")
    out = row(ctx.to(x.dtype).reshape(b, 1, -1), p.wo.weight, mesh, hq * hd)
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
             positions: torch.Tensor, mesh=None, *, gather: bool = True):
    """``(q_nope (B, S, H, dn), q_rope (B, S, H, dr) rotated, c_kv (B, S,
    kv_lora) normed, k_rope (B, S, dr) rotated)``; with a mesh and not
    ``gather``, this rank's heads of the queries where ``wq_b`` (or
    ``wq``) is sliced."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    hq = h * (dn + dr)
    if cfg.q_lora_rank:
        qa = column(x, p.wq_a.weight, mesh, cfg.q_lora_rank, gather=True)
        q = column(rms_norm(qa, p.q_norm), p.wq_b.weight, mesh, hq, gather=gather)
    else:
        q = column(x, p.wq.weight, mesh, hq, gather=gather)
    q = q.reshape(b, s, -1, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_freqs(dr, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)

    kv = column(x, p.wkv_a.weight, mesh, cfg.kv_lora_rank + dr,
                gather=True)  # (b, s, kv_lora + dr)
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
    the one copy on this path. With a ``mesh``, on this rank's heads
    where ``"model"`` divides them."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    tp = tp_size(mesh)
    gather = not (tp > 1 and h % tp == 0)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions, mesh,
                                            gather=gather)
    kv = column(c_kv, p.wkv_b.weight, mesh, h * (dn + dv), gather=gather)
    kv = kv.reshape(b, s, -1, dn + dv)
    h_l = kv.shape[2]
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k_rope = _replicated(k_rope, h_l != h, mesh)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h_l, dr)], dim=-1)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True)
    return row(out.transpose(1, 2).reshape(b, s, h_l * dv), p.wo.weight, mesh,
               h * dv)


def mla_decode(
    p: MLAttention, cfg: TransformerConfig, x: torch.Tensor,
    cache_ckv: torch.Tensor, cache_krope: torch.Tensor, pos: int, *,
    mesh=None, seq_split: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-matmul MLA decode over the compressed cache. x: (B, 1, d);
    cache_ckv: (B, L, kv_lora); cache_krope: (B, L, dr); pos: the new
    token's index.

    Scores are taken against the latent directly (q absorbed through
    W_uk) and the context is read in latent space and expanded through
    W_uv afterwards, in float32 (the bf16 weights widened, as JAX widens
    them against float32 operands). As ``gqa_decode``, the new entries
    are written into the caches IN PLACE, and the caches returned.

    With a ``mesh``, the queries and W_uk/W_uv are this rank's heads
    where ``"model"`` divides them, and with ``seq_split`` the caches
    are this rank's slice of the positions: the absorbed queries of
    every head are gathered, the softmax is combined over ``"model"``,
    and each rank expands its own heads' context."""
    b = x.shape[0]
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    cache_len = cache_ckv.shape[1]
    start = _seq_slice(mesh, cache_len, seq_split)
    h_l = p.wkv_b.weight.shape[0] // (dn + dv)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, cfg, x, positions, mesh,
                                                    gather=h_l == h)
    if start <= pos < start + cache_len:
        cache_ckv[:, pos - start] = c_kv_new[:, 0]
        cache_krope[:, pos - start] = k_rope_new[:, 0]

    # wkv_b.weight is (H * (dn + dv), kv_lora): the reference's (kv_lora,
    # H, dn + dv) matrix transposed (this rank's heads of it).
    wkv_b = p.wkv_b.weight.t().reshape(kr, h_l, dn + dv).float()
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    ckv = cache_ckv.float()
    q_eff = torch.einsum("bqhd,khd->bqhk", q_nope.float(), w_uk)
    q_rope = q_rope.float()
    if seq_split and h_l != h:
        q_eff = all_gather(q_eff, mesh, MODEL, 2)
        q_rope = all_gather(q_rope, mesh, MODEL, 2)
    s_nope = torch.einsum("bqhk,blk->bhql", q_eff, ckv)
    s_rope = torch.einsum("bqhd,bld->bhql", q_rope, cache_krope.float())
    scores = (s_nope + s_rope) / ((dn + dr) ** 0.5)
    live = torch.arange(start, start + cache_len, device=x.device) <= pos
    ctx_lat = decode_attend(scores, ckv, live, mesh, seq_split, "bhql,blk->bqhk")
    if ctx_lat.shape[2] != h_l:  # every head's context: keep this rank's
        h0 = _first_head(mesh, h_l, h)
        ctx_lat = ctx_lat[:, :, h0:h0 + h_l]
    ctx = torch.einsum("bqhk,khd->bqhd", ctx_lat, w_uv)
    out = row(ctx.to(x.dtype).reshape(b, 1, h_l * dv), p.wo.weight, mesh, h * dv)
    return out, cache_ckv, cache_krope
