"""Decoder LM of the port: init, prefill forward and KV-cache serving for
the dense GQA/MQA/MHA configs. The port's copy of the dense path of
``repro.models.transformer.model``.

The parameters are one ``TransformerLM`` module (its layers an
``nn.ModuleList`` where the reference stacks them along axis 0 for
``lax.scan``); the functions take it as ``params`` in the reference's
argument order. The model serves and does not train yet (``loss_fn``
and the optimizer wait for ROADMAP queue 1, item 16), so ``init_params``
returns parameters that do not require grad. Every entry point runs
where the parameters live: ``init_params`` allocates on the card unless
the caller passes ``device="cpu"``, and tokens go to the parameters'
device. MoE layers, MLA attention and the MTP head raise
``NotImplementedError`` (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import activation_fn, rms_norm
from repro_torch.models.transformer.attention import (
    GQAttention,
    gqa_attention,
    gqa_decode,
    init_gqa_params,
    no_mesh,
    normal_,
)
from repro_torch.models.transformer.config import TransformerConfig


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for the parts of the reference's LM the port lacks."""
    missing = []
    if cfg.moe is not None:
        missing.append("MoE layers")
    if cfg.attention != "gqa":
        missing.append(f"{cfg.attention!r} attention")
    if cfg.mtp_depth:
        missing.append("the multi-token-prediction head")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch "
            "yet (ROADMAP queue 1, item 15)"
        )


def torch_dtype(cfg: TransformerConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


class DenseFFN(nn.Module):
    """SwiGLU/GeGLU feed-forward: ``w_down(act(w_gate x) * w_up x)``."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.w_gate = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.w_up = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.w_down = nn.Linear(cfg.d_ff, cfg.d_model, **kw)


class DenseLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, device=device, dtype=dtype))
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, device=device, dtype=dtype))
        self.attn = GQAttention(cfg, device=device, dtype=dtype)
        self.ffn = DenseFFN(cfg, device=device, dtype=dtype)


class TransformerLM(nn.Module):
    """The parameters of one dense decoder LM. ``embed`` is (V, d);
    ``unembed`` (absent with tied embeddings) is an ``nn.Linear`` whose
    weight is the reference's ``(d, V)`` array transposed."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        check_supported(cfg)
        d = cfg.d_model
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, d, device=device, dtype=dtype))
        self.final_norm = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))
        self.unembed = (
            None if cfg.tie_embeddings
            else nn.Linear(d, cfg.vocab_size, bias=False, device=device,
                           dtype=dtype)
        )
        self.dense_layers = nn.ModuleList(
            DenseLayer(cfg, device=device, dtype=dtype)
            for _ in range(cfg.num_layers)
        )


def empty_params(cfg: TransformerConfig, device) -> TransformerLM:
    """A ``TransformerLM`` with uninitialised storage on ``device``
    (built on the meta device first, so nothing is drawn twice)."""
    with torch.device("meta"):
        model = TransformerLM(cfg, dtype=torch_dtype(cfg))
    return model.to_empty(device=device).requires_grad_(False)


def init_params(
    cfg: TransformerConfig,
    *,
    device=None,
    generator: torch.Generator | None = None,
) -> TransformerLM:
    """Random parameters with the reference's shapes and scales: normal
    draws (float32, cast to ``cfg.dtype``) scaled by 0.02 for the
    embedding, ``d ** -0.5`` for the unembedding and the q/k/v, gate and
    up projections, ``(Hq * hd) ** -0.5`` and ``d_ff ** -0.5`` for the
    output projections; every norm gamma zero. Drawn from ``generator``
    (which must live on ``device``), else from one seeded with 0. On
    ``device="meta"`` only the shapes are made."""
    dev = resolve_device(device)
    model = empty_params(cfg, dev)
    for p in model.parameters():
        if p.dim() == 1 and not p.is_meta:
            p.zero_()
    if dev.type == "meta":
        return model
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    d, f = cfg.d_model, cfg.d_ff
    normal_(model.embed, 0.02, gen)
    if model.unembed is not None:
        normal_(model.unembed.weight, d ** -0.5, gen)
    for layer in model.dense_layers:
        init_gqa_params(layer.attn, cfg, gen)
        normal_(layer.ffn.w_gate.weight, d ** -0.5, gen)
        normal_(layer.ffn.w_up.weight, d ** -0.5, gen)
        normal_(layer.ffn.w_down.weight, f ** -0.5, gen)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def as_tokens(params: TransformerLM, tokens) -> torch.Tensor:
    """``tokens`` as an int64 tensor on the parameters' device."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens, dtype=np.int64))
    return tokens.to(device=params.embed.device, dtype=torch.int64)


def embed_lookup(params: TransformerLM, cfg: TransformerConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = F.embedding(tokens, params.embed)
    if cfg.embed_scale:
        # The scale rounded to the activation dtype, as the reference's
        # jnp.asarray(sqrt(d), x.dtype).
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _dense_ffn(p: DenseFFN, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    h = act(F.linear(x, p.w_gate.weight)) * F.linear(x, p.w_up.weight)
    return F.linear(h.to(x.dtype), p.w_down.weight)


def _logits(params: TransformerLM, cfg: TransformerConfig,
            x: torch.Tensor) -> torch.Tensor:
    """Final norm and unembedding; float32 logits. As the reference's
    ``preferred_element_type=float32``, a bf16 product is summed and
    written in float32, never rounded to bf16: on the card one GEMM with
    float32 output, on the CPU (which has no such GEMM) the same product
    of the operands widened to float32, whose products are exact."""
    x = rms_norm(x, params.final_norm)
    w = params.embed if cfg.tie_embeddings else params.unembed.weight
    if x.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def forward(params: TransformerLM, cfg: TransformerConfig, tokens, *,
            mesh=None) -> torch.Tensor:
    """tokens: (B, S) ints -> logits (B, S, V) float32. Each layer's
    attention is one ``flash_attention`` launch on the card."""
    no_mesh(mesh)
    tokens = as_tokens(params, tokens)
    b, s = tokens.shape
    x = embed_lookup(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    positions = positions[None].expand(b, s)
    for layer in params.dense_layers:
        h = x + gqa_attention(layer.attn, cfg, rms_norm(x, layer.ln1), positions)
        x = h + _dense_ffn(layer.ffn, cfg, rms_norm(h, layer.ln2))
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def cache_length(cfg: TransformerConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
                  device=None) -> dict:
    """Zeroed stacked caches, ``{"dense": {"k", "v"}}`` each
    ``(L, B, C, Hkv, hd)`` with ``C = cache_length(cfg, max_len)``, on
    ``device`` (default: the card)."""
    check_supported(cfg)
    shape = (cfg.num_layers, batch, cache_length(cfg, max_len),
             cfg.num_kv_heads, cfg.head_dim)
    kw = dict(dtype=torch_dtype(cfg), device=resolve_device(device))
    return {"dense": {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}}


def serve_step(params: TransformerLM, cfg: TransformerConfig, cache: dict,
               tokens, pos, *, mesh=None):
    """One decode step: tokens (B, 1) at index ``pos``; returns (logits
    (B, 1, V) float32, cache). The cache is updated in place (see
    ``gqa_decode``) and returned."""
    no_mesh(mesh)
    pos = int(pos)
    x = embed_lookup(params, cfg, as_tokens(params, tokens))
    ck, cv = cache["dense"]["k"], cache["dense"]["v"]
    for i, layer in enumerate(params.dense_layers):
        attn_out, _, _ = gqa_decode(
            layer.attn, cfg, rms_norm(x, layer.ln1), ck[i], cv[i], pos)
        h = x + attn_out
        x = h + _dense_ffn(layer.ffn, cfg, rms_norm(h, layer.ln2))
    return _logits(params, cfg, x), cache


def prefill(params: TransformerLM, cfg: TransformerConfig, tokens,
            max_len: int, *, mesh=None):
    """Sequential prefill through ``serve_step``, one token at a time
    (the reference's simple serving path; it shares no attention code
    with ``forward``). Returns (last logits (B, 1, V), cache)."""
    tokens = as_tokens(params, tokens)
    b, s = tokens.shape
    cache = init_kv_cache(cfg, b, max_len, device=tokens.device)
    logits = None
    for i in range(s):
        logits, cache = serve_step(params, cfg, cache, tokens[:, i:i + 1], i,
                                   mesh=mesh)
    return logits, cache
