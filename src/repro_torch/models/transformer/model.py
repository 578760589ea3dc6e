"""Decoder LM of the port: init, prefill forward, the MTP head and
KV-cache serving, for every LM config of the reference (dense GQA/MQA/
MHA, MoE, MLA). The port's copy of ``repro.models.transformer.model``.

The parameters are one ``TransformerLM`` module (its layers in
``nn.ModuleList``s where the reference stacks them along axis 0 for
``lax.scan``): the leading dense layers (every layer of a dense model,
``num_dense_layers`` of an MoE one), then the MoE layers, then
DeepSeek-V3's ``mtp_layer`` and ``mtp_norm``. The functions take it as
``params`` in the reference's argument order. ``init_params`` returns
parameters that do not require grad (the serving path); the training
step (``repro_torch.train``) makes them require grad, and ``loss_fn``
is the reference's, MTP loss included, with each layer recomputed in
the backward when ``cfg.remat`` (``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint``). Every entry point runs where the
parameters live:
``init_params`` allocates on the card unless the caller passes
``device="cpu"``, and tokens go to the parameters' device.

With a ``mesh`` (``repro_torch.launch.mesh``) every entry point runs
this rank's share of the reference's sharded computation: ``params``
holds this rank's blocks (``configs/lm_family.py::lm_param_specs`` and
``distributed/sharding.py::shard_tree``), the inputs are the whole batch
on every rank, and each rank takes its block of the batch over the
``LM_RULES``' batch axes (``batch_axes``). Attention and the dense FFN are
tensor-parallel over ``"model"`` (``attention.py``), the embedding is
vocab-sharded through ``ops/sharded_lookup.py``, the unembedding's
logits are gathered over ``"model"`` before the cross-entropy, and the
MoE layers run ``moe.py``'s schedules. Outputs are this rank's block
of the batch; ``loss_fn``'s loss is the whole batch's, summed over the
batch axes before the division, on every rank, and each rank's
gradients are its share until ``sharding.reduce_gradients`` sums them
over the batch axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import (
    all_reduce,
    chunk,
    copy_to,
    gather_from,
    reduce_from,
)
from repro_torch.distributed.sharding import LM_RULES
from repro_torch.ops.sharded_lookup import sharded_row_gather
from repro_torch.models.common import (
    activation_fn,
    cross_entropy_sum,
    rms_norm,
    softmax_cross_entropy,
)
from repro_torch.models.transformer.attention import (
    GQAttention,
    MLAttention,
    gqa_attention,
    gqa_decode,
    init_gqa_params,
    init_mla_params,
    MODEL,
    column,
    mla_attention,
    mla_decode,
    normal_,
    row,
)
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.moe import MoE, init_moe_params, moe_ffn


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


class DecoderLayer(nn.Module):
    """One decoder layer: pre-norm attention (GQA or MLA, by
    ``cfg.attention``) and a feed-forward block, dense (``ffn``) or MoE
    (``moe``); the other of the two is None."""

    def __init__(self, cfg: TransformerConfig, *, use_moe: bool = False,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        attn = MLAttention if cfg.attention == "mla" else GQAttention
        self.attn = attn(cfg, **kw)
        self.ffn = None if use_moe else DenseFFN(cfg, **kw)
        self.moe = MoE(cfg, **kw) if use_moe else None


class TransformerLM(nn.Module):
    """The parameters of one decoder LM. ``embed`` is (V, d); ``unembed``
    (absent with tied embeddings) is an ``nn.Linear`` whose weight is
    the reference's ``(d, V)`` array transposed. ``moe_layers`` is empty
    for a dense model; ``mtp_layer`` and ``mtp_norm`` are None without
    ``mtp_depth``."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d, **kw))
        self.final_norm = nn.Parameter(torch.zeros(d, **kw))
        self.unembed = (
            None if cfg.tie_embeddings
            else nn.Linear(d, cfg.vocab_size, bias=False, **kw)
        )
        self.dense_layers = nn.ModuleList(
            DecoderLayer(cfg, **kw) for _ in range(cfg.num_dense_layers_effective()))
        self.moe_layers = nn.ModuleList(
            DecoderLayer(cfg, use_moe=True, **kw) for _ in range(cfg.num_moe_layers()))
        if cfg.mtp_depth:
            self.mtp_layer = DecoderLayer(cfg, **kw)
            self.mtp_norm = nn.Parameter(torch.zeros(d, **kw))
        else:
            self.mtp_layer = self.mtp_norm = None

    def layers(self):
        """Every trunk layer in order, each as ``(group, index, layer)``
        with ``group`` the KV cache's key ("dense" or "moe")."""
        for group, stack in (("dense", self.dense_layers), ("moe", self.moe_layers)):
            for i, layer in enumerate(stack):
                yield group, i, layer


def empty_params(cfg: TransformerConfig, device) -> TransformerLM:
    """A ``TransformerLM`` with uninitialised storage on ``device``
    (built on the meta device first, so nothing is drawn twice)."""
    with torch.device("meta"):
        model = TransformerLM(cfg, dtype=torch_dtype(cfg))
    return model.to_empty(device=device).requires_grad_(False)


def _init_layer(layer: DecoderLayer, cfg: TransformerConfig, gen) -> None:
    if cfg.attention == "mla":
        init_mla_params(layer.attn, cfg, gen)
    else:
        init_gqa_params(layer.attn, cfg, gen)
    if layer.moe is not None:
        init_moe_params(layer.moe, cfg, gen)
    else:
        d, f = cfg.d_model, cfg.d_ff
        normal_(layer.ffn.w_gate.weight, d ** -0.5, gen)
        normal_(layer.ffn.w_up.weight, d ** -0.5, gen)
        normal_(layer.ffn.w_down.weight, f ** -0.5, gen)


def init_params(
    cfg: TransformerConfig,
    *,
    device=None,
    generator: torch.Generator | None = None,
) -> TransformerLM:
    """Random parameters with the reference's shapes and scales: normal
    draws (float32, cast to ``cfg.dtype``; the MoE router stays float32)
    scaled by 0.02 for the embedding and by the inverse square root of
    each matrix's input width elsewhere (``d ** -0.5`` for the
    unembedding and every projection out of the model width, ``(Hq * hd)
    ** -0.5``, ``d_ff ** -0.5`` and so on for the others); every norm
    gamma zero. Drawn from ``generator`` (which must live on
    ``device``), else from one seeded with 0. On ``device="meta"`` only
    the shapes are made."""
    dev = resolve_device(device)
    model = empty_params(cfg, dev)
    for p in model.parameters():
        if p.dim() == 1 and not p.is_meta:
            p.zero_()
    if dev.type == "meta":
        return model
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    normal_(model.embed, 0.02, gen)
    if model.unembed is not None:
        normal_(model.unembed.weight, cfg.d_model ** -0.5, gen)
    for _, _, layer in model.layers():
        _init_layer(layer, cfg, gen)
    if model.mtp_layer is not None:
        _init_layer(model.mtp_layer, cfg, gen)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def as_tokens(params: TransformerLM, tokens) -> torch.Tensor:
    """``tokens`` as an int64 tensor on the parameters' device."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens, dtype=np.int64))
    return tokens.to(device=params.embed.device, dtype=torch.int64)


def batch_axes(mesh, batch: int) -> tuple:
    """The mesh axes the batch splits over: ``LM_RULES``' batch axes that
    the mesh has, the last dropped while they do not divide ``batch``
    (the reference's fallback for tiny or odd batches)."""
    if mesh is None or mesh.empty:
        return ()
    ax = LM_RULES.for_mesh(mesh).batch
    ax = () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)
    while ax and batch % mesh.axis_size(ax):
        ax = ax[:-1]
    return ax


def batch_block(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """This rank's block of dim 0 over ``axes`` (all of ``x`` without)."""
    return chunk(x, mesh, axes, 0) if axes else x


def _rank_batch(tokens: torch.Tensor, mesh, axes):
    """(the batch axes, this rank's rows of ``tokens``). ``axes`` None:
    ``tokens`` is the whole batch, split over ``batch_axes``; else
    ``tokens`` is this rank's block over ``axes`` already (as a dry run
    lays its arguments out)."""
    if axes is not None:
        return mesh.axes(axes), tokens
    dp = batch_axes(mesh, tokens.shape[0])
    return dp, batch_block(tokens, mesh, dp)


def embed_lookup(params: TransformerLM, cfg: TransformerConfig,
                 tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    if params.embed.shape[0] != cfg.vocab_size:  # this rank's rows
        x = sharded_row_gather(params.embed, tokens, mesh, MODEL)
    else:
        x = F.embedding(tokens, params.embed)
    if cfg.embed_scale:
        # The scale rounded to the activation dtype, as the reference's
        # jnp.asarray(sqrt(d), x.dtype).
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _dense_ffn(p: DenseFFN, cfg: TransformerConfig, x: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """With a mesh, ``d_ff`` sliced over ``"model"`` and the down
    projection summed over it."""
    act = activation_fn(cfg.activation)
    f = cfg.d_ff
    h = act(column(x, p.w_gate.weight, mesh, f, gather=False)) * column(
        x, p.w_up.weight, mesh, f, gather=False)
    return row(h.to(x.dtype), p.w_down.weight, mesh, f)


class _UnembedF32(torch.autograd.Function):
    """``x (N, d) @ w (V, d)^T`` of bf16 operands summed and written in
    float32 (one GEMM on the card). Its backward rounds the float32
    cotangent to the operands' dtype once and takes ``dx = g w`` and
    ``dw = g^T x`` in it, the usual mixed-precision VJP."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return torch.mm(g, w), torch.mm(g.t(), x)


def _unembed(params: TransformerLM, cfg: TransformerConfig,
             x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The unembedding; float32 logits. As the reference's
    ``preferred_element_type=float32``, a bf16 product is summed and
    written in float32, never rounded to bf16: on the card one GEMM with
    float32 output (``_UnembedF32``, which carries the gradient), on the
    CPU (which has no such GEMM) the same product of the operands
    widened to float32, whose products are exact. With a mesh and a
    vocab-sliced weight, this rank's columns of the logits, gathered
    over ``"model"``."""
    w = params.embed if cfg.tie_embeddings else params.unembed.weight
    if w.shape[0] != cfg.vocab_size:
        logits = _unembed_rows(copy_to(x, mesh, MODEL), w)
        return gather_from(logits, mesh, MODEL, -1)
    return _unembed_rows(x, w)


def _unembed_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        out = _UnembedF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def _logits(params: TransformerLM, cfg: TransformerConfig,
            x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Final norm and unembedding; float32 logits."""
    return _unembed(params, cfg, rms_norm(x, params.final_norm), mesh)


def _attn(p, cfg: TransformerConfig, x, positions, mesh=None):
    if cfg.attention == "mla":
        return mla_attention(p, cfg, x, positions, mesh=mesh)
    return gqa_attention(p, cfg, x, positions, mesh=mesh)


def _layer_fwd(layer: DecoderLayer, cfg: TransformerConfig, x, positions,
               mesh=None, dp=()):
    h = x + _attn(layer.attn, cfg, rms_norm(x, layer.ln1), positions, mesh)
    hn = rms_norm(h, layer.ln2)
    if layer.moe is not None:
        return h + moe_ffn(layer.moe, cfg, hn, activation_fn(cfg.activation),
                           mesh=mesh, dp_axes=dp)
    return h + _dense_ffn(layer.ffn, cfg, hn, mesh)


def _positions(b: int, s: int, device) -> torch.Tensor:
    positions = torch.arange(s, dtype=torch.int32, device=device)
    return positions[None].expand(b, s)


def _trunk(params: TransformerLM, cfg: TransformerConfig, tokens, mesh, dp):
    """Embedding and every layer on this rank's tokens."""
    b, s = tokens.shape
    x = embed_lookup(params, cfg, tokens, mesh)
    positions = _positions(b, s, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for _, _, layer in params.layers():
        if remat:
            x = checkpoint(_layer_fwd, layer, cfg, x, positions, mesh, dp,
                           use_reentrant=False)
        else:
            x = _layer_fwd(layer, cfg, x, positions, mesh, dp)
    return x


def hidden_states(params: TransformerLM, cfg: TransformerConfig, tokens, *,
                  mesh=None, batch_axes=None) -> torch.Tensor:
    """The trunk: tokens (B, S) -> the last layer's output (B, S, d),
    before the final norm (what the MTP head reads); with a mesh, this
    rank's block of the batch. ``batch_axes`` given: ``tokens`` is this
    rank's block over those axes already. With grad mode on and
    ``cfg.remat``, each layer keeps only its input and is recomputed in
    the backward."""
    tokens = as_tokens(params, tokens)
    dp = ()
    if mesh is not None:
        dp, tokens = _rank_batch(tokens, mesh, batch_axes)
    return _trunk(params, cfg, tokens, mesh, dp)


def forward(params: TransformerLM, cfg: TransformerConfig, tokens, *,
            mesh=None, batch_axes=None) -> torch.Tensor:
    """tokens: (B, S) ints -> logits (B, S, V) float32 (with a mesh, this
    rank's block of the batch, every vocab column; ``batch_axes`` as in
    ``hidden_states``). Each layer's attention is one ``flash_attention``
    launch on the card, and each MoE layer's combine one ``segment_sum``
    launch."""
    x = hidden_states(params, cfg, tokens, mesh=mesh, batch_axes=batch_axes)
    return _logits(params, cfg, x, mesh)


def _mtp_logits(params: TransformerLM, cfg: TransformerConfig,
                x_final: torch.Tensor, tokens, *, mesh=None) -> torch.Tensor:
    """DeepSeek-V3's multi-token-prediction head (depth 1, simplified as
    the reference: the MTP block reads the trunk's hidden states
    ``x_final`` (``hidden_states``) normed by ``mtp_norm`` plus the
    embedding of ``tokens``, and its dense layer's output is unembedded
    without the final norm). Returns float32 logits (B, S, V), which
    ``loss_fn``'s MTP term reads. With a mesh, ``x_final`` and the
    result are this rank's block of the batch, ``tokens`` the whole."""
    tokens = as_tokens(params, tokens)
    dp = batch_axes(mesh, tokens.shape[0])
    return _mtp_block(params, cfg, x_final, batch_block(tokens, mesh, dp), mesh)


def _mtp_block(params, cfg, x_final, tokens, mesh):
    b, s = tokens.shape
    emb_next = embed_lookup(params, cfg, tokens, mesh)
    h = rms_norm(x_final, params.mtp_norm) + emb_next
    h = _layer_fwd(params.mtp_layer, cfg, h, _positions(b, s, h.device), mesh)
    return _unembed(params, cfg, h, mesh)


def loss_fn(params: TransformerLM, cfg: TransformerConfig, batch: dict, *,
            mesh=None, rules=None, mtp_weight: float = 0.1,
            batch_axes=None) -> torch.Tensor:
    """batch: ``tokens`` (B, S), ``labels`` (B, S) with -1 = ignore. The
    mean next-token cross-entropy, plus ``mtp_weight`` times the MTP
    head's (labels shifted left by one, padded with -1) for a config with
    ``mtp_depth``. ``rules`` (the reference's sharding rules) may only be
    ``LM_RULES``, the layout ``lm_param_specs`` gives the weights; any
    other raises. With a mesh each mean is the whole batch's: the summed
    losses and the counts are summed over the batch axes, then divided
    (the reference's mean over ``labels != -1``), and the sum passes the
    gradient through, so each rank's gradient is its share.
    ``batch_axes`` given: the arrays hold this rank's block of the batch
    over those axes already (see ``hidden_states``)."""
    if rules is not None and rules != LM_RULES:
        raise ValueError(f"loss_fn lays the LM out by LM_RULES; got {rules}")
    tokens = as_tokens(params, batch["tokens"])
    labels = as_tokens(params, batch["labels"])
    pad = labels.new_full((labels.shape[0], 1), -1)
    mtp_labels = torch.cat([labels[:, 1:], pad], dim=1)
    dp = ()
    if mesh is not None:
        dp, tokens = _rank_batch(tokens, mesh, batch_axes)
        if batch_axes is None:
            labels, mtp_labels = (batch_block(t, mesh, dp) for t in (labels, mtp_labels))
    x = _trunk(params, cfg, tokens, mesh, dp)

    def mean(logits, lab):
        if not dp:
            return softmax_cross_entropy(logits, lab)
        total, count = cross_entropy_sum(logits, lab)
        total = reduce_from(total, mesh, dp)
        return total / torch.clamp(all_reduce(count, mesh, dp), min=1.0)

    loss = mean(_logits(params, cfg, x, mesh), labels)
    if cfg.mtp_depth and params.mtp_layer is not None:
        mtp_logits = _mtp_block(params, cfg, x, tokens, mesh)
        loss = loss + mtp_weight * mean(mtp_logits, mtp_labels)
    return loss


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def cache_length(cfg: TransformerConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


class KVCache(dict):
    """The stacked caches on a mesh: ``{"dense": ..., "moe": ...}`` as
    ``init_kv_cache`` makes them, holding this rank's blocks, with the
    specs they were laid out by (``lm_family._cache_specs``), the batch
    axes, and for each group whether its positions are split over
    ``"model"``."""

    def __init__(self, groups: dict, specs: dict, batch_axes: tuple, mesh):
        super().__init__(groups)
        self.specs = specs
        self.batch_axes = batch_axes
        tp = mesh.shape.get(MODEL, 1)
        self.seq_split = {g: tp > 1 and next(iter(sp.values()))[2] == MODEL
                          for g, sp in specs.items()}


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
                  device=None, mesh=None) -> dict:
    """Zeroed stacked caches, one entry per layer group (``"dense"``,
    ``"moe"``) with ``L`` the group's layers and ``C = cache_length(cfg,
    max_len)``: for GQA ``{"k", "v"}`` each ``(L, B, C, Hkv, hd)``, for
    MLA the compressed latent ``"ckv"`` ``(L, B, C, kv_lora)`` and the
    rope keys ``"krope"`` ``(L, B, C, dr)``; on ``device`` (default: the
    card). With a ``mesh``, a ``KVCache`` of this rank's blocks under
    ``lm_family._cache_specs`` (batch over the data axes when they
    divide it, then key/value heads over ``"model"`` when it divides
    them, else the positions), on the mesh's device."""
    clen = cache_length(cfg, max_len)

    def shapes(n):
        if cfg.attention == "mla":
            return {"ckv": (n, batch, clen, cfg.kv_lora_rank),
                    "krope": (n, batch, clen, cfg.qk_rope_head_dim)}
        shape = (n, batch, clen, cfg.num_kv_heads, cfg.head_dim)
        return {"k": shape, "v": shape}

    full = {group: shapes(n) for group, n in (
        ("dense", cfg.num_dense_layers_effective()), ("moe", cfg.num_moe_layers()))
        if n}
    if mesh is None:
        kw = dict(dtype=torch_dtype(cfg), device=resolve_device(device))
        return {g: {k: torch.zeros(sh, **kw) for k, sh in c.items()}
                for g, c in full.items()}
    from repro_torch.configs.lm_family import _cache_specs

    specs = _cache_specs(cfg, {g: {k: torch.empty(sh, device="meta")
                                   for k, sh in c.items()} for g, c in full.items()},
                         mesh, batch)
    kw = dict(dtype=torch_dtype(cfg), device=mesh.device)
    groups = {g: {k: torch.zeros(_block_shape(sh, specs[g][k], mesh), **kw)
                  for k, sh in c.items()} for g, c in full.items()}
    spec = next(iter(next(iter(specs.values())).values()))
    dp = spec[1] or ()
    return KVCache(groups, specs, (dp,) if isinstance(dp, str) else tuple(dp), mesh)


def _block_shape(shape, spec, mesh) -> tuple:
    return tuple(n // (mesh.axis_size(d) if d is not None else 1)
                 for n, d in zip(shape, spec))


def serve_step(params: TransformerLM, cfg: TransformerConfig, cache: dict,
               tokens, pos, *, mesh=None, batch_axes=None):
    """One decode step: tokens (B, 1) at index ``pos``; returns (logits
    (B, 1, V) float32, cache). The cache is updated in place (see
    ``gqa_decode`` and ``mla_decode``) and returned. With a ``mesh`` the
    cache is ``init_kv_cache(..., mesh=mesh)``'s, ``tokens`` the whole
    batch, and the logits this rank's block of it (the cache's layout
    fixes the batch axes; ``batch_axes`` given, which must be the
    cache's: ``tokens`` is this rank's block over them already)."""
    pos = int(pos)
    tokens = as_tokens(params, tokens)
    dp, seq_split = (), {}
    if mesh is not None:
        if not isinstance(cache, KVCache):
            raise ValueError("with a mesh, serve_step needs the KVCache of "
                             "init_kv_cache(..., mesh=mesh)")
        dp, seq_split = cache.batch_axes, cache.seq_split
    if batch_axes is None:
        tokens = batch_block(tokens, mesh, dp)
    elif tuple(batch_axes) != tuple(dp):
        raise ValueError(f"serve_step: tokens split over {tuple(batch_axes)}, "
                         f"the cache over {tuple(dp)}")
    x = embed_lookup(params, cfg, tokens, mesh)
    act = activation_fn(cfg.activation)
    for group, i, layer in params.layers():
        c = cache[group]
        split = seq_split.get(group, False)
        hn = rms_norm(x, layer.ln1)
        if cfg.attention == "mla":
            attn_out, _, _ = mla_decode(layer.attn, cfg, hn, c["ckv"][i],
                                        c["krope"][i], pos, mesh=mesh,
                                        seq_split=split)
        else:
            attn_out, _, _ = gqa_decode(layer.attn, cfg, hn, c["k"][i], c["v"][i],
                                        pos, mesh=mesh, seq_split=split)
        h = x + attn_out
        hn2 = rms_norm(h, layer.ln2)
        if layer.moe is not None:
            x = h + moe_ffn(layer.moe, cfg, hn2, act, mesh=mesh, dp_axes=dp)
        else:
            x = h + _dense_ffn(layer.ffn, cfg, hn2, mesh)
    return _logits(params, cfg, x, mesh), cache


def prefill(params: TransformerLM, cfg: TransformerConfig, tokens,
            max_len: int, *, mesh=None):
    """Sequential prefill through ``serve_step``, one token at a time
    (the reference's simple serving path; it shares no attention code
    with ``forward``). Returns (last logits (B, 1, V), cache); with a
    mesh, this rank's block of the logits and its ``KVCache``."""
    tokens = as_tokens(params, tokens)
    b, s = tokens.shape
    cache = init_kv_cache(cfg, b, max_len, device=tokens.device, mesh=mesh)
    logits = None
    for i in range(s):
        logits, cache = serve_step(params, cfg, cache, tokens[:, i:i + 1], i,
                                   mesh=mesh)
    return logits, cache
