"""Analytic per-step FLOP / HBM-byte models for the roofline: the port's
copy of ``repro/launch/perfmodel.py``, formula for formula and in the
same order of operations, so a config gives the same Python float as
the reference's.

The terms depend on the config, the shape and the rank count, not on
the device: ``launch/roofline.py`` divides them by the H100's rates.
Collective bytes are counted where the port's collectives send them
(``roofline.py``).

Conventions: matmul (m,k)x(k,n) = 2mkn flops; backward = 2x forward;
optimizer update ~ 12 flops/param (ignored: <0.1% of any cell here).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class StepCost:
    flops_total: float  # whole-step, all chips
    hbm_bytes_per_device: float


def _dtype_bytes(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[dtype]


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def lm_attention_flops(cfg, batch: int, seq: int, *, causal_avg: bool = True) -> float:
    """Score+context matmul flops for one forward pass (whole batch)."""
    if cfg.attention == "mla":
        qk_dim = cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        v_dim = cfg.num_heads * cfg.v_head_dim
    else:
        qk_dim = cfg.num_heads * cfg.head_dim
        v_dim = qk_dim
    kv_span = seq if cfg.sliding_window is None else min(seq, cfg.sliding_window)
    eff = kv_span / 2 if (causal_avg and cfg.sliding_window is None) else kv_span
    per_layer = 2 * batch * seq * eff * (qk_dim + v_dim)
    return per_layer * cfg.num_layers


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    """6*N_active*T + 3x attention quadratic term (fwd=1x, bwd=2x)."""
    return 6.0 * cfg.active_params() * batch * seq + 3.0 * lm_attention_flops(
        cfg, batch, seq
    )


def lm_prefill_flops(cfg, batch: int, seq: int) -> float:
    return 2.0 * cfg.active_params() * batch * seq + lm_attention_flops(
        cfg, batch, seq
    )


def lm_decode_flops(cfg, batch: int, cache_len: int) -> float:
    """One new token per sequence against a cache of cache_len."""
    if cfg.attention == "mla":
        # absorbed path: scores vs latent (kv_lora+rope), ctx in latent
        span = cache_len
        per_layer = 2 * batch * span * cfg.num_heads * (
            cfg.kv_lora_rank + cfg.qk_rope_head_dim + cfg.kv_lora_rank
        )
    else:
        span = (
            min(cache_len, cfg.sliding_window)
            if cfg.sliding_window
            else cache_len
        )
        per_layer = 4 * batch * span * cfg.num_heads * cfg.head_dim
    return 2.0 * cfg.active_params() * batch + per_layer * cfg.num_layers


def lm_train_bytes_per_device(
    cfg, batch: int, seq: int, chips: int, *, moment_dtype: str = "float32",
    microbatches: int = 1,
) -> float:
    """HBM traffic model: params are read fwd + read bwd (+re-read under
    remat) and written once; grads accumulate rw per microbatch; moments rw
    once; activations rw ~ 12*B*S*d per layer (stored residuals + remat
    recompute traffic). Parameter traffic repeats per microbatch (weights
    re-streamed from HBM each pass)."""
    p_dev = 2.0 * cfg.total_params() / chips  # bf16 params, sharded
    mdt = _dtype_bytes(moment_dtype)
    g_dev = 4.0 * cfg.total_params() / chips  # fp32 grad accumulator
    m_dev = mdt * cfg.total_params() / chips
    weight_traffic = microbatches * 3.0 * p_dev  # fwd + bwd + remat re-read
    grad_traffic = microbatches * 2.0 * g_dev
    opt_traffic = 2.0 * p_dev + 4.0 * m_dev
    act_bytes = 2  # bf16 activations
    tokens_dev = batch * seq / max(chips // 16, 1) / 16  # dp-sharded tokens
    # per layer: ~6 tensor rw of size (tokens, d) fwd + 2x bwd under remat
    act_traffic = 18.0 * tokens_dev * cfg.d_model * act_bytes * cfg.num_layers
    return weight_traffic + grad_traffic + opt_traffic + act_traffic


def lm_decode_bytes_per_device(cfg, batch: int, cache_len: int, chips: int) -> float:
    """Decode is weight+cache streaming: every active param read once, the
    live KV cache read once, new KV written."""
    p_dev = 2.0 * cfg.active_params() / chips
    if cfg.attention == "mla":
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        per_tok = 2 * cfg.num_kv_heads * cfg.head_dim
    span = (
        min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    )
    cache_dev = 2.0 * batch * span * per_tok * cfg.num_layers / chips
    return p_dev + cache_dev


def lm_prefill_bytes_per_device(cfg, batch: int, seq: int, chips: int) -> float:
    p_dev = 2.0 * cfg.total_params() / chips
    tokens_dev = batch * seq / chips * 16  # model-axis replicates activations
    act = 12.0 * tokens_dev * cfg.d_model * 2 * cfg.num_layers
    return p_dev + act


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def gnn_train_flops(arch_name: str, cfg, n: int, m: int, d_in: int) -> float:
    """Message passing: per-edge gather+reduce plus per-node MLPs; x3 for
    fwd+bwd."""
    if arch_name == "gin-tu":
        h = cfg.d_hidden
        per_layer = 2 * n * (d_in * h if d_in else h * h) + 2 * n * h * h + 2 * m * h
        fwd = sum(
            2 * n * ((d_in if i == 0 else h) * h + h * h) + 2 * m * (d_in if i == 0 else h)
            for i in range(cfg.num_layers)
        )
        return 3.0 * fwd
    if arch_name == "gat-cora":
        h, k = cfg.d_hidden, cfg.num_heads
        fwd = 2 * n * d_in * h * k + 6 * m * h * k  # proj + edge scores + agg
        fwd += 2 * n * h * k * cfg.num_classes + 4 * m * cfg.num_classes
        return 3.0 * fwd
    if arch_name == "egnn":
        h = cfg.d_hidden
        per_layer = 2 * m * (2 * h + 1) * h + 2 * m * h * h  # edge mlp
        per_layer += 2 * m * h * h + 2 * m * h  # coord mlp
        per_layer += 2 * n * 2 * h * h + 2 * n * h * h  # node mlp
        return 3.0 * (2 * n * d_in * h + cfg.num_layers * per_layer)
    if arch_name == "mace":
        c = cfg.channels
        n_irr = (cfg.l_max + 1) ** 2  # 9 for l_max=2
        paths = 15  # msg paths at l_max=2 steady state
        per_layer = 2 * m * c * n_irr * paths  # CG message contractions
        per_layer += 2 * n * c * c * (cfg.l_max + 1) * 3  # channel mixes
        per_layer += 2 * n * c * n_irr * 40  # product basis (corr 2+3)
        per_layer += 2 * m * cfg.n_rbf * 64 + 2 * m * 64 * paths * c  # radial
        return 3.0 * cfg.num_layers * per_layer
    raise ValueError(arch_name)


def gnn_train_bytes_per_device(
    arch_name: str, cfg, n: int, m: int, d_in: int, chips: int
) -> float:
    """Edge tensors sharded over all chips; node tensors replicated.
    Traffic = edge gathers/scatters (sharded) + node feature rw (replicated,
    the baseline's cost -- this is what the channel-sharding hillclimb
    attacks)."""
    h = getattr(cfg, "d_hidden", getattr(cfg, "channels", 64))
    n_irr = (cfg.l_max + 1) ** 2 if arch_name == "mace" else 1
    edge_rw = 4.0 * (m / chips) * h * n_irr * 4 * cfg.num_layers
    node_rw = 8.0 * n * h * n_irr * 4 * cfg.num_layers  # replicated!
    feats = 4.0 * n * d_in
    return edge_rw + node_rw + feats


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------


def recsys_step_flops(cfg, batch: int, *, train: bool) -> float:
    m_f, d_e = cfg.n_fields, cfg.embed_dim
    cin = 0
    h_prev = m_f
    for h in cfg.cin_layers:
        cin += 2 * h * h_prev * m_f * d_e
        h_prev = h
    mlp = 0
    d_in = m_f * d_e
    for d_out in cfg.mlp_layers:
        mlp += 2 * d_in * d_out
        d_in = d_out
    per_ex = cin + mlp
    return (3.0 if train else 1.0) * per_ex * batch


def recsys_bytes_per_device(cfg, batch: int, chips: int, *, train: bool) -> float:
    # embedding rows touched: batch x fields x dim, gathered from the
    # row-sharded table (each chip reads its resident rows only ~1/chips)
    lookup = 4.0 * batch * cfg.n_fields * cfg.embed_dim / chips
    dense_params = 4.0 * (
        sum(cfg.cin_layers) * cfg.n_fields * 210 + 400 * 400 + 390 * 400
    )
    act = 4.0 * batch / max(chips // 16, 1) / 16 * (
        cfg.n_fields * cfg.embed_dim + sum(cfg.cin_layers) + sum(cfg.mlp_layers)
    )
    factor = 4.0 if train else 1.0
    return factor * (lookup + act) + dense_params
