"""Decoder-LM configuration: the port's copy of
``repro.models.transformer.config``.

The dataclasses and param-count formulas are the reference's, field for
field, so a config of either package describes the same model.
``MoEConfig``'s ``ep_axes`` and ``a2a_dtype`` are read only by the
sharded MoE schedules (``moe.py``, with a mesh).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # "sorted_ep": sort-by-expert + all_to_all over the expert-sharded axis
    #              (the paper's coalescing guideline at pod scale).
    # "unsorted":  same buffers built by raw scatter without the sort
    #              (the uncoalesced baseline for the A/B).
    dispatch: str = "sorted_ep"
    router_renorm: bool = True  # renormalize top-k gate weights
    # Mesh axes jointly treated as the flat expert-parallel axis. DeepSeek's
    # 256 experts shard over ("data", "model") = 256 devices per pod.
    ep_axes: tuple[str, ...] = ("model",)
    # Quantize the dispatch-direction all-to-all payload (DeepSeek trains
    # with fp8 dispatch; combine stays bf16). None = full precision.
    a2a_dtype: str | None = None


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "silu"  # silu => SwiGLU, gelu_tanh => GeGLU
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None  # Mixtral SWA
    attention: str = "gqa"  # "gqa" | "mla"
    # MLA (DeepSeek-V3) dims
    q_lora_rank: int | None = None
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # MoE
    moe: MoEConfig | None = None
    num_dense_layers: int = 0  # leading dense layers (DeepSeek-V3 uses 3)
    # Multi-token prediction (DeepSeek-V3): extra depth-1 MTP head
    mtp_depth: int = 0
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    logical_rules: dict = field(default_factory=dict)

    @property
    def q_dim(self) -> int:
        if self.attention == "mla":
            return self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.num_heads * self.head_dim

    @property
    def attn_out_dim(self) -> int:
        if self.attention == "mla":
            return self.num_heads * self.v_head_dim
        return self.num_heads * self.head_dim

    def num_moe_layers(self) -> int:
        return 0 if self.moe is None else self.num_layers - self.num_dense_layers

    def param_count_dense_layer(self) -> int:
        d = self.d_model
        if self.attention == "mla":
            attn = (
                d * (self.q_lora_rank or self.q_dim)
                + (self.q_lora_rank or 0) * self.q_dim
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank
                * self.num_heads
                * (self.qk_nope_head_dim + self.v_head_dim)
                + self.attn_out_dim * d
            )
        else:
            attn = d * self.q_dim + 2 * d * self.num_kv_heads * self.head_dim
            attn += self.attn_out_dim * d
        ffn = 3 * d * self.d_ff
        return attn + ffn

    def param_count_moe_layer(self) -> int:
        assert self.moe is not None
        d = self.d_model
        base = self.param_count_dense_layer() - 3 * d * self.d_ff
        experts = 3 * d * self.moe.d_ff_expert * self.moe.num_experts
        shared = 3 * d * self.moe.d_ff_expert * self.moe.num_shared_experts
        router = d * self.moe.num_experts
        return base + experts + shared + router

    def total_params(self) -> int:
        n = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.num_dense_layers_effective() * self.param_count_dense_layer()
        n += self.num_moe_layers() * (
            self.param_count_moe_layer() if self.moe else 0
        )
        return n

    def num_dense_layers_effective(self) -> int:
        return self.num_layers if self.moe is None else self.num_dense_layers

    def active_params(self) -> int:
        """Activated parameters per token (for MoE model FLOP accounting)."""
        if self.moe is None:
            return self.total_params()
        d = self.d_model
        base = self.param_count_dense_layer() - 3 * d * self.d_ff
        act_ffn = 3 * d * self.moe.d_ff_expert * (
            self.moe.top_k + self.moe.num_shared_experts
        )
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        n += self.num_dense_layers * self.param_count_dense_layer()
        n += self.num_moe_layers() * (base + act_ffn + d * self.moe.num_experts)
        return n
