"""deepseek-v3-671b [arXiv:2412.19437]: 61L d=7168 128H MLA d_ff_expert=2048
vocab=129280, MoE 1 shared + 256 routed top-8, MTP depth 1.

``a2a_dtype`` (the fp8 payload of the dispatch all-to-all) is read from
``REPRO_OPT_LEVEL`` as the reference reads it, so the two configs are
equal field for field; only the all_to_all MoE schedule reads it (with
a mesh whose EP axes span more than one rank).
"""
import os

from repro_torch.configs.lm_family import LMArch
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

# REPRO_OPT_LEVEL=0 -> bf16 dispatch; the default names the fp8 dispatch.
_A2A_DTYPE = (
    None if os.environ.get("REPRO_OPT_LEVEL", "1") == "0" else "float8_e4m3fn"
)

CONFIG = TransformerConfig(
    name="deepseek-v3-671b",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,  # MLA: heads share one latent cache
    head_dim=128,
    d_ff=18432,  # the 3 leading dense layers
    vocab_size=129280,
    activation="silu",
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        capacity_factor=1.25,
        ep_axes=("data", "model"),
        a2a_dtype=_A2A_DTYPE,
    ),
    num_dense_layers=3,
    mtp_depth=1,
    rope_theta=10000.0,
)

SMOKE_CONFIG = TransformerConfig(
    name="deepseek-v3-smoke",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    attention="mla",
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_rope_head_dim=8,
    qk_nope_head_dim=16,
    v_head_dim=16,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared_experts=1),
    num_dense_layers=1,
    mtp_depth=1,
    dtype="float32",
    remat=False,
)

ARCH = LMArch(
    name="deepseek-v3-671b",
    config=CONFIG,
    smoke_config=SMOKE_CONFIG,
    train_microbatches=8,
    moment_dtype="bfloat16",
)
