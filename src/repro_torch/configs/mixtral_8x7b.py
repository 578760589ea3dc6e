"""mixtral-8x7b [arXiv:2401.04088]: 32L d=4096 32H GQA(kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention (w=4096).

The window keeps the decode cache a 4096-row ring buffer however long
the sequence runs; the prefill runs it through the ``flash_attention``
kernel's window mask.
"""
from repro_torch.configs.lm_family import LMArch
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="mixtral-8x7b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    activation="silu",
    sliding_window=4096,
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_ff_expert=14336,
        num_shared_experts=0,
        capacity_factor=1.25,
    ),
    num_dense_layers=0,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = TransformerConfig(
    name="mixtral-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    sliding_window=8,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32),
    dtype="float32",
    remat=False,
)

ARCH = LMArch(
    name="mixtral-8x7b",
    config=CONFIG,
    smoke_config=SMOKE_CONFIG,
    sub_quadratic=True,  # SWA
    train_microbatches=4,
    moment_dtype="bfloat16",
)
