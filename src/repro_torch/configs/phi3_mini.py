"""phi3-mini-3.8b [arXiv:2404.14219]: 32L d=3072 32H GQA(kv=32) d_ff=8192
vocab=32064, RoPE + SwiGLU (MHA: kv == q heads)."""
from repro_torch.models.transformer.config import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3-mini-3.8b",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    activation="silu",
    rope_theta=10000.0,
)

SMOKE_CONFIG = TransformerConfig(
    name="phi3-mini-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
    remat=False,
)
