"""gemma-2b [arXiv:2403.08295]: 18L d=2048 8H MQA(kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256, tied embeddings, sqrt(d) embed scale."""
from repro_torch.models.transformer.config import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma-2b",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="gelu_tanh",  # GeGLU
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)

SMOKE_CONFIG = TransformerConfig(
    name="gemma-2b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="gelu_tanh",
    embed_scale=True,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)
