"""qwen3-4b [hf:Qwen/Qwen3-8B family]: 36L d=2560 32H GQA(kv=8) d_ff=9728
vocab=151936, qk-norm, head_dim=128."""
from repro_torch.configs.lm_family import LMArch
from repro_torch.models.transformer.config import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-4b",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    activation="silu",
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = TransformerConfig(
    name="qwen3-4b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    dtype="float32",
    remat=False,
)

ARCH = LMArch(name="qwen3-4b", config=CONFIG, smoke_config=SMOKE_CONFIG)
