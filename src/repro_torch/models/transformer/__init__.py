from repro_torch.models.transformer.config import MoEConfig, TransformerConfig
from repro_torch.models.transformer.model import (
    TransformerLM,
    cache_length,
    forward,
    hidden_states,
    init_kv_cache,
    init_params,
    loss_fn,
    prefill,
    serve_step,
)

__all__ = [
    "TransformerConfig",
    "MoEConfig",
    "TransformerLM",
    "init_params",
    "forward",
    "loss_fn",
    "hidden_states",
    "init_kv_cache",
    "cache_length",
    "serve_step",
    "prefill",
]
