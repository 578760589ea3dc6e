"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim 10,
CIN 200-200-200, MLP 400-400, vocab 1e6 rows per field."""
from repro_torch.configs.recsys_family import RecsysArch
from repro_torch.models.recsys.xdeepfm import XDeepFMConfig

CONFIG = XDeepFMConfig(
    name="xdeepfm",
    n_fields=39,
    vocab_per_field=1_000_000,
    embed_dim=10,
    cin_layers=(200, 200, 200),
    mlp_layers=(400, 400),
    retrieval_dim=64,
    n_candidates=1_000_000,
)

SMOKE_CONFIG = XDeepFMConfig(
    name="xdeepfm-smoke",
    n_fields=8,
    vocab_per_field=1000,
    embed_dim=6,
    cin_layers=(16, 16),
    mlp_layers=(32, 32),
    retrieval_dim=8,
    n_candidates=512,
)

ARCH = RecsysArch(name="xdeepfm", config=CONFIG, smoke_config=SMOKE_CONFIG)
