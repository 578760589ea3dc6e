"""gin-tu [arXiv:1810.00826]: 5 layers, d_hidden=64, sum aggregator,
learnable eps."""
from repro_torch.configs.gnn_family import GNNArch
from repro_torch.models.gnn import gin
from repro_torch.models.gnn.gin import GINConfig

CONFIG = GINConfig(name="gin-tu", num_layers=5, d_hidden=64, eps_learnable=True)
SMOKE_CONFIG = GINConfig(
    name="gin-tu-smoke", num_layers=2, d_hidden=16, in_dim=8, num_classes=3
)

ARCH = GNNArch(
    name="gin-tu", module=gin, config=CONFIG, smoke_config=SMOKE_CONFIG
)
