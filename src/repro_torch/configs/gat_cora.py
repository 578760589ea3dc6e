"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden=8, 8 heads, attention
aggregator (Cora: in 1433, 7 classes)."""
from repro_torch.configs.gnn_family import GNNArch
from repro_torch.models.gnn import gat
from repro_torch.models.gnn.gat import GATConfig

CONFIG = GATConfig(
    name="gat-cora", num_layers=2, d_hidden=8, num_heads=8,
    in_dim=1433, num_classes=7,
)
SMOKE_CONFIG = GATConfig(
    name="gat-cora-smoke", num_layers=2, d_hidden=4, num_heads=2,
    in_dim=8, num_classes=3,
)

ARCH = GNNArch(
    name="gat-cora", module=gat, config=CONFIG, smoke_config=SMOKE_CONFIG
)
