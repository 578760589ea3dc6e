"""egnn [arXiv:2102.09844]: 4 layers, d_hidden=64, E(n)-equivariant."""
from repro_torch.configs.gnn_family import GNNArch
from repro_torch.models.gnn import egnn
from repro_torch.models.gnn.egnn import EGNNConfig

CONFIG = EGNNConfig(name="egnn", num_layers=4, d_hidden=64)
SMOKE_CONFIG = EGNNConfig(
    name="egnn-smoke", num_layers=2, d_hidden=16, in_dim=8
)

ARCH = GNNArch(
    name="egnn", module=egnn, config=CONFIG, smoke_config=SMOKE_CONFIG,
    geometric=True,
)
