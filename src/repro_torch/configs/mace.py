"""mace [arXiv:2206.07697]: 2 layers, 128 channels, l_max=2,
correlation order 3, 8 radial basis functions, E(3)-equivariant."""
from repro_torch.configs.gnn_family import GNNArch
from repro_torch.models.gnn import mace
from repro_torch.models.gnn.mace import MACEConfig

CONFIG = MACEConfig(
    name="mace", num_layers=2, channels=128, l_max=2, correlation=3,
    n_rbf=8, num_species=64,
)
SMOKE_CONFIG = MACEConfig(
    name="mace-smoke", num_layers=1, channels=16, l_max=2, correlation=3,
    n_rbf=4, num_species=5,
)

ARCH = GNNArch(
    name="mace", module=mace, config=CONFIG, smoke_config=SMOKE_CONFIG,
    geometric=True,
)
