"""Architecture registry of the port: ``get_arch(name)`` under the names
of ``repro.configs``.

Every architecture is ported. The five language models (the three dense
GQA/MQA/MHA ones, mixtral-8x7b with MoE and a sliding window,
deepseek-v3-671b with MoE, MLA and the MTP head) return an ``LMArch``
(``configs/lm_family.py``) with the full-width ``config`` and the small
``smoke_config`` of the reference. The GNNs gin-tu, gat-cora, egnn and
mace return a ``GNNArch`` (``configs/gnn_family.py``), whose
``config_for(shape)`` sizes the model for one of ``GNN_SHAPES``. xdeepfm
returns a ``RecsysArch`` (``configs/recsys_family.py``). Each has
``shapes()``, ``skip_reason(shape)`` and ``build(shape, mesh)``, the
``DryRunSpec`` that ``launch/dryrun.py`` runs.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.lm_family import LMArch

_ARCH_MODULES = {
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "gat-cora": "repro_torch.configs.gat_cora",
    "gin-tu": "repro_torch.configs.gin_tu",
    "egnn": "repro_torch.configs.egnn",
    "mace": "repro_torch.configs.mace",
    "xdeepfm": "repro_torch.configs.xdeepfm",
}

ARCH_NAMES = [
    "gemma-2b", "phi3-mini-3.8b", "qwen3-4b", "deepseek-v3-671b",
    "mixtral-8x7b", "egnn", "gat-cora", "mace", "gin-tu", "xdeepfm",
]


# The name earlier slices gave the LM entries.
Arch = LMArch


def get_arch(name: str):
    """The ``LMArch`` of a language model, the ``GNNArch`` of a GNN or the
    ``RecsysArch`` of xdeepfm."""
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name]).ARCH


def all_cells() -> list[tuple[str, str]]:
    """All 40 (arch, shape) cells."""
    cells = []
    for name in ARCH_NAMES:
        arch = get_arch(name)
        for shape in arch.shapes():
            cells.append((name, shape))
    return cells
