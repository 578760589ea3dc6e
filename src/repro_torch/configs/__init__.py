"""Architecture registry of the port: ``get_arch(name)`` under the names
of ``repro.configs``.

Every language model is ported: the three dense GQA/MQA/MHA ones,
mixtral-8x7b (MoE, sliding window) and deepseek-v3-671b (MoE, MLA, the
MTP head); each returns an ``Arch`` with the full-width ``config`` and
the small ``smoke_config`` of the reference. The GNNs gin-tu, gat-cora,
egnn and mace return a ``GNNArch`` (``configs/gnn_family.py``), whose
``config_for(shape)`` sizes the model for one of ``GNN_SHAPES``; their
forwards aggregate with the ``segment_sum`` kernel. xdeepfm returns a ``RecsysArch``
(``configs/recsys_family.py``). The reference's dry-run plumbing
(``LMArch.build``, ``GNNArch.build``, ``RecsysArch.build``,
``DryRunSpec``, the mesh shapes) is launch work and waits for ROADMAP
queue 1, item 17.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.transformer.config import TransformerConfig

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


@dataclass(frozen=True)
class Arch:
    """One language-model architecture: its published width and the
    small configuration the tests run."""

    name: str
    config: TransformerConfig
    smoke_config: TransformerConfig


def get_arch(name: str):
    """The ``Arch`` of a language model, the ``GNNArch`` of a GNN or the
    ``RecsysArch`` of xdeepfm."""
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(_ARCH_MODULES[name])
    if hasattr(mod, "ARCH"):
        return mod.ARCH
    return Arch(name=name, config=mod.CONFIG, smoke_config=mod.SMOKE_CONFIG)
