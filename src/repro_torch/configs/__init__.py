"""Architecture registry of the port: ``get_arch(name)`` under the names
of ``repro.configs``.

The three dense GQA/MQA/MHA language models are ported; each returns an
``Arch`` with the full-width ``config`` and the small ``smoke_config``
of the reference. The GNNs gin-tu and gat-cora return a ``GNNArch``
(``configs/gnn_family.py``), whose ``config_for(shape)`` sizes the
model for one of ``GNN_SHAPES``; their forwards aggregate with the
``segment_sum`` kernel. The reference's dry-run plumbing
(``LMArch.build``, ``GNNArch.build``, ``DryRunSpec``, the mesh shapes)
is launch work and waits for ROADMAP queue 1, item 17. The other names
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.transformer.config import TransformerConfig

_ARCH_MODULES = {
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "gat-cora": "repro_torch.configs.gat_cora",
    "gin-tu": "repro_torch.configs.gin_tu",
}

# Registered in the reference, not ported yet: name -> ROADMAP item.
_NOT_PORTED = {
    "deepseek-v3-671b": "queue 1, item 15 (MoE and MLA)",
    "mixtral-8x7b": "queue 1, item 15 (MoE)",
    "egnn": "queue 1, item 13 (GNN models)",
    "mace": "queue 1, item 13 (GNN models)",
    "xdeepfm": "queue 1, item 14 (RecSys)",
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
    """The ``Arch`` of a language model or the ``GNNArch`` of a GNN."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet "
            f"(ROADMAP {_NOT_PORTED[name]})"
        )
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(_ARCH_MODULES[name])
    if hasattr(mod, "ARCH"):
        return mod.ARCH
    return Arch(name=name, config=mod.CONFIG, smoke_config=mod.SMOKE_CONFIG)
