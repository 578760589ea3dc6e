"""Mesh builders: the port of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module starts no
process group. A mesh spans the ranks of the default group (see
``distributed/mesh.py``); with none started, a one-rank mesh starts one.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.graph import graph_mesh
from repro_torch.distributed.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 (data, model) single pod, or 2x16x16 (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have}; start {n} ranks "
            "(one a card) with torch.distributed.init_process_group first."
        )
    return Mesh(shape, axes, device=device)


def make_test_mesh(shape: tuple[int, ...] = (1, 1),
                   axes: tuple[str, ...] = ("data", "model"), *,
                   device=None) -> Mesh:
    """A small mesh over the default group's ranks (``device="cpu"`` for
    gloo ranks; default: the card)."""
    return Mesh(shape, axes, device=device)


def make_graph_mesh(num_devices: int | None = None, *, device=None):
    """1-D edge-partitioning mesh for the sharded graph engine."""
    return graph_mesh(num_devices, device=device)


def mesh_num_chips(mesh) -> int:
    """Ranks in a mesh (a ``Mesh`` or the graph engine's ``GraphMesh``)."""
    return int(mesh.size)
