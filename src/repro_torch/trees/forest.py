"""Spanning-forest extraction from Shiloach-Vishkin hook decisions.

The port of ``repro.trees.forest``. Every hook event attaches one tree
to another through a real graph edge, so the winning edges that
``core.components.sv_round_fns`` records with ``record_hooks=True`` form
a spanning forest. This module copies them to the host and compacts the
raw ``(hook_u, hook_v)`` slots into the forest the tour layer consumes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SpanningForest:
    """A spanning forest of the input graph, one tree per component.

    ``edge_u``/``edge_v`` are the ``num_nodes - num_trees`` winning hook
    edges (each a real input edge); ``labels`` are the CC labels, the
    minimum node id of each component, which the tour layer uses as the
    tree roots. All three live on the host.
    """

    num_nodes: int
    labels: np.ndarray  # (n,) component root ids (min node id)
    rounds: int
    edge_u: np.ndarray  # (f,) forest edge endpoints
    edge_v: np.ndarray  # (f,)

    @property
    def num_edges(self) -> int:
        return int(self.edge_u.shape[0])

    @property
    def num_trees(self) -> int:
        return self.num_nodes - self.num_edges


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def forest_from_hooks(
    hook_u, hook_v, labels, rounds, num_nodes: int
) -> SpanningForest:
    """Compact raw ``(hook_u, hook_v)`` slot arrays (sentinel n = never
    hooked) into a ``SpanningForest`` on the host."""
    hu, hv = _host(hook_u), _host(hook_v)
    mask = hu < num_nodes
    return SpanningForest(
        num_nodes=num_nodes,
        labels=_host(labels),
        rounds=int(rounds),
        edge_u=hu[mask].astype(np.int32),
        edge_v=hv[mask].astype(np.int32),
    )


def spanning_forest(
    src,
    dst,
    num_nodes: int,
    *,
    max_rounds: int | None = None,
    mesh=None,
    engine: str = "auto",
    **kwargs,
) -> SpanningForest:
    """Connected components and a spanning forest in one CC run: the
    port's ``connected_components(..., record_hooks=True)`` with the
    hooks copied to the host. ``engine=``, ``mesh=``, ``max_rounds=``,
    ``device=`` and the engine keywords behave as there, and labels and
    rounds equal a plain CC call's bit for bit (recording only reads the
    round state). The forest does not depend on the engine, except
    under a sampling pre-pass (``sample_rounds``), which hooks through
    sampled edges: still a spanning forest, but another one.
    """
    from repro_torch.core import connected_components

    if kwargs.pop("record_hooks", True) is not True:
        raise ValueError("spanning_forest always records hooks")
    res = connected_components(
        src, dst, num_nodes, max_rounds=max_rounds, mesh=mesh,
        engine=engine, record_hooks=True, **kwargs,
    )
    labels, rounds, (hook_u, hook_v) = res[0], res[1], res[2]
    return forest_from_hooks(hook_u, hook_v, labels, rounds, num_nodes)
