"""Elastic scaling: lay a training state out on a different mesh. The
port of ``repro/train/elastic.py``.

Checkpoints store full arrays (``checkpoint.py``), so growing or
shrinking the fleet is: restore, take this rank's blocks under the new
mesh's specs (``sharding.shard_tree``), continue. The only check needed
is that each sharded dim divides by its new axis size; a dim that does
not is replicated instead (with a warning), which is always correct.
"""
from __future__ import annotations

import logging
import math

from repro_torch.distributed.sharding import shard_tensor, tree_map

log = logging.getLogger("repro.elastic")


def fit_spec(spec, shape: tuple[int, ...], mesh) -> tuple:
    """Drop axis names absent from the mesh; replicate dims that don't
    divide."""
    parts = []
    for i, dim in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if dim is None:
            parts.append(None)
            continue
        names = (dim,) if isinstance(dim, str) else tuple(dim)
        names = tuple(a for a in names if a in mesh.axis_names)
        if not names:
            parts.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in names)
        if shape[i] % size:
            log.warning(
                "elastic: dim %d of shape %s not divisible by %s=%d; replicating",
                i, shape, names, size,
            )
            parts.append(None)
        else:
            parts.append(names if len(names) > 1 else names[0])
    return tuple(parts)


def reshard_state(state, spec_tree, mesh):
    """``state``: full tensors in a tree of dicts and lists, as
    ``checkpoint.py`` restores them; ``spec_tree``: specs of the same
    structure. Returns this rank's blocks on ``mesh`` (on its device),
    each leaf's spec fitted to the mesh first."""
    return tree_map(
        lambda x, spec: shard_tensor(x, fit_spec(spec, tuple(x.shape), mesh), mesh),
        state, spec_tree)
