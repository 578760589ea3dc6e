"""Named device meshes on ``torch.distributed``: the port's counterpart of
``jax.sharding.Mesh``.

A ``Mesh`` lays the ranks of the default process group out row-major
over named axes, as ``jax.make_mesh`` lays out devices: rank ``r`` of a
``(2, 2)`` ``("data", "model")`` mesh sits at ``data = r // 2, model = r
% 2``. "Axis ``a`` of the mesh" is the process group of the ranks that
differ only in ``a``; a tuple of axes (``ep_axes=("data", "model")``) is
the group of the ranks that differ only in those, ranked by their
flattened coordinate (the first axis major, as ``P(("data", "model"))``
reads). Every group is made once, with ``dist.new_group`` called in the
same order on every rank, when the mesh is built.

A mesh spans the whole default group. With no group started, a mesh of
one rank starts a one-rank group from an in-memory store (no network):
NCCL for the card, gloo for ``device="cpu"``. A group whose backend
cannot serve the mesh's device raises.

``with mesh:`` makes the mesh the active one, which the edge-sharded
segment reductions (``ops/segment.py``) read to resolve their axis
names, as the reference's names resolve inside ``shard_map``.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

_ACTIVE: list = []
# (shape, axis names, backend) -> the groups of every tuple of axes,
# made once per process: new_group is collective and groups are not freed.
_GROUPS: dict = {}


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


class Mesh:
    """Ranks of the default group on named axes. ``shape`` maps each axis
    name to its size (in mesh order); ``coords`` maps it to this rank's
    coordinate; ``device`` is where this rank's tensors live."""

    def __init__(self, shape, axis_names, *, device=None):
        axis_names = tuple(axis_names)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not fit axes {axis_names}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        backend = _backend_for(dev)
        n = math.prod(shape)
        if not dist.is_initialized():
            if n != 1:
                raise ValueError(
                    f"mesh {shape} needs {n} ranks, have 1: no process group "
                    f"is initialised (start {n} ranks with "
                    "torch.distributed.init_process_group first)")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        world = dist.get_world_size()
        if n != world:
            raise ValueError(
                f"mesh {shape} needs {n} ranks; the process group has "
                f"{world}: a mesh spans its whole group")
        have = dist.get_backend()
        if backend not in have:
            raise ValueError(
                f"a mesh on {dev} needs the {backend} backend; the process "
                f"group runs {have!r}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.device = dev
        self.rank = dist.get_rank()
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        self.coords = {a: (self.rank // st) % sz
                       for a, st, sz in zip(axis_names, strides, shape)}
        key = (shape, axis_names, backend)
        if key not in _GROUPS:
            _GROUPS[key] = self._make_groups(shape, strides)
        self._groups = _GROUPS[key]

    def _make_groups(self, shape, strides) -> dict:
        """One group per non-empty tuple of axes (in mesh order), for every
        coordinate of the other axes; each rank keeps the groups it is in."""
        names = self.axis_names
        mine = {}
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(range(len(names)), r):
                rest = [i for i in range(len(names)) if i not in axes]
                for other in itertools.product(*(range(shape[i]) for i in rest)):
                    base = sum(c * strides[i] for c, i in zip(other, rest))
                    ranks = [base + sum(c * strides[i] for c, i in zip(inner, axes))
                             for inner in itertools.product(
                                 *(range(shape[i]) for i in axes))]
                    group = dist.new_group(ranks=ranks)
                    if self.rank in ranks:
                        mine[tuple(names[i] for i in axes)] = group
        return mine

    # -- axes ---------------------------------------------------------------

    @property
    def empty(self) -> bool:
        return not self.axis_names

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axes(self, axes) -> tuple:
        """``axes`` (a name, a tuple of names or None) as a tuple of the
        mesh's names in mesh order; a name the mesh lacks raises."""
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in axes if a not in self.shape]
        if missing:
            raise ValueError(f"axes {missing} are not in mesh {self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(
                f"axes {axes} must name distinct axes in the mesh's order "
                f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's flattened coordinate over ``axes`` (first axis
        major), its rank in ``group(axes)``."""
        idx = 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that differ only in ``axes``."""
        axes = self.axes(axes)
        if not axes:
            raise ValueError("a group needs at least one axis")
        return self._groups[axes]

    # -- the active mesh ----------------------------------------------------

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.pop()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")


def active_mesh():
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def resolve_mesh(mesh=None, axes=()):
    """``mesh``, else the active mesh; raises if ``axes`` name axes and
    neither is there."""
    mesh = mesh if mesh is not None else active_mesh()
    if axes and mesh is None:
        raise ValueError(
            f"axes {tuple(axes)} name mesh axes, but no mesh is given or "
            "active (pass mesh= or enter `with mesh:`)")
    return mesh
