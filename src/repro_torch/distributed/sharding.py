"""Logical-axis sharding rules and path-based partition specs: the port of
``repro/distributed/sharding.py``.

Models name the logical axes of their tensors (batch, heads, d_ff,
vocab, expert, nodes, edges, table_rows); a ``ShardingRules`` table maps
them to mesh axes, so one model runs on a ``(data, model)`` mesh, a
``(pod, data, model)`` mesh or a one-rank test mesh without edits.

A spec is a tuple with one entry per dim: None (replicated), an axis
name, or a tuple of names, as ``tuple(P(...))`` of the reference. On
explicit ranks a tensor's layout is fixed when it is made, so the
counterpart of ``named_sharding_tree`` plus ``jax.device_put`` is
``shard_tree`` (full tensors in, this rank's blocks out) and its inverse
``gather_tree`` (tests and checkpoints use it). ``reduce_gradients`` is
the gradient reduction that GSPMD inserts for the reference's jitted
training step.
"""
from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field, replace

import torch
from torch import nn

from repro_torch.distributed.collectives import all_gather, all_reduce, chunk


@dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axis (None = replicate)."""

    batch: tuple[str, ...] | str | None = ("pod", "data")
    seq: str | None = None  # sequence sharding for long-context decode
    heads: str | None = "model"
    d_ff: str | None = "model"
    vocab: str | None = "model"
    expert: str | None = "model"
    edges: tuple[str, ...] | str | None = ("pod", "data", "model")
    nodes: str | None = None  # GNN node tensors replicated by default
    table_rows: str | None = "model"  # recsys embedding-table rows
    stage: str | None = None  # pipeline axis, usually "pod"

    def for_mesh(self, mesh) -> "ShardingRules":
        """Drop references to axes the mesh does not have."""

        def fix(ax):
            if ax is None:
                return None
            if isinstance(ax, str):
                return ax if ax in mesh.axis_names else None
            kept = tuple(a for a in ax if a in mesh.axis_names)
            return kept if kept else None

        kw = {k: fix(getattr(self, k)) for k in self.__dataclass_fields__}
        return ShardingRules(**kw)


# Default rule tables per model family.
LM_RULES = ShardingRules()
LM_DECODE_RULES = replace(ShardingRules(), batch=("pod", "data"))
LM_LONG_DECODE_RULES = replace(ShardingRules(), batch=None, seq="data")
GNN_RULES = ShardingRules(batch=("pod", "data"))
RECSYS_RULES = ShardingRules()


def normalize(spec) -> tuple:
    """``spec`` as a tuple with a one-name tuple entry written as the name,
    as ``tuple(P(...))`` reads."""
    return tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d for d in spec)


def spec_for(rules: ShardingRules, *logical_axes: str | None) -> tuple:
    """A spec from logical axis names (None = replicated dim)."""
    return normalize(None if ax is None else getattr(rules, ax) for ax in logical_axes)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec names, in order."""
    out = []
    for dim in spec:
        if dim is None:
            continue
        out += [dim] if isinstance(dim, str) else list(dim)
    return tuple(out)


def constrain(x: torch.Tensor, mesh, rules: ShardingRules, *axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` through logical axes.
    On explicit ranks a tensor's layout is fixed where it is made, so
    this returns ``x`` and only checks that the spec has an entry per
    dim of ``x``. No-op without a mesh."""
    if mesh is None or mesh.empty:
        return x
    spec = spec_for(rules.for_mesh(mesh), *axes)
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} does not fit a {x.dim()}-d tensor")
    return x


def _tree_items(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists, paths joined with "/"
    as the reference joins ``tree_flatten_with_path``'s keys (a list
    index reads ``[i]``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f"{prefix}/[{i}]" if prefix else f"[{i}]")
    else:
        yield prefix, tree


def _tree_map_path(fn, tree, prefix=""):
    """``fn(path, leaf)`` over a tree, paths as ``_tree_items`` spells them."""
    if isinstance(tree, dict):
        return {k: _tree_map_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map_path(fn, v, f"{prefix}/[{i}]" if prefix else f"[{i}]")
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


@dataclass
class PathRules:
    """Ordered (regex -> spec) table matched against parameter paths.

    First match wins; unmatched leaves are replicated."""

    rules: list = field(default_factory=list)

    def spec_of(self, name: str) -> tuple:
        for pat, spec in self.rules:
            if re.search(pat, name):
                return normalize(spec)
        return ()

    def spec_tree(self, shapes):
        """A tree of specs with ``shapes``' structure (dicts and lists)."""
        return _tree_map_path(lambda path, _: self.spec_of(path), shapes)


def _fix_dim(dim, mesh):
    if dim is None:
        return None
    if isinstance(dim, str):
        return dim if dim in mesh.axis_names else None
    kept = tuple(a for a in dim if a in mesh.axis_names)
    return kept if kept else None


def drop_missing_axes(spec_tree, mesh):
    """Remove mesh-absent axis names from every spec in a tree (dicts and
    lists of spec tuples)."""
    return tree_map(lambda s: normalize(_fix_dim(d, mesh) for d in s), spec_tree)


# ---------------------------------------------------------------------------
# laying tensors out on the ranks
# ---------------------------------------------------------------------------


def _dims(spec, ndim: int):
    """(dim, axes tuple) for each sharded dim of a spec."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return [(i, (d,) if isinstance(d, str) else tuple(d))
            for i, d in enumerate(spec) if d is not None]


def shard_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (a view
    of ``x`` when no dim is split, a contiguous copy otherwise), on the
    mesh's device."""
    out = x
    for dim, axes in _dims(spec, x.dim()):
        out = chunk(out, mesh, axes, dim)
    if out.data_ptr() != x.data_ptr() or out.shape != x.shape:
        out = out.contiguous().clone()
    return out.to(mesh.device)


def gather_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor whose block under ``spec`` this rank holds in
    ``x`` (every rank gets it; no autograd)."""
    for dim, axes in reversed(_dims(spec, x.dim())):
        x = all_gather(x, mesh, axes, dim)
    return x


def _named(tree):
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(_tree_items(tree))


def shard_tree(tree, specs, mesh):
    """``tree``'s tensors as this rank's blocks. A module comes back as a
    copy whose parameters are the blocks (``specs``: parameter name ->
    spec; a name it lacks stays replicated) and keep ``requires_grad``;
    a tree of dicts and lists comes back with the same structure
    (``specs`` a tree of the same structure)."""
    if isinstance(tree, nn.Module):
        memo = {}
        for name, p in tree.named_parameters():
            block = shard_tensor(p.detach(), specs.get(name, ()), mesh)
            memo[id(p)] = nn.Parameter(block, requires_grad=p.requires_grad)
        return copy.deepcopy(tree, memo)
    return tree_map(lambda x, s: shard_tensor(x, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """The inverse of ``shard_tree``: full tensors on every rank, as
    ``{name: tensor}`` for a module, else in the tree's structure."""
    if isinstance(tree, nn.Module):
        return {name: gather_tensor(p.detach(), specs.get(name, ()), mesh)
                for name, p in tree.named_parameters()}
    return tree_map(lambda x, s: gather_tensor(x.detach(), s, mesh), tree, specs)


def replicated_axes(spec, mesh, axes) -> tuple:
    """Those of ``axes`` (in mesh order) along which ``spec`` leaves a
    leaf replicated: where work split over them meets the leaf, its
    gradient is summed over these (``reduce_gradients``, and the sharded
    step's ``configs/common.py::ShardedUpdate``)."""
    owned = spec_axes(spec)
    return tuple(a for a in mesh.axis_names if a in tuple(axes) and a not in owned)


def reduce_gradients(params, specs, mesh, axes) -> None:
    """Sum each parameter's ``.grad`` in place over those of ``axes``
    (the mesh axes that split the batch or the edges) along which its
    spec leaves it replicated: the reduction GSPMD inserts where a
    replicated weight meets sharded work. Each rank's gradient is its
    share of the work's (see ``collectives``); after this every rank
    holds the meshless gradient's block. ``params``: a module or a
    ``{name: tensor}`` dict; ``specs``: name -> spec."""
    for name, p in _named(params).items():
        if p.grad is None:
            continue
        over = replicated_axes(specs.get(name, ()), mesh, axes)
        if over:
            p.grad.copy_(all_reduce(p.grad, mesh, over))
