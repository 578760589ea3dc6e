"""Shared dry-run plumbing: ``DryRunSpec``, ZeRO spec derivation, shard
shapes and the sharded half of the training step (``ShardedUpdate``).
The port of ``repro/configs/common.py``.

A spec is a tuple with one entry per leading dim (None, an axis name or
a tuple of names), as ``distributed/sharding.py`` writes them. A mesh
here is anything with ``axis_names`` and a ``shape`` dict (a ``Mesh``,
or a stub for specs alone).

Where the reference hands ``jax.jit`` abstract arguments and
``NamedSharding``s, a ``DryRunSpec`` holds trees of meta tensors (a
model's parameters as a meta-device module) and a tree of specs of the
same structure (a module's as ``{parameter name: spec}``).
``shard_args`` lays them out as one rank holds them, which is what
``fn`` takes, as a jitted step takes its shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn


@dataclass
class DryRunSpec:
    """Everything ``launch/dryrun.py`` needs to run one (arch x shape)
    cell as one rank of the production mesh."""

    fn: Callable
    args: tuple  # trees of meta tensors
    in_specs: Any  # a tree of specs per argument (see the module docstring)
    out_shardings: Any = None
    donate_argnums: tuple = ()
    model_flops_total: float = 0.0  # 6*N*D train / 2*N*D inference (useful)
    flops_total: float | None = None  # analytic whole-step flops (perfmodel)
    hbm_bytes_per_device: float | None = None  # analytic HBM traffic
    note: str = ""


def meta(shape, dtype) -> torch.Tensor:
    """A meta tensor: the counterpart of ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _spec_axes(spec) -> set:
    used = set()
    for dim in spec:
        if dim is None:
            continue
        if isinstance(dim, str):
            used.add(dim)
        else:
            used.update(dim)
    return used


def zero_spec(spec, shape: tuple[int, ...], mesh,
              extra_axes: tuple[str, ...]) -> tuple:
    """ZeRO-1: extend a param spec with `extra_axes` on the largest
    unsharded, divisible dim. Falls back to fewer axes, then to the
    original spec (always correct, just less sharded)."""
    extra = tuple(a for a in extra_axes if a in mesh.axis_names)
    used = _spec_axes(spec)
    extra = tuple(a for a in extra if a not in used)
    parts = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    for axes_try in (extra, extra[:1]):
        if not axes_try:
            continue
        size = math.prod(mesh.shape[a] for a in axes_try)
        cands = [
            i for i, dim in enumerate(parts)
            if dim is None and shape[i] % size == 0 and shape[i] >= size
        ]
        if cands:
            best = max(cands, key=lambda i: shape[i])
            parts[best] = axes_try if len(axes_try) > 1 else axes_try[0]
            return tuple(parts)
    return tuple(parts)


def _items(tree, specs):
    """(leaf, spec) pairs of an argument tree and its specs: a module's
    parameters by name, else dicts, lists and tuples walked together."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield p, specs.get(name, ())
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _items(v, s)
    elif isinstance(tree, torch.Tensor):
        yield tree, specs


def _shapes(tree) -> dict:
    if isinstance(tree, nn.Module):
        return {n: tuple(p.shape) for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(v) for v in tree)
    return tuple(tree.shape)


def zero_spec_tree(spec_tree, shape_tree, mesh, extra_axes: tuple[str, ...]):
    """``zero_spec`` of every leaf. ``shape_tree``: the parameters (a
    module, or a tree of tensors) whose specs ``spec_tree`` holds."""
    shapes = _shapes(shape_tree)

    def walk(s, sh):
        if isinstance(sh, dict):
            return {k: walk(s.get(k, ()) if isinstance(s, dict) else s, v)
                    for k, v in sh.items()}
        if isinstance(sh, list):
            return [walk(a, b) for a, b in zip(s, sh)]
        return zero_spec(s, sh, mesh, extra_axes)

    return walk(spec_tree, shapes)


def flat_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def shard_shape(shape, spec, mesh) -> tuple[int, ...]:
    """One rank's block of a leaf of ``shape`` under ``spec``, as
    ``NamedSharding.shard_shape`` gives it; a dim its axes do not divide
    raises, as there."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for i, (n, dim) in enumerate(zip(shape, spec)):
        if dim is None:
            out.append(n)
            continue
        axes = (dim,) if isinstance(dim, str) else tuple(dim)
        size = math.prod(mesh.shape[a] for a in axes)
        if n % size:
            raise ValueError(
                f"dim {i} of {tuple(shape)} does not divide over {axes} = {size}")
        out.append(n // size)
    return tuple(out)


def bytes_per_rank(tree, specs, mesh) -> int:
    """The bytes one rank holds of an argument tree laid out by ``specs``."""
    return sum(math.prod(shard_shape(x.shape, s, mesh)) * x.element_size()
               for x, s in _items(tree, specs))


def tree_bytes(tree) -> int:
    """The bytes of every tensor in a tree (``train/tree.py``'s trees:
    modules, dicts, lists, tuples; other leaves count 0)."""
    from repro_torch.train.tree import leaves

    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor))


def shard_args(args: tuple, in_specs, mesh) -> tuple:
    """Each argument as this rank holds it under ``in_specs`` (on the
    mesh's device): the counterpart of ``jit``'s ``in_shardings``."""
    from repro_torch.distributed.sharding import shard_tree

    return tuple(shard_tree(a, s, mesh) for a, s in zip(args, in_specs))


def _zero_dim(pspec, mspec):
    """(dim, axes) that ``zero_spec`` added to ``pspec`` to give
    ``mspec``, or (None, ())."""
    for i, (a, b) in enumerate(zip(tuple(mspec), tuple(pspec) + (None,) * len(mspec))):
        if a is not None and b is None:
            return i, (a,) if isinstance(a, str) else tuple(a)
    return None, ()


class ShardedUpdate:
    """The sharded half of ``train/loop.py::make_train_step`` (its
    ``sharded=``) for a module holding this rank's blocks (``pspecs``:
    parameter name -> spec) whose AdamW moments hold their blocks under
    ``mspecs`` (``zero_spec_tree`` of ``pspecs``: ZeRO-1). The moments
    are ``{"step", "m": {name: block}, "v": {name: block}}``.

    ``reduce`` is each microbatch's reduction. A rank's gradients are its
    share of the step's (see ``distributed/collectives.py``), summed over
    those of ``reduce_axes`` along which a parameter is replicated
    (``sharding.replicated_axes``). ``zero=True`` reduces them straight
    into the moments' layout (a reduce-scatter over the ZeRO axes: the
    reference's gradients pinned to that layout); else they are
    all-reduced whole and ``update`` cuts this rank's ZeRO block from
    the sum. ``update`` runs AdamW on each parameter's ZeRO block, with
    the global norm summed over every rank's blocks, and all-gathers the
    blocks back into the parameters, in place."""

    def __init__(self, mesh, pspecs: dict, mspecs: dict, reduce_axes: tuple, *,
                 zero: bool = False):
        from repro_torch.distributed.sharding import replicated_axes, spec_axes

        self.mesh = mesh
        self.names = sorted(pspecs)  # a module's tree.leaves order
        self.plan = []
        for name in self.names:
            ps = pspecs[name]
            ms = mspecs.get(name, ps)
            zdim, zaxes = _zero_dim(ps, ms)
            over = replicated_axes(ps, mesh, reduce_axes)
            scatter = zero and bool(zaxes) and set(zaxes) <= set(over)
            held = math.prod(mesh.shape[a] for a in spec_axes(ms))
            self.plan.append((zdim, zaxes, over, scatter, held))

    def reduce(self, grads: list) -> list:
        from repro_torch.distributed.collectives import all_reduce, reduce_scatter

        out = []
        for g, (zdim, zaxes, over, scatter, _) in zip(grads, self.plan):
            if scatter:
                g = reduce_scatter(g, self.mesh, zaxes, zdim)
                over = tuple(a for a in over if a not in zaxes)
            out.append(all_reduce(g, self.mesh, over) if over else g)
        return out

    def update(self, grads: list, opt_state: dict, params, opt_cfg):
        from repro_torch.distributed.collectives import all_gather, all_reduce, chunk
        from repro_torch.train.optimizer import adamw_update

        mesh = self.mesh
        named = dict(params.named_parameters())
        if sorted(named) != self.names:
            raise ValueError("ShardedUpdate: the parameters are not the specs' leaves")
        world = math.prod(mesh.shape.values())
        g_sub, p_sub, sumsq = [], [], None
        for name, g, (zdim, zaxes, _, scatter, held) in zip(self.names, grads, self.plan):
            p = named[name].detach()
            if zaxes:
                g = g if scatter else chunk(g, mesh, zaxes, zdim)
                p = chunk(p, mesh, zaxes, zdim).contiguous()
            g_sub.append(g)
            p_sub.append(p)
            # each block sits on world / held ranks
            sq = torch.sum(torch.square(g.float())) * (held / world)
            sumsq = sq if sumsq is None else sumsq + sq
        gnorm = torch.sqrt(all_reduce(sumsq, mesh, tuple(mesh.axis_names)))
        state = {"step": opt_state["step"],
                 "m": [opt_state["m"][n] for n in self.names],
                 "v": [opt_state["v"][n] for n in self.names]}
        _, new, metrics = adamw_update(g_sub, state, p_sub, opt_cfg, grad_norm=gnorm)
        with torch.no_grad():
            for name, block, (zdim, zaxes, *_) in zip(self.names, p_sub, self.plan):
                if zaxes:
                    named[name].copy_(all_gather(block, mesh, zaxes, zdim))
        return params, dict(opt_state, step=new["step"]), metrics
