"""Parameters laid out as the reference's pytrees.

The GNNs of ``models/gnn/{extra,egnn,mace}.py`` and xDeepFM keep their
parameters in a ``ParamTree``: an ``nn.Module`` addressed like the
reference's nested dicts and lists (``params["layers"][0]["w"]``), each
matrix in the reference's ``(in, out)`` layout, so a forward reads as
the reference's and ``load_tree`` carries the reference's weights in
without a transpose.

A spec is a dict whose values are shapes (tuples), ``None`` (a leaf the
reference sets to ``None``), nested dicts, or lists of either.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import he_init
from repro_torch.models.transformer.convert import copy_leaf, to_tensor


class ParamTree(nn.Module):
    """Nested parameters under the reference's keys. A list of shapes is
    an ``nn.ParameterList``, a list of dicts an ``nn.ModuleList`` of
    trees; ``None`` stays ``None``."""

    def __init__(self, spec: dict, *, dtype=torch.float32):
        super().__init__()
        self._keys = tuple(spec)
        for key, leaf in spec.items():
            self._add(key, leaf, dtype)

    def _add(self, key, leaf, dtype):
        if leaf is None:
            object.__setattr__(self, key, None)
        elif isinstance(leaf, dict):
            self.add_module(key, ParamTree(leaf, dtype=dtype))
        elif isinstance(leaf, list):
            if all(isinstance(x, dict) for x in leaf):
                self.add_module(key, nn.ModuleList(
                    ParamTree(x, dtype=dtype) for x in leaf))
            else:
                self.add_module(key, nn.ParameterList(
                    nn.Parameter(torch.empty(x, dtype=dtype)) for x in leaf))
        else:
            self.register_parameter(
                key, nn.Parameter(torch.empty(tuple(leaf), dtype=dtype)))

    def __getitem__(self, key):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def keys(self):
        return self._keys


def empty_tree(spec: dict, device, dtype=torch.float32) -> ParamTree:
    """A ``ParamTree`` with uninitialised storage on ``device``, outside
    autograd (the models of this slice are inference)."""
    with torch.device("meta"):
        tree = ParamTree(spec, dtype=dtype)
    return tree.to_empty(device=device).requires_grad_(False)


def generator_on(generator: torch.Generator | None, device) -> torch.Generator:
    """``generator``, or one seeded with 0 on ``device``."""
    return generator if generator is not None else torch.Generator(device).manual_seed(0)


@torch.no_grad()
def he_or_zero(params: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's init of an MLP stack: every 2-D leaf He-truncated
    normal with its first dimension as the fan-in (an ``(in, out)``
    matrix), every other leaf zero. Same distribution as the reference,
    other numbers."""
    for p in params.parameters():
        if p.dim() == 2:
            p.copy_(he_init(generator, p.shape, p.shape[0], p.dtype))
        else:
            p.zero_()
    return params


@torch.no_grad()
def load_tree(params: ParamTree, tree: dict, where: str = "") -> ParamTree:
    """Copy the reference's pytree (numpy leaves) into ``params``, leaf by
    leaf; raises where a key, a length, a shape or a dtype differs."""
    if set(tree) != set(params.keys()):
        raise ValueError(
            f"{where or 'tree'}: reference keys {sorted(tree)} are not the "
            f"port's {sorted(params.keys())}"
        )
    for key in params.keys():
        dst, src, name = params[key], tree[key], f"{where}{key}"
        if dst is None or src is None:
            if (dst is None) != (src is None):
                raise ValueError(f"{name}: None in one tree only")
        elif isinstance(dst, (nn.ModuleList, nn.ParameterList)):
            if len(dst) != len(src):
                raise ValueError(
                    f"{name}: the reference has {len(src)} entries, the port "
                    f"{len(dst)}"
                )
            for i, (d, s) in enumerate(zip(dst, src)):
                if isinstance(d, ParamTree):
                    load_tree(d, s, f"{name}[{i}]/")
                else:
                    copy_leaf(d, to_tensor(s), f"{name}[{i}]")
        elif isinstance(dst, ParamTree):
            load_tree(dst, src, f"{name}/")
        else:
            copy_leaf(dst, to_tensor(src), name)
    return params
