"""State trees of the training slice: nested dicts, lists and tuples of
tensors (or numpy arrays), where an ``nn.Module`` stands for the dict of
its parameters under their dotted names and ``None`` is an empty
subtree, as in JAX's pytrees. Leaves are visited in the reference's
order: a dict's keys sorted, a sequence by index."""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

SEP = "__"  # joins a leaf's path into its checkpoint file name, as the reference


def _children(tree):
    if isinstance(tree, nn.Module):
        return sorted(tree.named_parameters())
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def named_leaves(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` of ``tree``; a path is the tuple of keys
    and indices from the root."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for key, child in children:
        out.extend(named_leaves(child, prefix + (key,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def leaf_name(path: tuple) -> str:
    """The reference's file stem of a leaf: its path's keys joined by
    ``__``."""
    return SEP.join(str(k) for k in path)


def map_tree(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``; a module becomes
    the dict of its mapped parameters."""
    if tree is None:
        return None
    if isinstance(tree, (nn.Module, dict)):
        return {key: map_tree(fn, child) for key, child in _children(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, child) for child in tree)
    return fn(tree)


def like(tree, values: list):
    """``values`` (one a leaf, in ``named_leaves`` order) in ``tree``'s
    structure."""
    it = iter(values)
    out = map_tree(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def trainable(params):
    """``params`` with every floating-point leaf set to require grad, in
    place. The inference builders return parameters that do not; the
    training step calls this on what it is given."""
    for leaf in leaves(params):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            leaf.requires_grad_(True)
    return params


@torch.no_grad()
def copy_into(dst, src) -> None:
    """Copy the leaves of ``src`` into those of ``dst`` (same structure;
    a module's parameters by name), in place, each moved to its
    destination's device and dtype."""
    dst_leaves, src_leaves = named_leaves(dst), named_leaves(src)
    if [p for p, _ in dst_leaves] != [p for p, _ in src_leaves]:
        raise ValueError("copy_into: the two trees have different leaves")
    for (path, d), (_, s) in zip(dst_leaves, src_leaves):
        if tuple(d.shape) != tuple(s.shape):
            raise ValueError(f"{leaf_name(path)}: shape {tuple(s.shape)} != {tuple(d.shape)}")
        d.copy_(torch.as_tensor(s))
