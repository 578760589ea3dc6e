"""Carry the reference's xDeepFM parameters into the port.

``params_from_jax(tree, cfg)`` takes the pytree of
``repro.models.recsys.xdeepfm.init_params`` with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``; this module imports no
jax) and returns the port's ``ParamTree`` holding the same numbers, leaf
for leaf in the reference's layout. Exact.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.recsys import xdeepfm
from repro_torch.models.tree import ParamTree, empty_tree, load_tree


def params_from_jax(tree: dict, cfg: xdeepfm.XDeepFMConfig, *,
                    device=None) -> ParamTree:
    """The port's xDeepFM parameters holding ``tree``'s numbers, on
    ``device`` (default: the card)."""
    if not isinstance(cfg, xdeepfm.XDeepFMConfig):
        raise TypeError(f"no RecSys model of the port takes a {type(cfg).__name__}")
    params = empty_tree(xdeepfm.param_spec(cfg), resolve_device(device),
                        getattr(torch, cfg.dtype))
    return load_tree(params, tree)
