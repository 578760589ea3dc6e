"""Carry the reference's GNN parameters into the port.

``params_from_jax(tree, cfg)`` takes the pytree of
``repro.models.gnn.{gin,gat,egnn,mace}.init_params`` or of
``repro.models.gnn.extra.{gcn,sage,pna}_init`` with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``; this module imports no
jax) and returns the port's parameters holding the same numbers. For
GIN and GAT every ``(in, out)`` matrix of the reference's ``x @ W`` is
transposed into ``nn.Linear``'s ``(out, in)``; the other models keep
the reference's layout in a ``ParamTree`` and are copied leaf for leaf.
All are exact.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn import egnn, extra, gat, gin, mace
from repro_torch.models.transformer.convert import copy_leaf, to_tensor
from repro_torch.models.tree import empty_tree, load_tree

# The models whose parameters are a ParamTree: config type -> its spec.
_TREE_SPECS = {
    extra.GCNConfig: extra.gcn_spec,
    extra.SAGEConfig: extra.sage_spec,
    extra.PNAConfig: extra.pna_spec,
    egnn.EGNNConfig: egnn.param_spec,
    mace.MACEConfig: mace.param_spec,
}

# (reference leaf of each layer, module attribute, transpose?)
_GIN_LEAVES = (
    ("w1", "w1.weight", True),
    ("b1", "w1.bias", False),
    ("w2", "w2.weight", True),
    ("b2", "w2.bias", False),
    ("ln_g", "ln_g", False),
    ("ln_b", "ln_b", False),
    ("eps", "eps", False),
)
_GAT_LEAVES = (
    ("w", "w.weight", True),
    ("a_src", "a_src", False),
    ("a_dst", "a_dst", False),
    ("b", "b", False),
)


def params_from_jax(tree: dict, cfg, *, device=None):
    """The port's ``GIN`` (for a ``GINConfig``), ``GAT`` (for a
    ``GATConfig``) or ``ParamTree`` (for the configs of GCN, SAGE, PNA,
    EGNN and MACE) holding ``tree``'s numbers, on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(
            f"the reference tree has {len(tree['layers'])} layers; "
            f"{cfg.name} has {cfg.num_layers}"
        )
    if type(cfg) in _TREE_SPECS:
        params = empty_tree(_TREE_SPECS[type(cfg)](cfg), dev, getattr(torch, cfg.dtype))
        return load_tree(params, tree)
    if isinstance(cfg, gin.GINConfig):
        model, leaves = gin.empty_params(cfg, dev), _GIN_LEAVES
        copy_leaf(model.head.weight, to_tensor(tree["head_w"]).T, "head_w")
        copy_leaf(model.head.bias, to_tensor(tree["head_b"]), "head_b")
    elif isinstance(cfg, gat.GATConfig):
        model, leaves = gat.empty_params(cfg, dev), _GAT_LEAVES
    else:
        raise TypeError(f"no GNN of the port takes a {type(cfg).__name__}")
    for i, (src, layer) in enumerate(zip(tree["layers"], model.layers)):
        for key, attr, transpose in leaves:
            leaf = to_tensor(src[key])
            copy_leaf(layer.get_parameter(attr), leaf.T if transpose else leaf,
                      f"layers[{i}]/{key}")
    return model
