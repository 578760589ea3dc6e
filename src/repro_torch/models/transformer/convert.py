"""Carry the reference's LM parameters into the port.

``params_from_jax(tree, cfg)`` takes the pytree of
``repro.models.transformer.init_params`` with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``; this module imports no jax) and
returns a ``TransformerLM`` holding the same numbers. It unstacks the
``dense_layers/*`` and ``moe_layers/*`` arrays (stacked along axis 0 for
``lax.scan``) into one module per layer, copies ``mtp_layer`` and
``mtp_norm``, and transposes every ``(in, out)`` matrix of the
reference's ``x @ W`` that the port holds as an ``nn.Linear`` into its
``(out, in)`` layout; the MoE leaves keep the reference's layouts. Both
conversions are exact: bfloat16 arrays (``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects) cross as their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.model import TransformerLM, empty_params

_TOP_LEVEL = {"embed", "final_norm", "unembed", "dense_layers", "moe_layers",
              "mtp_layer", "mtp_norm"}


def to_tensor(a) -> torch.Tensor:
    """A numpy array (float32, or bfloat16 from ``ml_dtypes``) as a CPU
    tensor of the same dtype and bits."""
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        # jax hands out read-only buffers; np.ascontiguousarray would
        # also turn a 0-d leaf (GIN's eps) into a 1-d one.
        a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _layer_leaves(cfg: TransformerConfig, use_moe: bool) -> list:
    """One layer's leaves: (path in the reference's layer tree, attribute
    path in the port's ``DecoderLayer``, whether the leaf is an (in, out)
    matrix to transpose)."""
    leaves = [(("ln1",), "ln1", False), (("ln2",), "ln2", False)]
    if cfg.attention == "mla":
        attn = (["wq_a", "wq_b"] if cfg.q_lora_rank else ["wq"]) + [
            "wkv_a", "wkv_b", "wo"]
        norms = (["q_norm"] if cfg.q_lora_rank else []) + ["kv_norm"]
    else:
        attn = ["wq", "wk", "wv", "wo"]
        norms = ["q_norm", "k_norm"] if cfg.qk_norm else []
    leaves += [(("attn", w), f"attn.{w}.weight", True) for w in attn]
    leaves += [(("attn", g), f"attn.{g}", False) for g in norms]
    if use_moe:
        moe = ["router", "w_gate", "w_up", "w_down"]
        if cfg.moe.num_shared_experts:
            moe += ["w_gate_shared", "w_up_shared", "w_down_shared"]
        leaves += [(("moe", w), f"moe.{w}", False) for w in moe]
    else:
        leaves += [(("ffn", w), f"ffn.{w}.weight", True)
                   for w in ("w_gate", "w_up", "w_down")]
    return leaves


def copy_leaf(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
        raise ValueError(
            f"{name}: reference leaf {tuple(src.shape)} {src.dtype} does not "
            f"fit the port's {tuple(dst.shape)} {dst.dtype}"
        )
    dst.copy_(src)


def _leaf(tree: dict, path: tuple) -> torch.Tensor:
    for key in path:
        tree = tree[key]
    return to_tensor(tree)


def _copy_layers(layers, tree: dict, group: str, cfg, use_moe: bool) -> None:
    """Unstack the reference's ``tree[group]`` into the modules of
    ``layers``."""
    for path, attr, transpose in _layer_leaves(cfg, use_moe):
        name = f"{group}/{'/'.join(path)}"
        stacked = _leaf(tree[group], path)
        if stacked.shape[0] != len(layers):
            raise ValueError(
                f"{name} stacks {stacked.shape[0]} layers; {cfg.name} has "
                f"{len(layers)}"
            )
        for i, layer in enumerate(layers):
            src = stacked[i].T if transpose else stacked[i]
            copy_leaf(layer.get_parameter(attr), src, f"{name}[{i}]")


@torch.no_grad()
def params_from_jax(tree: dict, cfg: TransformerConfig, *,
                    device=None) -> TransformerLM:
    """The port's parameters holding ``tree``'s numbers, on ``device``
    (default: the card)."""
    extra = set(tree) - _TOP_LEVEL
    if extra:
        raise ValueError(f"{cfg.name}: unknown reference leaves {sorted(extra)}")
    model = empty_params(cfg, resolve_device(device))
    copy_leaf(model.embed, to_tensor(tree["embed"]), "embed")
    copy_leaf(model.final_norm, to_tensor(tree["final_norm"]), "final_norm")
    if model.unembed is not None:
        copy_leaf(model.unembed.weight, to_tensor(tree["unembed"]).T, "unembed")
    for group, use_moe in (("dense_layers", False), ("moe_layers", True)):
        layers = getattr(model, group)
        if len(layers) or group in tree:
            _copy_layers(layers, tree, group, cfg, use_moe)
    if model.mtp_layer is not None:
        for path, attr, transpose in _layer_leaves(cfg, False):
            src = _leaf(tree["mtp_layer"], path)
            copy_leaf(model.mtp_layer.get_parameter(attr),
                      src.T if transpose else src, f"mtp_layer/{'/'.join(path)}")
        copy_leaf(model.mtp_norm, to_tensor(tree["mtp_norm"]), "mtp_norm")
    return model
