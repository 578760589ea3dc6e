"""Carry the reference's LM parameters into the port.

``params_from_jax(tree, cfg)`` takes the pytree of
``repro.models.transformer.init_params`` with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``; this module imports no jax) and
returns a ``TransformerLM`` holding the same numbers. It unstacks the
``dense_layers/*`` arrays (stacked along axis 0 for ``lax.scan``) into
one module per layer and transposes every ``(in, out)`` matrix of the
reference's ``x @ W`` into ``nn.Linear``'s ``(out, in)`` layout. Both
conversions are exact: bfloat16 arrays (``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects) cross as their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.model import TransformerLM, empty_params


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


# Per-layer leaves: (path under dense_layers, module attribute path,
# whether the leaf is an (in, out) matrix to transpose).
_LAYER_LEAVES = (
    (("ln1",), "ln1", False),
    (("ln2",), "ln2", False),
    (("attn", "wq"), "attn.wq.weight", True),
    (("attn", "wk"), "attn.wk.weight", True),
    (("attn", "wv"), "attn.wv.weight", True),
    (("attn", "wo"), "attn.wo.weight", True),
    (("ffn", "w_gate"), "ffn.w_gate.weight", True),
    (("ffn", "w_up"), "ffn.w_up.weight", True),
    (("ffn", "w_down"), "ffn.w_down.weight", True),
)
_QK_NORM_LEAVES = (
    (("attn", "q_norm"), "attn.q_norm", False),
    (("attn", "k_norm"), "attn.k_norm", False),
)


def copy_leaf(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
        raise ValueError(
            f"{name}: reference leaf {tuple(src.shape)} {src.dtype} does not "
            f"fit the port's {tuple(dst.shape)} {dst.dtype}"
        )
    dst.copy_(src)


@torch.no_grad()
def params_from_jax(tree: dict, cfg: TransformerConfig, *,
                    device=None) -> TransformerLM:
    """The port's parameters holding ``tree``'s numbers, on ``device``
    (default: the card)."""
    extra = set(tree) - {"embed", "final_norm", "unembed", "dense_layers"}
    if extra:
        raise NotImplementedError(
            f"{cfg.name}: reference leaves {sorted(extra)} have no "
            "counterpart in repro_torch yet (ROADMAP queue 1, item 15)"
        )
    model = empty_params(cfg, resolve_device(device))
    copy_leaf(model.embed, to_tensor(tree["embed"]), "embed")
    copy_leaf(model.final_norm, to_tensor(tree["final_norm"]), "final_norm")
    if model.unembed is not None:
        copy_leaf(model.unembed.weight, to_tensor(tree["unembed"]).T, "unembed")
    layers = tree["dense_layers"]
    leaves = _LAYER_LEAVES + (_QK_NORM_LEAVES if cfg.qk_norm else ())
    for path, attr, transpose in leaves:
        stacked = layers
        for key in path:
            stacked = stacked[key]
        stacked = to_tensor(stacked)
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(
                f"dense_layers/{'/'.join(path)} stacks {stacked.shape[0]} "
                f"layers; {cfg.name} has {cfg.num_layers}"
            )
        for i, layer in enumerate(model.dense_layers):
            dst = layer.get_parameter(attr)
            src = stacked[i].T if transpose else stacked[i]
            copy_leaf(dst, src, f"dense_layers/{'/'.join(path)}[{i}]")
    return model
