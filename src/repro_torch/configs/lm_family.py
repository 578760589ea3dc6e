"""The LM family's layout on a mesh: the port of ``lm_path_rules`` and
``_cache_specs`` of ``repro/configs/lm_family.py``. The shapes table and
``LMArch.build`` (the dry-run plumbing) wait for ROADMAP queue 1, item
17.

``lm_path_rules`` names the reference's parameter paths (for example
``dense_layers/attn/wq``, stacked along axis 0 for ``lax.scan``).
``lm_param_specs`` maps each onto the port's leaves by the rule
``models/transformer/convert.py`` carries weights across with: the
stack axis is dropped (the port keeps one module per layer), and an
``nn.Linear``'s spec has its two dims swapped (it holds the reference's
``(in, out)`` matrix as ``(out, in)``). Each spec is then fitted to the
mesh (``train/elastic.py::fit_spec``): a dim that does not divide is
replicated.
"""
from __future__ import annotations

import math

from repro_torch.distributed.sharding import PathRules, normalize
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.train.elastic import fit_spec


def lm_path_rules(cfg: TransformerConfig, mesh) -> PathRules:
    m = "model" if "model" in mesh.axis_names else None
    ep = None
    if cfg.moe is not None:
        ep_axes = tuple(a for a in cfg.moe.ep_axes if a in mesh.axis_names)
        if ep_axes and cfg.moe.num_experts % math.prod(
            mesh.shape[a] for a in ep_axes
        ) == 0:
            ep = ep_axes if len(ep_axes) > 1 else ep_axes[0]
    rules = [
        (r"(^|/)embed$", (m, None)),
        (r"(^|/)unembed$", (None, m)),
        (r"mtp_layer/attn/w(q|q_a|q_b|kv_b)$", (None, m)),
        (r"mtp_layer/attn/wo$", (m, None)),
        (r"mtp_layer/ffn/w_(gate|up)$", (None, m)),
        (r"mtp_layer/ffn/w_down$", (m, None)),
        (r"mtp_layer/", ()),  # catch-all: unstacked ranks, keep replicated
        (r"moe/router$", ()),
        (r"moe/w_(gate|up)_shared$", (None, None, m)),
        (r"moe/w_down_shared$", (None, m, None)),
    ]
    if ep is not None:
        rules += [
            (r"moe/w_(gate|up|down)$", (None, ep, None, None)),
        ]
    else:
        # expert-TP layout (Mixtral: 8 experts < 16-wide axis)
        rules += [
            (r"moe/w_(gate|up)$", (None, None, None, m)),
            (r"moe/w_down$", (None, None, m, None)),
        ]
    rules += [
        (r"attn/w(q|k|v|q_a|q_b|kv_b)$", (None, None, m)),
        (r"attn/wo$", (None, m, None)),
        (r"ffn/w_(gate|up)$", (None, None, m)),
        (r"ffn/w_down$", (None, m, None)),
    ]
    return PathRules(rules)


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _cache_specs(cfg: TransformerConfig, cache_abs, mesh, batch: int):
    """Cache sharding: batch over (pod, data) when divisible, then kv-heads
    over model when divisible, else the sequence dim over model.
    ``cache_abs``: a tree of dicts whose leaves have ``.shape`` (the full
    stacked caches of ``init_kv_cache``)."""
    dp = _dp_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp) if dp else 1
    batch_dim = dp if (dp and batch % dp_size == 0 and batch >= dp_size) else None
    msize = mesh.shape.get("model", 1)

    def spec_of(leaf):
        if len(leaf.shape) == 5:  # (L, B, C, hkv, hd)
            heads = leaf.shape[3]
            if heads % msize == 0 and msize > 1:
                return (None, batch_dim, None, "model", None)
            if leaf.shape[2] % msize == 0:
                return (None, batch_dim, "model", None, None)
            return (None, batch_dim, None, None, None)
        # MLA latent: (L, B, C, r)
        if leaf.shape[2] % msize == 0:
            return (None, batch_dim, "model", None)
        return (None, batch_dim, None, None)

    return {g: {k: normalize(spec_of(v)) for k, v in c.items()}
            for g, c in cache_abs.items()}


def _port_leaves(cfg: TransformerConfig):
    """(port parameter name, reference path, stacked, transposed) of every
    leaf of a ``TransformerLM`` for ``cfg``."""
    from repro_torch.models.transformer.convert import _layer_leaves

    out = [("embed", "embed", False, False),
           ("final_norm", "final_norm", False, False)]
    if not cfg.tie_embeddings:
        out.append(("unembed.weight", "unembed", False, True))
    for group, n, use_moe in (
            ("dense_layers", cfg.num_dense_layers_effective(), False),
            ("moe_layers", cfg.num_moe_layers(), True)):
        for i in range(n):
            for path, attr, transpose in _layer_leaves(cfg, use_moe):
                out.append((f"{group}.{i}.{attr}", f"{group}/{'/'.join(path)}",
                            True, transpose))
    if cfg.mtp_depth:
        for path, attr, transpose in _layer_leaves(cfg, False):
            out.append((f"mtp_layer.{attr}", f"mtp_layer/{'/'.join(path)}",
                        False, transpose))
        out.append(("mtp_norm", "mtp_norm", False, False))
    return out


def _port_spec(rules: PathRules, path: str, shape, stacked: bool,
               transposed: bool, mesh) -> tuple:
    """The spec ``rules`` give the reference leaf at ``path``, for the
    port's leaf of ``shape`` (see the module docstring)."""
    spec = tuple(rules.spec_of(path))
    ndim = len(shape) + (1 if stacked else 0)
    spec = (spec + (None,) * ndim)[:ndim]
    if stacked:
        spec = spec[1:]
    if transposed:
        spec = spec[::-1]
    return fit_spec(spec, shape, mesh)


def moe_param_specs(cfg: TransformerConfig, mesh) -> dict:
    """``{attribute: spec}`` of one ``MoE`` block's leaves (an MoE layer's
    ``moe.*``, as ``lm_param_specs`` lays them out): the experts over
    the EP axes when those divide the expert count, else each expert's
    ``d_ff`` over ``"model"``; the shared expert's ``d_ff`` over
    ``"model"``; the router replicated."""
    m, d = cfg.moe, cfg.d_model
    shapes = {"router": (d, m.num_experts), "w_gate": (m.num_experts, d, m.d_ff_expert),
              "w_up": (m.num_experts, d, m.d_ff_expert),
              "w_down": (m.num_experts, m.d_ff_expert, d)}
    if m.num_shared_experts:
        fs = m.d_ff_expert * m.num_shared_experts
        shapes |= {"w_gate_shared": (d, fs), "w_up_shared": (d, fs),
                   "w_down_shared": (fs, d)}
    rules = lm_path_rules(cfg, mesh)
    return {k: _port_spec(rules, f"moe_layers/moe/{k}", sh, True, False, mesh)
            for k, sh in shapes.items()}


def lm_param_specs(params, cfg: TransformerConfig, mesh) -> dict:
    """``{parameter name: spec}`` for every leaf of the ``TransformerLM``
    ``params`` (full shapes; a meta-device model serves), from
    ``lm_path_rules`` as the module docstring says, fitted to the mesh.
    ``sharding.shard_tree(params, specs, mesh)`` then gives this rank's
    blocks."""
    rules = lm_path_rules(cfg, mesh)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    specs = {}
    for name, path, stacked, transposed in _port_leaves(cfg):
        specs[name] = _port_spec(rules, path, shapes[name], stacked, transposed, mesh)
    missing = set(shapes) - set(specs)
    if missing:
        raise ValueError(f"{cfg.name}: no spec for {sorted(missing)}")
    return specs
