"""LM-family dry-run/arch plumbing shared by the five LM configs: the
port of ``repro/configs/lm_family.py``.

Shapes (per assignment):
  train_4k     seq 4096,   global_batch 256   (train_step)
  prefill_32k  seq 32768,  global_batch 32    (serve prefill forward)
  decode_32k   seq 32768,  global_batch 128   (serve_step, KV cache)
  long_500k    seq 524288, global_batch 1     (serve_step; SWA archs only)

REPRO_OPT_LEVEL=0 gives the reference's baseline schedules; the default
(1) its optimisations, read at the same places: the dense LMs train in
2 microbatches instead of 8, each microbatch's gradients are
reduce-scattered into the moments' ZeRO layout instead of all-reduced
whole, and deepseek-v3's dispatch all-to-all carries fp8
(``configs/deepseek_v3.py``).

``LMArch.build`` gives the ``DryRunSpec`` of one cell: meta-device
parameters (one module per layer) with their specs, and a step that runs
on one rank's blocks (``configs/common.py::shard_args``). The reference
passes ``ShardingRules().for_mesh(mesh)`` to its model; the port's LM
has one layout, ``LM_RULES`` fitted to the mesh, which is that.

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
import os
from dataclasses import dataclass

from repro_torch.configs.common import (
    DryRunSpec,
    ShardedUpdate,
    dp_axes,
    meta,
    zero_spec_tree,
)
from repro_torch.distributed.sharding import PathRules, normalize
from repro_torch.launch import perfmodel as pm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.train.elastic import fit_spec

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


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


def _cache_specs(cfg: TransformerConfig, cache_abs, mesh, batch: int):
    """Cache sharding: batch over (pod, data) when divisible, then kv-heads
    over model when divisible, else the sequence dim over model.
    ``cache_abs``: a tree of dicts whose leaves have ``.shape`` (the full
    stacked caches of ``init_kv_cache``)."""
    dp = dp_axes(mesh)
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


def _batch_spec(dp: tuple) -> tuple:
    return normalize((dp if dp else None, None))


@dataclass
class LMArch:
    name: str
    config: TransformerConfig
    smoke_config: TransformerConfig
    sub_quadratic: bool = False  # SWA/SSM/linear-attn -> can run long_500k
    train_microbatches: int = 8
    moment_dtype: str = "float32"
    family: str = "lm"

    def shapes(self):
        return list(LM_SHAPES)

    def skip_reason(self, shape: str) -> str | None:
        if shape == "long_500k" and not self.sub_quadratic:
            return (
                "full quadratic attention; 500k-token decode excluded per "
                "assignment (run only for SSM/hybrid/sliding-window archs)"
            )
        return None

    def opt_config(self):
        """The AdamW settings of ``build``'s train step."""
        from repro_torch.train.optimizer import AdamWConfig

        return AdamWConfig(moment_dtype=self.moment_dtype)

    def microbatches(self) -> int:
        """The train step's microbatches under ``REPRO_OPT_LEVEL``."""
        nmb = self.train_microbatches
        if int(os.environ.get("REPRO_OPT_LEVEL", "1")) and self.config.moe is None:
            # dense LMs fit larger microbatches; fewer accumulation
            # rounds = fewer cross-replica gradient reductions
            nmb = min(nmb, 2)
        return nmb

    # ------------------------------------------------------------------
    def build(self, shape: str, mesh) -> DryRunSpec:
        """The cell's spec on ``mesh`` (see the module docstring)."""
        import torch

        from repro_torch.distributed.sharding import LM_RULES
        from repro_torch.models.transformer.model import (
            KVCache,
            init_kv_cache,
            init_params,
            loss_fn,
            serve_step,
        )
        from repro_torch.models.transformer.model import forward as lm_forward
        from repro_torch.train.loop import make_train_step
        from repro_torch.train.optimizer import init_opt_state

        info = LM_SHAPES[shape]
        cfg = self.config
        params = init_params(cfg, device="meta")
        pspecs = lm_param_specs(params, cfg, mesh)
        batch, seq = info["batch"], info["seq"]
        dp = dp_axes(mesh)
        n_active = cfg.active_params()
        chips = math.prod(mesh.shape.values())

        if info["kind"] == "train":
            opt_cfg = self.opt_config()
            opt = init_opt_state(params, opt_cfg)
            mspecs = zero_spec_tree(pspecs, params, mesh, dp)
            ospecs = {"step": (), "m": mspecs, "v": mspecs}
            batch_abs = {
                "tokens": meta((batch, seq), torch.int32),
                "labels": meta((batch, seq), torch.int32),
            }
            bspecs = {"tokens": _batch_spec(dp), "labels": _batch_spec(dp)}
            opt_level = int(os.environ.get("REPRO_OPT_LEVEL", "1"))
            nmb = self.microbatches()

            def loss_of(p, b):
                return loss_fn(p, cfg, b, mesh=mesh, rules=LM_RULES, batch_axes=dp)

            step = make_train_step(
                loss_of, opt_cfg, num_microbatches=nmb,
                sharded=ShardedUpdate(mesh, pspecs, mspecs, dp, zero=bool(opt_level)))

            def train_step(params, opt_state, b):
                params, opt_state, _, metrics = step(params, opt_state, None, b)
                return params, opt_state, metrics["loss"]

            return DryRunSpec(
                fn=train_step,
                args=(params, opt, batch_abs),
                in_specs=(pspecs, ospecs, bspecs),
                donate_argnums=(0, 1),
                model_flops_total=6.0 * n_active * batch * seq,
                flops_total=pm.lm_train_flops(cfg, batch, seq),
                hbm_bytes_per_device=pm.lm_train_bytes_per_device(
                    cfg, batch, seq, chips,
                    moment_dtype=self.moment_dtype, microbatches=nmb,
                ),
                note=f"microbatches={nmb} moment_dtype={self.moment_dtype}",
            )

        if info["kind"] == "prefill":
            batch_abs = meta((batch, seq), torch.int32)

            def fwd(params, tokens):
                return lm_forward(params, cfg, tokens, mesh=mesh, batch_axes=dp)

            return DryRunSpec(
                fn=fwd,
                args=(params, batch_abs),
                in_specs=(pspecs, _batch_spec(dp)),
                model_flops_total=2.0 * n_active * batch * seq,
                flops_total=pm.lm_prefill_flops(cfg, batch, seq),
                hbm_bytes_per_device=pm.lm_prefill_bytes_per_device(
                    cfg, batch, seq, chips
                ),
            )

        # decode
        cache_abs = init_kv_cache(cfg, batch, seq, device="meta")
        cspecs = _cache_specs(cfg, cache_abs, mesh, batch)
        dp_size = math.prod(mesh.shape[a] for a in dp) if dp else 1
        bdim = dp if (dp and batch % dp_size == 0 and batch >= dp_size) else None
        tok_abs = meta((batch, 1), torch.int32)

        def step(params, cache, tokens):
            cache = KVCache(cache, cspecs, tuple(bdim or ()), mesh)
            return serve_step(params, cfg, cache, tokens, seq - 1, mesh=mesh,
                              batch_axes=tuple(bdim or ()))

        return DryRunSpec(
            fn=step,
            args=(params, cache_abs, tok_abs),
            in_specs=(pspecs, cspecs, normalize((bdim, None))),
            donate_argnums=(1,),
            model_flops_total=2.0 * n_active * batch,
            flops_total=pm.lm_decode_flops(cfg, batch, seq),
            hbm_bytes_per_device=pm.lm_decode_bytes_per_device(
                cfg, batch, seq, chips
            ),
            note="one decode token against a seq_len KV cache",
        )
