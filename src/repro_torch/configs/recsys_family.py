"""The RecSys family of the port's registry (xdeepfm): the shape table
and ``RecsysArch`` of ``repro/configs/recsys_family.py``.

Shapes (per assignment):
  train_batch     batch=65,536              (train_step)
  serve_p99       batch=512                 (online inference)
  serve_bulk      batch=262,144             (offline scoring)
  retrieval_cand  batch=1, 1e6 candidates   (retrieval scoring)

The table is copied, not imported: the reference module imports jax.

The embedding table (39 fields x 1e6 rows x dim 10) is row-sharded over
the "model" axis; lookups run through ``ops/sharded_lookup.py``
(partial gather + sum; ``models/recsys/xdeepfm.py`` with ``mesh=``).
Optimizer moments are ZeRO-sharded over the data axes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.common import (
    DryRunSpec,
    ShardedUpdate,
    dp_axes,
    meta,
    zero_spec_tree,
)
from repro_torch.distributed.sharding import normalize
from repro_torch.launch import perfmodel as pm
from repro_torch.models.recsys import xdeepfm as xm

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1),
}


def recsys_param_specs(params, mesh) -> dict:
    """``{parameter name: spec}``: the tables' rows over ``"model"``,
    every other leaf replicated."""
    m = "model" if "model" in mesh.axis_names else None
    return {name: (m, None) if name in ("table", "linear", "cand_embed") else ()
            for name, _ in params.named_parameters()}


@dataclass
class RecsysArch:
    """The RecSys architecture (``models/recsys/xdeepfm.py``): its
    published config and the small one the tests run."""

    name: str
    config: xm.XDeepFMConfig
    smoke_config: xm.XDeepFMConfig
    family: str = "recsys"

    def shapes(self):
        return list(RECSYS_SHAPES)

    def skip_reason(self, shape: str) -> str | None:
        return None

    def opt_config(self):
        """The AdamW settings of ``build``'s train step."""
        from repro_torch.train.optimizer import AdamWConfig

        return AdamWConfig(lr=1e-3, moment_dtype="float32")

    def build(self, shape: str, mesh) -> DryRunSpec:
        """The cell's step on ``mesh`` (see the module docstring)."""
        import torch

        from repro_torch.models.tree import empty_tree
        from repro_torch.train.loop import make_train_step
        from repro_torch.train.optimizer import init_opt_state

        info = RECSYS_SHAPES[shape]
        cfg = self.config
        batch = info["batch"]
        dp = dp_axes(mesh)
        dp_size = math.prod(mesh.shape[a] for a in dp) if dp else 1
        bdim = dp if (dp and batch % dp_size == 0 and batch >= dp_size) else None

        params = empty_tree(xm.param_spec(cfg), "meta", getattr(torch, cfg.dtype))
        pspecs = recsys_param_specs(params, mesh)
        # dense-compute flops per example: CIN + MLP mac counts
        m_f, d_e = cfg.n_fields, cfg.embed_dim
        cin_macs = 0
        h_prev = m_f
        for h in cfg.cin_layers:
            cin_macs += h * h_prev * m_f * d_e
            h_prev = h
        mlp_macs = 0
        d_in = m_f * d_e
        for d_out in cfg.mlp_layers:
            mlp_macs += d_in * d_out
            d_in = d_out
        per_example = 2 * (cin_macs + mlp_macs)
        chips = math.prod(mesh.shape.values())
        ids = meta((batch, cfg.n_fields), torch.int32)

        if info["kind"] == "train":
            opt_cfg = self.opt_config()
            opt = init_opt_state(params, opt_cfg)
            mspecs = zero_spec_tree(pspecs, params, mesh, dp)
            ospecs = {"step": (), "m": mspecs, "v": mspecs}
            batch_abs = {"sparse_ids": ids, "labels": meta((batch,), torch.int32)}
            bspecs = {"sparse_ids": normalize((bdim, None)),
                      "labels": normalize((bdim,))}
            baxes = tuple(bdim or ())

            def loss_of(p, b):
                return xm.loss_fn(p, cfg, b, mesh=mesh, batch_axes=baxes)

            step = make_train_step(
                loss_of, opt_cfg, sharded=ShardedUpdate(mesh, pspecs, mspecs, baxes))

            def train_step(params, opt_state, b):
                params, opt_state, _, metrics = step(params, opt_state, None, b)
                return params, opt_state, metrics["loss"]

            return DryRunSpec(
                fn=train_step,
                args=(params, opt, batch_abs),
                in_specs=(pspecs, ospecs, bspecs),
                donate_argnums=(0, 1),
                model_flops_total=3.0 * per_example * batch,  # fwd+bwd
                flops_total=pm.recsys_step_flops(cfg, batch, train=True),
                hbm_bytes_per_device=pm.recsys_bytes_per_device(
                    cfg, batch, chips, train=True
                ),
            )

        if info["kind"] == "serve":
            def serve(params, b):
                return xm.serve_step(params, cfg, b, mesh=mesh)

            return DryRunSpec(
                fn=serve,
                args=(params, {"sparse_ids": ids}),
                in_specs=(pspecs, {"sparse_ids": normalize((bdim, None))}),
                model_flops_total=float(per_example * batch),
                flops_total=pm.recsys_step_flops(cfg, batch, train=False),
                hbm_bytes_per_device=pm.recsys_bytes_per_device(
                    cfg, batch, chips, train=False
                ),
            )

        # retrieval: 1 query x n_candidates batched dot
        def retrieve(params, b):
            scores, top = xm.serve_retrieval(params, cfg, b, top_k=100, mesh=mesh)
            return top

        flops = 2.0 * cfg.n_candidates * cfg.retrieval_dim + per_example
        cand_bytes = 4.0 * cfg.n_candidates * cfg.retrieval_dim / chips
        return DryRunSpec(
            fn=retrieve,
            args=(params, {"sparse_ids": ids}),
            in_specs=(pspecs, {"sparse_ids": (None, None)}),
            model_flops_total=flops,
            flops_total=flops,
            hbm_bytes_per_device=cand_bytes
            + pm.recsys_bytes_per_device(cfg, batch, chips, train=False),
        )
