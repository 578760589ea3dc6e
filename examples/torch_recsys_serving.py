"""xDeepFM on the PyTorch port: brief training then batched CTR serving +
1-vs-100k retrieval.

    PYTHONPATH=src python examples/torch_recsys_serving.py --steps 60 [--device cpu]

Runs on the CUDA card unless ``--device`` names another; the scores must
be probabilities and the retrieval's ids candidates.
"""
import argparse
import math
import time

import torch

from repro_torch.data.recsys import recsys_batch
from repro_torch.device import resolve_device
from repro_torch.models.recsys.xdeepfm import (
    XDeepFMConfig,
    init_params,
    loss_fn,
    serve_retrieval,
    serve_step,
)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = XDeepFMConfig(
        n_fields=16, vocab_per_field=50_000, embed_dim=10,
        cin_layers=(64, 64), mlp_layers=(128, 128),
        retrieval_dim=32, n_candidates=100_000,
    )
    params = init_params(cfg, device=dev)
    opt_cfg = AdamWConfig(lr=2e-3, weight_decay=0.0, warmup_steps=5)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(lambda p, b: loss_fn(p, cfg, b), opt_cfg)

    for i in range(args.steps):
        raw = recsys_batch(args.batch, cfg.n_fields, cfg.vocab_per_field,
                           seed=1, step=i)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        params, opt, _, metrics = step(params, opt, None, batch)
        if i % max(args.steps // 6, 1) == 0:
            print(f"step {i:4d}  bce {float(metrics['loss']):.4f}")
        assert math.isfinite(float(metrics["loss"]))

    # --- online serving (p99-style small batch) ---
    raw = recsys_batch(256, cfg.n_fields, cfg.vocab_per_field, seed=2)
    b = {"sparse_ids": torch.from_numpy(raw["sparse_ids"]).to(dev)}
    with torch.no_grad():
        scores = serve_step(params, cfg, b)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(20):
            serve_step(params, cfg, b)
        _sync(dev)
        dt = (time.perf_counter() - t0) / 20
        print(f"serve batch=256: {dt*1e3:.2f} ms/batch "
              f"({256/dt:,.0f} scores/s), score range "
              f"[{float(scores.min()):.3f}, {float(scores.max()):.3f}]")
        assert bool(((scores >= 0) & (scores <= 1)).all())

        # --- retrieval: one query against n_candidates ---
        q = {"sparse_ids": b["sparse_ids"][:1]}
        t0 = time.perf_counter()
        _scores, (vals, idx) = serve_retrieval(params, cfg, q, top_k=10)
        _sync(dev)
        dt = time.perf_counter() - t0
    print(f"retrieval over {cfg.n_candidates:,} candidates: {dt*1e3:.1f} ms; "
          f"top-3 ids {idx[:3].tolist()}")
    assert bool(((idx >= 0) & (idx < cfg.n_candidates)).all())
    assert bool((vals[:-1] >= vals[1:]).all())


if __name__ == "__main__":
    main()
