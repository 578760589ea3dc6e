"""Train GAT on a synthetic Cora-shaped graph (full-batch node classes)
on the PyTorch port.

    PYTHONPATH=src python examples/torch_gnn_cora.py --steps 100 [--device cpu]

Labels are planted by a hidden linear model over features so accuracy is
measurable (random = 1/7). Runs on the CUDA card unless ``--device``
names another, where every aggregation is a ``segment_sum`` kernel
launch."""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.graphs import full_graph
from repro_torch.device import resolve_device
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=2708)
    ap.add_argument("--edges", type=int, default=10556)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = get_arch("gat-cora")
    cfg = arch.config_for("full_graph_sm")
    g = full_graph(args.nodes, args.edges, cfg.in_dim, num_classes=cfg.num_classes)
    # plant learnable structure: labels = argmax of a hidden projection
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(cfg.in_dim, cfg.num_classes)).astype(np.float32)
    g["labels"] = np.argmax(g["node_feats"] @ w_true, -1).astype(np.int32)
    g = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
         for k, v in g.items()}

    params = arch.module.init_params(cfg, device=dev)
    opt_cfg = AdamWConfig(lr=5e-3, weight_decay=0.0, warmup_steps=5)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(lambda p, b: arch.module.loss_fn(p, cfg, b), opt_cfg)

    def accuracy():
        with torch.no_grad():
            logits = arch.module.forward(params, cfg, g)
        return float((logits.argmax(-1) == g["labels"]).float().mean())

    for i in range(args.steps):
        params, opt, _, metrics = step(params, opt, None, g)
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:4d}  loss {float(metrics['loss']):.4f}  acc {accuracy():.3f}")
    acc = accuracy()
    print(f"final accuracy {acc:.3f} (random = {1/cfg.num_classes:.3f})")
    assert acc > 2.5 / cfg.num_classes, "model failed to beat random"


if __name__ == "__main__":
    main()
