"""End-to-end LM training on the PyTorch port: ~100M-param decoder,
synthetic KISS data, checkpoint/auto-resume, straggler watchdog,
optional grad compression.

    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 50 --device cpu

Kill it mid-run and re-launch: it resumes from the last checkpoint
(under the temporary directory by default). Runs on the CUDA card unless
``--device`` names another; the loss must end finite and below where it
started.
"""
import argparse
import logging
import math
import os
import tempfile

from repro_torch.data.lm import lm_batch
from repro_torch.models.common import count_params
from repro_torch.models.transformer import TransformerConfig, init_params, loss_fn
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.optimizer import AdamWConfig

PRESETS = {
    # ~112M params: the "train a ~100M model" example driver
    "100m": dict(
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=32000, batch=4, seq=256,
    ),
    "10m": dict(
        num_layers=6, d_model=256, num_heads=8, num_kv_heads=4,
        head_dim=32, d_ff=1024, vocab_size=8000, batch=8, seq=128,
    ),
    "tiny": dict(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=1000, batch=8, seq=64,
    ),
}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    cfg = TransformerConfig(
        name=f"lm-{args.preset}",
        num_layers=p["num_layers"], d_model=p["d_model"],
        num_heads=p["num_heads"], num_kv_heads=p["num_kv_heads"],
        head_dim=p["head_dim"], d_ff=p["d_ff"], vocab_size=p["vocab_size"],
        dtype="float32", remat=False,
    )
    params = init_params(cfg, device=args.device)
    print(f"model: {count_params(params)/1e6:.1f}M params")

    def data():
        step = 0
        while True:
            yield lm_batch(p["batch"], p["seq"], cfg.vocab_size, seed=7, step=step)
            step += 1

    opt_cfg = AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 2),
        total_steps=args.steps,
    )
    loop_cfg = LoopConfig(
        total_steps=args.steps,
        checkpoint_every=max(args.steps // 5, 10),
        checkpoint_dir=args.checkpoint_dir,
        log_every=max(args.steps // 30, 1),
        grad_compression=args.grad_compression,
        num_microbatches=args.microbatches,
    )
    _, out = train(
        params, lambda prm, b: loss_fn(prm, cfg, b), data(), opt_cfg, loop_cfg
    )
    h = out["history"]
    if not h:
        print(f"nothing to do: {args.checkpoint_dir} holds a finished run")
        return
    print(
        f"steps {h[0]['step']}..{h[-1]['step']}  "
        f"loss {h[0]['loss']:.3f} -> {out['final_loss']:.3f}  "
        f"slow steps flagged: {len(out['slow_steps'])}"
    )
    assert math.isfinite(out["final_loss"])
    if h[0]["step"] == 0 and len(h) > 1:
        assert out["final_loss"] < h[0]["loss"], "loss did not fall"


if __name__ == "__main__":
    main()
