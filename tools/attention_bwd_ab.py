#!/usr/bin/env python3
"""Time ``repro_torch``'s ``flash_attention`` backward kernel of one
checkout on one CUDA card, at qwen3-4b's, MLA's or gemma-2b's training
shape.

    python3 tools/attention_bwd_ab.py [--shape {qwen3,mla,mla16,gemma}] [--step]
        [--samples N] [--sdpa] [SRC_DIR]

``SRC_DIR`` is the ``src`` directory of the checkout whose kernel is
timed (by default this checkout's); its kernels are built from its own
``csrc``. ``--shape qwen3`` (the default) is ``chip_smoke.py``'s
``ATTN_BWD_SHAPE`` (B=1, Hq=32, Hkv=8, S=4096, D=128), ``--shape mla``
its ``TRAIN_MLA_ATTN`` (deepseek-v3's MLA: B=1, H=128, S=2048, (D, Dv) =
(192, 128)), ``--shape mla16`` the same with H = 16 (whose K and V, 21
MB, fit L2: against ``mla``, the cost of re-reading them), ``--shape
gemma`` its ``ATTN_BWD_GEMMA_SHAPE`` (gemma-2b: B=1, Hq=8, Hkv=1,
S=4096, D=256); all bf16, causal, with inputs from seed 18. A checkout
whose ``flash_attention_bwd`` takes no ``lse`` (before the forward wrote
one) is called without it. The line gives the device ms of one call by
CUDA events around 20 calls (``--samples`` such figures), each pass's ms
from a profile, the FLOP bound and the card's name and power limit, and
a checksum of the gradients (the sums of |dq|, |dk| and |dv|); with
``--sdpa`` also the backward of SDPA (cuDNN's at MLA's shapes) on the
same inputs. ``--step`` times a training step of ``chip_smoke.py``
instead (host clock around a synchronised ``value_and_grads``, three
after a warm-up), with its launches, the backward passes' device ms in
a profile of one more step and a checksum of the step's gradients (the
sum of every leaf's sum of |grad|): phase 17 (e)'s, deepseek-v3 at full
width cut to its dense layers and the MTP layer at B=1, S=2048, or with
``--shape gemma`` phase 17 (f)'s, gemma-2b at full width and depth at
B=1, S=4096. To
compare two commits, unpack one beside the other and run this script on
each in turns in one call on the same card: parent, change, change,
parent.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", choices=("qwen3", "mla", "mla16", "gemma"), default="qwen3")
    parser.add_argument("--step", action="store_true")
    parser.add_argument("--samples", type=int, default=1)
    parser.add_argument("--sdpa", action="store_true")
    parser.add_argument("src", nargs="?", default=str(ROOT / "src"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attention_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels.flash_attention import flash_attention, ops

    card = cs.card_line()
    dev = torch.device("cuda")
    if args.step:
        gemma = args.shape == "gemma"
        walls, counts, passes, checksum = train_step_ms(cs, dev, gemma)
        what = (f"{cs.TRAIN_GEMMA_ARCH} full depth B=1 S={cs.TRAIN_GEMMA_S}" if gemma else
                f"{cs.TRAIN_MLA_ARCH} dense layers + MTP B=1 S={cs.TRAIN_MLA_S}")
        print(f"attention_bwd_ab step {src}: {what}: wall_ms={walls} launches={counts} "
              f"passes_ms={passes} grad_abs_sum={checksum} [{card}]")
        return 0
    if args.shape in ("mla", "mla16"):
        (b, hq, hkv, s, d), dv = cs.TRAIN_MLA_ATTN, 128
        if args.shape == "mla16":
            hq = hkv = 16
    else:
        shape = cs.ATTN_BWD_GEMMA_SHAPE if args.shape == "gemma" else cs.ATTN_BWD_SHAPE
        (b, hq, hkv, s, d), dv = shape, shape[4]
    gen = torch.Generator(dev).manual_seed(18)
    q, k, v, dout = (torch.randn(b, h, s, w, device=dev, generator=gen).to(torch.bfloat16)
                     for h, w in ((hq, d), (hkv, d), (hkv, dv), (hq, dv)))
    if "lse" in inspect.signature(ops.flash_attention_bwd).parameters:
        out, lse = ops.flash_attention_lse(q, k, v, impl="cuda")
        call = lambda: ops.flash_attention_bwd(q, k, v, out, dout, lse)  # noqa: E731
    else:
        out = flash_attention(q, k, v, impl="cuda")
        call = lambda: ops.flash_attention_bwd(q, k, v, out, dout)  # noqa: E731
    grads = call()
    samples = [cs.cuda_ms(call, iters=20, warmup=3) for _ in range(args.samples)]
    ms = sum(samples) / len(samples)
    _, _, _, ranked, _ = cs.device_share(call, top=20)
    passes = {name[:60]: t for name, t in ranked if "attn_bwd" in name}
    bound, _, _ = cs.attention_bwd_bound_ms(b, hq, hkv, s, s, d, dv, True, None, 2)
    checksum = [float(g.float().abs().sum()) for g in grads]
    library = cs.sdpa_backward_ms(q, k, v, dout) if args.sdpa else None
    print(f"attention_bwd_ab {src}: B={b} Hq={hq} Hkv={hkv} S={s} D={d} Dv={dv} bf16 causal: "
          f"ms={ms} ms_samples={samples} passes_ms={passes} bound_ms={bound} "
          f"share_of_bound={bound / ms} ms_per_head={ms / hq} grad_abs_sums={checksum} "
          f"sdpa_backward_ms={library} [{card}]")
    return 0


def train_step_ms(cs, dev, gemma: bool, repeats: int = 3) -> tuple:
    """``(wall ms of each step, launches of the last, the backward passes'
    device ms in a profile of one more step, the sum of every gradient's
    sum of |grad|)``: phase 17 (e)'s loss-and-gradients step of the
    checkout on the path, or with ``gemma`` phase 17 (f)'s."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.loop import value_and_grads
    from repro_torch.train.tree import trainable

    if gemma:
        cfg = get_arch(cs.TRAIN_GEMMA_ARCH).config
        batch = cs.lm_train_batch(dev, 1, 3, cfg.vocab_size, cs.TRAIN_GEMMA_S)
    else:
        full = get_arch(cs.TRAIN_MLA_ARCH).config
        cfg = dataclasses.replace(full, num_layers=full.num_dense_layers)
        batch = cs.lm_train_batch(dev, 1, 2, cfg.vocab_size, cs.TRAIN_MLA_S)
    params = trainable(init_params(cfg, device=dev,
                                   generator=torch.Generator(dev).manual_seed(0)))
    step_loss = lambda p, b: loss_fn(p, cfg, b)  # noqa: E731
    value_and_grads(step_loss, params, batch)  # warm-up
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        value_and_grads(step_loss, params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = dict(launch_counts)
    try:
        _, _, _, ranked, _ = cs.device_share(
            lambda: value_and_grads(step_loss, params, batch), top=200)
    except RuntimeError as err:  # a profile that lost device records
        print(f"attention_bwd_ab step: passes not measured: {err}")
        ranked = []
    passes = {}
    for name, ms in ranked:
        for tag in ("attn_bwd_dq_", "attn_bwd_dkdv_", "attn_bwd_sum_groups"):
            if tag in name:
                passes[tag.strip("_")] = passes.get(tag.strip("_"), 0.0) + ms
    _, grads = value_and_grads(step_loss, params, batch)
    checksum = sum(float(g.float().abs().sum()) for g in grads)
    return walls, counts, passes, checksum


if __name__ == "__main__":
    sys.exit(main())
