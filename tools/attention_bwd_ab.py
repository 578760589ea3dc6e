#!/usr/bin/env python3
"""Time ``repro_torch``'s ``flash_attention`` backward kernel of one
checkout on one CUDA card, at qwen3-4b's training shape.

    python3 tools/attention_bwd_ab.py [SRC_DIR]

``SRC_DIR`` is the ``src`` directory of the checkout whose kernel is
timed (by default this checkout's); its kernels are built from its own
``csrc``. The shape is ``chip_smoke.py``'s ``ATTN_BWD_SHAPE`` (B=1,
Hq=32, Hkv=8, S=4096, D=128, bf16, causal) with inputs from seed 18; a
checkout whose ``flash_attention_bwd`` takes no ``lse`` (before the
forward wrote one) is called without it. The line gives the device ms
of one call by CUDA events around 20 calls, each pass's ms from a
profile, the FLOP bound and the card's name and power limit, and a
checksum of the gradients. To compare two commits, unpack one beside
the other and run this script on each in turns in one call on the same
card: parent, change, change, parent.
"""
from __future__ import annotations

import inspect
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    sys.path.insert(0, str(src))
    from repro_torch.kernels.flash_attention import flash_attention, ops

    card = cs.card_line()
    dev = torch.device("cuda")
    b, hq, hkv, s, d = cs.ATTN_BWD_SHAPE
    gen = torch.Generator(dev).manual_seed(18)
    q, k, v, dout = (torch.randn(b, h, s, d, device=dev, generator=gen).to(torch.bfloat16)
                     for h in (hq, hkv, hkv, hq))
    if "lse" in inspect.signature(ops.flash_attention_bwd).parameters:
        out, lse = ops.flash_attention_lse(q, k, v, impl="cuda")
        call = lambda: ops.flash_attention_bwd(q, k, v, out, dout, lse)  # noqa: E731
    else:
        out = flash_attention(q, k, v, impl="cuda")
        call = lambda: ops.flash_attention_bwd(q, k, v, out, dout)  # noqa: E731
    grads = call()
    ms = cs.cuda_ms(call, iters=20, warmup=3)
    _, _, _, ranked, _ = cs.device_share(call, top=20)
    passes = {name[:60]: t for name, t in ranked if "attn_bwd" in name}
    bound, _, _ = cs.attention_bwd_bound_ms(b, hq, hkv, s, s, d, d, True, None, 2)
    checksum = [float(g.float().abs().sum()) for g in grads]
    print(f"attention_bwd_ab {src}: B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16 causal: "
          f"ms={ms} passes_ms={passes} bound_ms={bound} share_of_bound={bound / ms} "
          f"grad_abs_sums={checksum} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
