#!/usr/bin/env python3
"""Time ``repro_torch``'s ``flash_attention`` forward kernel of one
checkout on one CUDA card, at the prefill shapes of the main path.

    python3 tools/attention_fwd_ab.py [--shapes qwen3,mla,mixtral,gemma] [--sdpa] [SRC_DIR]

``SRC_DIR`` is the ``src`` directory of the checkout whose kernel is
timed (by default this checkout's); its kernels are built from its own
``csrc``. Shapes, bf16, causal, on the models' transposed ``(B, S, H,
D)`` layout, inputs from seed 18: ``qwen3`` qwen3-4b's prefill (B=2,
Hq=32, Hkv=8, S=4096, D=128), ``mla`` deepseek-v3's MLA prefill (B=1,
H=128, S=4096, (D, Dv) = (192, 128), ``chip_smoke.py``'s ``mla_qkv``),
``mla16`` the same at H=16 (whose K and V, 42 MB, about fit the 50 MB
L2), ``mixtral`` mixtral-8x7b's windowed prefill (B=1, Hq=32, Hkv=8,
S=8192, D=128, window 4096), ``gemma`` gemma-2b's (B=1, Hq=8, Hkv=1,
S=4096, D=256). ``--sdpa`` also times PyTorch's SDPA on the first
backend that takes each shape. Each line gives the device ms of one call
(``chip_smoke.py``'s ``graph_ms``), ms per query head, the bound, a
checksum of the output and the card's name and power limit. To compare
two commits, unpack one beside the other and run this script on each in
turns in one call on the same card: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name -> (B, Hq, Hkv, S, D, Dv, window)
SHAPES = {
    "qwen3": (2, 32, 8, 4096, 128, 128, None),
    "mla": (1, 128, 128, 4096, 192, 128, None),
    "mla16": (1, 16, 16, 4096, 192, 128, None),
    "mixtral": (1, 32, 8, 8192, 128, 128, 4096),
    "gemma": (1, 8, 1, 4096, 256, 256, None),
}


def operands(cs, dev, gen, b, hq, hkv, s, d, dv):
    """q, k, v as the models hand them to the kernel: transposed views of
    (B, S, H, D) tensors (MLA's v a column slice of its expansion)."""
    import torch

    if d != dv:
        return cs.mla_qkv(dev, gen, s, hq)
    return tuple(torch.randn(b, s, h, d, device=dev, generator=gen).to(torch.bfloat16)
                 .transpose(1, 2) for h in (hq, hkv, hkv))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", default="qwen3,mla,mixtral,gemma")
    parser.add_argument("--sdpa", action="store_true")
    parser.add_argument("src", nargs="?", default=str(ROOT / "src"))
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    if not torch.cuda.is_available():
        print("attention_fwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels.flash_attention import flash_attention

    card = cs.card_line()
    dev = torch.device("cuda")
    for name in args.shapes.split(","):
        b, hq, hkv, s, d, dv, window = SHAPES[name]
        gen = torch.Generator(dev).manual_seed(18)
        q, k, v = operands(cs, dev, gen, b, hq, hkv, s, d, dv)
        call = lambda: flash_attention(q, k, v, window=window, impl="cuda")  # noqa: E731
        ms = cs.graph_ms(call)
        bound, _, _ = cs.attention_bound_ms(b, hq, hkv, s, s, d, True, window, 2, dv=dv)
        checksum = float(call().float().abs().sum())
        sdpa = ""
        if args.sdpa:
            backend = cs.sdpa_backend(q, k, v) if window is None else None
            if backend is not None:
                def lib():
                    with sdpa_kernel([backend]):
                        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=hq != hkv)
                sdpa = f" sdpa_ms={cs.graph_ms(lib)} ({backend.name})"
        print(f"attention_fwd_ab {src} {name}: B={b} Hq={hq} Hkv={hkv} S={s} D={d} Dv={dv} "
              f"window={window} bf16 causal: ms={ms} "
              f"ms_per_head={ms / (b * hq)} bound_ms={bound} share_of_bound={bound / ms}"
              f"{sdpa} abs_sum={checksum} [{card}]", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
