"""Batched LM serving on the PyTorch port: the wave-batched engine over a
smoke-size model.

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 6 --slots 3 [--device cpu]

Runs on the CUDA card unless ``--device`` names another; every request
must come back with its ``--new-tokens`` tokens, each in the vocabulary.
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_arch("qwen3-4b").smoke_config
    params = init_params(cfg, device=args.device)
    eng = ServeEngine(params, cfg, num_slots=args.slots, max_len=64)
    for uid in range(args.requests):
        eng.submit(
            Request(uid=uid, prompt=[1 + uid, 2 + uid, 3],
                    max_new_tokens=args.new_tokens)
        )
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done)
    where = str(params.embed.device)
    if params.embed.is_cuda:
        where = torch.cuda.get_device_name(params.embed.device)
    print(f"{len(done)} requests in {eng.waves} waves, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s on {where})")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt {r.prompt} -> {r.output}")
    assert sorted(r.uid for r in done) == list(range(args.requests))
    for r in done:
        assert len(r.output) == args.new_tokens and not r.failed, r
        assert all(0 <= t < cfg.vocab_size for t in r.output), r


if __name__ == "__main__":
    main()
