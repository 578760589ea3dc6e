#!/usr/bin/env python3
"""Time ``repro_torch``'s ``segment_sum_sorted`` of one checkout on one
CUDA card, at the GNN path's shapes, the MoE combines' or the other
wide rows of the main path.

    python3 tools/segment_sum_ab.py [--shape {gnn,moe,wide}] [SRC_DIR]

``SRC_DIR`` is the ``src`` directory of the checkout whose kernel is
timed (by default this checkout's). ``--shape gnn`` (the default): the
ids are sorted uniform draws over ogb_products' 2,449,029 nodes for its
61,859,140 edges (the distribution of ``full_graph``'s destinations,
without its 20-38 s host build), ``chip_smoke.py``'s power-law ids and
its hub case, all from seed 0. ``--shape moe``: the combines of
``chip_smoke.py``'s ``MOE_COMBINES`` (mixtral-8x7b's (16,384 x 4,096)
and deepseek-v3's (32,768 x 7,168), bf16, ``top_k`` rows a token), the
same bytes as deepseek-v3's cut into rows of 128 columns (each row's 56
pieces under its id: one contiguous stream of narrow rows), and 7,167
columns (a bf16 row stride that is not a multiple of 16 bytes).
``--shape wide``: the other main-path sums of rows wider than 128
columns, on ``molecule_batch(4096)``: MACE's l = 1 and l = 2 messages
(m, 128, 3) and (m, 128, 5) over the edges and gin-tu's graph readout
(nodes, 320) over the graph ids, float32. The timing is
``chip_smoke.py``'s ``graph_ms``. Each line gives the device ms of one
call, the byte bound at 3.35 TB/s, ``torch.segment_reduce``'s ms
(``--shape moe`` and ``wide``), a checksum of the output and the card's
name and power limit. To compare two commits, unpack one beside
the other and run this script on each in turns in one call on the same
card: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDE_PIECES = 56  # deepseek-v3's 7,168 columns as rows of 128


def gnn_cases(cs, dev, gen):
    import torch

    uniform = torch.randint(0, cs.GNN_N, (cs.GNN_M,), device=dev, generator=gen)
    uniform = uniform.sort().values.int()
    power = cs.power_law_ids(dev, gen)
    hub, hub_data = cs.hub_case(dev, gen)
    for name, ids, n, feat in (("uniform (m, 100)", uniform, cs.GNN_N, (100,)),
                               ("uniform (m, 64)", uniform, cs.GNN_N, (64,)),
                               ("uniform (m, 8)", uniform, cs.GNN_N, (8,)),
                               ("uniform (m, 1, 47)", uniform, cs.GNN_N, (1, 47)),
                               ("uniform (m, 1)", uniform, cs.GNN_N, (1,)),
                               ("power-law (m, 64)", power, cs.GNN_N, (64,)),
                               ("hub (2^22, 64)", hub, cs.HUB_N, (64,))):
        data = (hub_data if ids is hub
                else torch.randn((ids.shape[0], *feat), device=dev, generator=gen))
        yield name, data, ids, n, name.startswith(("power", "hub"))


def moe_cases(cs, dev, gen):
    import torch

    bf = torch.bfloat16
    for name, t, k, d in cs.MOE_COMBINES:
        ids = cs.combine_ids(dev, t, k)
        data = torch.randn(t * k, d, device=dev, generator=gen).to(bf)
        yield f"{name} combine ({t * k}, {d}) bf16, {k} rows a token", data, ids, t, False
        if d == WIDE_PIECES * 128:
            yield (f"{name} combine's bytes as ({t * k * WIDE_PIECES}, 128) rows",
                   data.view(-1, 128), ids.repeat_interleave(WIDE_PIECES), t, False)
            del data
            data = torch.randn(t * k, d - 1, device=dev, generator=gen).to(bf)
            yield f"{name} combine ids, ({t * k}, {d - 1}) bf16", data, ids, t, False


def wide_cases(cs, dev, gen):
    import torch

    from repro_torch.data.graphs import molecule_batch

    mol = molecule_batch(cs.MOLECULE_BIG)
    dst = torch.from_numpy(mol["dst"]).to(dev)
    gids = torch.from_numpy(mol["graph_ids"]).to(dev)
    n_nodes = len(mol["graph_ids"])
    what = f"molecule({cs.MOLECULE_BIG})"
    for name, ids, n, feat in ((f"{what} mace A l=1 (m, 128, 3)", dst, n_nodes, (128, 3)),
                               (f"{what} mace A l=2 (m, 128, 5)", dst, n_nodes, (128, 5)),
                               (f"{what} gin-tu readout (nodes, 320)", gids,
                                cs.MOLECULE_BIG, (320,))):
        yield name, torch.randn((ids.shape[0], *feat), device=dev, generator=gen), ids, n, False


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", choices=("gnn", "moe", "wide"), default="gnn")
    parser.add_argument("src", nargs="?", default=str(ROOT / "src"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("segment_sum_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels.segment_sum import segment_sum_sorted

    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    cases = {"gnn": gnn_cases, "moe": moe_cases, "wide": wide_cases}[args.shape]
    for name, data, ids, n, skewed in cases(cs, dev, gen):
        m, d, s = data.shape[0], data[0].numel(), data.element_size()
        ms = cs.graph_ms(lambda: segment_sum_sorted(data, ids, n, impl="cuda"),
                         calls=2 if skewed else 10, replays=2 if skewed else 3)
        bound = (m * d * s + 4 * m + n * d * s + 4 * (n + 1)) / cs.HBM_BYTES_PER_S * 1e3
        checksum = float(segment_sum_sorted(data, ids, n, impl="cuda").float().abs().sum())
        lib = ""
        if args.shape != "gnn":
            flat, lengths = data.view(m, d), torch.bincount(ids.long(), minlength=n)
            lib_ms = cs.cuda_ms(lambda: torch.segment_reduce(flat, "sum", lengths=lengths),
                                iters=5, warmup=1)
            lib = f" segment_reduce_ms={lib_ms}"
        print(f"segment_sum_ab {src} {name}: ms={ms} bound_ms={bound} "
              f"share_of_bound={bound / ms}{lib} abs_sum={checksum} [{card}]", flush=True)
        del data
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
