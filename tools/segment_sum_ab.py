#!/usr/bin/env python3
"""Time ``repro_torch``'s ``segment_sum_sorted`` of one checkout on one
CUDA card, at the GNN path's shapes.

    python3 tools/segment_sum_ab.py [SRC_DIR]

``SRC_DIR`` is the ``src`` directory of the checkout whose kernel is
timed (by default this checkout's). The ids are sorted uniform draws
over ogb_products' 2,449,029 nodes for its 61,859,140 edges (the
distribution of ``full_graph``'s destinations, without its 20-38 s
host build), ``chip_smoke.py``'s power-law ids and its hub case, all
from seed 0; the timing is ``chip_smoke.py``'s ``graph_ms``. Each line
gives the device ms of one call, the byte bound at 3.35 TB/s and the
card's name and power limit. To compare two commits, unpack one beside
the other and run this script on each in turns in one call on the same
card: parent, change, change, parent.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("segment_sum_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    sys.path.insert(0, str(src))
    from repro_torch.kernels.segment_sum import segment_sum_sorted

    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    uniform = torch.randint(0, cs.GNN_N, (cs.GNN_M,), device=dev, generator=gen)
    uniform = uniform.sort().values.int()
    power = cs.power_law_ids(dev, gen)
    hub, hub_data = cs.hub_case(dev, gen)
    cases = (("uniform (m, 100)", uniform, cs.GNN_N, (100,)),
             ("uniform (m, 64)", uniform, cs.GNN_N, (64,)),
             ("uniform (m, 8)", uniform, cs.GNN_N, (8,)),
             ("uniform (m, 1, 47)", uniform, cs.GNN_N, (1, 47)),
             ("uniform (m, 1)", uniform, cs.GNN_N, (1,)),
             ("power-law (m, 64)", power, cs.GNN_N, (64,)),
             ("hub (2^22, 64)", hub, cs.HUB_N, (64,)))
    for name, ids, n, feat in cases:
        data = (hub_data if ids is hub
                else torch.randn((ids.shape[0], *feat), device=dev, generator=gen))
        m, d, s = data.shape[0], data[0].numel(), data.element_size()
        skewed = name.startswith(("power", "hub"))
        ms = cs.graph_ms(lambda: segment_sum_sorted(data, ids, n, impl="cuda"),
                         calls=2 if skewed else 10, replays=2 if skewed else 3)
        bound = (m * d * s + 4 * m + n * d * s + 4 * (n + 1)) / cs.HBM_BYTES_PER_S * 1e3
        print(f"segment_sum_ab {src} {name}: ms={ms} bound_ms={bound} "
              f"share_of_bound={bound / ms} [{card}]", flush=True)
        del data
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
