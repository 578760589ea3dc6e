#!/usr/bin/env python3
"""Time ``repro_torch``'s ``edge_hook`` of one checkout on one CUDA card,
on the calls the CC main path makes.

    python3 tools/edge_hook_ab.py [SRC_DIR]

``SRC_DIR`` is the ``src`` directory of the checkout whose kernel is
timed (by default this checkout's). The script runs
``connected_components`` once on each of ``chip_smoke.py``'s three CC
graphs (giant+dust 2^22; random 2^20 at m/n = 4; dense 2^20 at
m/n = 9, which runs Afforest sampling), records the arguments of every
``edge_hook`` call by wrapping the name ``core/components.py`` calls,
and replays each call with ``chip_smoke.py``'s ``graph_ms``. It prints,
for each cell, the summed device ms of sv2 and of sv3 beside their
summed byte bounds at 3.35 TB/s, and the giant+dust round-1 calls on
their own. Then one probe, built from ``tools/gather_probe.cu``: random
4-byte gathers from a 16 MB table (inside the 50 MB L2) and from a 1 GB
table, in sectors per second. Every line carries the card's name and
power limit. To compare two commits, unpack one beside the other and
run this script on each in turns in one call on the same card: parent,
change, change, parent.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBE_SRC = ROOT / "tools" / "gather_probe.cu"
PROBE_LIB = ROOT / "tools" / "_build" / "gather_probe.so"
PROBE_TABLES = (("16 MB (L2)", 22), ("1 GB (device memory)", 28))  # log2 words
PROBE_THREADS = 1 << 22


def gather_rates(cs, build, card: str) -> None:
    """Print the probe's random-gather rates, one line a table."""
    import torch

    PROBE_LIB.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(PROBE_LIB),
                    str(PROBE_SRC)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(PROBE_LIB))
    lib.gather_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p]
    lib.gather_probe.restype = ctypes.c_int
    lib.gather_probe_per_thread.restype = ctypes.c_int
    per_thread = lib.gather_probe_per_thread()
    out = torch.empty(PROBE_THREADS, dtype=torch.int32, device="cuda")
    for name, log2_words in PROBE_TABLES:
        table = torch.randint(0, 1 << 30, (1 << log2_words,), dtype=torch.int32,
                              device="cuda")

        def launch():
            status = lib.gather_probe(table.data_ptr(), log2_words, out.data_ptr(),
                                      PROBE_THREADS,
                                      torch.cuda.current_stream().cuda_stream)
            cs.check(status == 0, f"gather_probe launch: CUDA error {status}")

        ms = cs.graph_ms(launch)
        gathers = PROBE_THREADS * per_thread
        print(f"edge_hook_ab probe: random 4-byte gathers from a {name} table: "
              f"gathers={gathers} ms={ms} sectors_per_s={gathers / ms * 1e3} "
              f"sector_bytes_per_s={32 * gathers / ms * 1e3} [{card}]", flush=True)
        del table


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("edge_hook_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build

    card = cs.card_line()
    dev = torch.device("cuda")
    build.build(("edge_hook",))
    recorded = cs.record_hook_calls(cs.cc_graphs(), dev)
    for name, calls in recorded.items():
        times = cs.hook_call_times(calls)
        if name == "giant_dust":
            for mode in ("sv2", "sv3"):
                ms, bound = next((t, bd) for md, t, bd in times if md == mode)
                print(f"edge_hook_ab {src} giant_dust round-1 {mode}: ms={ms} "
                      f"bound_ms={bound} share_of_bound={bound / ms} [{card}]",
                      flush=True)
        sums = cs.hook_cell_sums(times)
        total = sum(ms for _, ms, _ in sums.values())
        print(f"edge_hook_ab {src} {name}: " + " ".join(
            f"{mode} calls={k} ms={ms} bound_ms={bound} share_of_bound={bound / ms}"
            for mode, (k, ms, bound) in sorted(sums.items()))
            + f" total_ms={total} [{card}]", flush=True)
        del calls
    del recorded
    torch.cuda.empty_cache()
    gather_rates(cs, build, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
