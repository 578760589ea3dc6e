"""Render roofline, memory and comparison tables from dry-run JSON
records: the port of ``repro/launch/report.py``, with the same tables
from the same record keys. The MFU bound divides by the H100's peak
(``roofline.PEAK_FLOPS``, read when a table is made) and the memory
table asks whether a rank's arguments and temporaries fit the H100's
80 GB. The port's records hold no temporaries (only XLA's compiler
knows them; ``launch/dryrun.py``), so that column reads 0.00 and the
fit is the arguments'.

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun.json
"""
from __future__ import annotations

import json

from repro_torch.launch import roofline as rl

HBM_GB = 80  # H100 SXM5 80GB


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_markdown(path: str, mesh: str = "single") -> str:
    recs = [r for r in json.load(open(path)) if r["mesh"] == mesh]
    lines = [
        "| arch | shape | compute | memory | collective (raw / bf16-wire) "
        "| bottleneck | MFU-bound | useful/total flops |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skip":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skip | — | "
                f"{r['reason'][:58]} |"
            )
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | |")
            continue
        f = r["roofline"]
        coll_bf16 = f.get("collective_s_bf16_wire", f["collective_s"])
        dom = max(f["compute_s"], f["memory_s"], coll_bf16)
        ideal = f["model_flops_total"] / (r["chips"] * rl.PEAK_FLOPS)
        frac = ideal / dom if dom else 0.0
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(f['compute_s'])} | "
            f"{_fmt_s(f['memory_s'])} | {_fmt_s(f['collective_s'])} / "
            f"{_fmt_s(coll_bf16)} | {f['bottleneck']} | {frac:.3f} | "
            f"{f['useful_flops_fraction']:.2f} |"
        )
    return "\n".join(lines)


def memory_markdown(path: str, mesh: str = "single") -> str:
    recs = [
        r for r in json.load(open(path))
        if r["mesh"] == mesh and r["status"] == "ok"
    ]
    lines = [
        f"| arch | shape | args GB/dev | temp GB/dev | fits {HBM_GB}GB H100 |",
        "|---|---|---|---|---|",
    ]
    for r in recs:
        m = r["roofline"]["memory_per_device"]
        a = m.get("argument_size_in_bytes", 0) / 1e9
        t = m.get("temp_size_in_bytes", 0) / 1e9
        alias = m.get("alias_size_in_bytes", 0) / 1e9
        tot = a + t - 0  # aliased buffers reuse argument space
        lines.append(
            f"| {r['arch']} | {r['shape']} | {a:.2f} | {t:.2f} | "
            f"{'yes' if tot <= HBM_GB else 'NO (' + f'{tot:.1f}GB' + ')'} |"
        )
    return "\n".join(lines)


def compare_markdown(base_path: str, opt_path: str, cells) -> str:
    base = {
        (r["arch"], r["shape"], r["mesh"]): r
        for r in json.load(open(base_path))
    }
    opt = {
        (r["arch"], r["shape"], r["mesh"]): r for r in json.load(open(opt_path))
    }
    lines = [
        "| cell | metric | baseline | optimized | gain |",
        "|---|---|---|---|---|",
    ]
    for key in cells:
        b, o = base.get(key), opt.get(key)
        if not (b and o and b["status"] == "ok" and o["status"] == "ok"):
            continue
        for metric in ("collective_s", "compute_s", "memory_s"):
            bb, oo = b["roofline"][metric], o["roofline"][metric]
            gain = bb / oo if oo else float("inf")
            lines.append(
                f"| {key[0]} x {key[1]} ({key[2]}) | {metric} | "
                f"{_fmt_s(bb)} | {_fmt_s(oo)} | {gain:.2f}x |"
            )
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    print(roofline_markdown(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.json"))
