"""Per-phase summary table for an exported Chrome trace: the port's copy
of ``repro/obs/summarize.py``, with the same table character for
character.

    python -m repro_torch.obs.summarize trace.json
    python -m repro_torch.obs.summarize trace.json --require serve.wave

Reads the ``{"traceEvents": [...]}`` JSON written by
``repro_torch.obs.trace.export_chrome`` (a bare event list also works),
aggregates the complete events (``ph="X"``) by span name, and prints
count / total / mean / max wall time per phase, widest total first --
the quick answer to "where did the time go" without opening Perfetto.

``--require SUBSTR`` (repeatable) exits nonzero unless at least one
complete event's name contains the substring: CI's traced-smoke step
uses it to assert the serve lifecycle spans (wave, retry, bisection
probe) actually appeared in the trace.

Pure stdlib -- no torch, no package imports -- so it runs anywhere the
JSON does.
"""
from __future__ import annotations

import argparse
import json
import sys


def load_events(path: str) -> list[dict]:
    """The event list from a Chrome-trace JSON file (object or list)."""
    with open(path) as f:
        payload = json.load(f)
    events = payload.get("traceEvents") if isinstance(payload, dict) else payload
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents list)")
    return events


def summarize(events: list[dict]) -> list[tuple]:
    """[(name, count, total_us, mean_us, max_us)] sorted by total desc."""
    agg: dict[str, list[float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        dur = float(ev.get("dur", 0.0))
        row = agg.setdefault(ev["name"], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += dur
        row[2] = max(row[2], dur)
    return sorted(
        (
            (name, int(cnt), total, total / cnt, mx)
            for name, (cnt, total, mx) in agg.items()
        ),
        key=lambda r: -r[2],
    )


def format_table(rows: list[tuple]) -> str:
    if not rows:
        return "(no complete spans in trace)"
    w = max(len(r[0]) for r in rows)
    lines = [
        f"{'span':<{w}}  {'count':>7}  {'total_ms':>10}  "
        f"{'mean_us':>10}  {'max_us':>10}"
    ]
    for name, cnt, total, mean, mx in rows:
        lines.append(
            f"{name:<{w}}  {cnt:>7}  {total / 1e3:>10.3f}  "
            f"{mean:>10.1f}  {mx:>10.1f}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.summarize", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("trace", help="Chrome-trace JSON from trace.export_chrome")
    ap.add_argument(
        "--require", action="append", default=[], metavar="SUBSTR",
        help="fail unless a complete span name contains SUBSTR "
             "(repeatable; CI's traced-smoke assertion)",
    )
    args = ap.parse_args(argv)

    events = load_events(args.trace)
    rows = summarize(events)
    print(format_table(rows))
    n_inst = sum(1 for ev in events if ev.get("ph") == "i")
    print(f"# {len(rows)} phases, {sum(r[1] for r in rows)} spans, "
          f"{n_inst} instant events")
    missing = [
        s for s in args.require if not any(s in r[0] for r in rows)
    ]
    if missing:
        print(f"# REQUIRE FAIL: no span matching {missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
