"""Central metrics registry: one namespace for every engine's counters.

The port's copy of ``repro.obs.metrics`` (host-only, no torch): the
stats dataclasses of the port (``FrontierStats``, ``SplitterStats``)
publish through the same path and under the same counter prefixes as
the reference, so the two packages' snapshots compare key for key.

* **counter** (``inc``): monotone accumulation -- round counts, edge
  visits. Integer-valued fields of published stats objects land here.
* **gauge** (``gauge``): last-write-wins level -- fractions, ratios.
  Float-valued stats fields land here.
* **histogram** (``observe``): distribution summary; ``snapshot()``
  expands it to ``name.count`` / ``name.sum`` / ``name.min`` /
  ``name.max``.

A name is permanently bound to its first kind; reusing it as another
kind raises.

``publish_stats(stats, prefix)`` walks the dataclass fields and maps
bool -> counter (0/1), int -> counter, float -> gauge, ndarray ->
``field.total`` counter (element sum), list/tuple -> ``field.count``
counter, str/None -> skipped. Every mapping is a pure function of the
stats values, so two identical runs produce identical snapshots.

``derived_fragment(snap, prefix)`` renders a snapshot as the
reference's benchmark ``derived`` string (``a=1;b=2.500``), so the
port's serving counters compare with ``BENCH_smoke.json`` as text.
"""
from __future__ import annotations

import dataclasses


class Registry:
    """Counters/gauges/histograms with a flat deterministic snapshot."""

    def __init__(self):
        self._kinds: dict[str, str] = {}
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        # name -> [count, sum, min, max]
        self._hists: dict[str, list[float]] = {}

    def _claim(self, name: str, kind: str) -> None:
        have = self._kinds.setdefault(name, kind)
        if have != kind:
            raise ValueError(
                f"metric {name!r} is already a {have}, not a {kind}; "
                "pick one kind per name"
            )

    def inc(self, name: str, value: float = 1) -> None:
        """Accumulate onto a counter (create at 0)."""
        self._claim(name, "counter")
        self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        """Set a gauge (last write wins)."""
        self._claim(name, "gauge")
        self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Record one sample into a histogram."""
        self._claim(name, "histogram")
        h = self._hists.get(name)
        if h is None:
            self._hists[name] = [1, value, value, value]
        else:
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)

    def snapshot(self) -> dict:
        """Flat ``{name: number}`` in deterministic (sorted) order.
        Histograms expand to ``.count`` / ``.sum`` / ``.min`` /
        ``.max``; values stay int where they accumulated as ints."""
        out: dict = {**self._counters, **self._gauges}
        for name, (cnt, total, lo, hi) in self._hists.items():
            out[f"{name}.count"] = cnt
            out[f"{name}.sum"] = total
            out[f"{name}.min"] = lo
            out[f"{name}.max"] = hi
        return {k: out[k] for k in sorted(out)}

    def reset(self) -> None:
        """Drop all values AND name->kind bindings."""
        self.__init__()


# The process-global registry (callers that need an isolated snapshot,
# such as the tests, build their own ``Registry``).
_GLOBAL = Registry()


def inc(name: str, value: float = 1) -> None:
    _GLOBAL.inc(name, value)


def gauge(name: str, value: float) -> None:
    _GLOBAL.gauge(name, value)


def observe(name: str, value: float) -> None:
    _GLOBAL.observe(name, value)


def snapshot() -> dict:
    return _GLOBAL.snapshot()


def reset() -> None:
    _GLOBAL.reset()


def publish_stats(stats, prefix: str, registry: Registry | None = None,
                  exclude: tuple = ()) -> None:
    """Publish a stats dataclass into a registry under ``prefix``,
    skipping the fields named in ``exclude`` (ids, not quantities).

    The one shared path behind every stats object's ``publish()``
    method; see the module docstring for the field-type mapping."""
    import numpy as np

    reg = registry if registry is not None else _GLOBAL
    for f in dataclasses.fields(stats):
        if f.name in exclude:
            continue
        v = getattr(stats, f.name)
        name = f"{prefix}.{f.name}"
        if v is None or isinstance(v, str):
            continue
        if isinstance(v, bool):
            reg.inc(name, int(v))
        elif isinstance(v, (int, np.integer)):
            reg.inc(name, int(v))
        elif isinstance(v, (float, np.floating)):
            reg.gauge(name, float(v))
        elif isinstance(v, np.ndarray):
            reg.inc(f"{name}.total", float(v.sum()) if v.size else 0.0)
        elif isinstance(v, (list, tuple)):
            reg.inc(f"{name}.count", len(v))


def derived_fragment(snap: dict, prefix: str = "") -> str:
    """Render snapshot entries whose name starts with ``prefix`` as a
    benchmark ``derived`` fragment (``a=1;b=2.500``): sorted by name
    whatever the input order, integral values as ints, other floats to
    three decimals -- the reference's rendering, character for
    character."""
    parts = []
    for k, v in sorted(snap.items()):
        if not k.startswith(prefix):
            continue
        if float(v) == int(v):
            parts.append(f"{k}={int(v)}")
        else:
            parts.append(f"{k}={v:.3f}")
    return ";".join(parts)
