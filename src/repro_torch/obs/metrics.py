"""Central metrics registry: one namespace for every engine's counters.

The port's copy of ``repro.obs.metrics`` (host-only, no torch): the
stats dataclasses of the port (``FrontierStats``, ``SplitterStats``)
publish through the same path and under the same counter prefixes as
the reference, so the two packages' snapshots compare key for key.

* **counter** (``inc``): monotone accumulation -- round counts, edge
  visits. Integer-valued fields of published stats objects land here.
* **gauge** (``gauge``): last-write-wins level -- fractions, ratios.
  Float-valued stats fields land here.

A name is permanently bound to its first kind; reusing it as another
kind raises.

``publish_stats(stats, prefix)`` walks the dataclass fields and maps
bool -> counter (0/1), int -> counter, float -> gauge, ndarray ->
``field.total`` counter (element sum), list/tuple -> ``field.count``
counter, str/None -> skipped. Every mapping is a pure function of the
stats values, so two identical runs produce identical snapshots.
"""
from __future__ import annotations

import dataclasses


class Registry:
    """Counters and gauges with a flat deterministic snapshot."""

    def __init__(self):
        self._kinds: dict[str, str] = {}
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}

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

    def snapshot(self) -> dict:
        """Flat ``{name: number}`` in deterministic (sorted) order;
        values stay int where they accumulated as ints."""
        out: dict = {**self._counters, **self._gauges}
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
