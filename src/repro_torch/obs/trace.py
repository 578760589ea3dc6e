"""Host-side span tracer for the level-synchronous engines.

The port's counterpart of ``repro.obs.trace``, with the same span names
and ``trace=`` knob. The engines are host-driven: a level or round runs
on the device, the host reads the live count or convergence flag it
needs anyway, and decides the next step. Spans attach at those
boundaries and never add a device->host read of their own.

Usage::

    from repro_torch.obs import trace

    trace.configure(trace="on")            # or REPRO_TRACE=1
    with trace.span("cc.frontier.level", bucket=4096) as sp:
        ...                                # host-driven work
        sp.tag(rounds=rounds)              # values the host ALREADY read
    trace.event("serve.quarantine", uid=7) # instant marker
    trace.export_chrome("trace.json")      # Chrome/Perfetto timeline

* **Disabled is free.** ``span()`` returns one shared ``_NULL_SPAN``
  singleton when tracing is off.
* **Device spans.** ``span(..., device=True)`` waits at close for the
  device of the tensor registered via ``sp.block_on(x)``
  (``torch.cuda.synchronize`` for a CUDA tensor; a CPU tensor is
  already done), so the span's duration covers the device work it
  launched.

* **Timer spans.** ``span(..., timer=True)`` returns a real timing
  span even when tracing is disabled (it times, and waits with
  ``device=True``, but records nothing): the training loop's straggler
  watchdog reads ``sp.duration`` (seconds) after the block, as the
  reference's does.
* **Instant events.** ``event(name, **attrs)`` records a Chrome-trace
  marker (``ph="i"``), as the serving scheduler does at a quarantine.
* **Profiler interplay.** ``span(..., profile=True)`` enters
  ``torch.profiler.record_function(name)`` for the span's body when the
  global ``profile`` knob is ``"on"`` (and tracing is on), so host spans
  line up with device kernels in a ``torch.profiler`` capture, where the
  reference enters ``jax.profiler.TraceAnnotation``. Off by default.

``export_chrome(path)`` writes the timeline as Chrome-trace JSON
(``{"traceEvents": [...]}``, complete events ``ph="X"``, instants
``ph="i"``, microsecond timestamps), which loads in ``chrome://tracing``
or Perfetto; ``python -m repro_torch.obs.summarize trace.json`` prints
the per-phase aggregate table.
"""
from __future__ import annotations

import json
import os
import threading
import time

# The choice sets for the tracing knobs (the reference's values).
TRACE_MODES = ("off", "on")
PROFILE_MODES = ("off", "on")


class _NullSpan:
    """The shared disabled-path span: every method is a no-op."""

    __slots__ = ()
    duration = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **attrs):
        return self

    def block_on(self, value):
        return value


_NULL_SPAN = _NullSpan()


def _wait_for(value) -> None:
    """Wait until the device work producing ``value`` has finished."""
    import torch

    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


class Span:
    """One live span. Use as a context manager; see module docstring."""

    __slots__ = ("_tracer", "name", "attrs", "device", "profile", "_blockee",
                 "_ann", "_t0", "duration")

    def __init__(self, tracer, name, attrs, device, profile):
        self._tracer = tracer  # None: a timer-only span (tracing disabled)
        self.name = name
        self.attrs = attrs
        self.device = device
        self.profile = profile
        self._blockee = None
        self._ann = None
        self._t0 = 0
        self.duration = 0.0

    def tag(self, **attrs) -> "Span":
        """Attach attributes the host has ALREADY read -- never pass a
        device tensor."""
        self.attrs.update(attrs)
        return self

    def block_on(self, value):
        """Register the tensor this span's close waits for
        (``device=True`` spans only). Returns ``value`` unchanged."""
        self._blockee = value
        return value

    def __enter__(self):
        if self.profile and self._tracer is not None:
            from torch.profiler import record_function

            self._ann = record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.device and self._blockee is not None:
            _wait_for(self._blockee)
        end = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        self.duration = (end - self._t0) * 1e-9
        if self._tracer is not None:
            if exc_type is not None:
                self.attrs.setdefault("exception", exc_type.__name__)
            self._tracer._record(self.name, self._t0, end, self.attrs)
        return False


class Tracer:
    """Span collector. The module-level functions drive one
    process-global instance; tests may build their own."""

    def __init__(self, *, trace: str = "off", profile: str = "off"):
        self.events: list[dict] = []
        self._origin = time.perf_counter_ns()
        self._pid = os.getpid()
        self.configure(trace=trace, profile=profile)

    def configure(self, *, trace: str | None = None,
                  profile: str | None = None) -> None:
        """Set the ``trace=`` / ``profile=`` modes (an unknown string
        raises like every other dispatch knob)."""
        # check_choice imports lazily, and only to raise: the engines this
        # module instruments import it, so a module-level import of
        # repro_torch.core here would be a cycle.
        if trace is not None:
            if trace not in TRACE_MODES:
                from repro_torch.core.components import check_choice

                check_choice("trace", trace, TRACE_MODES)
            self.trace = trace
        if profile is not None:
            if profile not in PROFILE_MODES:
                from repro_torch.core.components import check_choice

                check_choice("profile", profile, PROFILE_MODES)
            self.profile = profile

    @property
    def enabled(self) -> bool:
        return self.trace == "on"

    def reset(self) -> None:
        """Drop recorded events (fresh timeline, same knobs)."""
        self.events = []
        self._origin = time.perf_counter_ns()

    def span(self, name: str, *, device: bool = False, profile: bool = False,
             timer: bool = False, **attrs):
        """A context-managed span; the no-op singleton when tracing is
        disabled, unless ``timer=True`` (see module docstring)."""
        if not self.enabled:
            if not timer:
                return _NULL_SPAN
            return Span(None, name, attrs, device, False)
        return Span(self, name, attrs, device, profile and self.profile == "on")

    def event(self, name: str, **attrs) -> None:
        """An instant marker (Chrome-trace ``ph="i"``); nothing when
        tracing is off."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        self.events.append({
            "name": name, "ph": "i", "s": "t",
            "ts": (now - self._origin) / 1e3,
            "pid": self._pid, "tid": threading.get_ident(),
            "args": attrs,
        })

    def _record(self, name, t0_ns, end_ns, attrs) -> None:
        self.events.append({
            "name": name, "ph": "X",
            "ts": (t0_ns - self._origin) / 1e3,  # Chrome wants microseconds
            "dur": (end_ns - t0_ns) / 1e3,
            "pid": self._pid, "tid": threading.get_ident(),
            "args": attrs,
        })

    def chrome_trace(self) -> dict:
        """The Chrome-trace/Perfetto JSON object."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> int:
        """Write the timeline as Chrome-trace JSON; returns the number
        of events written (loads in chrome://tracing / Perfetto)."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1, default=str)
        return len(self.events)


# The process-global tracer the engines record into. REPRO_TRACE=1 (or
# "on") enables tracing from the environment; REPRO_PROFILE=1 arms the
# profiler annotations as well.
_ON = ("1", "on", "true", "yes")
_GLOBAL = Tracer(
    trace="on" if os.environ.get("REPRO_TRACE", "").lower() in _ON else "off",
    profile="on" if os.environ.get("REPRO_PROFILE", "").lower() in _ON else "off",
)


def configure(*, trace: str | None = None, profile: str | None = None):
    _GLOBAL.configure(trace=trace, profile=profile)


def enabled() -> bool:
    return _GLOBAL.enabled


def reset() -> None:
    _GLOBAL.reset()


# Bound-method aliases, not wrapper defs: the disabled path stays
# near-free in the engines' loops. _GLOBAL is never reassigned.
span = _GLOBAL.span
event = _GLOBAL.event


def chrome_trace() -> dict:
    return _GLOBAL.chrome_trace()


def export_chrome(path: str) -> int:
    return _GLOBAL.export_chrome(path)
