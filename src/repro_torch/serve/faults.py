"""Deterministic fault injection for the LM serving engine: the port's
copy of the LM half of ``repro.serve.faults`` (it imports no torch).

The containment machinery in ``serve/waves.py`` (quarantine +
bisection, bounded retry, graceful degradation) is only trustworthy if
every path is exercised deterministically -- waiting for a real device
OOM or a real invariant break in CI would test nothing. A ``FaultPlan``
is a fully deterministic description of which faults to inject where;
the engine accepts one (``fault_plan=``) behind a no-op default,
consults it at the few natural failure points, and raises ordinary
exceptions that then flow through the SAME classification / bisection /
degradation code real failures do:

* **poison** (``poison_uids``): an ``InjectedEngineError`` whenever a
  wave contains the uid -- the "request that trips an invariant only
  when packed" case; bisection must isolate exactly this request.
* **transient** (``transient_uids``: uid -> failure count): a
  ``TransientFault`` for the first N attempts of any wave containing
  the uid, success afterwards -- exercises the bounded retry policy.
* **simulated OOM** (``oom_slots_at`` for the LM cache width): a
  ``SimulatedOOM`` that is resource-exhaustion-shaped, so the scheduler
  degrades (halves the slots, re-packs smaller waves) instead of
  quarantining.

The reference's graph-serving injections (``oom_node_caps``,
``nonconverge_uids``, ``malformed_uids``, ``FaultPlan.random``) come
with graph serving (ROADMAP queue 1, item 10).

Classification (``classify_failure`` / ``is_resource_exhausted``)
covers real failures too: any ``MemoryError``, or an error message
carrying XLA's ``RESOURCE_EXHAUSTED`` marker or ``"out of memory"``
(``torch.OutOfMemoryError``'s "CUDA out of memory" on the card),
degrades; everything else non-transient is poison.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class InjectedFault(RuntimeError):
    """Base class for every fault the harness raises on purpose."""


class InjectedEngineError(InjectedFault):
    """Deterministic poison: raised whenever a wave contains the uid."""


class TransientFault(InjectedFault):
    """Clears after a bounded number of retries of the same request."""


class SimulatedOOM(InjectedFault, MemoryError):
    """Resource-exhaustion-shaped: classified like a real device OOM."""


# Substrings that mark a real resource-exhaustion failure. XLA raises
# XlaRuntimeError("RESOURCE_EXHAUSTED: ...") on device OOM; PyTorch
# raises torch.OutOfMemoryError("CUDA out of memory. ...").
_RESOURCE_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory")


def is_resource_exhausted(exc: BaseException) -> bool:
    """OOM-shaped? (simulated, MemoryError, or an OOM message)."""
    if isinstance(exc, MemoryError):
        return True
    msg = str(exc)
    return any(marker in msg for marker in _RESOURCE_MARKERS)


def classify_failure(exc: BaseException) -> str:
    """``"transient"`` | ``"resource"`` | ``"poison"``.

    Transient failures are retried in place (bounded by
    ``max_retries``); resource failures degrade (smaller waves);
    everything else is poison and gets bisected out.
    """
    if isinstance(exc, TransientFault):
        return "transient"
    if is_resource_exhausted(exc):
        return "resource"
    return "poison"


@dataclass
class FaultPlan:
    """A deterministic injection schedule. Default-constructed (or
    ``None``) injects nothing -- the engine's no-op default.
    ``transient_uids`` is the plan's only mutable state: each injected
    transient failure decrements its counter, so a plan instance
    describes one engine run (build a fresh plan per engine).
    """

    poison_uids: frozenset = frozenset()
    transient_uids: dict = field(default_factory=dict)  # uid -> failures
    oom_slots_at: int | None = None  # LM: OOM when num_slots >= this

    def check_wave(self, wave) -> None:
        """Top of ``_run_wave``: transient (counted) then poison."""
        for r in wave:
            left = self.transient_uids.get(r.uid, 0)
            if left > 0:
                self.transient_uids[r.uid] = left - 1
                raise TransientFault(
                    f"injected transient fault (request {r.uid}, "
                    f"{left - 1} failures left)"
                )
        poisoned = [r.uid for r in wave if r.uid in self.poison_uids]
        if poisoned:
            raise InjectedEngineError(
                f"injected engine error (poison uids {poisoned})"
            )

    def check_slots(self, num_slots: int) -> None:
        """LM engine, before the (num_slots, max_len) cache allocates."""
        if self.oom_slots_at is not None and num_slots >= self.oom_slots_at:
            raise SimulatedOOM(
                "injected RESOURCE_EXHAUSTED on KV cache width "
                f"num_slots={num_slots}"
            )
