"""Deterministic fault injection for the serving engines: the port's
copy of ``repro.serve.faults`` (it imports numpy, not torch).

The containment machinery in ``serve/waves.py`` (quarantine +
bisection, bounded retry, graceful degradation) is only trustworthy if
every path is exercised deterministically -- waiting for a real device
OOM or a real invariant break in CI would test nothing. A ``FaultPlan``
is a seeded, fully deterministic description of which faults to inject
where; both serving engines accept one (``fault_plan=``) behind a no-op
default, consult it at the few natural failure points, and raise
ordinary exceptions that then flow through the SAME classification /
bisection / degradation code real failures do:

* **poison** (``poison_uids``): an ``InjectedEngineError`` whenever a
  wave contains the uid -- the "request that trips an invariant only
  when packed" case; bisection must isolate exactly this request.
* **transient** (``transient_uids``: uid -> failure count): a
  ``TransientFault`` for the first N attempts of any wave containing
  the uid, success afterwards -- exercises the bounded retry policy.
* **simulated OOM** (``oom_node_caps`` for graph buckets,
  ``oom_slots_at`` for the LM cache width): a ``SimulatedOOM`` that is
  resource-exhaustion-shaped, so the scheduler degrades (caps the
  bucket, re-packs smaller waves) instead of quarantining.
* **non-convergence** (``nonconverge_uids``): the graph engine forces
  ``max_rounds=0`` on waves containing the uid, so the REAL
  ``ConvergenceError`` sentinel of the dense engines fires -- nothing
  here fakes the error; the injection only removes the round budget.
* **malformed submits** (``malformed_uids`` + ``malform``): a
  test-stream-side corruption helper; the engines' ``submit``
  validation must reject the request loudly before it ever reaches a
  wave (the containment layer never sees it).

``FaultPlan.random`` draws from ``np.random.default_rng`` exactly as
the reference does, so a seed gives both packages the same plan.

Classification (``classify_failure`` / ``is_resource_exhausted``)
covers real failures too: any ``MemoryError``, or an error message
carrying XLA's ``RESOURCE_EXHAUSTED`` marker or ``"out of memory"``
(``torch.OutOfMemoryError``'s "CUDA out of memory" on the card),
degrades; everything else non-transient is poison.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


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
    ``None``) injects nothing -- the no-op default both engines ship
    with. ``transient_uids`` is the plan's only mutable state: each
    injected transient failure decrements its counter, so a plan
    instance describes one engine run (build a fresh plan per engine).
    """

    poison_uids: frozenset = frozenset()
    transient_uids: dict = field(default_factory=dict)  # uid -> failures
    oom_node_caps: frozenset = frozenset()  # graph bucket node_caps
    oom_slots_at: int | None = None  # LM: OOM when num_slots >= this
    nonconverge_uids: frozenset = frozenset()  # graph: force max_rounds=0
    malformed_uids: frozenset = frozenset()  # corrupted before submit

    @classmethod
    def random(
        cls,
        seed: int,
        uids,
        *,
        p_poison: float = 0.1,
        p_transient: float = 0.1,
        max_transient: int = 1,
        p_nonconverge: float = 0.0,
    ) -> "FaultPlan":
        """Seeded random plan over ``uids`` -- same seed, same plan (and
        the reference's plan: the same draws in the same order)."""
        rng = np.random.default_rng(seed)
        uids = list(uids)
        draws = rng.random((len(uids), 3))
        poison, transient, nonconv = set(), {}, set()
        for uid, (a, b, c) in zip(uids, draws):
            if a < p_poison:
                poison.add(uid)
            elif c < p_nonconverge:
                nonconv.add(uid)
            elif b < p_transient:
                transient[uid] = int(rng.integers(1, max_transient + 1))
        return cls(
            poison_uids=frozenset(poison),
            transient_uids=transient,
            nonconverge_uids=frozenset(nonconv),
        )

    # -- engine-side checkpoints ------------------------------------

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

    def check_bucket(self, node_cap: int) -> None:
        """Graph engine, after the wave's capacity bucket is chosen."""
        if node_cap in self.oom_node_caps:
            raise SimulatedOOM(
                "injected RESOURCE_EXHAUSTED on bucket "
                f"node_cap={node_cap}"
            )

    def check_slots(self, num_slots: int) -> None:
        """LM engine, before the (num_slots, max_len) cache allocates."""
        if self.oom_slots_at is not None and num_slots >= self.oom_slots_at:
            raise SimulatedOOM(
                "injected RESOURCE_EXHAUSTED on KV cache width "
                f"num_slots={num_slots}"
            )

    def wants_nonconverge(self, wave) -> bool:
        return any(r.uid in self.nonconverge_uids for r in wave)

    # -- test-stream-side helper -------------------------------------
    def malform(self, req):
        """Corrupt a graph request so ``submit`` must reject it (edge
        endpoint outside ``[0, num_nodes)``). Returns the request."""
        bad = np.asarray([req.num_nodes + 7], np.int32)
        req.src = np.concatenate([np.asarray(req.src, np.int32), bad])
        req.dst = np.concatenate([np.asarray(req.dst, np.int32), bad])
        return req
