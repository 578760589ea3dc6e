"""Shared wave/slot machinery for the serving engines: the port's copy
of ``repro.serve.waves``, scheduler and containment unchanged.

The port has the LM token engine (``serve/engine.py``); the
graph-analytics engine of the reference (``serve/graph.py``) waits for
ROADMAP queue 1, item 10. In the reference both run the same outer loop:
requests queue up, a WAVE of them is admitted under a static capacity,
the whole wave runs as one shape-static batched device program, and the
wave retires together (the branch-free analogue of the paper's lockstep
walk: all lanes step together, finished lanes burn no semantics). This
module owns that loop so the two engines only differ in (a) how a wave
is formed under their capacity model and (b) what running a wave means.

Subclasses implement:

* ``_next_wave()`` — pop the next wave off ``self.queue`` (FIFO; a
  subclass may stop early when its capacity budget fills, but must make
  progress whenever the queue is nonempty);
* ``_run_wave(wave)`` — execute the wave and write per-request results
  onto the request objects (``done`` flags included);
* ``_degrade(wave, exc)`` (optional) — given a resource-exhausted wave,
  permanently shrink the engine's capacity and return smaller re-packed
  sub-waves (None = cannot degrade further).

``submit`` is overridable for admission-time validation — the one place
a request can be rejected loudly instead of being silently dropped by
an exhausted wave loop later.

**Fault containment.** A ``_run_wave`` failure never escapes ``run()``
under the default ``on_failure="quarantine"`` policy; see
``docs/serving.md`` for the full model. In short:

* **transient** failures (``serve/faults.classify_failure``) re-run the
  same wave up to ``max_retries`` times;
* **resource-exhaustion** (OOM-shaped) failures degrade: the subclass
  permanently caps its capacity and the wave re-packs into smaller
  sub-waves (``_degrade``) — requests only fail when a single request
  alone still exhausts the device;
* everything else is **poison** and is bisected out: probe one half
  (one wave run); a failing probe provably still contains a poison, a
  passing probe proves the poison is in the other half — so ceil(log2
  K) probes isolate it, the deferred "presumed healthy" siblings re-run
  together as one wave, and a single poison in a K-request wave costs
  at most ceil(log2 K) + 1 extra wave runs while every survivor
  completes bit-exact (subsets of a wave decompose exactly on both
  engines).

Each ``run()`` call appends a ``HealthRecord`` whose counters are
deterministic under a deterministic ``FaultPlan`` (held equal to the
reference's in ``tests/test_torch_serve_lm.py``), returns ONLY the
requests that reached a terminal state during THIS call (``done`` or
``failed`` — never re-delivering an earlier run's results), and frees
their uids for reuse.

``on_failure="raise"`` restores fail-fast: the first ``_run_wave``
error propagates (no retry, no bisection, no degradation).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.components import check_choice
from repro_torch.obs import trace
from repro_torch.obs.metrics import Registry
from repro_torch.serve.faults import classify_failure, is_resource_exhausted

FAILURE_POLICIES = ("quarantine", "raise")


@dataclass
class HealthRecord:
    """Per-``run()`` containment counters (deterministic under a
    deterministic fault plan; guarded like the wave counters).

    ``wave_runs`` counts every ``_run_wave`` attempt (success or
    failure) including retries, bisection probes, and degraded
    re-packs; ``completed``/``failed`` partition the requests the run
    delivered; ``quarantined`` counts requests isolated as poison
    (== ``failed`` unless a subclass fails requests another way);
    ``retried`` counts transient re-runs, ``bisections`` poison-hunt
    episodes, and ``degraded`` capacity-capping events."""

    run: int
    completed: int = 0
    failed: int = 0
    retried: int = 0
    quarantined: int = 0
    degraded: int = 0
    bisections: int = 0
    wave_runs: int = 0

    def publish(self, registry=None, prefix: str = "serve.health") -> None:
        """Publish the counters (``run`` excluded -- it is an id, not a
        quantity) into the metrics registry (``repro_torch.obs.metrics``)."""
        from repro_torch.obs.metrics import publish_stats

        publish_stats(self, prefix, registry, exclude=("run",))


class WaveScheduler:
    """Queue -> waves -> finished, with fault containment and a
    per-run wave counter."""

    def __init__(
        self,
        *,
        max_retries: int = 1,
        on_failure: str = "quarantine",
        fault_plan=None,
    ):
        check_choice("on_failure", on_failure, FAILURE_POLICIES)
        self.queue: list = []
        self.finished: list = []
        self.waves = 0
        self.max_retries = max_retries
        self.on_failure = on_failure
        self.fault_plan = fault_plan
        self.health_records: list[HealthRecord] = []
        self.health: HealthRecord | None = None
        self._delivered = 0  # prefix of self.finished already returned
        self._inflight: set = set()  # uids submitted but not delivered
        # Per-engine registry (NOT the process-global one): each run()
        # publishes its HealthRecord and subclasses publish their wave
        # records here, so an engine's snapshot() is a deterministic
        # function of its own request stream + fault plan alone.
        self.metrics = Registry()

    # -- admission ----------------------------------------------------
    def submit(self, req) -> None:
        """Admit a request to the queue. Subclasses validate here."""
        self._register(req)
        self.queue.append(req)

    def _register(self, req) -> None:
        """Claim the request's uid (results and health records are
        keyed by uid; duplicates would alias silently). Subclass
        ``submit`` paths that bypass the queue register here too."""
        uid = getattr(req, "uid", None)
        if uid is None:
            return
        if uid in self._inflight:
            raise ValueError(
                f"request {uid}: uid already in flight; wait for run() "
                "to deliver it or pick a fresh uid"
            )
        self._inflight.add(uid)

    def _next_wave(self) -> list:
        """Pop the next wave (nonempty while the queue is) off the queue."""
        raise NotImplementedError

    def _run_wave(self, wave: list) -> None:
        raise NotImplementedError

    # -- containment ----------------------------------------------------
    def _attempt(self, wave: list) -> Exception | None:
        """Run a wave with bounded transient retries. Returns None on
        success (the wave is retired) or the terminal exception."""
        retries = 0
        while True:
            self.health.wave_runs += 1
            # First attempt is a "serve.wave" span, re-runs are
            # "serve.retry" child attempts; a failing attempt carries
            # its failure classification as a span tag.
            name = "serve.wave" if retries == 0 else "serve.retry"
            with trace.span(name, requests=len(wave), retry=retries) as sp:
                try:
                    self._run_wave(wave)
                except Exception as exc:
                    if self.on_failure == "raise":
                        raise
                    failure = classify_failure(exc)
                    sp.tag(failure=failure, error=type(exc).__name__)
                    if failure == "transient" and retries < self.max_retries:
                        retries += 1
                        self.health.retried += 1
                        continue
                    return exc
            self.finished.extend(wave)
            self.waves += 1
            return None

    def _process_wave(self, wave: list) -> None:
        """Retire a wave through retry -> degrade -> bisect."""
        exc = self._attempt(wave)
        if exc is None:
            return
        if is_resource_exhausted(exc):
            subs = self._degrade(wave, exc)
            if subs is not None:
                self.health.degraded += 1
                with trace.span(
                    "serve.degrade", requests=len(wave), subs=len(subs),
                    failure=classify_failure(exc),
                ):
                    for sub in subs:
                        self._process_wave(sub)
                return
        if len(wave) == 1:
            self._quarantine(wave[0], exc)
            return
        self._bisect(wave, exc)

    def _bisect(self, wave: list, exc: Exception) -> None:
        """Isolate the poison request(s) of a failed multi-request wave.

        Invariant: ``suspect`` provably contains a poison (a wave fails
        iff it contains one, and failures are deterministic). Probing
        the first half either shrinks ``suspect`` to it (probe failed)
        or proves the poison is in the other half (probe passed and
        retired). The singleton left after ceil(log2 K) probes is
        quarantined WITHOUT a solo run — guilt by the invariant — and
        the deferred siblings re-run as one wave (recursing here if
        they hide another poison)."""
        self.health.bisections += 1
        suspect, stash = list(wave), []
        with trace.span(
            "serve.bisect", suspects=len(wave),
            failure=classify_failure(exc),
        ) as bsp:
            while len(suspect) > 1:
                mid = len(suspect) // 2
                probe, rest = suspect[:mid], suspect[mid:]
                with trace.span("serve.bisect.probe", size=len(probe)):
                    e = self._attempt(probe)
                if e is None:
                    suspect = rest
                else:
                    suspect, exc = probe, e
                    stash = rest + stash
            bsp.tag(isolated=getattr(suspect[0], "uid", None))
        self._quarantine(suspect[0], exc)
        if stash:
            self._process_wave(stash)

    def _degrade(self, wave: list, exc: Exception) -> list | None:
        """Hook: permanently shrink capacity after an OOM-shaped
        failure and return re-packed sub-waves, or None if this wave
        cannot run any smaller (base: no capacity model to shrink)."""
        return None

    def _quarantine(self, req, exc: Exception) -> None:
        """Terminal failure: deliver the request as ``failed`` with the
        captured error instead of stranding it in the queue."""
        req.failed = True
        req.error = f"{type(exc).__name__}: {exc}"
        self.health.quarantined += 1
        self.finished.append(req)
        trace.event(
            "serve.quarantine", uid=getattr(req, "uid", None),
            failure=classify_failure(exc), error=type(exc).__name__,
        )

    # -- the outer loop -------------------------------------------------
    def run(self) -> list:
        """Process the whole queue; returns the requests that reached a
        terminal state (``done`` or ``failed``) during THIS call, in
        completion order (requests finished at submit time first).
        Earlier runs' deliveries are never returned again."""
        self.health = HealthRecord(run=len(self.health_records))
        self.health_records.append(self.health)
        with trace.span(
            "serve.run", run=self.health.run, queued=len(self.queue),
        ) as sp:
            while self.queue:
                wave = self._next_wave()
                if not wave:  # defensive: a stuck _next_wave would spin
                    raise RuntimeError("_next_wave returned an empty wave")
                self._process_wave(wave)
            new = self.finished[self._delivered:]
            self._delivered = len(self.finished)
            for r in new:
                self._inflight.discard(getattr(r, "uid", None))
                if getattr(r, "failed", False):
                    self.health.failed += 1
                else:
                    self.health.completed += 1
            sp.tag(
                completed=self.health.completed, failed=self.health.failed,
                wave_runs=self.health.wave_runs,
            )
        # One publish per run(): the containment counters land in the
        # engine's own registry under serve.health.*, the reference's
        # namespace.
        self.health.publish(self.metrics)
        return new
