"""Serving of the port: the wave-batched LM engine over one shared wave
scheduler (``serve/waves.py``) with fault containment (quarantine and
bisection, bounded retry, graceful degradation) and the deterministic
fault-injection harness (``serve/faults.py``). Graph-analytics serving
(``repro.serve.graph``) waits for ROADMAP queue 1, item 10."""
from repro_torch.serve.engine import OVERFLOW_POLICIES, Request, ServeEngine
from repro_torch.serve.faults import (
    FaultPlan,
    InjectedEngineError,
    InjectedFault,
    SimulatedOOM,
    TransientFault,
    classify_failure,
    is_resource_exhausted,
)
from repro_torch.serve.waves import FAILURE_POLICIES, HealthRecord, WaveScheduler

__all__ = [
    "Request",
    "ServeEngine",
    "OVERFLOW_POLICIES",
    "WaveScheduler",
    "HealthRecord",
    "FAILURE_POLICIES",
    "FaultPlan",
    "InjectedFault",
    "InjectedEngineError",
    "TransientFault",
    "SimulatedOOM",
    "classify_failure",
    "is_resource_exhausted",
]
