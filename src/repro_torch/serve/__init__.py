"""Serving of the port: wave-batched LM decode (``serve/engine.py``) and
graph-analytics serving (``serve/graph.py``: all five request kinds,
packed into disjoint-union waves) over one shared wave scheduler
(``serve/waves.py``) with fault containment (quarantine and bisection,
bounded retry, graceful degradation) and the deterministic
fault-injection harness (``serve/faults.py``)."""
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
from repro_torch.serve.graph import (
    KINDS,
    GraphRequest,
    GraphResult,
    GraphServeEngine,
    WaveRecord,
)
from repro_torch.serve.waves import FAILURE_POLICIES, HealthRecord, WaveScheduler

__all__ = [
    "Request",
    "ServeEngine",
    "OVERFLOW_POLICIES",
    "GraphRequest",
    "GraphResult",
    "GraphServeEngine",
    "WaveRecord",
    "KINDS",
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
