"""Observability for the port: host-side span tracing and the metrics
registry, with the span names and counter prefixes of ``repro.obs``."""
from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import Registry, publish_stats
from repro_torch.obs.trace import TRACE_MODES, Tracer

__all__ = [
    "trace",
    "metrics",
    "Tracer",
    "Registry",
    "publish_stats",
    "TRACE_MODES",
]
