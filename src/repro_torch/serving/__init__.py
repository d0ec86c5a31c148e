"""Serving substrate of the port: requests, KV-cache reservation accounting,
schedulers, the discrete-event simulator (``SimEngine``, NumPy copies of the
reference's modules) and the real-generation engine (``RealEngine``) over a
served model and the port's kernels."""

from repro_torch.serving.engine import (RealEngine, ReplicaSpec, ServeStats,
                                        SimEngine)
from repro_torch.serving.kvcache import KVCacheManager
from repro_torch.serving.request import Request, workload_from_scenario
from repro_torch.serving.scheduler import ORDERINGS, PREEMPT_MODES, Policy
from repro_torch.serving.telemetry import (EVENT_KINDS, TERMINAL_KINDS, TraceEvent,
                                           Tracer, goodput, latency_summary,
                                           percentile_summary, ttft_summary)

__all__ = [
    "EVENT_KINDS", "KVCacheManager", "ORDERINGS", "PREEMPT_MODES", "Policy",
    "RealEngine", "ReplicaSpec", "Request", "ServeStats", "SimEngine",
    "TERMINAL_KINDS", "TraceEvent", "Tracer", "goodput", "latency_summary",
    "percentile_summary", "ttft_summary", "workload_from_scenario",
]
