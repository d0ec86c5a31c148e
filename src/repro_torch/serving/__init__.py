"""Serving substrate of the port: requests, KV-cache reservation accounting
(paged, with ref-counted shared prefix pages + copy-on-write), schedulers,
the discrete-event simulator (``SimEngine``) and the real-generation engine
(``RealEngine``) over a served model and the port's kernels, the open-loop
multi-replica cluster simulator (arrival traces + routers), the
dispatch-time predictor service that puts the trained ProD-D head in the
loop through the ``prod_head`` kernel, and the online adaptation subsystem
(drift-aware traces, adaptive conformal calibration, predictor refresh,
SLO-aware admission). The NumPy modules are copies of the reference's."""

from repro_torch.serving.adaptation import (AdaptationConfig, AdmissionController,
                                            OnlineAdapter, coverage_of, refit_head)
from repro_torch.serving.arrivals import (DriftSpec, LatentOracle, TraceConfig,
                                          corrupt_latents, make_trace,
                                          stable_rate_specs)
from repro_torch.serving.cluster import Cluster, ClusterStats, ROUTERS, STEAL_MODES
from repro_torch.serving.engine import (RealEngine, ReplicaSpec, ServeStats,
                                        SimEngine)
from repro_torch.serving.kvcache import KVCacheManager
from repro_torch.serving.predictor import (PerfectOracle, PredictorService,
                                           ServiceStats, fit_trace_head)
from repro_torch.serving.request import Request, workload_from_scenario
from repro_torch.serving.scheduler import ORDERINGS, PREEMPT_MODES, Policy
from repro_torch.serving.telemetry import (EVENT_KINDS, TERMINAL_KINDS, TraceEvent,
                                           Tracer, goodput, latency_summary,
                                           percentile_summary, ttft_summary)

__all__ = [
    "AdaptationConfig", "AdmissionController", "Cluster", "ClusterStats",
    "DriftSpec", "EVENT_KINDS", "KVCacheManager", "LatentOracle", "ORDERINGS",
    "OnlineAdapter", "PREEMPT_MODES", "PerfectOracle", "Policy",
    "PredictorService", "ROUTERS", "RealEngine", "ReplicaSpec", "Request",
    "STEAL_MODES", "ServeStats", "ServiceStats", "SimEngine", "TERMINAL_KINDS",
    "TraceConfig", "TraceEvent", "Tracer", "corrupt_latents", "coverage_of",
    "fit_trace_head", "goodput", "latency_summary", "make_trace",
    "percentile_summary", "refit_head", "stable_rate_specs", "ttft_summary",
    "workload_from_scenario",
]
