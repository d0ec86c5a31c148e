"""Request model and workload generators.

The port's own copy of ``repro.serving.request`` (NumPy only), kept line
for line so that the same trace gives the same results bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    arrival: float                      # arrival time (engine steps)
    prompt_len: int
    true_len: int                       # realized decode length (sim: sampled)
    phi: Optional[np.ndarray] = None    # served-LLM hidden state (predictor input)
    predicted_len: Optional[float] = None
    reserve_len: Optional[float] = None
    # distributional predictions (attached by a PredictorService at dispatch);
    # pred_q is the q0.9 total decode length — the remaining-work signal that
    # least-laxity ordering and quantile work stealing consume
    pred_q: Optional[float] = None
    pred_probs: Optional[np.ndarray] = None  # predictive histogram over bins
    # calibrated reservation quantile recorded at annotation time by an
    # OnlineAdapter — the conformal score target (true_len <= cal_q means
    # covered). Unlike reserve_len (which eviction may bump) it changes only
    # under Policy.refine_every > 0, where each refine tick re-cuts it on the
    # posterior at the same effective level, so ACI coverage is tracked
    # against the refreshed estimate (conformal-on-posterior)
    cal_q: Optional[float] = None
    # effective CDF level the reservation was cut at, recovered once from
    # (pred_probs, cal_q) at the first refine tick — pinning it stops the
    # level from ratcheting when later refines re-invert an already-refreshed
    # cal_q against the dispatch histogram
    pred_level: Optional[float] = None
    # trace provenance (cluster simulator)
    setting: Optional[str] = None       # "model/scenario" the law came from
    deadline: Optional[float] = None    # absolute SLO: must finish by this step
    replica: Optional[int] = None       # router-assigned replica index
    # shared-context provenance: the first prefix_len prompt tokens are the
    # context named prefix_id (a chat session's accumulated turns, an agentic
    # loop's growing scratchpad, or a per-scenario system prompt). A
    # share_prefixes=True KV pool backs those tokens with ref-counted shared
    # pages, and the prefix_affine router keeps the session on the replica
    # already holding them. None/0 = no shared context (unchanged behavior)
    prefix_id: Optional[str] = None
    prefix_len: int = 0
    # engine bookkeeping
    t_start: Optional[float] = None
    t_finish: Optional[float] = None
    # tick that emitted this request's first decode token (the TTFT anchor);
    # set once — a preempted request that resumes keeps its original value
    t_first_token: Optional[float] = None
    generated: int = 0
    overflows: int = 0
    # keep-mode preemption: tokens of KV pages this (queued) request still
    # holds — page-rounded grant covering prompt + generated progress. The
    # pages live in one replica's pool; work stealing hands them off
    # (export_held/adopt_held) or drops them back to 0 (recompute)
    held: int = 0

    @property
    def wait(self) -> float:
        return (self.t_start - self.arrival) if self.t_start is not None else np.inf

    @property
    def ttft(self) -> float:
        """Time to first token (inf until one is emitted)."""
        return (self.t_first_token - self.arrival) \
            if self.t_first_token is not None else np.inf

    @property
    def latency(self) -> float:
        return (self.t_finish - self.arrival) if self.t_finish is not None else np.inf

    @property
    def slo_met(self) -> bool:
        """Finished, and within the deadline if one was set."""
        if self.t_finish is None:
            return False
        return self.deadline is None or self.t_finish <= self.deadline

    def fresh_copy(self) -> "Request":
        """Copy for a new simulation run: identity/trace fields (including
        any fields added later) carried over via :func:`dataclasses.replace`,
        engine bookkeeping reset. ``phi`` stays shared — it is read-only for
        the engine. This replaces the brittle ``Request(**r.__dict__)``
        pattern, which silently breaks on non-init fields."""
        return dataclasses.replace(self, replica=None, t_start=None,
                                   t_finish=None, t_first_token=None,
                                   generated=0, overflows=0, held=0,
                                   pred_level=None)


def workload_from_scenario(
    data, n: int, seed: int = 0, arrival_rate: float = 4.0,
) -> List[Request]:
    """Build a Poisson-arrival workload from a Track-A ScenarioData test split.

    Each request's true decode length is one *fresh* draw from its prompt's
    length distribution (sample column r-1), and φ is the last-token view —
    i.e. the predictor never saw the realized length, as in deployment.
    """
    rng = np.random.default_rng(seed)
    n = min(n, data.len_test.shape[0])
    idx = rng.permutation(data.len_test.shape[0])[:n]
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, size=n))
    reqs = []
    for i, (j, t) in enumerate(zip(idx, arrivals)):
        reqs.append(Request(
            rid=i, arrival=float(t),
            prompt_len=int(rng.integers(16, 256, endpoint=True)),
            true_len=int(data.len_test[j, -1]),
            phi=data.phi_test["last"][j],
        ))
    return reqs
