"""Schedulers: FCFS, SJF on predicted length, deadline-aware orderings, and
the uncertainty-aware quantile policy that only a distributional predictor
(ProD-D) enables.

Orderings:
* ``fcfs``       — arrival order
* ``sjf_pred``   — shortest predicted remaining length first
* ``sjf_oracle`` — shortest realized length first (upper bound)
* ``srtf_pred``  — sjf_pred + preemption of the longest-remaining active slot
* ``edf``        — earliest deadline first (requests without a deadline run
                   FCFS after all deadline-carrying ones)
* ``laxity``     — least laxity first, laxity = deadline − now − predicted
                   q0.9 remaining work. Since ``now`` is common to every
                   queued entry at any comparison instant, ordering by the
                   static key ``deadline − q0.9-remaining`` IS the least-
                   laxity order — no time-dependent re-keying needed.

Reservation policies:
* ``max``       — reserve max_seq_len (vLLM-naive; zero overflow, max waste)
* ``predicted`` — reserve predicted median × margin
* ``quantile``  — reserve the q-th quantile of the ProD-D predictive
                  distribution (per-request risk control; the CoRE-style
                  learning-for-scheduling coupling)
* ``oracle``    — reserve the realized length (upper bound)

The port's own copy of ``repro.serving.scheduler`` (NumPy only), kept line
for line so that the same trace gives the same results bit for bit. One
addition: :func:`annotate_predictions` brings a predictor's tensors to host
NumPy at the ``predictor=`` seam.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serving.request import Request

ORDERINGS = ("fcfs", "sjf_pred", "sjf_oracle", "srtf_pred", "edf", "laxity")
RESERVES = ("max", "predicted", "quantile", "oracle")
PREEMPT_MODES = ("recompute", "keep")
# chunked-prefill budget allocation (ReplicaSpec.step_token_budget engines):
# which prefilling slot gets the next chunk of the per-step token budget
CHUNK_ORDERS = ("fcfs", "prod")


@dataclass(frozen=True)
class Policy:
    """Scheduling policy: queue ordering × KV reservation sizing.

    Parameters
    ----------
    order : one of :data:`ORDERINGS` (see module docstring).
    reserve : one of :data:`RESERVES` — how much KV to reserve per request.
    margin : multiplier on the predicted median for ``reserve="predicted"``.
    quantile : CDF level for ``reserve="quantile"``.
    max_seq_len : serve-time length cap; reservations clamp to it.
    preempt : SRTF only — evict the longest-remaining active slot when a much
        shorter request waits.
    preempt_factor : preempt only if the victim's predicted remaining exceeds
        this multiple of the newcomer's.
    preempt_mode : what happens to the victim's KV reservation, one of
        :data:`PREEMPT_MODES`. ``"recompute"`` releases it all and resume
        re-reserves — and re-prefills — from scratch; ``"keep"`` retains the
        pages the victim already filled (paged KV), so resume reserves only
        the delta pages and skips the prefill recompute.
    chunk_order : chunked-prefill only (engines with a
        ``ReplicaSpec.step_token_budget``), one of :data:`CHUNK_ORDERS` —
        which prefilling slot the per-step token budget feeds first.
        ``"fcfs"`` hands chunks out in slot admission order; ``"prod"`` is
        the ProD-aware allocation: predicted-short requests first (earliest
        deadline breaking ties), so short answers reach their first token
        before long ones monopolize the budget.
    refine_every : posterior length refinement period in engine ticks.
        Every ``refine_every`` ticks the engine re-conditions each active
        slot's ProD-D histogram on its decode progress
        (:class:`~repro.core.online.PosteriorRefiner`), refreshing the
        median / work-quantile / reservation quantiles that SRTF, laxity,
        stealing, chunk ordering, and KV sizing read. ``0`` (default)
        disables refinement entirely — bit-identical legacy behavior.
    """

    order: str = "fcfs"            # see ORDERINGS
    reserve: str = "max"           # see RESERVES
    margin: float = 1.2            # multiplier for `predicted`
    quantile: float = 0.9
    max_seq_len: int = 4096
    preempt: bool = False          # srtf: evict the longest-remaining active
    preempt_factor: float = 2.0    # only if its remaining > factor × newcomer's
    preempt_mode: str = "recompute"   # see PREEMPT_MODES
    chunk_order: str = "fcfs"         # see CHUNK_ORDERS
    refine_every: int = 0             # 0 = no mid-flight refinement

    def __post_init__(self):
        if self.order not in ORDERINGS:
            raise ValueError(f"order {self.order!r} not in {ORDERINGS}")
        if self.reserve not in RESERVES:
            raise ValueError(f"reserve {self.reserve!r} not in {RESERVES}")
        if self.preempt_mode not in PREEMPT_MODES:
            raise ValueError(
                f"preempt_mode {self.preempt_mode!r} not in {PREEMPT_MODES}")
        if self.chunk_order not in CHUNK_ORDERS:
            raise ValueError(
                f"chunk_order {self.chunk_order!r} not in {CHUNK_ORDERS}")
        if int(self.refine_every) != self.refine_every or self.refine_every < 0:
            raise ValueError("refine_every must be a non-negative integer "
                             "number of ticks (0 = off)")


def predicted_remaining(r: Request) -> float:
    """Estimated remaining tokens (ProD-O style: static estimate − progress)."""
    base = r.predicted_len if r.predicted_len is not None else float(r.true_len)
    return max(base - r.generated, 1.0)


def quantile_remaining(r: Request, max_cap: Optional[float] = None,
                       refiner=None) -> float:
    """Predicted q0.9 remaining work — the pessimistic remaining-tokens signal
    least-laxity ordering and quantile work stealing budget against.

    Fallback chain:

    1. ``pred_q`` — the PredictorService-attached true q0.9;
    2. ``reserve_len`` — but only when it carries per-request information
       (a quantile/predicted/oracle reservation). When ``max_cap`` (the
       policy's ``max_seq_len``) is given and the reservation sits at that
       cap — ``reserve="max"`` reserves the cap for *every* request — the
       reservation is a constant pseudo-quantile that would poison laxity
       ordering and quantile stealing, so it is skipped;
    3. the point prediction (``predicted_len``, else the realized length).

    ``refiner`` (a :class:`~repro.core.online.PosteriorRefiner`, passed by
    engines running with ``Policy.refine_every > 0``) repairs the
    over-runner collapse: a request that has outlived its dispatch-time
    quantile used to hit the ``max(base - generated, 1.0)`` floor, so every
    over-runner keyed identically (1.0) and SRTF/laxity ordering, quantile
    stealing, and victim choice among them degenerated to tie-break order.
    Conditioning the histogram on survival to ``generated`` keeps the
    remaining-work estimate well-defined (the posterior quantile is always
    above ``generated``), so over-runners stay mutually ordered by their
    tails."""
    if r.pred_q is not None:
        base = float(r.pred_q)
    elif r.reserve_len is not None and not (
            max_cap is not None and float(r.reserve_len) >= float(max_cap)):
        base = float(r.reserve_len)
    else:
        base = predicted_remaining(r) + r.generated
    if (refiner is not None and r.pred_probs is not None
            and base - r.generated < 1.0):
        base = refiner.quantile(r.pred_probs, float(r.generated),
                                refiner.work_quantile)
    return max(base - r.generated, 1.0)


def annotate_predictions(requests: List[Request], predictor, policy: Policy):
    """Attach predicted median + reservation length from the ProD head.

    ``predictor`` is any of the interchangeable predictors behind the cluster
    ``predictor=`` seam:

    * an object with ``annotate(requests, policy)`` — the batched, jitted
      :class:`~repro.serving.predictor.PredictorService` (trained ProD-D
      head) or the :class:`~repro.serving.predictor.PerfectOracle`; it is
      delegated to wholesale;
    * an object with ``predict(phi) -> median`` and ``quantile(phi, q)`` over
      stacked per-request features — the trained
      :class:`~repro.core.predictor.LengthPredictor` or the trace-level
      :class:`~repro.serving.arrivals.LatentOracle`;
    * ``None`` — requests pre-annotated by a trace generator keep their
      predictions; anything else falls back to max/oracle reservation.
    """
    if not requests:
        return
    if predictor is not None and hasattr(predictor, "annotate"):
        predictor.annotate(requests, policy)
        return
    if predictor is None:
        for r in requests:
            if policy.reserve == "oracle":
                r.reserve_len = float(r.true_len)
            elif (policy.reserve in ("quantile", "predicted")
                  and r.reserve_len is not None):
                # pre-annotated trace (cluster path): clamp, keep
                r.reserve_len = float(
                    min(max(r.reserve_len, 8.0), policy.max_seq_len))
            else:
                r.reserve_len = float(policy.max_seq_len)
        return

    phi = np.stack([np.asarray(r.phi) for r in requests])
    med = np.asarray(_on_host(predictor.predict(phi)), np.float64)
    if policy.reserve == "quantile":
        res = np.asarray(_on_host(predictor.quantile(phi, policy.quantile)),
                         np.float64)
    elif policy.reserve == "predicted":
        res = med * policy.margin
    elif policy.reserve == "oracle":
        res = np.array([r.true_len for r in requests], np.float64)
    else:
        res = np.full(len(requests), policy.max_seq_len, np.float64)
    for r, m, rv in zip(requests, med, res):
        r.predicted_len = float(m)
        r.reserve_len = float(min(max(rv, 8.0), policy.max_seq_len))


def _on_host(x):
    """A predictor's output as host NumPy. The port's ``LengthPredictor``
    answers with a tensor on its device (``np.asarray`` refuses a CUDA
    tensor); NumPy predictors (a stub, ``LatentOracle``) pass through."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def order_key(r: Request, order: str,
              max_cap: Optional[float] = None, refiner=None) -> float:
    """Static heap key realizing ``order`` (FIFO tie-break happens outside).

    EDF keys on the absolute deadline; least-laxity keys on
    ``deadline − q0.9-remaining`` (see module docstring for why the static
    key is exact). ``max_cap`` (the policy's ``max_seq_len``) lets
    :func:`quantile_remaining` recognize an uninformative ``reserve="max"``
    reservation and fall through to the point prediction; ``refiner``
    (engines with ``Policy.refine_every > 0``) keeps over-runner keys
    well-defined via posterior conditioning. Requests without a deadline
    key to +inf under both — they run FIFO after every deadline-carrying
    request."""
    if order == "fcfs":
        return float(r.arrival)
    if order in ("sjf_pred", "srtf_pred"):
        return predicted_remaining(r)
    if order == "sjf_oracle":
        return float(r.true_len)
    if order == "edf":
        return float(r.deadline) if r.deadline is not None else float("inf")
    if order == "laxity":
        if r.deadline is None:
            return float("inf")
        return float(r.deadline) - quantile_remaining(r, max_cap=max_cap,
                                                      refiner=refiner)
    raise ValueError(order)


def pick_next(queue: List[Request], policy: Policy, now: float) -> Optional[int]:
    """Index into `queue` of the next request to admit (arrived ones only)."""
    avail = [i for i, r in enumerate(queue) if r.arrival <= now]
    if not avail:
        return None
    return min(avail, key=lambda i: (order_key(queue[i], policy.order), i))
