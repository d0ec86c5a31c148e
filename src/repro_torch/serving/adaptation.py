"""Online adaptation: the closed feedback loop from observed completions back
into prediction and admission while the cluster runs.

The open-loop simulator annotates every request once, up front, with a
predictor whose calibration is frozen at fit time. Under a *moving* workload
(:class:`~repro.serving.arrivals.DriftSpec`) that reservation quantile
silently loses coverage — the lengths drift out from under the head while φ
looks unchanged. This module closes the loop with three cooperating pieces,
all living behind the same ``Cluster(predictor=...)`` seam:

* :class:`OnlineAdapter` — wraps any predictor (LatentOracle, trained
  :class:`~repro.serving.predictor.PredictorService`, PerfectOracle) and
  (1) annotates requests *at dispatch time* with an **adaptive-conformal**
  effective reservation quantile: an ACI-style step update
  ``q ← q + γ·(err − (1 − target))`` per observed completion drives realized
  coverage to ``target_coverage`` whatever the base predictor's bias is;
  (2) keeps a rolling residual window over (calibrated quantile, realized
  length) pairs for coverage/MAE **drift alarms**; and (3) periodically (or
  on alarm) **refreshes** the trained head: a warm-start re-fit on the
  recent completion buffer, hot-swapped into the live service via
  :meth:`~repro.serving.predictor.PredictorService.swap_weights` without
  losing its batching/cache stats.

* :class:`AdmissionController` — SLO-aware admission at the cluster enqueue
  seam: a request whose calibrated q-reservation cannot meet its deadline
  given the target replica's current predicted backlog is **rejected
  early** (counted in ``ClusterStats.rejected``) instead of timing out late
  after occupying queue space.

* :func:`refit_head` — the refresh primitive: ProD-D targets from single
  realized lengths (one-hot histograms; serving feedback has no repeated
  draws) trained from the current weights for a few epochs.

Determinism: the cluster feeds the adapter at fixed ``every``-tick
checkpoints with completions in a canonical global order, so the whole
closed loop stays bit-identical between the per-slot reference and
vectorized event-leap engine paths (see ``tests/test_adaptation.py``).

The port's own copy of ``repro.serving.adaptation``, kept line for line but
for :func:`refit_head`, which warm-starts through the port's
``train_predictor`` on the served head's device.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import targets as targets_mod
from repro_torch.core.predictor import train_predictor
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (Policy, annotate_predictions,
                                           quantile_remaining)


@dataclass(frozen=True)
class AdaptationConfig:
    """Knobs for one :class:`OnlineAdapter`.

    Parameters
    ----------
    target_coverage : realized-coverage target for the reservation quantile
        (P[true length ≤ reserved quantile] the controller steers to).
    gamma : ACI step size on the effective quantile level per observation.
        0 freezes the quantile — the "static" ablation that still records
        coverage through the identical code path.
    q_min, q_max : clamp range for the effective quantile level.
    window : rolling residual window (completions) for coverage/MAE
        reporting and drift alarms.
    every : cluster ticks between adaptation checkpoints (observe + refresh
        checks). The cluster caps its event leaps at these ticks, so the
        cadence is exact in both decode paths.
    refresh_every : ticks between scheduled warm-start re-fits (0 disables
        scheduled refreshes; alarms may still fire one).
    refresh_min_samples : completion-buffer floor below which no refit runs.
    refresh_epochs : warm-start epochs per refit (incremental, not
        from-scratch).
    refresh_seed : base seed for refits (advanced per refresh, so replays
        are deterministic).
    buffer_size : completion buffer capacity (most recent kept).
    coverage_alarm : drift alarm when the rolling coverage drops below
        ``target_coverage − coverage_alarm`` over a full window (0 = off).
    mae_alarm_mult : drift alarm when the rolling MAE exceeds this multiple
        of the post-warmup baseline MAE (0 = off).
    """

    target_coverage: float = 0.9
    gamma: float = 0.02
    q_min: float = 0.5
    q_max: float = 0.995
    window: int = 512
    every: int = 32
    refresh_every: float = 0.0
    refresh_min_samples: int = 256
    refresh_epochs: int = 3
    refresh_seed: int = 97
    buffer_size: int = 4096
    coverage_alarm: float = 0.0
    mae_alarm_mult: float = 0.0

    def __post_init__(self):
        if not 0.0 < self.target_coverage < 1.0:
            raise ValueError("target_coverage must be in (0, 1)")
        if self.gamma < 0:
            raise ValueError("gamma must be >= 0")
        if not 0.0 < self.q_min <= self.q_max < 1.0:
            raise ValueError("need 0 < q_min <= q_max < 1")
        if self.window <= 0 or self.every <= 0:
            raise ValueError("window and every must be positive")
        if self.buffer_size <= 0 or self.refresh_min_samples <= 0:
            raise ValueError("buffer sizes must be positive")


def coverage_of(requests, since: Optional[float] = None) -> float:
    """Realized reservation coverage over completed requests: the fraction
    whose true length fit the calibrated quantile recorded at annotation
    time (``Request.cal_q``). ``since`` restricts to requests that arrived
    at/after that step (post-switch coverage). NaN when nothing is scored.

    This is THE coverage semantics of the subsystem — the same comparison
    (with the same float tolerance) :meth:`OnlineAdapter.observe` scores, so
    benches/tests/examples can never drift from what the controller steers.

    Under ``Policy.refine_every > 0`` the engine re-cuts ``cal_q`` on the
    posterior (same effective level, recovered from the dispatch histogram),
    so coverage — and therefore the ACI feedback — is tracked against the
    *refreshed* reservation rather than the stale dispatch-time one
    (conformal-on-posterior; see ``docs/serving.md``).
    """
    scored = [r for r in requests
              if r.cal_q is not None
              and (since is None or r.arrival >= since)]
    if not scored:
        return float("nan")
    return float(np.mean([r.true_len <= r.cal_q + 1e-9 for r in scored]))


def refit_head(predictor, phi: np.ndarray, lengths: np.ndarray,
               epochs: int = 3, seed: int = 0):
    """Warm-start re-fit of a ProD-D head on observed (φ, length) pairs.

    Serving feedback yields ONE realized length per request — not the
    paper's r repeated draws — so each completion contributes a one-hot
    histogram target; across the buffer the head still learns the smoothed
    conditional distribution because nearby features populate nearby bins.
    Training starts from the predictor's CURRENT weights and runs ``epochs``
    passes (no cold-start step floor): a cheap incremental update sized for
    the serving loop. Returns a new
    :class:`~repro_torch.core.predictor.LengthPredictor` on the same bin
    edges and device. ``seed`` (an integer) orders the minibatches.
    """
    dev = predictor.edges.device
    lens = np.asarray(lengths, np.float64).reshape(-1, 1)
    tgt = targets_mod.dist_target(
        torch.as_tensor(lens, dtype=torch.float32, device=dev),
        predictor.edges)
    pcfg = dataclasses.replace(predictor.pcfg, epochs=int(epochs))
    return train_predictor(int(seed), np.asarray(phi), tgt, pcfg,
                           predictor.edges, init_params=predictor.params,
                           device=dev)


class OnlineAdapter:
    """Adaptive-conformal calibration + predictor refresh behind the
    ``Cluster(predictor=...)`` seam.

    Satisfies the ``annotate(requests, policy)`` predictor protocol (any
    base predictor composes unchanged underneath) and additionally exposes
    ``observe``/``maybe_refresh`` — the presence of ``observe`` is what
    switches :meth:`~repro.serving.cluster.Cluster.run` into its closed
    loop: dispatch-time annotation, canonical-order completion feedback at
    ``cfg.every``-tick checkpoints, and weight refreshes.

    The effective quantile level initializes lazily from the first policy's
    ``quantile`` (so ``gamma=0`` reproduces the un-adapted run exactly) and
    is only meaningful for ``reserve="quantile"`` policies; other reserve
    rules pass through, with coverage still recorded against whatever was
    reserved.
    """

    def __init__(self, base, cfg: AdaptationConfig = AdaptationConfig(),
                 tracer=None):
        self.base = base
        self.cfg = cfg
        self.tracer = tracer
        # snapshot the pristine weights: refreshes swap new predictors into
        # the live service, and a later run must not silently start from
        # run 1's refreshed head (Cluster.run guarantees deterministic
        # replay — engines reset, requests fresh-copied, adapter reset)
        self._base_predictor = getattr(base, "predictor", None)
        self.reset()

    def reset(self):
        """Clear all adaptation state (a Cluster run starts fresh),
        restoring the base service's original weights if refreshes swapped
        them out."""
        if (self._base_predictor is not None
                and self.base.predictor is not self._base_predictor):
            self.base.swap_weights(self._base_predictor)
        c = self.cfg
        self.q_eff: Optional[float] = None
        self.annotated = 0
        self.observed = 0
        self.miscovered = 0
        self.refreshes = 0
        self._cov_win: deque = deque(maxlen=c.window)
        self._mae_win: deque = deque(maxlen=c.window)
        self._mae_baseline: Optional[float] = None
        self._buf_phi: deque = deque(maxlen=c.buffer_size)
        self._buf_len: deque = deque(maxlen=c.buffer_size)
        self._last_refresh = 0.0

    # -- predictor protocol (annotation) -------------------------------------

    def annotate(self, requests: List[Request], policy: Policy):
        """Annotate via the base predictor at the current effective
        reservation quantile, recording each request's calibrated quantile
        (``cal_q``) for later conformal scoring."""
        if not requests:
            return
        c = self.cfg
        if self.q_eff is None:
            self.q_eff = float(np.clip(policy.quantile, c.q_min, c.q_max))
        eff = policy
        if policy.reserve == "quantile" and policy.quantile != self.q_eff:
            eff = dataclasses.replace(policy, quantile=self.q_eff)
        annotate_predictions(requests, self.base, eff)
        for r in requests:
            r.cal_q = float(r.reserve_len)
        self.annotated += len(requests)

    # -- feedback ------------------------------------------------------------

    def observe(self, finished: List[Request]):
        """Feed realized completions back: per-observation ACI step on the
        effective quantile, rolling residual windows, completion buffer."""
        c = self.cfg
        for r in finished:
            if r.cal_q is None:
                continue
            covered = float(r.true_len) <= r.cal_q + 1e-9
            self.observed += 1
            self.miscovered += 0 if covered else 1
            self._cov_win.append(1.0 if covered else 0.0)
            if r.predicted_len is not None:
                self._mae_win.append(
                    abs(float(r.predicted_len) - float(r.true_len)))
                if (self._mae_baseline is None
                        and len(self._mae_win) == c.window):
                    self._mae_baseline = float(np.mean(self._mae_win))
            if r.phi is not None:
                self._buf_phi.append(np.asarray(r.phi, np.float64))
                self._buf_len.append(float(r.true_len))
            if c.gamma > 0.0 and self.q_eff is not None:
                err = 0.0 if covered else 1.0
                self.q_eff = float(np.clip(
                    self.q_eff + c.gamma * (err - (1.0 - c.target_coverage)),
                    c.q_min, c.q_max))

    # -- drift detection + refresh -------------------------------------------

    def rolling_coverage(self) -> float:
        return float(np.mean(self._cov_win)) if self._cov_win else float("nan")

    def rolling_mae(self) -> float:
        return float(np.mean(self._mae_win)) if self._mae_win else float("nan")

    def coverage(self) -> float:
        """Realized coverage over every observed completion."""
        return 1.0 - self.miscovered / max(self.observed, 1)

    def drift_alarmed(self) -> bool:
        """Windowed coverage/MAE alarm (full windows only, to avoid noisy
        warm-up trips)."""
        c = self.cfg
        if c.coverage_alarm > 0 and len(self._cov_win) == c.window:
            if self.rolling_coverage() < c.target_coverage - c.coverage_alarm:
                return True
        if (c.mae_alarm_mult > 0 and self._mae_baseline is not None
                and len(self._mae_win) == c.window):
            if self.rolling_mae() > c.mae_alarm_mult * self._mae_baseline:
                return True
        return False

    def maybe_refresh(self, now: float) -> bool:
        """Re-fit the head on the completion buffer when a scheduled refresh
        is due or a drift alarm fires, then hot-swap the weights into the
        base service. No-op for weight-less base predictors.

        Both residual windows are cleared on a refresh: the pending
        residuals were scored by the OLD weights, so keeping them would let
        a just-handled alarm re-fire before the refreshed head produced a
        single observation. Since :meth:`drift_alarmed` only trips on full
        windows, the clear doubles as the alarm cooldown — measured in
        completions, the unit the windows are in."""
        c = self.cfg
        if not hasattr(self.base, "swap_weights"):
            return False
        if len(self._buf_len) < c.refresh_min_samples:
            return False
        due = (c.refresh_every > 0
               and now - self._last_refresh >= c.refresh_every)
        alarmed = self.drift_alarmed()
        if not (due or alarmed):
            return False
        new = refit_head(self.base.predictor, np.stack(self._buf_phi),
                         np.asarray(self._buf_len), epochs=c.refresh_epochs,
                         seed=c.refresh_seed + self.refreshes)
        self.base.swap_weights(new)
        self._last_refresh = float(now)
        self.refreshes += 1
        if self.tracer is not None:
            self.tracer.emit(now, -1, -1, "refresh", version=self.refreshes,
                             alarmed=int(alarmed), buffer=len(self._buf_len))
        self._cov_win.clear()
        self._mae_win.clear()
        self._mae_baseline = None
        return True

    def row(self) -> dict:
        """Adaptation summary for bench tables."""
        return dict(q_eff=self.q_eff, observed=self.observed,
                    coverage=self.coverage(),
                    rolling_coverage=self.rolling_coverage(),
                    rolling_mae=self.rolling_mae(),
                    refreshes=self.refreshes, buffer=len(self._buf_len))


@dataclass(frozen=True)
class AdmissionController:
    """SLO-aware admission at the cluster enqueue seam: reject early what
    would time out late.

    At dispatch the routed replica's finish time is estimated as
    ``now + slack × (predicted backlog / service rate + prefill ticks +
    ceil(q-reservation / speed))`` — the calibrated reservation is the
    pessimistic work estimate, so admission inherits the conformal
    controller's coverage guarantees. Requests whose estimate misses their
    deadline never enter the queue (``ClusterStats.rejected``, distinct from
    ``timed_out``); deadline-less requests are always admitted.

    ``slack`` scales the whole estimate: < 1 admits optimistically, > 1
    hedges. The decision reads only dispatch-tick engine state, so it is
    identical between the reference and vectorized decode paths.
    """

    slack: float = 1.0
    # optional telemetry sink — excluded from equality/hash so controllers
    # with and without tracing still compare equal on their policy knob
    tracer: object = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.slack <= 0:
            raise ValueError("slack must be positive")

    def admit(self, req: Request, engine, spec, now: float) -> bool:
        if req.deadline is None:
            if self.tracer is not None:
                self.tracer.emit(now, getattr(engine, "replica_id", -1),
                                 req.rid, "admission", ok=1, eta=float(now),
                                 deadline=-1.0)
            return True
        work = float(req.reserve_len) if req.reserve_len is not None \
            else quantile_remaining(req)
        # note: the engine grants the reservation page-rounded
        # (spec.page_size), but that slack is memory, not decode work — the
        # service-time estimate stays in raw tokens, so admission does not
        # over-reject short requests as pages grow
        decode = float(np.ceil(work / spec.speed))
        if spec.step_token_budget is not None:
            # chunked-prefill cost model: the prompt is consumed in chunks of
            # prefill_chunk_tokens (whole budget when atomic) drawn from the
            # per-step token budget, so prefill latency is ceil(prompt/chunk)
            ce = min(spec.prefill_chunk_tokens or spec.step_token_budget,
                     spec.step_token_budget)
            prefill = float(-(-int(req.prompt_len) // ce))
        else:
            pts = spec.prefill_tokens_per_step
            prefill = float(-(-int(req.prompt_len) // pts)) if pts > 0 else 0.0
        wait = engine.predicted_backlog() / spec.service_rate
        eta = now + self.slack * (wait + prefill + decode)
        ok = eta <= float(req.deadline)
        if self.tracer is not None:
            self.tracer.emit(now, getattr(engine, "replica_id", -1), req.rid,
                             "admission", ok=int(ok), eta=float(eta),
                             deadline=float(req.deadline))
        return ok
