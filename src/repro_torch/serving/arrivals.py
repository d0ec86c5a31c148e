"""Open-loop arrival traces for the cluster simulator.

Generates request streams whose decode lengths are drawn from the calibrated
heavy-tailed prompt-conditioned laws in :mod:`repro.data.scenarios` — any one
of the eight (served model × scenario) settings, or a traffic mix over all of
them — under three arrival processes:

* ``poisson``  — homogeneous Poisson (exponential interarrivals);
* ``bursty``   — 2-state Markov-modulated Poisson (calm/burst), normalized so
  the long-run mean rate equals ``rate``;
* ``diurnal``  — sinusoidally modulated rate via thinning,
  λ(t) = rate·(1 + amp·sin(2πt/period)); for ``amp > 1`` the sinusoid is
  clamped at 0 (dead-of-night silence) and rescaled so the long-run mean
  rate still equals ``rate``.

Traces can carry **shared context**: ``session_frac``/``agentic_frac`` turn
a fraction of base requests into multi-turn chat sessions / agentic tool
loops whose follow-up prompts extend the previous turn's full context, and
``system_prompt_len`` prepends a per-scenario common system prompt. Every
such request is tagged with ``prefix_id``/``prefix_len`` so a
``share_prefixes=True`` KV pool can back the common tokens with ref-counted
shared pages and the ``prefix_affine`` router can keep sessions where their
pages live. All knobs default off — the trace is then bit-identical to the
session-free generator.

Each request carries φ = its (noise-corrupted) length-law latents, so the
:class:`LatentOracle` can stand in for a trained ProD head at trace scale:
its median/quantile predictions are exact functionals of the corrupted
latents, and the corruption level follows the paper's feature-informativeness
calibration (``feature_sigma``) — chat traffic is genuinely harder to predict
than math. True lengths are drawn from the *clean* latents.

The port's own copy of ``repro.serving.arrivals`` (NumPy only), kept line
for line so that the same ``TraceConfig`` gives the same trace bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.lengths import law_quantile, sample_lengths, sample_prompt_latents
from repro_torch.data.scenarios import ALL_SETTINGS, feature_sigma, get_spec
from repro_torch.serving.request import Request


@dataclass(frozen=True)
class DriftSpec:
    """Non-stationary workload: how the length laws move mid-trace.

    The drift is deliberately *invisible in features*: the multiplier inflates
    the clean latents that true lengths are drawn from, while each request's
    φ keeps its pre-drift distribution. A predictor fit before the switch
    therefore silently under-covers afterwards — the regime the online
    adaptation subsystem (:mod:`repro.serving.adaptation`) exists for.

    Parameters
    ----------
    switch_step : trace time of the regime change.
    scale_mult : post-switch multiplier on every prompt's true-length median
        (1.0 = no scale drift).
    mix_weights : post-switch arrival weights over ``cfg.settings()`` — a
        scenario-mix shift (e.g. traffic turning mostly chat). ``None`` keeps
        the uniform mix.
    ramp_steps : 0 makes the scale change abrupt at ``switch_step``; > 0
        interpolates the log multiplier linearly over
        ``[switch_step, switch_step + ramp_steps]``.
    """

    switch_step: float
    scale_mult: float = 1.0
    mix_weights: Optional[Tuple[float, ...]] = None
    ramp_steps: float = 0.0

    def __post_init__(self):
        if self.switch_step < 0:
            raise ValueError("switch_step must be >= 0")
        if self.scale_mult <= 0:
            raise ValueError("scale_mult must be positive")
        if self.ramp_steps < 0:
            raise ValueError("ramp_steps must be >= 0")

    def log_scale_at(self, t: np.ndarray) -> np.ndarray:
        """Per-arrival log multiplier on the true-length median."""
        full = np.log(self.scale_mult)
        if self.ramp_steps <= 0:
            return np.where(np.asarray(t) >= self.switch_step, full, 0.0)
        frac = np.clip((np.asarray(t) - self.switch_step) / self.ramp_steps,
                       0.0, 1.0)
        return full * frac


@dataclass(frozen=True)
class TraceConfig:
    """Open-loop trace specification: arrivals × length laws × SLOs.

    Parameters
    ----------
    n_requests : trace length.
    pattern : arrival process — ``poisson`` | ``bursty`` (2-state MMPP) |
        ``diurnal`` (sinusoidally thinned); see module docstring.
    rate : long-run mean arrivals per engine step (all patterns normalize
        to it).
    model, scenario : which calibrated length law(s) draw decode lengths —
        a single setting or ``"mix"`` over all of them.
    seed : one seed drives arrivals, latents, lengths, and feature noise —
        traces are fully deterministic.
    prompt_min, prompt_max : uniform prompt-length range, both ends
        *inclusive* (KV admission cost).
    max_seq_len : serve cap; decode lengths are clipped to it.
    view : predictor probe view (``last``/``mean``/``proxy``/``entropy``) —
        sets the feature-noise level requests carry (see
        :func:`~repro.data.scenarios.feature_sigma`).
    slo_factor, slo_floor : per-class SLOs — deadline = arrival + slo_floor
        + slo_factor × the class law's median scale. Both 0 disables SLOs.
    drift : optional :class:`DriftSpec` making the workload non-stationary
        (scenario-mix shift and/or true-length scale inflation at a switch
        step). ``None`` keeps the stationary trace bit-identical to before.
    burst_* : bursty-pattern shape; diurnal_* : diurnal-pattern shape
        (``diurnal_amp`` must be >= 0; above 1 the modulated rate is clamped
        at 0 and renormalized to preserve the mean — see module docstring).
    session_frac : fraction of base requests that seed a multi-turn chat
        session; follow-up turns (1 + Geometric(mean ``session_turns_mean``)
        of them) re-submit the full previous context (prompt + answer) plus
        fresh user tokens, arriving ``exp(session_gap_mean)`` steps after
        the previous answer could have finished. Each turn carries
        ``prefix_id="chat/<seed rid>"`` with ``prefix_len`` = the inherited
        context. Session turns are *appended* to the trace: it then holds
        more than ``n_requests`` requests.
    agentic_frac : like ``session_frac`` but for agentic tool loops: short
        think-time gaps (``agentic_gap_mean``), small tool-output glue
        between turns, ``agentic_turns_mean`` extra calls on average
        (``prefix_id="agent/<seed rid>"``). A base request seeds at most one
        of the two (``session_frac + agentic_frac <= 1``).
    session_turns_mean, session_gap_mean, agentic_turns_mean,
    agentic_gap_mean : shape knobs for the above.
    system_prompt_len : tokens of a per-scenario common system prompt
        prepended to every base request's prompt
        (``prefix_id="sys/<setting>"``) — the classic always-shared prefix.
    """

    n_requests: int = 50_000
    pattern: str = "poisson"        # poisson | bursty | diurnal
    rate: float = 1.0               # mean arrivals per engine step
    model: str = "mix"              # qwen | llama | mix
    scenario: str = "mix"           # math | coding | longseq | chat | mix
    seed: int = 0
    prompt_min: int = 16
    prompt_max: int = 256
    max_seq_len: int = 4096         # decode lengths clipped to the serve cap
    view: str = "last"              # predictor probe view (feature noise)
    # per-class SLOs: deadline = arrival + slo_floor + slo_factor × the
    # setting's typical length (its law's median scale) — chat gets a bigger
    # absolute budget than math, the per-token budget is shared. 0 = no SLOs.
    slo_factor: float = 0.0
    slo_floor: float = 0.0
    # non-stationarity (None = stationary trace, unchanged behavior)
    drift: Optional[DriftSpec] = None
    # bursty (2-state MMPP)
    burst_rate_mult: float = 6.0
    burst_len_mean: float = 200.0   # mean steps per burst episode
    calm_len_mean: float = 1800.0
    # diurnal
    diurnal_period: float = 20_000.0
    diurnal_amp: float = 0.8
    # shared-context workloads (all 0 = off: trace bit-identical to before)
    session_frac: float = 0.0
    session_turns_mean: float = 3.0
    session_gap_mean: float = 200.0
    agentic_frac: float = 0.0
    agentic_turns_mean: float = 6.0
    agentic_gap_mean: float = 8.0
    system_prompt_len: int = 0

    def __post_init__(self):
        if self.diurnal_amp < 0:
            raise ValueError(
                f"diurnal_amp must be >= 0, got {self.diurnal_amp} (negative "
                "amplitudes are a phase shift in disguise; use amp >= 0)")
        if not 0.0 <= self.session_frac <= 1.0:
            raise ValueError("session_frac must be in [0, 1]")
        if not 0.0 <= self.agentic_frac <= 1.0:
            raise ValueError("agentic_frac must be in [0, 1]")
        if self.session_frac + self.agentic_frac > 1.0:
            raise ValueError("session_frac + agentic_frac must be <= 1")
        if self.system_prompt_len < 0:
            raise ValueError("system_prompt_len must be >= 0")
        if min(self.session_turns_mean, self.session_gap_mean,
               self.agentic_turns_mean, self.agentic_gap_mean) < 0:
            raise ValueError("session/agentic turn and gap means must be >= 0")
        if not 0 <= self.prompt_min <= self.prompt_max:
            raise ValueError("need 0 <= prompt_min <= prompt_max")

    @property
    def has_sessions(self) -> bool:
        """Does this trace carry any shared-context traffic?"""
        return (self.session_frac > 0 or self.agentic_frac > 0
                or self.system_prompt_len > 0)

    def settings(self) -> Tuple[Tuple[str, str], ...]:
        if self.model == "mix" and self.scenario == "mix":
            return ALL_SETTINGS
        models = ("qwen", "llama") if self.model == "mix" else (self.model,)
        scens = (("math", "coding", "longseq", "chat")
                 if self.scenario == "mix" else (self.scenario,))
        return tuple((m, s) for m in models for s in scens)


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------


def _poisson_arrivals(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _bursty_arrivals(cfg: TraceConfig, rng: np.random.Generator,
                     n: int) -> np.ndarray:
    """2-state MMPP: alternate exponential-length calm/burst episodes; draw
    the arrivals inside an episode as uniform order statistics of a Poisson
    count. Base rate is scaled so the long-run mean equals cfg.rate."""
    p_burst = cfg.burst_len_mean / (cfg.burst_len_mean + cfg.calm_len_mean)
    mean_mult = (1.0 - p_burst) + p_burst * cfg.burst_rate_mult
    base = cfg.rate / mean_mult
    out: List[np.ndarray] = []
    t, total, burst = 0.0, 0, False
    while total < n:
        mean_len = cfg.burst_len_mean if burst else cfg.calm_len_mean
        dur = float(rng.exponential(mean_len))
        lam = base * (cfg.burst_rate_mult if burst else 1.0)
        k = int(rng.poisson(lam * dur))
        if k:
            out.append(t + np.sort(rng.random(k)) * dur)
            total += k
        t += dur
        burst = not burst
    return np.concatenate(out)[:n]


def _diurnal_arrivals(cfg: TraceConfig, rng: np.random.Generator,
                      n: int) -> np.ndarray:
    """Inhomogeneous Poisson via thinning against the modulation's peak.

    ``amp <= 1``: λ(t) = rate·(1 + amp·sin(2πt/period)), mean-rate ``rate``
    by symmetry. ``amp > 1`` would push λ(t) negative through the troughs —
    the raw sinusoid is not a rate — so λ is clamped at 0 there and divided
    by the clipped sinusoid's mean, E[max(0, 1 + amp·sin θ)] =
    (π + 2·arcsin(1/amp) + 2·amp·cos(arcsin(1/amp))) / 2π, keeping the
    long-run mean rate equal to ``rate`` (the normalization every arrival
    pattern promises). Without the renormalization the clamp silently
    *inflates* the mean rate — the pre-fix bug."""
    amp = cfg.diurnal_amp
    if amp > 1.0:
        crit = np.arcsin(1.0 / amp)
        mean_pos = (np.pi + 2.0 * crit + 2.0 * amp * np.cos(crit)) \
            / (2.0 * np.pi)
    else:
        mean_pos = 1.0          # exact: keeps amp <= 1 traces bit-identical
    lam_max = cfg.rate * (1.0 + amp) / mean_pos
    kept: List[np.ndarray] = []
    t, total = 0.0, 0
    while total < n:
        chunk = max(1024, 2 * (n - total))
        cand = t + np.cumsum(rng.exponential(1.0 / lam_max, size=chunk))
        lam_t = cfg.rate / mean_pos * np.maximum(
            0.0, 1.0 + amp * np.sin(2.0 * np.pi * cand / cfg.diurnal_period))
        keep = cand[rng.random(chunk) < lam_t / lam_max]
        kept.append(keep)
        total += len(keep)
        t = float(cand[-1])
    return np.concatenate(kept)[:n]


def arrival_times(cfg: TraceConfig, rng: np.random.Generator) -> np.ndarray:
    n = cfg.n_requests
    if n <= 0:
        return np.zeros(0, np.float64)
    if cfg.pattern == "poisson":
        return _poisson_arrivals(rng, n, cfg.rate)
    if cfg.pattern == "bursty":
        return _bursty_arrivals(cfg, rng, n)
    if cfg.pattern == "diurnal":
        return _diurnal_arrivals(cfg, rng, n)
    raise ValueError(cfg.pattern)


# ---------------------------------------------------------------------------
# trace construction
# ---------------------------------------------------------------------------


def corrupt_latents(rng: np.random.Generator, lat: np.ndarray, spec,
                    view: str) -> np.ndarray:
    """Noise-corrupt clean length-law latents into predictor features.

    Adds ``feature_sigma(spec, view)``-scaled Gaussian noise to the log-median
    coordinate — the paper's feature-informativeness calibration (chat ≫
    math; last > mean > proxy > entropy). This one helper defines the feature
    distribution BOTH the trace generator (request φ) and
    :func:`~repro.serving.predictor.fit_trace_head` (training features) draw
    from, so the trained head is never evaluated off-distribution."""
    noisy = lat.copy()
    noisy[:, 0] += feature_sigma(spec, view) * rng.standard_normal(len(lat))
    return noisy


def make_trace(cfg: TraceConfig) -> List[Request]:
    """Build an open-loop request trace: Poisson/bursty/diurnal arrivals with
    heavy-tailed prompt-conditioned lengths from the calibrated scenario laws.

    Deterministic for a fixed config (single seeded Generator). Requests come
    back sorted by arrival with φ = noise-corrupted latents attached.

    With ``cfg.drift`` set the trace is non-stationary: arrivals after the
    switch step re-draw their scenario from ``drift.mix_weights`` and their
    *true* lengths from scale-inflated latents, while φ stays on the pre-drift
    feature distribution (see :class:`DriftSpec` — the drift is invisible to
    any predictor that only sees features)."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_requests
    arrivals = arrival_times(cfg, rng)
    settings = cfg.settings()
    pick = rng.integers(0, len(settings), size=n)
    drift = cfg.drift
    log_shift = None
    if drift is not None:
        if drift.mix_weights is not None:
            w = np.asarray(drift.mix_weights, np.float64)
            if w.shape != (len(settings),) or np.any(w < 0) or w.sum() <= 0:
                raise ValueError(
                    f"mix_weights must be {len(settings)} non-negative "
                    f"weights (one per cfg.settings() entry), got {w}")
            post_pick = rng.choice(len(settings), size=n, p=w / w.sum())
            pick = np.where(arrivals >= drift.switch_step, post_pick, pick)
        log_shift = drift.log_scale_at(arrivals)

    true_len = np.zeros(n, np.int64)
    phi = np.zeros((n, 4), np.float64)
    slo_budget = np.zeros(n, np.float64)
    for si, (model, scen) in enumerate(settings):
        idx = np.nonzero(pick == si)[0]
        if len(idx) == 0:
            continue
        spec = get_spec(model, scen)
        lat = sample_prompt_latents(rng, spec.law, len(idx))
        lat_true = lat
        if log_shift is not None:
            lat_true = lat.copy()
            lat_true[:, 0] += log_shift[idx]
        true_len[idx] = sample_lengths(rng, lat_true, 1, spec.law)[:, 0]
        phi[idx] = corrupt_latents(rng, lat, spec, cfg.view)
        slo_budget[idx] = cfg.slo_floor + cfg.slo_factor * spec.law.median_scale
    true_len = np.minimum(true_len, cfg.max_seq_len)
    # inclusive on both ends, as the TraceConfig docstring promises (the
    # pre-fix exclusive upper bound made prompt_max unreachable)
    plen = rng.integers(cfg.prompt_min, cfg.prompt_max, size=n, endpoint=True)
    with_slo = cfg.slo_factor > 0.0 or cfg.slo_floor > 0.0

    reqs = [
        Request(
            rid=i, arrival=float(arrivals[i]), prompt_len=int(plen[i]),
            true_len=int(true_len[i]), phi=phi[i],
            setting="/".join(settings[pick[i]]),
            deadline=float(arrivals[i] + slo_budget[i]) if with_slo else None,
        )
        for i in range(n)
    ]
    if cfg.has_sessions:
        _attach_sessions(cfg, rng, reqs, pick, settings, slo_budget, with_slo)
    reqs.sort(key=lambda r: r.arrival)
    return reqs


def _attach_sessions(cfg: TraceConfig, rng: np.random.Generator,
                     reqs: List[Request], pick: np.ndarray, settings,
                     slo_budget: np.ndarray, with_slo: bool):
    """Turn base requests into shared-context traffic, in place.

    System prompts: every base request gets ``system_prompt_len`` extra
    prompt tokens tagged ``prefix_id="sys/<setting>"`` — one common prefix
    per scenario, shared across unrelated requests.

    Sessions/agentic loops: a ``session_frac``/``agentic_frac`` split of the
    base requests each seeds a turn chain. Turn k+1 resubmits turn k's whole
    context (prompt + realized answer) plus fresh user/tool tokens, arrives
    after the previous answer's decode time plus a think-time gap, and
    declares the inherited context via ``prefix_id``/``prefix_len`` so a
    sharing KV pool recognizes it. Follow-up turns draw fresh lengths from
    the seed's scenario law (stationary — drift applies to base arrivals
    only) and are *appended*: rids continue past ``n_requests``. Chains stop
    before the context would crowd out decode room under ``max_seq_len``.

    All extra randomness is drawn after the base trace is fully built, so
    switching sessions on never perturbs the base requests' draws."""
    n = len(reqs)
    rid = n
    if cfg.system_prompt_len > 0:
        for r in reqs:
            r.prompt_len += cfg.system_prompt_len
            r.prefix_id = f"sys/{r.setting}"
            r.prefix_len = cfg.system_prompt_len
    u = rng.random(n)
    extra: List[Request] = []
    ctx_cap = cfg.max_seq_len - max(64, cfg.prompt_max)
    for i in range(n):
        chat = u[i] < cfg.session_frac
        agentic = (not chat
                   and u[i] < cfg.session_frac + cfg.agentic_frac)
        if not (chat or agentic):
            continue
        seed = reqs[i]
        spec = get_spec(*settings[pick[i]])
        turns_mean = cfg.session_turns_mean if chat else cfg.agentic_turns_mean
        gap_mean = cfg.session_gap_mean if chat else cfg.agentic_gap_mean
        turns = int(rng.geometric(min(1.0, 1.0 / max(turns_mean, 1.0))))
        sid = f"{'chat' if chat else 'agent'}/{seed.rid}"
        ctx, prev_ans, t_prev = seed.prompt_len, seed.true_len, seed.arrival
        for _ in range(turns):
            fresh = int(rng.integers(cfg.prompt_min, cfg.prompt_max,
                                     endpoint=True)) if chat \
                else int(rng.integers(8, 32, endpoint=True))
            new_prompt = ctx + prev_ans + fresh
            if new_prompt > ctx_cap:
                break       # context budget exhausted: session ends
            lat = sample_prompt_latents(rng, spec.law, 1)
            t_len = min(int(sample_lengths(rng, lat, 1, spec.law)[0, 0]),
                        cfg.max_seq_len)
            t_arr = t_prev + float(prev_ans) + float(rng.exponential(gap_mean))
            extra.append(Request(
                rid=rid, arrival=t_arr, prompt_len=new_prompt,
                true_len=t_len,
                phi=corrupt_latents(rng, lat, spec, cfg.view)[0],
                setting=seed.setting,
                deadline=(t_arr + float(slo_budget[i])) if with_slo else None,
                prefix_id=sid, prefix_len=ctx + prev_ans,
            ))
            rid += 1
            ctx, prev_ans, t_prev = new_prompt, t_len, t_arr
    reqs.extend(extra)


class LatentOracle:
    """Trace-scale ProD-predictor proxy: predicts from each request's
    (noise-corrupted) length-law latents instead of a trained head.

    One of the three interchangeable predictors behind the cluster's
    ``predictor=`` seam — the analytic proxy, bracketed by the trained
    :class:`~repro.serving.predictor.PredictorService` (the paper's actual
    head) and the zero-error
    :class:`~repro.serving.predictor.PerfectOracle`.

    ``predict`` returns the body median exp(log m̃) — the ProD-M point
    estimate — and ``quantile`` inverts the full body+tail mixture CDF at the
    corrupted latents — the ProD-D distributional estimate. Because log m̃
    carries ``feature_sigma``-scaled noise, prediction quality degrades
    exactly where the paper says features are least informative."""

    def predict(self, phi: np.ndarray) -> np.ndarray:
        return np.exp(np.asarray(phi, np.float64)[:, 0])

    def quantile(self, phi: np.ndarray, q: float) -> np.ndarray:
        return law_quantile(np.asarray(phi, np.float64), q)


def mean_true_length(reqs: Sequence[Request]) -> float:
    return float(np.mean([r.true_len for r in reqs]))


def stable_rate(n_replicas: int, max_slots: int, mean_len: float,
                load: float = 0.7) -> float:
    """Arrival rate giving the cluster utilization ``load``: each slot emits
    one token per step, so capacity is n_replicas·max_slots/mean_len req/step."""
    return load * n_replicas * max_slots / max(mean_len, 1.0)


def stable_rate_specs(specs, mean_len: float, load: float = 0.7) -> float:
    """Heterogeneity-aware :func:`stable_rate`: cluster decode capacity is
    Σ slots·speed tokens/step over the :class:`ReplicaSpec` fleet (prefill
    cost is ignored — treat ``load`` as a decode-utilization target)."""
    service = float(sum(s.max_slots * s.speed for s in specs))
    return load * service / max(mean_len, 1.0)
