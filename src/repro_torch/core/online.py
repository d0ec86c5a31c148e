"""ProD-O: online remaining-length prediction (beyond paper; its §5 roadmap).

The paper's formulation (§2.2) already covers t > 0: after t output tokens the
state z_t = {x, y_1..y_t} induces a distribution P(L_t | φ(z_t)) over the
REMAINING length. Repeated sampling per state is not available online (each
trajectory visits its states once), so supervision is single-draw — but the
predictor still outputs a K-bin distribution trained by CE and decoded by the
median (ProD's robust decode), TRAIL-style with ProD machinery.

This module builds the (φ(z_t), L − t) dataset from RealEngine generations,
trains the same head, and evaluates remaining-length MAE as a function of t —
the expected signature is error shrinking as decoding progresses, beating the
static prompt-only baseline max(median − t, 0).

It also hosts the serving-side half of that idea: :class:`PosteriorRefiner`
conditions a request's dispatch-time ProD-D histogram on the tokens it has
already emitted (P[L = ℓ | L > t] by truncate-and-renormalize, with an
optional learned hazard-rate correction), so scheduler keys and KV
reservations can re-read refreshed quantiles mid-flight instead of trusting
the prompt-only estimate forever.

The port of ``repro.core.online``: keys become integer seeds, the head
trains through the port's ``train_predictor`` and the hazard grid is
evaluated through ``LengthPredictor.quantiles`` (the ``prod_head`` kernel on
the GPU); the refiner and the tables are NumPy, copied line for line.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.config import PredictorConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import bins as bins_mod
from repro_torch.core.predictor import LengthPredictor, train_predictor
from repro_torch.core.targets import build_target


def build_online_dataset(
    step_hidden: np.ndarray,   # (B, T, d) per-step decode hidden states
    step_valid: np.ndarray,    # (B, T) bool
    lengths: np.ndarray,       # (B,) realized generation lengths
    stride: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten trajectories into (phi (N,d), remaining (N,), t (N,), b (N,))."""
    B, T, d = step_hidden.shape
    phis, rem, ts, bs = [], [], [], []
    for b in range(B):
        L = int(lengths[b])
        for t in range(0, min(L, T), stride):
            if not step_valid[b, t]:
                continue
            phis.append(step_hidden[b, t])
            rem.append(L - (t + 1))
            ts.append(t + 1)
            bs.append(b)
    return (np.stack(phis).astype(np.float32),
            np.asarray(rem, np.float32), np.asarray(ts, np.int64),
            np.asarray(bs, np.int64))


def train_online_predictor(
    seed: int,
    phi: np.ndarray,
    remaining: np.ndarray,
    pcfg: PredictorConfig,
    device: DeviceLike = None,
) -> LengthPredictor:
    dev = resolve_device(device)
    edges = bins_mod.make_edges(pcfg.n_bins, pcfg.bin_max, pcfg.bin_spacing,
                                device=dev)
    rem = torch.as_tensor(np.asarray(remaining), dtype=torch.float32, device=dev)
    target = build_target(rem[:, None], edges, "single")
    return train_predictor(seed, phi, target, pcfg, edges, device=dev)


# ---------------------------------------------------------------------------
# Posterior refinement: condition the dispatch histogram on survival to t
# ---------------------------------------------------------------------------

# survivor mass below this is treated as "t is at/past the histogram support":
# renormalizing residual float dust would decode garbage quantiles, so the
# refiner degenerates to an explicit point mass at the cap instead
_SURVIVOR_EPS = 1e-12


def _hazard_features(ts: np.ndarray, cap: float) -> np.ndarray:
    """Feature map φ(t) the hazard head conditions on: progress in log and
    linear scale plus a bias channel (tiny on purpose — the head must work
    from repeated-generation traces of a few thousand lengths)."""
    t = np.asarray(ts, np.float64)
    return np.stack([np.log1p(t), t / max(float(cap), 1.0),
                     np.sqrt(np.maximum(t, 0.0)) / np.sqrt(max(cap, 1.0)),
                     np.ones_like(t)], axis=-1).astype(np.float32)


@dataclass
class HazardTable:
    """Learned hazard-rate correction, pre-evaluated on a progress grid.

    ``probs[g]`` is the head's estimate of the *population* conditional
    distribution P[L ∈ bin_k | L > ts[g]] and ``prior`` the population
    marginal it was fit against. The refiner turns the pair into a
    multiplicative correction on naive truncation:

        c_k(t) = probs[g(t)]_k / truncate-renorm(prior, t)_k

    i.e. how much the *realized* survival law deviates from truncating the
    prompt-only marginal — systematic head miscalibration as a function of
    progress. The grid is evaluated once at fit time (one fused-kernel
    batch), so refine ticks stay pure NumPy lookups.
    """

    ts: np.ndarray                       # (G,) sorted progress grid
    probs: np.ndarray                    # (G, K) conditional distributions
    prior: np.ndarray                    # (K,) population marginal histogram
    clip: Tuple[float, float] = (0.25, 4.0)

    def row(self, t: float) -> np.ndarray:
        g = int(np.searchsorted(self.ts, float(t), side="right")) - 1
        return self.probs[min(max(g, 0), len(self.ts) - 1)]


def fit_hazard_table(
    seed: int,
    pred_probs: np.ndarray,    # (N, K) dispatch-time predictive histograms
    lengths: np.ndarray,       # (N,) realized decode lengths
    edges: np.ndarray,         # (K+1,) the serving head's bin edges
    t_grid: Optional[Sequence[int]] = None,
    hidden: int = 32,
    epochs: int = 30,
    clip: Tuple[float, float] = (0.25, 4.0),
    device: DeviceLike = None,
) -> HazardTable:
    """Fit the hazard-rate correction head from repeated-generation traces.

    Builds (φ(t), L) pairs for every trace length that survived past each
    grid point t, trains the shared 2-layer head (:mod:`repro.core.heads`
    via :func:`repro.core.predictor.train_predictor`) on single-draw CE
    targets, and evaluates it over the grid through the fused quantile
    kernel — the same inference path the serving head uses (one call, on
    ``device``). ``seed`` seeds the head's init and minibatch order.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, np.float64)
    lengths = np.asarray(lengths, np.float64)
    cap = float(edges[-1])
    if t_grid is None:
        # log-spaced progress checkpoints, deduplicated after int-rounding
        g = np.unique(np.round(np.geomspace(1.0, max(cap / 2.0, 2.0), 24))
                      .astype(np.int64))
        t_grid = [0] + list(g)
    ts, ls = [], []
    for t in t_grid:
        alive = lengths[lengths > t]
        ts.extend([float(t)] * len(alive))
        ls.extend(alive.tolist())
    phi = _hazard_features(np.asarray(ts), cap)
    pcfg = PredictorConfig(n_bins=len(edges) - 1, hidden=hidden,
                           bin_max=int(cap), bin_spacing="log", epochs=epochs)
    edges_t = torch.as_tensor(edges, dtype=torch.float32, device=dev)
    target = build_target(torch.as_tensor(ls, dtype=torch.float32,
                                          device=dev)[:, None], edges_t, "single")
    head = train_predictor(seed, phi, target, pcfg, edges_t, device=dev)
    grid = np.unique(np.asarray(t_grid, np.float64))      # sorted, distinct
    gp, _ = head.quantiles(_hazard_features(grid, cap), qs=(0.5,))
    return HazardTable(ts=grid, probs=gp.cpu().numpy().astype(np.float64),
                       prior=np.asarray(pred_probs, np.float64).mean(0),
                       clip=clip)


@dataclass
class PosteriorRefiner:
    """Mid-flight posterior over a request's total decode length.

    Given the dispatch-time ProD-D histogram ``p`` over ``edges`` and the
    ``t`` tokens the request has already emitted, the refiner returns the
    truncated-and-renormalized conditional P[L = ℓ | L > t]: bins fully
    below ``t`` get zero mass, the bin straddling ``t`` keeps the fraction
    of its width above ``t`` (the same uniform-within-bin model the
    CDF-crossing quantile decode interpolates with), and the rest is
    renormalized by the survivor mass S(t) = P[L > t].

    Quantiles decode from that conditional CDF with in-bin linear
    interpolation — consistent with :func:`repro.core.bins.decode_median` /
    the fused kernel at t = 0 — so every refreshed quantile is a *total*
    length, never below ``t``, and monotone in ``t``. When ``t`` is at or
    past the histogram support (S(t) ≈ 0) the posterior is an explicit
    degenerate point mass at the cap rather than a NaN-prone
    renormalization: every quantile returns ``max(cap, t + 1)``.

    ``hazard`` (a :class:`HazardTable`) multiplies the truncated mass by a
    learned, clipped correction for systematic deviation of realized
    survival from naive truncation; ``None`` is pure truncate-renorm.
    """

    edges: np.ndarray
    work_quantile: float = 0.9
    cap: Optional[float] = None
    hazard: Optional[HazardTable] = None

    def __post_init__(self):
        self.edges = np.asarray(self.edges, np.float64)
        if self.edges.ndim != 1 or len(self.edges) < 2:
            raise ValueError("edges must be a 1-D array of >= 2 bin edges")
        if not (0.0 < self.work_quantile < 1.0):
            raise ValueError("work_quantile must be in (0, 1)")
        self.cap = float(self.cap if self.cap is not None else self.edges[-1])

    # -- conditional mass ----------------------------------------------------

    def _mass(self, probs: np.ndarray, t: float) -> np.ndarray:
        """Unnormalized truncated (and hazard-corrected) bin masses."""
        e = self.edges
        lo, hi = e[:-1], e[1:]
        frac = np.clip((hi - float(t)) / np.maximum(hi - lo, 1e-300),
                       0.0, 1.0)
        m = np.asarray(probs, np.float64) * frac
        hz = self.hazard
        if hz is not None and m.sum() > _SURVIVOR_EPS:
            ref = np.asarray(hz.prior, np.float64) * frac
            s = ref.sum()
            if s > _SURVIVOR_EPS:
                c = np.clip(hz.row(t) / np.maximum(ref / s, 1e-12),
                            hz.clip[0], hz.clip[1])
                m = m * np.where(frac > 0.0, c, 1.0)
        return m

    def survivor(self, probs: np.ndarray, t: float) -> float:
        """S(t) = P[L > t] under the *uncorrected* dispatch histogram."""
        e = self.edges
        frac = np.clip((e[1:] - float(t)) / np.maximum(e[1:] - e[:-1], 1e-300),
                       0.0, 1.0)
        return float((np.asarray(probs, np.float64) * frac).sum())

    def condition(self, probs: np.ndarray, t: float) -> np.ndarray:
        """P[L ∈ bin_k | L > t] — a proper distribution for every t ≥ 0.

        Degenerate case (t at/past support): point mass in the last bin."""
        m = self._mass(probs, t)
        s = float(m.sum())
        if s <= _SURVIVOR_EPS:
            out = np.zeros(len(self.edges) - 1, np.float64)
            out[-1] = 1.0
            return out
        return m / s

    # -- quantile decode -----------------------------------------------------

    def quantiles(self, probs: np.ndarray, t: float, qs) -> np.ndarray:
        """Posterior *total-length* quantiles at CDF levels ``qs``.

        CDF-crossing + in-bin linear interpolation over the conditional
        histogram; the crossing bin interpolates from ``max(edge, t)`` so
        results are always ≥ t, clamped into [t, max(cap, t + 1)]."""
        t = float(t)
        m = self._mass(probs, t)
        s = float(m.sum())
        hi_clamp = max(self.cap, t + 1.0)
        out = np.empty(len(tuple(qs)), np.float64)
        if s <= _SURVIVOR_EPS:
            out[:] = hi_clamp          # degenerate point mass at the cap
            return out
        cum = np.cumsum(m)
        e = self.edges
        for j, q in enumerate(qs):
            tgt = float(q) * s
            k = int(np.searchsorted(cum, tgt, side="left"))
            k = min(k, len(m) - 1)
            prev = cum[k - 1] if k else 0.0
            left = max(float(e[k]), t)
            right = float(e[k + 1])
            f = 0.0 if m[k] <= _SURVIVOR_EPS \
                else min(max((tgt - prev) / m[k], 0.0), 1.0)
            out[j] = min(max(left + f * (right - left), t), hi_clamp)
        return out

    def quantile(self, probs: np.ndarray, t: float, q: float) -> float:
        return float(self.quantiles(probs, t, (q,))[0])

    def level_of(self, probs: np.ndarray, value: float) -> float:
        """Inverse decode: the CDF level of ``value`` under the *dispatch*
        histogram (in-bin linear interpolation). Recovers the effective
        quantile level a reservation was cut at — e.g. an OnlineAdapter's
        ACI-adjusted ``q_eff`` — so refinement can re-cut the reservation
        at the same conformal level on the posterior."""
        e = self.edges
        p = np.asarray(probs, np.float64)
        v = float(value)
        if v <= float(e[0]):
            return 0.0
        if v >= float(e[-1]):
            return 1.0
        k = int(np.searchsorted(e, v, side="right")) - 1
        k = min(max(k, 0), len(p) - 1)
        cum = float(p[:k].sum())
        width = float(e[k + 1] - e[k])
        frac = (v - float(e[k])) / width if width > 0 else 1.0
        return min(max(cum + float(p[k]) * frac, 0.0), 1.0)


def evaluate_by_progress(
    predictor: LengthPredictor,
    phi: np.ndarray,
    remaining: np.ndarray,
    ts: np.ndarray,
    static_total_pred: Optional[np.ndarray] = None,   # per-sample prompt-only L̂
    n_buckets: int = 4,
) -> Dict[str, Dict[int, float]]:
    """Remaining-length MAE bucketed by decode progress t; compares the online
    head against the static baseline max(L̂_prompt − t, 0)."""
    pred = predictor.predict(np.asarray(phi)).cpu().numpy()
    out: Dict[str, Dict[int, float]] = {"online": {}, "static": {}, "count": {}}
    edges = np.quantile(ts, np.linspace(0, 1, n_buckets + 1))
    for i in range(n_buckets):
        m = (ts >= edges[i]) & (ts <= edges[i + 1] if i == n_buckets - 1
                                else ts < edges[i + 1])
        if not m.any():
            continue
        lo = int(edges[i])
        out["online"][lo] = float(np.mean(np.abs(pred[m] - remaining[m])))
        out["count"][lo] = int(m.sum())
        if static_total_pred is not None:
            stat = np.maximum(static_total_pred[m] - ts[m], 0.0)
            out["static"][lo] = float(np.mean(np.abs(stat - remaining[m])))
    return out
