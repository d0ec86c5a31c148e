"""Heavy-tailed prompt-conditioned output-length laws.

Each prompt i carries latent (m_i, σ_i, w_i, α_i): conditional on the prompt,

    L  ~  m_i · LogNormal(0, σ_i)                 w.p. 1 − w_i   (body)
    L  ~  m_i · (1 + Pareto(α_i))                 w.p. w_i       (tail)

The lognormal body has median m_i (so the prompt median is stable), while the
Pareto tail produces the occasional multi-× generations the paper documents
(max/median 2–4× over 100 repeats). This is the data-generating family the
paper's Observations 1–2 are consistent with; Assumption 1's (1+ε)-moment
bound holds for α > 1 + ε.

The port's own copy of ``repro.data.lengths`` (NumPy only): the same seed gives the
same arrays, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class LengthLaw:
    """Scenario-level hyper-parameters for the per-prompt latents."""

    median_scale: float        # cross-prompt median of m_i
    median_spread: float       # lognormal σ of m_i across prompts
    sigma_body: float          # within-prompt lognormal σ (sets the noise radius)
    tail_weight: float         # P(tail draw)
    tail_alpha: float          # Pareto index (smaller = heavier)
    min_len: int = 4
    max_len: int = 1 << 17


def sample_prompt_latents(
    rng: np.random.Generator, law: LengthLaw, n: int
) -> np.ndarray:
    """Per-prompt latent matrix z (n, 4): [log m, σ, w, α]."""
    log_m = np.log(law.median_scale) + law.median_spread * rng.standard_normal(n)
    sigma = law.sigma_body * np.exp(0.25 * rng.standard_normal(n))
    w = np.clip(law.tail_weight * np.exp(0.5 * rng.standard_normal(n)), 0.0, 0.4)
    alpha = np.clip(law.tail_alpha * np.exp(0.15 * rng.standard_normal(n)), 1.1, 8.0)
    return np.stack([log_m, sigma, w, alpha], axis=1)


def sample_lengths(
    rng: np.random.Generator, latents: np.ndarray, r: int, law: LengthLaw
) -> np.ndarray:
    """r independent generations per prompt. latents (n,4) -> lengths (n, r)."""
    n = latents.shape[0]
    m = np.exp(latents[:, 0])[:, None]
    sigma = latents[:, 1][:, None]
    w = latents[:, 2][:, None]
    alpha = latents[:, 3][:, None]
    body = m * np.exp(sigma * rng.standard_normal((n, r)))
    # Pareto tail via inverse CDF: L = m · u^{-1/α} ≥ m
    u = rng.random((n, r))
    tail = m * (u ** (-1.0 / alpha))
    pick_tail = rng.random((n, r)) < w
    L = np.where(pick_tail, tail, body)
    return np.clip(np.rint(L), law.min_len, law.max_len).astype(np.int64)


def true_conditional_median(latents: np.ndarray) -> np.ndarray:
    """Population median of the mixture ≈ body median m (tail weight ≤ 0.4
    keeps the mixture median inside the body; exact for w < 0.5 up to the
    body/tail overlap, adequate as the θ*-target for the theory checks)."""
    return np.exp(latents[:, 0])


def _ndtr(z: np.ndarray) -> np.ndarray:
    """Standard-normal CDF, vectorized. scipy when present, math.erf else."""
    try:
        from scipy.special import ndtr
        return ndtr(z)
    except ImportError:  # pragma: no cover - scipy ships in the image
        import math
        return 0.5 * (1.0 + np.vectorize(math.erf)(z / np.sqrt(2.0)))


def law_quantile(latents: np.ndarray, q: float) -> np.ndarray:
    """Per-prompt q-quantile of the body+tail length mixture, vectorized.

    CDF(x) = (1−w)·Φ((ln x − ln m)/σ) + w·[1 − (x/m)^{−α}]₊ has no closed
    inverse, so invert by geometric bisection in x. This is the exact
    distributional object a ProD-D head estimates — the serving layer uses it
    for quantile KV reservation at trace scale, where training a head per
    50k-request trace would dominate the benchmark."""
    latents = np.asarray(latents, np.float64)
    m = np.exp(latents[:, 0])
    sigma = np.maximum(latents[:, 1], 1e-6)
    w = np.clip(latents[:, 2], 0.0, 0.999)
    alpha = np.maximum(latents[:, 3], 1.01)

    def cdf(x):
        body = _ndtr((np.log(np.maximum(x, 1e-12)) - np.log(m)) / sigma)
        tail = np.where(x >= m, 1.0 - (np.maximum(x, 1e-12) / m) ** (-alpha),
                        0.0)
        return (1.0 - w) * body + w * tail

    lo = m * np.exp(-8.0 * sigma)
    # upper bracket: body saturates by e^{8σ}; the tail reaches q at
    # m·((1−q)/w)^{−1/α} once the body has saturated — take the max, doubled
    tail_hi = np.where(
        w > 1e-12,
        (np.maximum(1.0 - q, 1e-12) / np.maximum(w, 1e-12)) ** (-1.0 / alpha),
        1.0,
    )
    hi = 2.0 * m * np.maximum(np.exp(8.0 * sigma), np.maximum(tail_hi, 1.0))
    for _ in range(60):
        mid = np.sqrt(lo * hi)
        below = cdf(mid) < q
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return hi
