"""Theoretical analysis utilities (paper §2.3, Theorem 1, Appendix B).

The port's own copy of ``repro.core.theory`` (NumPy only): the same inputs
give the same outputs, bit for bit.

Implements the linear ridge surrogate with median-of-r labels and the
quantities in Theorem 1, plus empirical validators:

* ``lemma3_moment`` — E|median(X_1..X_r)|^{1+ε} ≤ 2v (Lemma 3);
* ``failure_prob`` — the 4N·exp(−r/8) repeated-sampling failure term;
* ``r_required``   — r ≥ 8·log(4N/δ) making the bound hold w.p. ≥ 1−2δ;
* ``theorem1_bound`` — β_N and the per-point bound β_N·‖φ(x)‖_{V_N^{-1}}.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np


@dataclass
class RidgeFit:
    theta: np.ndarray          # (d,)
    vn: np.ndarray             # (d, d) = λI + Σ φφᵀ
    vn_inv: np.ndarray
    lam: float


def ridge_fit(phi: np.ndarray, labels: np.ndarray, lam: float = 1.0) -> RidgeFit:
    """θ̂_N = V_N^{-1} Σ_i L̄_i φ(x_i)  (App. B closed form)."""
    phi = np.asarray(phi, np.float64)
    d = phi.shape[1]
    vn = lam * np.eye(d) + phi.T @ phi
    vn_inv = np.linalg.inv(vn)
    theta = vn_inv @ (phi.T @ np.asarray(labels, np.float64))
    return RidgeFit(theta=theta, vn=vn, vn_inv=vn_inv, lam=lam)


def vn_norm(fit: RidgeFit, x: np.ndarray) -> np.ndarray:
    """‖φ(x)‖_{V_N^{-1}} — the self-normalized uncertainty term."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    return np.sqrt(np.einsum("nd,de,ne->n", x, fit.vn_inv, x))


def failure_prob(N: int, r: int) -> float:
    return float(4.0 * N * np.exp(-r / 8.0))


def r_required(N: int, delta: float) -> int:
    return int(np.ceil(8.0 * np.log(4.0 * N / delta)))


def theorem1_constants(v: float, eps: float, N: int, delta: float) -> Tuple[float, float]:
    """C = (4v)^{1/(1+ε)},  ρ_δ = 2C ln(8N/δ) + 4C^{-ε} v."""
    C = (4.0 * v) ** (1.0 / (1.0 + eps))
    rho = 2.0 * C * np.log(8.0 * N / delta) + 4.0 * C ** (-eps) * v
    return C, rho


def theorem1_beta(
    N: int, d: int, v: float, eps: float, delta: float, lam: float, S: float
) -> float:
    """β_N = sqrt(ρ² N^{(1-ε)/(1+ε)} + 2Cρ d N^{(1-ε)/(1+ε)} log(1+N/λd)) + √λ S."""
    C, rho = theorem1_constants(v, eps, N, delta)
    pw = N ** ((1.0 - eps) / (1.0 + eps))
    return float(
        np.sqrt(rho**2 * pw + 2.0 * C * rho * d * pw * np.log(1.0 + N / (lam * d)))
        + np.sqrt(lam) * S
    )


def theorem1_pointwise_bound(fit: RidgeFit, x: np.ndarray, beta: float) -> np.ndarray:
    return beta * vn_norm(fit, x)


# ---------------------------------------------------------------------------
# empirical validators
# ---------------------------------------------------------------------------


def lemma3_moment(
    sampler: Callable[[np.random.Generator, Tuple[int, ...]], np.ndarray],
    r: int,
    eps: float,
    n_trials: int = 20000,
    seed: int = 0,
) -> Tuple[float, float]:
    """Empirical (E|X|^{1+ε}, E|median_r|^{1+ε}) — Lemma 3 says the second is
    ≤ 2× the first for symmetric X."""
    rng = np.random.default_rng(seed)
    x = sampler(rng, (n_trials, r))
    base = float(np.mean(np.abs(x[:, 0]) ** (1.0 + eps)))
    med = np.median(x, axis=1)
    med_moment = float(np.mean(np.abs(med) ** (1.0 + eps)))
    return base, med_moment


def median_label_noise(lengths: np.ndarray, true_median: np.ndarray) -> np.ndarray:
    """η̄_i = median(L_i1..L_ir) − median*(x_i): the label noise Theorem 1 controls."""
    return np.median(lengths, axis=1) - true_median


def empirical_coverage(
    fit: RidgeFit, phi_test: np.ndarray, true_vals: np.ndarray, beta: float
) -> float:
    """Fraction of test points with |φᵀθ* − φᵀθ̂| ≤ β‖φ‖_{V_N^{-1}} (should be
    ≥ 1−2δ when r ≥ r_required)."""
    pred = phi_test @ fit.theta
    bound = theorem1_pointwise_bound(fit, phi_test, beta)
    return float(np.mean(np.abs(pred - true_vals) <= bound))
