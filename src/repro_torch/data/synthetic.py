"""Track-A scenario datasets: repeated-sampling lengths + feature views.

The latent (log m, σ, w, α) of each prompt drives its length distribution;
feature views are noisy nonlinear embeddings of those latents, with per-view
noise encoding each probe's information content (see ``scenarios.VIEW_NOISE``).
The head must learn view → conditional-median through the same nonlinearity
for every method — only the supervision target differs, as in the paper.

The port's own copy of ``repro.data.synthetic`` (NumPy only): the same seed gives the
same arrays, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.data import scenarios as sc
from repro_torch.data.lengths import (
    LengthLaw,
    sample_lengths,
    sample_prompt_latents,
    true_conditional_median,
)


@dataclass
class ScenarioData:
    model: str
    scenario: str
    r: int
    len_train: np.ndarray               # (N, r) int
    len_test: np.ndarray                # (Nt, r) int
    phi_train: Dict[str, np.ndarray]    # view -> (N, d)
    phi_test: Dict[str, np.ndarray]
    latents_train: np.ndarray           # (N, 4)
    latents_test: np.ndarray
    spec: sc.ScenarioSpec

    @property
    def true_median_train(self) -> np.ndarray:
        return true_conditional_median(self.latents_train)

    @property
    def true_median_test(self) -> np.ndarray:
        return true_conditional_median(self.latents_test)


def _feature_views(
    rng: np.random.Generator,
    latents: np.ndarray,
    spec: sc.ScenarioSpec,
    mixers: Dict[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """Noisy nonlinear embeddings of the prompt latents, one per probe view."""
    n = latents.shape[0]
    d = spec.d_feature
    z = latents.copy()
    z[:, 0] = (z[:, 0] - 5.0)            # center log-median roughly
    views = {}
    for view, base_noise in sc.VIEW_NOISE.items():
        noise = base_noise * spec.feature_hardness
        z_obs = z + noise * rng.standard_normal(z.shape) * np.array([1.0, 0.5, 0.25, 0.25])
        nuisance = rng.standard_normal((n, 4))
        inp = np.concatenate([z_obs, nuisance], axis=1)     # (n, 8)
        a, b = mixers[view]
        phi = np.tanh(inp @ a + b)                          # (n, d)
        views[view] = (phi / np.sqrt(d)).astype(np.float32)  # ‖φ‖₂ ≈ O(1)
    return views


def _make_mixers(rng: np.random.Generator, d: int) -> Dict[str, np.ndarray]:
    mixers = {}
    for view in sc.VIEW_NOISE:
        a = rng.standard_normal((8, d)) * 0.9
        b = 0.3 * rng.standard_normal(d)
        mixers[view] = (a, b)
    return mixers


def make_scenario(
    model: str,
    scenario: str,
    n_train: Optional[int] = None,
    n_test: Optional[int] = None,
    r: int = 16,
    seed: int = 0,
    full_paper_splits: bool = False,
) -> ScenarioData:
    spec = sc.get_spec(model, scenario)
    if full_paper_splits:
        n_train, n_test = sc.PAPER_SPLITS[scenario]
    n_train = n_train or 1500
    n_test = n_test or 400
    import zlib
    rng = np.random.default_rng(
        seed * 7919 + zlib.crc32(f"{model}/{scenario}".encode()) % 100003
    )
    mixers = _make_mixers(rng, spec.d_feature)  # frozen "model" per setting
    lat_tr = sample_prompt_latents(rng, spec.law, n_train)
    lat_te = sample_prompt_latents(rng, spec.law, n_test)
    len_tr = sample_lengths(rng, lat_tr, r, spec.law)
    len_te = sample_lengths(rng, lat_te, r, spec.law)
    return ScenarioData(
        model=model, scenario=scenario, r=r,
        len_train=len_tr, len_test=len_te,
        phi_train=_feature_views(rng, lat_tr, spec, mixers),
        phi_test=_feature_views(rng, lat_te, spec, mixers),
        latents_train=lat_tr, latents_test=lat_te, spec=spec,
    )


def surrogate_linear_data(
    n: int, d: int, eps: float = 0.5, v: float = 1.0, r: int = 16,
    S: float = 1.0, seed: int = 0,
):
    """Theorem-1 surrogate: L_i = φ(x_i)ᵀθ* + η_i with symmetric heavy-tailed η
    (student-t with df = 1 + 2ε ⇒ E|η|^{1+ε} finite), ‖φ‖₂ ≤ 1, ‖θ*‖₂ ≤ S.

    Returns (phi (n,d), eta (n,r), theta_star (d,)).
    """
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal(d)
    theta = S * theta / np.linalg.norm(theta)
    phi = rng.standard_normal((n, d))
    phi = phi / np.maximum(np.linalg.norm(phi, axis=1, keepdims=True), 1.0)
    df = 1.0 + 2.0 * eps
    eta = rng.standard_t(df, size=(n, r))
    # scale to make E|η|^{1+ε} ≈ v (monte-carlo normalization)
    probe = rng.standard_t(df, size=200_000)
    scale = (v / np.mean(np.abs(probe) ** (1 + eps))) ** (1.0 / (1 + eps))
    return phi.astype(np.float64), (eta * scale), theta
