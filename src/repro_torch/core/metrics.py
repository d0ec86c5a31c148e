"""Evaluation metrics and heavy-tail diagnostics (paper §3.1, A.1, A.4).

Medians are ``targets.sample_median`` (``torch.quantile``): for an even
count it averages the two middle values, as ``jnp.median`` does, where
``torch.median`` would return the lower one."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.targets import sample_median


def mae(pred: torch.Tensor, target: torch.Tensor) -> float:
    return float(torch.mean(torch.abs(pred.to(torch.float32)
                                      - target.to(torch.float32))))


def median_mae_per_prompt(lengths: torch.Tensor) -> torch.Tensor:
    """Prompt-level Median-MAE (A.1): (1/R) Σ_r |L_ir - median_i|. (N, R) -> (N,)."""
    l32 = lengths.to(torch.float32)
    med = sample_median(l32)[:, None]
    return torch.mean(torch.abs(l32 - med), dim=-1)


def noise_radius(lengths: torch.Tensor) -> float:
    """The Noise Radius reference line: mean prompt-level Median-MAE."""
    return float(torch.mean(median_mae_per_prompt(lengths)))


def max_to_median(lengths: torch.Tensor) -> torch.Tensor:
    """Heavy-tail diagnostic (A.4): max(length)/median(length) per prompt."""
    l32 = lengths.to(torch.float32)
    return torch.amax(l32, dim=-1) / torch.clamp(sample_median(l32), min=1.0)


def noise_ratio(lengths: torch.Tensor) -> torch.Tensor:
    """Median-MAE normalized by the prompt median (the 11.5%–18.2% figure)."""
    med = sample_median(lengths.to(torch.float32))
    return median_mae_per_prompt(lengths) / torch.clamp(med, min=1.0)


def hill_tail_index(samples: np.ndarray, k_frac: float = 0.1) -> float:
    """Hill estimator of the tail index α on the pooled upper tail.

    Smaller α = heavier tail; α ≤ 2 implies infinite variance. Used to check
    the "consistent with heavy-tailed behavior" claim quantitatively.
    """
    x = np.sort(np.asarray(samples, dtype=np.float64).ravel())
    x = x[x > 0]
    n = len(x)
    k = max(int(n * k_frac), 2)
    tail = x[n - k:]
    logs = np.log(tail) - np.log(tail[0])
    return float(1.0 / np.mean(logs[1:])) if np.mean(logs[1:]) > 0 else float("inf")


def summarize_run(name: str, pred, target) -> dict:
    return {"method": name, "mae": mae(pred, target)}
