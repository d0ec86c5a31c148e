"""Evaluation metrics and heavy-tail diagnostics (paper §3.1, A.1)."""

from __future__ import annotations

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
