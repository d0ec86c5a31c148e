"""Cross-entropy losses over the K-bin grid (paper §2.4).

``soft_ce`` covers both variants: with a one-hot target it is ProD-M's
standard CE; with a histogram target it is ProD-D's distributional soft CE.
"""

from __future__ import annotations

import torch


def soft_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-(1/N) Σ_i Σ_k target_i(k) log q(k|x_i)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(target * logp, dim=-1))
