"""Repeated-sampling supervision targets (paper §2.3–2.4).

Given r independent generations per prompt with lengths ``L (N, r)``:

* **ProD-M**: one-hot of the binned sample median;
* **ProD-D**: the binned empirical histogram (soft target);
* **single**: one-hot of a single sampled length (ablation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bins import bin_index


def sample_median(lengths: torch.Tensor) -> torch.Tensor:
    """Sample median over the repeat axis, (N, r) -> (N,). For even r it is
    the mean of the two middle values, as ``jnp.median``; ``torch.median``
    would return the lower one."""
    return torch.quantile(lengths.to(torch.float32), 0.5, dim=-1)


def _one_hot(idx: torch.Tensor, K: int) -> torch.Tensor:
    return F.one_hot(idx, K).to(torch.float32)


def median_target(lengths: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """ProD-M: y_med one-hot (N, K)."""
    return _one_hot(bin_index(sample_median(lengths), edges), edges.shape[0] - 1)


def dist_target(lengths: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """ProD-D: p_dist (N, K); p_i(k) = (1/r) Σ_j 1[b(L_ij)=k]."""
    idx = bin_index(lengths.to(torch.float32), edges)          # (N, r)
    return _one_hot(idx, edges.shape[0] - 1).mean(dim=1)


def single_target(lengths: torch.Tensor, edges: torch.Tensor,
                  which: int = 0) -> torch.Tensor:
    """One-shot label (ablation): one-hot of the ``which``-th sample."""
    one = lengths[:, which].to(torch.float32)
    return _one_hot(bin_index(one, edges), edges.shape[0] - 1)


def build_target(lengths: torch.Tensor, edges: torch.Tensor, kind: str,
                 single_idx: int = 0) -> torch.Tensor:
    if kind == "median":
        return median_target(lengths, edges)
    if kind == "dist":
        return dist_target(lengths, edges)
    if kind == "single":
        return single_target(lengths, edges, single_idx)
    raise ValueError(kind)
