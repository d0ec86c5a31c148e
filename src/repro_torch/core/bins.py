"""Length-bin grids and distribution→point decoders (paper §2.4).

The predictor outputs a distribution over K length bins. The paper decodes a
point estimate as the *median* of the predictive distribution — the CDF 0.5
crossing with linear interpolation inside the crossing bin. All three
decoders of ``repro.core.bins`` are here, quirks included: ``log_edges`` sets
edge 0 to 0, and ``decode_median`` falls back to bin 0 when the CDF never
reaches 0.5 (the fused kernel clamps to K−1 instead).
"""

from __future__ import annotations

import math

import torch

from repro_torch.common.device import DeviceLike, resolve_device


def linear_edges(n_bins: int, bin_max: float, bin_min: float = 0.0,
                 device: DeviceLike = None) -> torch.Tensor:
    return torch.linspace(bin_min, bin_max, n_bins + 1, dtype=torch.float32,
                          device=resolve_device(device))


def log_edges(n_bins: int, bin_max: float, bin_min: float = 1.0,
              device: DeviceLike = None) -> torch.Tensor:
    """Log-spaced edges — a beyond-paper option that matches heavy tails."""
    e = torch.exp(torch.linspace(math.log(bin_min), math.log(bin_max), n_bins + 1,
                                 dtype=torch.float32, device=resolve_device(device)))
    e[0] = 0.0
    return e


def make_edges(n_bins: int, bin_max: float, spacing: str = "linear",
               device: DeviceLike = None) -> torch.Tensor:
    if spacing == "linear":
        return linear_edges(n_bins, bin_max, device=device)
    if spacing == "log":
        return log_edges(n_bins, bin_max, device=device)
    raise ValueError(spacing)


def bin_index(lengths: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """b(L): map lengths to bin ids in [0, K-1] (overflow clamps to last bin)."""
    K = edges.shape[0] - 1
    idx = torch.searchsorted(edges, lengths.to(edges.dtype).contiguous(),
                             right=True) - 1
    return idx.clamp(0, K - 1)


def bin_centers(edges: torch.Tensor) -> torch.Tensor:
    return 0.5 * (edges[:-1] + edges[1:])


def decode_median(probs: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Median of the predictive distribution with in-bin interpolation."""
    cdf = torch.cumsum(probs, dim=-1)
    # argmax of a bool picks the first True, and bin 0 when there is none
    k_star = torch.argmax((cdf >= 0.5).to(torch.int8), dim=-1)
    take = lambda arr, i: torch.gather(arr, -1, i[..., None])[..., 0]
    cdf_prev = torch.where(k_star > 0, take(cdf, (k_star - 1).clamp(min=0)),
                           torch.zeros((), dtype=cdf.dtype, device=cdf.device))
    p_k = take(probs, k_star)
    t = ((0.5 - cdf_prev) / p_k.clamp(min=1e-12)).clamp(0.0, 1.0)
    left = edges[k_star]
    right = edges[k_star + 1]
    return left + t * (right - left)


def decode_mean(probs: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    return probs @ bin_centers(edges)


def decode_argmax(probs: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    return bin_centers(edges)[torch.argmax(probs, dim=-1)]


DECODERS = {"median": decode_median, "mean": decode_mean, "argmax": decode_argmax}


def decode(probs: torch.Tensor, edges: torch.Tensor, how: str) -> torch.Tensor:
    return DECODERS[how](probs, edges)
