"""The shared ProD predictor head (paper §2.4).

A 2-layer MLP: φ(x) ∈ R^d → 512 (ReLU) → K bin logits → softmax. Both ProD-M
and ProD-D use this exact head; the only difference is the training target.
Training differentiates the plain ``head_logits``; median and quantile
inference go through ``ops.prod_head`` — the fused CUDA kernel on the GPU.
Parameters are a dict of fp32 tensors with the reference's names and shapes.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.bins import decode as decode_probs
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def head_init(seed: int, d: int, hidden: int, n_bins: int,
              device: DeviceLike = None) -> Params:
    """Seeded head weights, drawn on the CPU and moved to ``device``, so a
    seed gives the same weights on every device."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    params = {
        "w1": torch.randn((d, hidden), generator=g, dtype=f32) * (1.0 / math.sqrt(d)),
        "b1": torch.zeros(hidden, dtype=f32),
        "w2": torch.randn((hidden, n_bins), generator=g, dtype=f32)
        * (1.0 / math.sqrt(hidden)),
        "b2": torch.zeros(n_bins, dtype=f32),
    }
    return {k: v.to(dev) for k, v in params.items()}


def head_logits(params: Params, phi: torch.Tensor) -> torch.Tensor:
    h = torch.relu(phi.to(torch.float32) @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def head_probs(params: Params, phi: torch.Tensor) -> torch.Tensor:
    return torch.softmax(head_logits(params, phi), dim=-1)


def head_predict(params: Params, phi: torch.Tensor, edges: torch.Tensor,
                 how: str = "median") -> torch.Tensor:
    """Single-shot point prediction. ``median`` uses the fused kernel path."""
    if how == "median":
        _, med = ops.prod_head(phi, params["w1"], params["b1"], params["w2"],
                               params["b2"], edges)
        return med
    return decode_probs(head_probs(params, phi), edges, how)


def head_quantiles(params: Params, phi: torch.Tensor, edges: torch.Tensor,
                   qs: Sequence[float]):
    """Fused distributional inference: one head evaluation returning the full
    histogram AND every requested predictive quantile, ``(probs (B, K),
    quants (B, len(qs)))``."""
    return ops.prod_head(phi, params["w1"], params["b1"], params["w2"],
                         params["b2"], edges, qs=qs)
