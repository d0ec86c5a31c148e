"""Rotary position embeddings: standard RoPE (half-split rotation, fp32
angles), Qwen2-VL's M-RoPE, and YaRN's frequencies (DeepSeek-V3 / Kimi-K2).

M-RoPE splits the head-dim frequency bands into three sections driven by
(temporal, height, width) position streams; for pure text the three streams
coincide and M-RoPE reduces exactly to RoPE (arXiv:2409.12191).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.kernels import ops


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude factor 0.1 mscale ln(scale) + 1 (1 at scale <= 1):
    DeepSeek-V3's ``yarn_get_mscale``."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_range(dim: int, theta: float, original_max_pos: int, beta_fast: float,
               beta_slow: float) -> Tuple[int, int]:
    """The band indices (low, high) between which YaRN ramps from the
    original frequencies to the interpolated ones: the bands that turn
    ``beta_fast`` and ``beta_slow`` times over the original context
    (``yarn_find_correction_range``), clipped to [0, dim - 1]."""
    def band(rotations):
        return dim * math.log(original_max_pos / (rotations * 2 * math.pi)) / (2 * math.log(theta))
    return max(math.floor(band(beta_fast)), 0), min(math.ceil(band(beta_slow)), dim - 1)


def yarn_inv_freq(dim: int, theta: float, factor: float, original_max_pos: int,
                  beta_fast: float, beta_slow: float, device=None) -> torch.Tensor:
    """(dim // 2,) YaRN frequencies (DeepSeek-V3's
    ``DeepseekV3YarnRotaryEmbedding``): band i keeps theta^(-2i/dim) below
    ``low``, takes it divided by ``factor`` above ``high``, and a linear
    blend between them."""
    low, high = yarn_range(dim, theta, original_max_pos, beta_fast, beta_slow)
    extra = rope_freqs(dim, theta, device=device)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / max(high - low, 0.001), 0.0, 1.0)
    return extra / factor * ramp + extra * (1.0 - ramp)


def mrope_section(head_dim: int) -> Tuple[int, int, int]:
    """Frequency-band split (t, h, w); qwen2-vl uses (16, 24, 24) for hd=128."""
    half = head_dim // 2
    hw = 3 * half // 8
    return (half - 2 * hw, hw, hw)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                use_mrope: bool = False) -> torch.Tensor:
    """positions (B, S), or (3, B, S) for M-RoPE -> rotation angles (B, S,
    head_dim//2) fp32. Without ``use_mrope`` a (3, B, S) input gives stream
    0's angles (text-only M-RoPE is RoPE); with it, each of the three
    streams drives its section of the bands (:func:`mrope_section`)."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    if not use_mrope:
        if positions.ndim == 3:
            positions = positions[0]
        return positions[..., None].to(torch.float32) * freqs
    if positions.ndim != 3 or positions.shape[0] != 3:
        raise ValueError(f"M-RoPE takes (3, B, S) positions, got {tuple(positions.shape)}")
    t, h, _ = mrope_section(head_dim)
    ang = positions[..., None].to(torch.float32) * freqs          # (3, B, S, half)
    return torch.cat([ang[0, ..., :t], ang[1, ..., t:t + h], ang[2, ..., t + h:]], dim=-1)


def angles_by_base(positions: torch.Tensor, head_dim: int, theta: float,
                   theta_local: float, kinds: Iterable[str],
                   use_mrope: bool = False) -> Dict[str, torch.Tensor]:
    """One angle table per rope base the attention layers use: "local" for
    the ``local`` (windowed) layers, at ``theta_local``, and "global" for
    every other attention layer, at ``theta`` (the reference's
    ``_precompute_angles``, ``repro/models/transformer.py:158-170``)."""
    keys = {"local" if k == "local" else "global" for k in kinds if k != "ssm"}
    return {key: rope_angles(positions, head_dim, theta_local if key == "local" else theta,
                             use_mrope=use_mrope)
            for key in keys}


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, head_dim); angles: (B, S, head_dim//2). The half-split
    rotation in fp32, rounded once to x's dtype (``kernels/ops.py::rope``:
    the plain version on the CPU and under autograd, one kernel on the
    card)."""
    return ops.rope(x, angles)


def positions_from_tokens(batch: int, seq: int, device=None) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :].expand(batch, seq)


def text_mrope_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """M-RoPE positions of plain text: the three streams equal, (3, B, S)."""
    return positions_from_tokens(batch, seq, device=device)[None].expand(3, batch, seq)
