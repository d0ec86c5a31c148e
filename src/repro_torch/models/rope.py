"""Rotary position embeddings (standard RoPE, half-split rotation, fp32 angles).

M-RoPE (Qwen2-VL) comes with the VLM slice.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (B, S) int -> rotation angles (B, S, head_dim//2) fp32."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    return positions[..., None].to(torch.float32) * freqs


def angles_by_base(positions: torch.Tensor, head_dim: int, theta: float,
                   theta_local: float, kinds: Iterable[str]) -> Dict[str, torch.Tensor]:
    """One angle table per rope base the attention layers use: "local" for
    the ``local`` (windowed) layers, at ``theta_local``, and "global" for
    every other attention layer, at ``theta`` (the reference's
    ``_precompute_angles``, ``repro/models/transformer.py:158-170``)."""
    keys = {"local" if k == "local" else "global" for k in kinds if k != "ssm"}
    return {key: rope_angles(positions, head_dim, theta_local if key == "local" else theta)
            for key in keys}


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, head_dim); angles: (B, S, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def positions_from_tokens(batch: int, seq: int, device=None) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :].expand(batch, seq)
