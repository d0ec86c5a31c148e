"""Rotary position embeddings: standard RoPE (half-split rotation, fp32
angles) and Qwen2-VL's M-RoPE.

M-RoPE splits the head-dim frequency bands into three sections driven by
(temporal, height, width) position streams; for pure text the three streams
coincide and M-RoPE reduces exactly to RoPE (arXiv:2409.12191).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


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
    """x: (B, S, H, head_dim); angles: (B, S, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def positions_from_tokens(batch: int, seq: int, device=None) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :].expand(batch, seq)


def text_mrope_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """M-RoPE positions of plain text: the three streams equal, (3, B, S)."""
    return positions_from_tokens(batch, seq, device=device)[None].expand(3, batch, seq)
