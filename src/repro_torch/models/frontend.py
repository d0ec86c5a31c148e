"""Modality frontend *stubs*: the port's copy of ``repro/models/frontend.py``.

Whisper's mel + conv audio codec and Qwen2-VL's ViT vision tower are stubs,
as in the reference: these helpers make the frame and patch embeddings (and
M-RoPE position streams) of the shapes and dtypes a real frontend would. The
embeddings are drawn from an explicit ``torch.Generator``, so they differ
from ``jax.random``'s draws (parity tests carry the reference's across); the
position streams are the reference's exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import torch_dtype


def audio_frame_embeds(gen: torch.Generator, cfg: ModelConfig, batch: int) -> torch.Tensor:
    """Stub for Whisper's mel + conv frontend output: (B, encoder_seq, d) in
    the config's dtype, normal with std 0.02, on the generator's device."""
    x = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                    device=gen.device)
    return x.to(torch_dtype(cfg.dtype)) * 0.02


def vlm_embeds(gen: torch.Generator, cfg: ModelConfig, batch: int, seq: int,
               n_patches: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stub for Qwen2-VL: interleaved patch + text embeddings and M-RoPE ids.
    The first ``n_patches`` positions (default min(seq // 4, 256)) emulate
    vision tokens on a square grid of side floor(sqrt(n_patches)): temporal
    id 0, then the patch's row and column; the text after them has t = h = w
    = 1, 2, and so on. Returns (embeds (B, S, d) in the config's dtype, std
    0.02, positions (3, B, S) int32), on the generator's device."""
    n_patches = n_patches or min(seq // 4, 256)
    emb = torch.randn((batch, seq, cfg.d_model), generator=gen, device=gen.device)
    emb = emb.to(torch_dtype(cfg.dtype)) * 0.02
    side = max(int(n_patches ** 0.5), 1)
    i32 = dict(dtype=torch.int32, device=gen.device)
    text = torch.arange(seq - n_patches, **i32) + 1
    patch = torch.arange(n_patches, **i32)
    pos = torch.stack([torch.cat([torch.zeros(n_patches, **i32), text]),
                       torch.cat([patch // side, text]), torch.cat([patch % side, text])])
    return emb, pos[:, None].expand(3, batch, seq)
