"""Model facade: ``build_model(cfg)`` returns a :class:`Model` whose methods
are plain functions of (params, batch).

The reference's ``Runtime`` knobs (block sizes, causal skip, MoE capacity,
remat, mesh) are read by nothing in this slice — the kernels choose their own
tiles and always skip fully masked tiles — so the port has no ``Runtime`` yet.
The ProD predictor head consumes ``hidden`` from prefill: the served model's
last-layer hidden state of the last prompt token (paper §2.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import transformer
from repro_torch.models.layers import init_tree, unembed


def last_token_hidden(hidden: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """φ(x): last-layer hidden state of the last (non-pad) prompt token."""
    idx = torch.clamp(lengths.to(torch.long) - 1, 0, hidden.shape[1] - 1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    def spec(self):
        return transformer.model_spec(self.cfg)

    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
        """Seeded random weights in the config's dtype, made on ``device``."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        return init_tree(self.spec(), g, self.dtype, dev)

    def prefill(self, params, tokens: torch.Tensor,
                attn_valid: Optional[torch.Tensor] = None, logits_mode: str = "all"):
        """Returns (logits, hidden (B, S, d), the per-layer cache: (k, v) for
        attention layers, {"h", "conv"} for SSM layers)."""
        return transformer.forward(params, self.cfg, tokens, attn_valid=attn_valid,
                                   logits_mode=logits_mode)

    def decode_step(self, params, tokens, cache, pos, lengths):
        """tokens, pos (B,), lengths (B,) int32. Returns (logits, hidden),
        writes the new K/V into ``cache`` and replaces its SSM states."""
        return transformer.decode_step(params, self.cfg, tokens, cache, pos, lengths)

    def unembed(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return unembed(hidden, params["embed"], params.get("head"))

    def init_cache(self, batch: int, cache_len: int, device: DeviceLike = None):
        return transformer.init_cache(self.cfg, batch, cache_len, self.dtype,
                                      resolve_device(device))

    def decode_cache(self, prefill_cache, cache_len: int):
        """The cache ``prefill`` returned, grown to ``cache_len`` positions
        for decode (raises where the shared block's window is outgrown)."""
        return transformer.decode_cache(self.cfg, prefill_cache, cache_len)


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)
    return Model(cfg=cfg)
