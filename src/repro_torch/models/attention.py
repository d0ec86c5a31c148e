"""Attention: GQA projections, prefill attention through the flash kernel,
and decode attention against the KV cache through the split-KV kernel.

The JAX package runs jnp twins of its Pallas kernels at these two points
(``repro/models/attention.py:168,185``); the port calls its own kernels there,
through ``kernels.ops``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec
from repro_torch.models.rope import apply_rope


def attn_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    hd = cfg.head_dim
    return {
        "wq": ParamSpec((cfg.d_model, cfg.n_heads, hd)),
        "wk": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd)),
        "wv": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd)),
        "wo": ParamSpec((cfg.n_heads, hd, cfg.d_model)),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def qkv_project(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                angles: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q (B, S, H, hd), k and v (B, S, KV, hd)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def out_project(p: Dict[str, torch.Tensor], o: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd')."""
    h, k, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)


def prefix_lengths(valid: torch.Tensor) -> torch.Tensor:
    """(B, S) bool key-validity mask -> (B,) int32 lengths. The kernel takes a
    valid prefix per row (right padding); any other mask raises."""
    lengths = valid.sum(dim=1, dtype=torch.int32)
    prefix = torch.arange(valid.shape[1], device=valid.device)[None, :] < lengths[:, None]
    if not torch.equal(prefix, valid.to(torch.bool)):
        raise ValueError("attn_valid must be a prefix mask (right-padded rows)")
    return lengths


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0,
                      kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal prefill attention, (B, S, H, hd); ``window`` > 0 limits each
    query to the last ``window`` keys."""
    return ops.flash_attention(q, k, v, causal=True, window=window,
                               kv_lengths=kv_lengths)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a full cache: q (B, 1, H, hd), cache
    (B, Sc, KV, hd), lengths (B,) int32 valid prefix (the reference's
    ``full_cache_valid``) -> (B, 1, H, hd)."""
    return ops.decode_attention(q[:, 0], k_cache, v_cache, lengths)[:, None]
