"""Multi-head latent attention (MLA): the attention of DeepSeek-V3, which
Kimi-K2 uses (``DeepseekV3Attention`` of the published
``modeling_deepseek.py``).

A layer's equations, with x (B, S, d) the normed residual, H heads, n =
``qk_nope_head_dim``, r = ``qk_rope_head_dim``, c = ``v_head_dim`` and R =
``kv_lora_rank``::

    q           = rms_norm(x W_qa) W_qb            (B, S, H, n + r)
    q_pe        = rope(q[..., n:])
    [lat, k]    = x W_kva                          (B, S, R + r)
    lat         = rms_norm(lat)                    the latent
    k_pe        = rope(k)                          one rope key, shared by the heads
    [k_nope, v] = lat W_kvb                        (B, S, H, n + c)
    score       = (q_nope . k_nope + q_pe . k_pe) * scale
    out         = softmax(score) v W_o

with scale = (n + r)^-0.5, times mscale^2 under YaRN (mscale =
``rope.yarn_mscale(factor, mscale_all_dim)``).

* **Prefill** runs the expanded form through the flash kernel: K is k_nope
  with k_pe repeated over the heads (n + r = 192 columns), V its c = 128
  columns, and the scale passed in.
* **Decode** runs the absorbed form: W_UK (W_kvb's k_nope columns) is folded
  into q (q_lat = q_nope W_UK^T, (B, H, R)), the scores are an MQA of the H
  heads over one latent cache entry [lat, k_pe] a token (R + r = 576
  values), and W_UV (its v columns) is applied to the attended latent. The
  products run in the model dtype, the softmax in fp32 on the scores masked
  by ``lengths``.
* **The cache entry** of a layer is one (B, Sc, R + r) tensor, the normed
  latent and the rotated k_pe: the prefill returns it at the prompt's
  length, a decode step writes its token's entry in place.

Departures from the published code:

* RoPE is the port's half-split rotation (``models/rope.py``). The
  checkpoint's interleaved layout is a permutation of the rope columns of
  W_qb and W_kva, which seeded weights make moot.
* The two norms (``q_norm``, ``kv_norm``) are applied as (1 + scale), as the
  port holds every RMSNorm.
* The cos/sin magnitude yarn_mscale(factor, mscale) / yarn_mscale(factor,
  mscale_all_dim) is taken as 1, which it is where mscale = mscale_all_dim
  (Kimi-K2); ``check_supported`` raises for any other.

Spans (``common/scopes.py``): ``mla.q`` (q down, norm, up, rope), ``mla.kv``
(kv down, norm, k_pe rope; at prefill the W_kvb expansion), ``mla.attend``
(flash, or the absorbed products) and ``mla.out`` (W_UV at decode, and
W_o).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common import scopes
from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import head_project, out_project
from repro_torch.models.layers import ParamSpec, rms_norm
from repro_torch.models.rope import apply_rope, rope_freqs, yarn_inv_freq, yarn_mscale


def check_supported(cfg: ModelConfig) -> None:
    """Raise for an MLA configuration this module does not compute."""
    if not cfg.q_lora_rank:
        raise ValueError(f"{cfg.name}: MLA without a q down-projection (q_lora_rank 0) "
                         f"is not built")
    if cfg.yarn_factor and yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) != yarn_mscale(
            cfg.yarn_factor, cfg.yarn_mscale_all_dim):
        raise ValueError(f"{cfg.name}: a YaRN cos/sin magnitude other than 1 is not built")


def mla_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, Q, R = cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    n, r, c = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": ParamSpec((d, Q), ("embed", None)),
        "q_norm": ParamSpec((Q,), (None,), init="zeros"),
        "wq_b": ParamSpec((Q, H, n + r), (None, "heads", "head_dim"), scale=Q ** -0.5),
        "wkv_a": ParamSpec((d, R + r), ("embed", None)),
        "kv_norm": ParamSpec((R,), (None,), init="zeros"),
        "wkv_b": ParamSpec((R, H, n + c), (None, "heads", "head_dim"), scale=R ** -0.5),
        "wo": ParamSpec((H, c, d), ("heads", "head_dim", "embed"), scale=(H * c) ** -0.5),
    }


def softmax_scale(cfg: ModelConfig) -> float:
    """(n + r)^-0.5, times yarn_mscale(factor, mscale_all_dim)^2 under YaRN
    (0.13086 for Kimi-K2)."""
    s = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        s *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return s


def rope_angles(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions (B, S) -> (B, S, r / 2) fp32 angles of the rope columns, at
    YaRN's frequencies where the configuration scales them."""
    r, dev = cfg.qk_rope_head_dim, positions.device
    if cfg.yarn_factor:
        inv = yarn_inv_freq(r, cfg.rope_theta, cfg.yarn_factor, cfg.yarn_original_max_pos,
                            cfg.yarn_beta_fast, cfg.yarn_beta_slow, device=dev)
    else:
        inv = rope_freqs(r, cfg.rope_theta, device=dev)
    return positions[..., None].to(torch.float32) * inv


def cache_width(cfg: ModelConfig) -> int:
    """Values a token a layer holds in the latent cache: R + r."""
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def _query(p, x, cfg: ModelConfig, angles) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q_nope (B, S, H, n), the rotated q_pe (B, S, H, r)."""
    n = cfg.qk_nope_head_dim
    with scopes.span("mla.q"):
        q = head_project(rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps), p["wq_b"])
        return q[..., :n], apply_rope(q[..., n:], angles)


def _entry(p, x, cfg: ModelConfig, angles) -> torch.Tensor:
    """x (B, S, d) -> the cache entry (B, S, R + r): the normed latent and
    the rotated k_pe."""
    R = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    lat = rms_norm(kv[..., :R], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(kv[..., None, R:], angles)[:, :, 0]
    return torch.cat([lat, k_pe], dim=-1)


def mla_prefill(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                angles: torch.Tensor, kv_lengths: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d), the normed residual; ``kv_lengths`` (B,) the valid
    prefix of each row. Returns (the attention's output (B, S, d), the cache
    entry (B, S, R + r))."""
    B, S, _ = x.shape
    H, n, R, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    q_nope, q_pe = _query(p, x, cfg, angles)
    with scopes.span("mla.kv"):
        entry = _entry(p, x, cfg, angles)
        kv = head_project(entry[..., :R], p["wkv_b"])                    # (B, S, H, n + c)
        k = torch.cat([kv[..., :n], entry[:, :, None, R:].expand(B, S, H, r)], dim=-1)
        v = kv[..., n:].contiguous()
        q = torch.cat([q_nope, q_pe], dim=-1)
    with scopes.span("mla.attend"):
        o = ops.flash_attention(q, k, v, causal=True, kv_lengths=kv_lengths,
                                scale=softmax_scale(cfg))
    with scopes.span("mla.out"):
        return out_project(p, o), entry


def mla_decode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               angles: torch.Tensor, cache: torch.Tensor, rows: torch.Tensor,
               slot: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One decode step: x (B, 1, d), the normed residual of the new tokens.
    Writes their entries into ``cache`` (B, Sc, R + r) at (``rows``,
    ``slot``) and attends to each row's first ``lengths`` slots. Returns the
    attention's output (B, 1, d)."""
    n, R = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q_nope, q_pe = _query(p, x, cfg, angles)
    with scopes.span("mla.kv"):
        cache[rows, slot] = _entry(p, x, cfg, angles)[:, 0]
    w_kvb = p["wkv_b"].transpose(0, 1)                                  # (H, R, n + c)
    with scopes.span("mla.attend"):
        # W_UK folded into q, a product a head: (H, B, n) x (H, n, R)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_kvb[..., :n].transpose(1, 2))
        qf = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)     # (B, H, R + r)
        s = torch.bmm(qf, cache.transpose(1, 2)).to(torch.float32) * softmax_scale(cfg)
        valid = torch.arange(cache.shape[1], device=s.device)[None, :] < lengths[:, None]
        s = s.masked_fill(~valid[:, None, :], float("-inf"))
        att = torch.softmax(s, dim=-1).to(x.dtype)
        o_lat = torch.bmm(att, cache[..., :R])                           # (B, H, R)
    with scopes.span("mla.out"):
        o = torch.bmm(o_lat.transpose(0, 1), w_kvb[..., n:])             # (H, B, c)
        return out_project(p, o.transpose(0, 1)[:, None])
