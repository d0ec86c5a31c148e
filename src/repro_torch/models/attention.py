"""Attention: GQA projections, prefill attention through the flash kernel,
decode attention against the KV cache through the split-KV kernel, and the
training forward's blocked attention.

The JAX package runs jnp twins of its Pallas kernels at the first two points
(``repro/models/attention.py:168,185``); the port calls its own kernels there,
through ``kernels.ops``. Training differentiates :func:`blocked_attention`, a
plain PyTorch online softmax, as the reference's trainer differentiates its
XLA ``blocked_attention``: the repo has no backward kernel to port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, rms_norm
from repro_torch.models.rope import apply_rope


def attn_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    hd = cfg.head_dim
    s = {
        "wq": ParamSpec((cfg.d_model, cfg.n_heads, hd)),
        "wk": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd)),
        "wv": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd)),
        "wo": ParamSpec((cfg.n_heads, hd, cfg.d_model)),
    }
    if cfg.qk_norm:                 # Gemma3: RMS norms over head_dim on q and k
        s["q_norm"] = ParamSpec((hd,), init="zeros")
        s["k_norm"] = ParamSpec((hd,), init="zeros")
    return s


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def qkv_project(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                angles: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q (B, S, H, hd), k and v (B, S, KV, hd). With
    ``qk_norm`` q and k are RMS-normalised over hd before RoPE
    (``repro/models/attention.py:49-51``)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
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
    """Single-token attention against a cache: q (B, 1, H, hd), cache (B, Sc,
    KV, hd), lengths (B,) int32 valid prefix in slot order (the reference's
    ``full_cache_valid``, or :func:`ring_cache_valid` for a ring) -> (B, 1,
    H, hd)."""
    return ops.decode_attention(q[:, 0], k_cache, v_cache, lengths)[:, None]


def ring_cache_valid(lengths: torch.Tensor, window: int) -> torch.Tensor:
    """The valid slots of a ring of ``window`` slots as a prefix length:
    ``min(lengths, window)``. The reference's ``ring_cache_valid`` is the
    mask ``arange(window) < min(lengths, window)``, a prefix in slot order;
    the softmax does not care in which order the keys sit, so the decode
    kernel's prefix contract holds on a ring as it is."""
    return torch.clamp(lengths, max=window)


NEG_INF = -1e30
BLOCK = 512            # the reference's block_q = block_kv


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Pad axis 1 with zeros up to a multiple of ``mult``."""
    pad = (-x.shape[1]) % mult
    if not pad:
        return x
    return F.pad(x, [0, 0] * (x.ndim - 2) + [0, pad])


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int = 0) -> torch.Tensor:
    """Causal online-softmax attention over blocks of ``BLOCK`` keys, q (B, S,
    H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd); ``window`` > 0 keeps the
    keys with q - k < window. The counterpart of
    ``repro/models/attention.py:72-171`` at the arguments the training
    forward gives it (causal, a layer's window, no key mask, the default
    blocks), step for step (fp32 scores and accumulators, masked scores at
    -1e30, the output rounded once to ``v``'s dtype). Key blocks that every
    row of a query block masks are skipped, on both sides of the band. Past
    the diagonal the reference's update multiplies by exp(0) and adds
    exp(-1e30 - m) = 0. Before the window a row has seen no valid key yet
    (m = -1e30); its first valid key, which every row has (its own), comes
    with alpha = exp(-1e30 - m) = 0 and wipes what those blocks added, so
    starting after them gives the same numbers. Plain PyTorch, so autograd
    differentiates it."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    blk = min(BLOCK, S)
    q, k, v = _pad_to(q, blk), _pad_to(k, blk), _pad_to(v, blk)
    pos = torch.arange(q.shape[1], device=q.device)
    f32 = torch.float32
    outs = []
    for i in range(q.shape[1] // blk):
        rows = slice(i * blk, (i + 1) * blk)
        qc = q[:, rows].reshape(B, blk, KV, G, hd).to(f32)
        m = torch.full((B, KV, G, blk), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((B, KV, G, blk), dtype=f32, device=q.device)
        acc = torch.zeros((B, KV, G, blk, hd), dtype=f32, device=q.device)
        for j in range(i + 1):
            if window and i * blk - ((j + 1) * blk - 1) >= window:
                continue              # before the window of every row of the block
            cols = slice(j * blk, (j + 1) * blk)
            vb = v[:, cols]
            s = torch.einsum("bqkgh,bskh->bkgqs", qc, k[:, cols].to(f32)) * scale
            mask = pos[cols][None, :] <= pos[rows][:, None]
            if window:
                mask = mask & (pos[rows][:, None] - pos[cols][None, :] < window)
            s = torch.where(mask, s, torch.full((), NEG_INF, dtype=f32, device=q.device))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(vb.dtype).to(f32), vb.to(f32))
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])   # (B, KV, G, blk, hd)
    out = torch.stack(outs, dim=1)                                 # (B, nq, KV, G, blk, hd)
    out = torch.movedim(out, -2, 2).reshape(B, -1, KV * G, hd)
    return out[:, :S].to(v.dtype)
