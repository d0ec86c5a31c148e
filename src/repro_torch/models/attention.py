"""Attention: GQA projections, prefill attention through the flash kernel,
decode attention against the KV cache through the split-KV kernel, and the
training forward's blocked attention.

The JAX package runs jnp twins of its Pallas kernels at the first two points
(``repro/models/attention.py:168,185``); the port calls its own kernels there,
through ``kernels.ops``. Training differentiates :func:`blocked_attention`, a
plain PyTorch online softmax, as the reference's trainer differentiates its
XLA ``blocked_attention``: the repo has no backward kernel to port. Its core
runs under ``scoped_kernel_vjp("fusedkernel_flash_attention")``
(``common/scopes.py``), as the reference's: the backward recomputes the
blocks, so only q, k and v are kept between the passes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.scopes import scoped_kernel_vjp
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, rms_norm
from repro_torch.models.rope import apply_rope


def attn_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    hd = cfg.head_dim
    s = {
        "wq": ParamSpec((cfg.d_model, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.n_heads, hd, cfg.d_model), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:                 # Gemma3: RMS norms over head_dim on q and k
        s["q_norm"] = ParamSpec((hd,), ("head_dim",), init="zeros")
        s["k_norm"] = ParamSpec((hd,), ("head_dim",), init="zeros")
    return s


def head_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def qkv_project(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                angles: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q (B, S, H, hd), k and v (B, S, KV, hd). With
    ``qk_norm`` q and k are RMS-normalised over hd before RoPE
    (``repro/models/attention.py:49-51``)."""
    q, k, v = head_project(x, p["wq"]), head_project(x, p["wk"]), head_project(x, p["wv"])
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
                      causal: bool = True, window: int = 0,
                      kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill attention through the flash kernel: q (B, Sq, H, hd) against
    k/v (B, Skv, KV, hd) -> (B, Sq, H, hd). Causal for a decoder's
    self-attention (Sq = Skv), where ``window`` > 0 limits each query to the
    last ``window`` keys; ``causal=False`` for an encoder (Sq = Skv) and for
    cross-attention over the encoder's keys (Sq != Skv)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
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
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """Online-softmax attention over blocks of keys, q (B, Sq, H, hd), k/v
    (B, Skv, KV, hd) -> (B, Sq, H, hd): causal (Sq = Skv), where ``window``
    > 0 keeps the keys with q - k < window, or with ``causal=False`` every
    key (an encoder, and cross-attention, Sq != Skv). The counterpart of
    ``repro/models/attention.py:72-171`` at the arguments the training
    forwards give it (no key mask, the default blocks of ``min(512, Sq)``
    queries and ``min(512, Skv)`` keys, the padded keys of the last block
    masked), step for step (fp32 scores and accumulators, masked scores at
    -1e30, the output rounded once to ``v``'s dtype). Key blocks that every
    row of a query block masks are skipped, on both sides of the band. Past
    the diagonal the reference's update multiplies by exp(0) and adds
    exp(-1e30 - m) = 0. Before the window a row has seen no valid key yet
    (m = -1e30); its first valid key, which every row has (its own), comes
    with alpha = exp(-1e30 - m) = 0 and wipes what those blocks added, so
    starting after them gives the same numbers. Plain PyTorch, so autograd
    differentiates it."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    bq, bk = min(BLOCK, Sq), min(BLOCK, Skv)
    q, k, v = _pad_to(q, bq), _pad_to(k, bk), _pad_to(v, bk)

    def attend_all(q, k, v):
        return torch.stack([_attend_block(q, k, v, i, bq, bk, Skv, causal, window)
                            for i in range(q.shape[1] // bq)], dim=1)  # (B, nq, KV, G, bq, hd)

    out = scoped_kernel_vjp("fusedkernel_flash_attention", attend_all)(q, k, v)
    out = torch.movedim(out, -2, 2).reshape(B, -1, H, hd)
    return out[:, :Sq].to(v.dtype)


def _attend_block(q, k, v, i: int, bq: int, bk: int, Skv: int, causal: bool, window: int):
    """Query block ``i`` of :func:`blocked_attention` against its key blocks
    -> (B, KV, G, bq, hd) fp32."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    f32 = torch.float32
    rows = slice(i * bq, (i + 1) * bq)
    qc = q[:, rows].reshape(B, bq, KV, G, hd).to(f32)
    m = torch.full((B, KV, G, bq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, KV, G, bq), dtype=f32, device=q.device)
    acc = torch.zeros((B, KV, G, bq, hd), dtype=f32, device=q.device)
    for j in range(k.shape[1] // bk):
        if causal and j * bk > (i + 1) * bq - 1:
            break                 # past the diagonal of every row of the block
        if window and i * bq - ((j + 1) * bk - 1) >= window:
            continue              # before the window of every row of the block
        cols = slice(j * bk, (j + 1) * bk)
        vb = v[:, cols]
        s = torch.einsum("bqkgh,bskh->bkgqs", qc, k[:, cols].to(f32)) * scale
        mask = (kpos[cols] < Skv)[None, :].expand(bq, bk)
        if causal:
            mask = mask & (kpos[cols][None, :] <= qpos[rows][:, None])
        if window:
            mask = mask & (qpos[rows][:, None] - kpos[cols][None, :] < window)
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=f32, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(vb.dtype).to(f32), vb.to(f32))
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]
