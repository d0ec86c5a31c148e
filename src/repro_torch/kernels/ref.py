"""Plain PyTorch versions of the ported kernels (the correctness ground truth).

Line for line with ``repro/kernels/ref.py``. The CPU tests hold these against
the JAX oracles; ``chip_smoke.py`` holds each CUDA kernel against them on the
card; ``ops`` runs them for tensors that lie on the CPU.

One addition: ``flash_attention_ref`` takes ``kv_lengths`` (B,), the valid
key prefix of each row, which is how the port's prefill passes the reference
model's right-padding mask (``kv_valid``) to the attention.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Skv, KV, hd)
    v: torch.Tensor,            # (B, Skv, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_lengths: Optional[torch.Tensor] = None,   # (B,) int32 valid key prefix
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    mask = mask[None, None, None]
    if kv_lengths is not None:
        kv_ok = kpos[None, :] < kv_lengths.to(q.device)[:, None]      # (B, Skv)
        mask = mask & kv_ok[:, None, None, None, :]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.to(torch.float32))
    return torch.movedim(o, 3, 1).reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,            # (B, H, hd)
    k: torch.Tensor,            # (B, Sc, KV, hd)
    v: torch.Tensor,            # (B, Sc, KV, hd)
    lengths: torch.Tensor,      # (B,) int32 — valid cache prefix
) -> torch.Tensor:
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.to(torch.float32))
    return o.reshape(B, H, hd).to(q.dtype)


def ssd_scan_ref(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) fp32
    a: torch.Tensor,    # (B, S, H) fp32 log-decay
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence. Returns (y (B,S,H,P), h (B,H,P,N))."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32

    def step(h, xt, dtt, at, Bt, Ct):
        h = torch.exp(at)[:, :, None, None] * h + torch.einsum(
            "bh,bhp,bn->bhpn", dtt, xt, Bt)
        return h, torch.einsum("bhpn,bn->bhp", h, Ct)

    h = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    xs = (x.to(f32), dt.to(f32), a.to(f32), Bm.to(f32), Cm.to(f32))
    ys = []
    for t in range(S):
        h, yt = step(h, *(v[:, t] for v in xs))
        ys.append(yt)
    return torch.stack(ys, dim=1).to(x.dtype), h


def prod_head_ref(
    phi: torch.Tensor,       # (B, d) — served LLM last hidden state
    w1: torch.Tensor,        # (d, hidden)
    b1: torch.Tensor,        # (hidden,)
    w2: torch.Tensor,        # (hidden, K)
    b2: torch.Tensor,        # (K,)
    edges: torch.Tensor,     # (K+1,) bin edges
    qs: Optional[torch.Tensor] = None,   # (Q,) CDF levels; None -> median only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ProD predictor head (paper §2.4): 2-layer MLP -> softmax over K bins
    -> CDF-crossing quantile decode with in-bin linear interpolation.

    Returns (probs (B, K) fp32, median_estimate (B,) fp32) when ``qs`` is
    None, else (probs, quants (B, Q) fp32) — one column per CDF level.
    """
    single = qs is None
    f32 = torch.float32
    qs = (torch.tensor([0.5], dtype=f32, device=phi.device) if single
          else torch.as_tensor(qs, dtype=f32, device=phi.device))
    h = torch.relu(phi.to(f32) @ w1.to(f32) + b1.to(f32))
    logits = h @ w2.to(f32) + b2.to(f32)
    probs = torch.softmax(logits, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    K = probs.shape[-1]
    Q = qs.shape[0]
    crossed = cdf[:, None, :] >= qs[None, :, None]                # (B, Q, K)
    # first crossing, clamped to the last bin when float32 rounding keeps the
    # CDF below q (q→1) — same rule as the kernels, so all versions agree
    iota = torch.arange(K, device=phi.device)[None, None, :]
    k_star = torch.min(torch.where(crossed, iota, K - 1), dim=-1).values
    cdf_prev = torch.where(
        k_star > 0,
        torch.gather(cdf[:, None, :].expand(-1, Q, -1), -1,
                     (k_star - 1).clamp(min=0)[..., None])[..., 0],
        torch.zeros((), dtype=f32, device=phi.device))
    p_k = torch.gather(probs[:, None, :].expand(-1, Q, -1), -1,
                       k_star[..., None])[..., 0]
    t = ((qs[None, :] - cdf_prev) / p_k.clamp(min=1e-12)).clamp(0.0, 1.0)
    edges = edges.to(f32)
    left = edges[k_star]
    right = edges[k_star + 1]
    quants = left + t * (right - left)
    if single:
        return probs, quants[:, 0]
    return probs, quants
