"""Plain PyTorch versions of the ported kernels (the correctness ground truth).

Line for line with ``repro/kernels/ref.py``. The CPU tests hold these against
the JAX oracles; ``chip_smoke.py`` holds each CUDA kernel against them on the
card; ``ops`` runs them for tensors that lie on the CPU. Four additions:
:func:`ssd_chunked`, the reference model's chunked scan (``repro/models/
ssm.py``), the form the scan kernel computes, which the training forward
differentiates and a traced prefill records; :func:`unembed_ref`, the plain
version of the unembed kernel; and :func:`rms_norm_ref` and
:func:`rope_ref`, the model's RMSNorm and RoPE as the reference model writes
them, the plain versions of the ``rms_norm`` and ``rope`` kernels. The last
three kernels replace no TPU kernel.

Three additions to ``flash_attention_ref``: a ``scale`` of the scores and a
V narrower than Q and K (multi-head latent attention, ``models/mla.py``); it
takes ``kv_lengths`` (B,), the valid key prefix of each row, which is how
the port's prefill passes the reference model's right-padding mask
(``kv_valid``) to the attention; and a query row with no valid key gets the
reference model's value there, not a softmax over -1e30. The reference's serving prefill
(``repro/models/attention.py:72-171``, blocks of ``min(512, Skv)`` keys)
takes exp(-1e30 - (-1e30)) = 1 for every key of such a row, the zero
padding of the last block included, so the row is
sum_{k < Skv} v_k / Skv_pad, Skv_pad being Skv rounded up to a whole block.
A prefill meets such rows where a short prompt shares a batch padded past
its length plus the window (a ring-cached shared block).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a zero-initialised scale applied as (1 + scale), fp32
    inside (``repro/models/layers.py:83-88``): the plain version of the
    ``rms_norm`` kernel."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def rope_ref(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """RoPE's half-split rotation in fp32 (``repro/models/rope.py:49-56``): x (B,
    S, H, head_dim), angles (B, S, head_dim//2). The plain version of the
    ``rope`` kernel."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def unembed_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The unembed's product in fp32, as ``repro/models/layers.py:135-138``
    computes it: the logits of every input the kernel does not take."""
    return x.to(torch.float32) @ w.to(torch.float32)


def flash_attention_ref(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Skv, KV, hd)
    v: torch.Tensor,            # (B, Skv, KV, hd_v)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_lengths: Optional[torch.Tensor] = None,   # (B,) int32 valid key prefix
    scale: Optional[float] = None,               # 1/sqrt(hd) when None
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    hd_v = v.shape[-1]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32), k.to(torch.float32))
    s = s / math.sqrt(hd) if scale is None else s * scale
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
    o = torch.where(~mask.any(dim=-1)[..., None], empty_row_value(v)[:, :, None, None], o)
    return torch.movedim(o, 3, 1).reshape(B, Sq, H, hd_v).to(q.dtype)


def empty_row_value(v: torch.Tensor) -> torch.Tensor:
    """(B, Skv, KV, hd) -> (B, KV, hd) fp32: what the reference's blocked
    prefill gives a query row that no key is valid for."""
    Skv = v.shape[1]
    blk = min(512, Skv)
    return v.to(torch.float32).sum(dim=1) / (-(-Skv // blk) * blk)


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


def _chunk_scan(xc, dtc, ac, Bc, Cc, h):
    """The reference's scan body over chunks: each input is (nc, B, Q, ...)
    with the chunks leading; h (B, H, P, N) fp32 is carried across them.
    Returns (y chunks (nc, B, Q, H, P) fp32, the last h)."""
    f32 = torch.float32
    Q = xc.shape[2]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xc.device))
    ys = []
    for x_c, dt_c, a_c, B_c, C_c in zip(xc, dtc, ac, Bc, Cc):
        x_c, B_c, C_c = x_c.to(f32), B_c.to(f32), C_c.to(f32)
        cum = torch.cumsum(a_c, dim=1)                          # (B, Q, H)
        # intra-chunk: the exponent masked before the exp, so that no exp of a
        # positive difference (inf) meets the mask in the backward
        diff = cum[:, :, None, :] - cum[:, None, :, :]          # (B, Q, Q, H)
        L = torch.exp(torch.where(tri[None, :, :, None], diff, float("-inf")))
        CB = torch.einsum("bqn,bkn->bqk", C_c, B_c)              # (B, Q, Q)
        scores = CB[..., None] * L * dt_c[:, None, :, :]        # (B, Q, Q, H)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", scores, x_c)
        # the carried state's contribution
        y_inter = torch.einsum("bqn,bqh,bhpn->bqhp", C_c, torch.exp(cum), h)
        # the new carried state
        cum_last = cum[:, -1:, :]                               # (B, 1, H)
        decay_to_end = torch.exp(cum_last - cum) * dt_c         # (B, Q, H)
        state_new = torch.einsum("bkn,bkh,bkhp->bhpn", B_c, decay_to_end, x_c)
        h = torch.exp(cum_last[:, 0, :])[:, :, None, None] * h + state_new
        ys.append(y_intra + y_inter)
    return torch.stack(ys), h


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in plain PyTorch, differentiable by autograd: x (B, S, H,
    P), dt and a (B, S, H) fp32 (post-softplus step, log-decay dt * A), Bm
    and Cm (B, S, N), over chunks of Q = min(chunk, S) with S padded to a
    multiple of Q, from the state ``h0`` (B, H, P, N) fp32 (zeros if None).
    Returns (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) fp32).
    The reference's ``ssd_chunked`` (``repro/models/ssm.py``) and the form
    the scan kernel computes (Q = 64, ``csrc/ssd_scan.cu``)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x, dt, a, Bm, Cm = (F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
                            for t in (x, dt, a, Bm, Cm))
    Sp = S + pad
    nc = Sp // Q

    def to_chunks(t):
        return torch.movedim(t.reshape((B, nc, Q) + t.shape[2:]), 1, 0)

    if h0 is None:
        h0 = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    yc, h = _chunk_scan(*(to_chunks(t) for t in (x, dt, a, Bm, Cm)), h0)
    y = torch.movedim(yc.to(x.dtype), 0, 1).reshape(B, Sp, H, P)[:, :S]
    return y, h



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
