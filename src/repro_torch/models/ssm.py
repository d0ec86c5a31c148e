"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060]: the
training forward, prefill over a whole prompt and the O(1) decode
recurrence.

The port of ``repro/models/ssm.py``. Prefill runs the chunked SSD scan
through ``kernels.ops.ssd_scan`` where the reference calls ``ssd_chunked``
(the point where the TPU runs its Pallas kernel); decode is the one-step
recurrence in plain PyTorch. Training (:func:`ssm_apply_train`) runs
:func:`ssd_chunked`, plain PyTorch under autograd over the config's
``ssm_chunk``, as the reference trains its scan through XLA: the repo has
no backward kernel to port. Layout: d_inner = H*P, one B/C group shared
across heads.

Reference behaviour kept as it is:

- ``_discretize`` ignores ``dt_bias``, though the spec declares it;
- prefill sums the conv's products and adds the D skip in the model dtype,
  decode does both in fp32;
- prefill scans the right padding too: ``h`` and the conv tail come from the
  padded length, not from each prompt's own length.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.scopes import scoped_kernel_vjp
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import ParamSpec, rms_norm

State = Dict[str, torch.Tensor]     # {"h": (B, H, P, N) fp32, "conv": (B, W-1, C)}


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(H, P, N, d_conv_channels)."""
    H = cfg.ssm_n_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    return H, P, N, H * P + 2 * N


def ssm_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    H, P, N, d_conv = ssm_dims(cfg)
    d_inner = H * P
    d = cfg.d_model
    return {
        "w_in": ParamSpec((d, 2 * d_inner + 2 * N + H), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv_width, d_conv), ("conv", "ssm_inner"),
                            init="normal", scale=0.5),
        "conv_b": ParamSpec((d_conv,), ("ssm_inner",), init="zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "norm": ParamSpec((d_inner,), ("ssm_inner",), init="zeros"),
        "w_out": ParamSpec((d_inner, d), ("ssm_inner", "embed")),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    H, P, N, _ = ssm_dims(cfg)
    d_inner = H * P
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)
    return z, xbc, dt  # (..., d_inner), (..., d_inner + 2N), (..., H)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C): the sum of W
    shifted products in the input's dtype, as the reference writes it (not
    ``F.conv1d``, which cuDNN runs in TF32 for fp32 by default)."""
    W = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i: i + S] * w[i] for i in range(W))
    return F.silu(out + b)


def _discretize(dt_raw: torch.Tensor, A_log: torch.Tensor):
    dt = F.softplus(dt_raw.to(torch.float32))                  # (B, S, H)
    A = -torch.exp(A_log.to(torch.float32))                    # (H,)
    return dt, dt * A                                          # dt, a = log-decay


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training scan: ``kernels/ref.py::ssd_chunked`` over chunks of
    ``chunk`` from the state ``h0`` (zeros if None), differentiable by
    autograd. Returns (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) fp32).

    It runs under ``scoped_kernel_vjp("fusedkernel_ssd_scan")``
    (``common/scopes.py``), as the reference's chunk loop: the backward
    recomputes it, so the (B, Q, Q, H) tiles are not kept between the passes."""
    if h0 is None:
        B, _, H, P = x.shape
        h0 = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)
    scan = lambda *t: ref.ssd_chunked(*t[:5], chunk, t[5])
    return scoped_kernel_vjp("fusedkernel_ssd_scan", scan)(x, dt, a, Bm, Cm, h0)


def _layer(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, scan):
    """The Mamba2 layer over (B, S, d) around ``scan(xs, dt, a, Bm, Cm) -> (y,
    h)``. Returns (its output, h, the conv's raw input)."""
    H, P, N, _ = ssm_dims(cfg)
    B, S, _ = x.shape
    z, xbc_raw, dt_raw = _split_proj(x @ p["w_in"], cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    dt, a = _discretize(dt_raw, p["A_log"])
    y, h = scan(xs, dt, a, Bm, Cm)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(B, S, H * P)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"], h, xbc_raw


def ssm_apply_train(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 layer for training, x (B, S, d) -> (B, S, d): the
    scan in :func:`ssd_chunked` over ``cfg.ssm_chunk``, no decode state."""
    return _layer(p, x, cfg, lambda *t: ssd_chunked(*t, cfg.ssm_chunk))[0]


def ssm_prefill(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """Full-sequence Mamba2 layer over (B, S, d); returns its output and the
    decode state (h, conv tail)."""
    scan = lambda xs, dt, a, Bm, Cm: ops.ssd_scan(xs.contiguous(), dt, a, Bm.contiguous(),
                                                  Cm.contiguous())
    out, h, xbc_raw = _layer(p, x, cfg, scan)
    S, W = x.shape[1], cfg.ssm_conv_width
    conv_tail = (xbc_raw[:, -(W - 1):] if S >= W - 1
                 else F.pad(xbc_raw, (0, 0, W - 1 - S, 0)))
    return out, {"h": h, "conv": conv_tail.to(x.dtype)}


def ssm_decode_step(p: Dict[str, torch.Tensor], x: torch.Tensor, state: State,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """One token, x (B, 1, d). Returns its output and the new state."""
    H, P, N, _ = ssm_dims(cfg)
    B = x.shape[0]
    f32 = torch.float32
    z, xbc_raw, dt_raw = _split_proj(x @ p["w_in"], cfg)       # (B, 1, *)
    window = torch.cat([state["conv"], xbc_raw], dim=1)         # (B, W, C)
    conv_out = ((window.to(f32) * p["conv_w"].to(f32)).sum(dim=1)
                + p["conv_b"].to(f32))
    xbc = F.silu(conv_out)[:, None, :].to(x.dtype)             # (B, 1, C)
    xs, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
    xs1 = xs.reshape(B, H, P)
    dt, a = _discretize(dt_raw[:, 0], p["A_log"])               # (B, H)
    decay = torch.exp(a)[:, :, None, None]                      # (B, H, 1, 1)
    inject = torch.einsum("bh,bhp,bn->bhpn", dt, xs1.to(f32), Bm[:, 0].to(f32))
    h = decay * state["h"] + inject
    y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].to(f32))
    y = y + p["D"].to(f32)[None, :, None] * xs1.to(f32)
    y = y.reshape(B, 1, H * P).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"], {"h": h, "conv": window[:, 1:].to(x.dtype)}
