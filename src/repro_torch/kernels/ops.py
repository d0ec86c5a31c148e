"""Public entry points of the port's kernels, dispatched on the tensor's device.

A CUDA tensor goes to the hand-written kernel (which raises on what it does
not take); a CPU tensor goes to the plain PyTorch version in ``ref``. There is
no fall-back from one to the other. Signatures follow ``repro/kernels/ops.py``
without its ``impl`` and block-size knobs: the device picks the path, and the
tile sizes are the kernels' own. ``flash_attention`` adds ``kv_lengths``, the
valid key prefix of each row, and ``scale``, the scores' factor, with a V
that may be narrower than Q and K. ``unembed`` replaces no TPU kernel (the
reference's unembed is a plain fp32 product): a head stored in fp32 takes
that product on either device, and a bf16 head on the card the kernel.
``rms_norm`` and ``rope`` replace no TPU kernel either: each is the model's
fp32 elementwise chain (``ref.rms_norm_ref``, ``ref.rope_ref``) as one pass
on the card. Neither kernel has a backward, so under autograd (grad enabled
and an input that requires grad) both devices take the plain version.

Each entry point runs under ``fusedkernel_<name>`` (``common/scopes.py``),
the mark by which the dry-run's analyzer (``launch/graph_analysis.py``)
counts a kernel's bytes. While a trace records (``scopes.tracing``), the
scan's plain version is the chunked form the kernel computes
(``ref.ssd_chunked`` at the kernel's chunk): ``ref.ssd_scan_ref`` loops
over every position, which a traced 32k prefill would unroll step by step.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.scopes import is_tracing, kernel_region, span
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.prod_head import prod_head_cuda
from repro_torch.kernels.rms_norm import rms_norm_cuda
from repro_torch.kernels.rope import rope_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.kernels.unembed import unembed_cuda


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


SCAN_CHUNK = 64      # the scan kernel's chunk (csrc/ssd_scan.cu)


@kernel_region("fusedkernel_flash_attention")
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_lengths: Optional[torch.Tensor] = None, scale: Optional[float] = None):
    """``scale`` multiplies the scores (1/sqrt(q's width) when None); v may
    be narrower than q and k (MLA: 192 and 128), and the output takes v's."""
    if _on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    kv_lengths=kv_lengths, scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_lengths=kv_lengths, scale=scale)


@kernel_region("fusedkernel_decode_attention")
def decode_attention(q, k, v, lengths):
    if _on_cuda(q):
        return decode_attention_cuda(q, k, v, lengths)
    return ref.decode_attention_ref(q, k, v, lengths)


@kernel_region("fusedkernel_ssd_scan")
def ssd_scan(x, dt, a, Bm, Cm):
    """Chunked SSD scan: (y (B, S, H, P) in x's dtype, h (B, H, P, N) fp32).
    The reference's ``chunk`` is gone: the kernel picks its own and masks a
    ragged last chunk itself, so no padded copies are made."""
    if _on_cuda(x):
        return ssd_scan_cuda(x, dt, a, Bm, Cm)
    if is_tracing():
        return ref.ssd_chunked(x, dt, a, Bm, Cm, SCAN_CHUNK)
    return ref.ssd_scan_ref(x, dt, a, Bm, Cm)


@kernel_region("fusedkernel_prod_head")
def prod_head(phi, w1, b1, w2, b2, edges, *, qs=None):
    """Fused head. ``qs=None`` returns (probs, median); ``qs`` a sequence of
    CDF levels returns (probs, quants (B, Q)) — all levels in one call."""
    if not _on_cuda(phi):
        return ref.prod_head_ref(phi, w1, b1, w2, b2, edges, qs=qs)
    with span("head.levels"):
        levels = torch.as_tensor([0.5] if qs is None else qs, dtype=torch.float32,
                                 device=phi.device)
    probs, quants = prod_head_cuda(phi, w1, b1, w2, b2, edges, levels)
    return (probs, quants[:, 0]) if qs is None else (probs, quants)


@kernel_region("fusedkernel_unembed")
def unembed(x, w):
    """fp32 logits x (..., K) @ w (K, N). On the CPU, and for a head stored in
    fp32, the fp32 product ``ref.unembed_ref``. A bf16 head on the card goes
    to the kernel, x as contiguous rows; the kernel raises on what it does
    not take (x not bf16, a layout TMA cannot read)."""
    if not _on_cuda(x) or w.dtype == torch.float32:
        return ref.unembed_ref(x, w)
    logits = unembed_cuda(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return logits.reshape(*x.shape[:-1], w.shape[-1])


@kernel_region("fusedkernel_rms_norm")
def rms_norm(x, scale, eps: float):
    """RMSNorm over x's last dimension with the gain (1 + scale), rounded once
    to x's dtype: the plain version on the CPU and under autograd, the
    kernel on the card (it raises on what it does not take)."""
    if not _on_cuda(x) or (torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad)):
        return ref.rms_norm_ref(x, scale, eps)
    return rms_norm_cuda(x, scale, eps)


@kernel_region("fusedkernel_rope")
def rope(x, angles):
    """x (B, S, H, hd) rotated by angles (B, S, hd / 2): the plain version on
    the CPU and under autograd, the kernel on the card (it raises on what it
    does not take)."""
    if not _on_cuda(x) or (torch.is_grad_enabled() and (x.requires_grad or angles.requires_grad)):
        return ref.rope_ref(x, angles)
    return rope_cuda(x, angles)
