"""Public entry points of the port's kernels, dispatched on the tensor's device.

A CUDA tensor goes to the hand-written kernel (which raises on what it does
not take); a CPU tensor goes to the plain PyTorch version in ``ref``. There is
no fall-back from one to the other. Signatures follow ``repro/kernels/ops.py``
without its ``impl`` and block-size knobs: the device picks the path, and the
tile sizes are the kernels' own. ``flash_attention`` adds ``kv_lengths``, the
valid key prefix of each row.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.prod_head import prod_head_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_lengths: Optional[torch.Tensor] = None):
    if _on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    kv_lengths=kv_lengths)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_lengths=kv_lengths)


def decode_attention(q, k, v, lengths):
    if _on_cuda(q):
        return decode_attention_cuda(q, k, v, lengths)
    return ref.decode_attention_ref(q, k, v, lengths)


def ssd_scan(x, dt, a, Bm, Cm):
    """Chunked SSD scan: (y (B, S, H, P) in x's dtype, h (B, H, P, N) fp32).
    The reference's ``chunk`` is gone: the kernel picks its own and masks a
    ragged last chunk itself, so no padded copies are made."""
    if _on_cuda(x):
        return ssd_scan_cuda(x, dt, a, Bm, Cm)
    return ref.ssd_scan_ref(x, dt, a, Bm, Cm)


def prod_head(phi, w1, b1, w2, b2, edges, *, qs=None):
    """Fused head. ``qs=None`` returns (probs, median); ``qs`` a sequence of
    CDF levels returns (probs, quants (B, Q)) — all levels in one call."""
    if not _on_cuda(phi):
        return ref.prod_head_ref(phi, w1, b1, w2, b2, edges, qs=qs)
    levels = torch.as_tensor([0.5] if qs is None else qs, dtype=torch.float32,
                             device=phi.device)
    probs, quants = prod_head_cuda(phi, w1, b1, w2, b2, edges, levels)
    return (probs, quants[:, 0]) if qs is None else (probs, quants)
