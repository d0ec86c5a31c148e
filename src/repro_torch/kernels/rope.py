"""RoPE in one pass on the card: wrapper of ``csrc/rope.cu``.

The half-split rotation [x1 cos - x2 sin, x2 cos + x1 sin] of each head of x
(B, S, H, hd) by its token's fp32 angles (B, S, hd / 2), fp32 inside with the
plain path's roundings and rounded once to x's dtype, where the plain version
(``ref.rope_ref``) is twelve launches. Replaces no TPU kernel: the reference
writes RoPE in jnp and leaves it to XLA. x is bf16 or fp32 with a contiguous
last dimension and any strides above it (the MLA's ``q[..., n:]`` and
``kv[..., None, R:]`` are read in place); the angles' last dimension is
contiguous. The output is contiguous.

``rope_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rope_cuda(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd) bf16 or fp32 on the card, hd even, last dimension
    contiguous; angles (B, S, hd / 2) fp32, last dimension contiguous. Raises
    on anything else. Returns the rotated x (B, S, H, hd), contiguous, in x's
    dtype."""
    code = _build.TORCH_DTYPE_CODES.get(x.dtype, -1)
    if not (x.is_cuda and code >= 0 and x.ndim == 4 and x.shape[-1] % 2 == 0
            and x.stride(-1) == 1 and angles.dtype == torch.float32
            and angles.shape == (*x.shape[:2], x.shape[-1] // 2) and angles.stride(-1) == 1):
        raise ValueError(f"rope: takes bf16 or fp32 CUDA x (B, S, H, hd) with hd even and a "
                         f"contiguous last dimension, and fp32 angles (B, S, hd / 2) with a "
                         f"contiguous last dimension; got x {tuple(x.shape)} {x.dtype} strides "
                         f"{x.stride()} on {x.device}, angles {tuple(angles.shape)} "
                         f"{angles.dtype}")
    if angles.device != x.device:
        raise ValueError(f"rope: angles on {angles.device}, expected {x.device}")
    B, S, H, hd = x.shape
    out = torch.empty((B, S, H, hd), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    sb, ss, sh, _ = x.stride()
    ab, as_, _ = angles.stride()
    fn = _build.entry("rope", n_pointers=4, n_ints=10)
    err = fn(x.data_ptr(), angles.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream, B, S, H, hd, sb, ss, sh, ab, as_,
             code)
    _build.check(err, "rope")
    rope_cuda.launches += 1
    return out


rope_cuda.launches = 0
