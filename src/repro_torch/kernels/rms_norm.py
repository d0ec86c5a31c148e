"""RMSNorm in one pass on the card: wrapper of ``csrc/rms_norm.cu``.

out = x * rsqrt(mean(x^2) + eps) * (1 + scale), fp32 inside and rounded once
to x's dtype, where the plain version (``ref.rms_norm_ref``) is ten launches,
each a pass over the activation in fp32. Replaces no TPU kernel: the
reference writes the norm in jnp and leaves it to XLA. x is bf16 or fp32 with
a contiguous last dimension; its rows may have any one stride (the MLA's
``kv[..., :R]``). The output is contiguous.

``rms_norm_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def row_stride(shape, strides) -> int:
    """The one stride between consecutive rows of a tensor seen as (rows,
    shape[-1]), or -1 where its leading dimensions do not flatten to one."""
    rs = span = None
    for n, s in zip(reversed(shape[:-1]), reversed(strides[:-1])):
        if n == 1:
            continue
        if rs is None:
            rs, span = s, s * n
        elif s != span:
            return -1
        else:
            span *= n
    return shape[-1] if rs is None else rs


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., d) bf16 or fp32 on the card, last dimension contiguous, rows
    at one stride; scale (d,) contiguous, bf16 or fp32. Raises on anything
    else. Returns the normed x, contiguous, in x's dtype."""
    code = _build.TORCH_DTYPE_CODES.get(x.dtype, -1)
    d = x.shape[-1]
    rs = row_stride(x.shape, x.stride()) if x.ndim else -1
    if not (x.is_cuda and code >= 0 and x.stride(-1) == 1 and rs >= d
            and scale.shape == (d,) and scale.stride(0) == 1
            and scale.dtype in _build.TORCH_DTYPE_CODES):
        raise ValueError(f"rms_norm: takes bf16 or fp32 CUDA x (..., d) with a contiguous last "
                         f"dimension and rows at one stride, and scale (d,) contiguous in bf16 or "
                         f"fp32; got x {tuple(x.shape)} {x.dtype} strides "
                         f"{x.stride() if x.ndim else ()} on {x.device}, scale "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if scale.device != x.device:
        raise ValueError(f"rms_norm: scale on {scale.device}, expected {x.device}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    M = x.numel() // d if d else 0
    if M == 0:
        return out
    fn = _build.entry("rms_norm", n_pointers=4, n_ints=5, n_floats=1)
    err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream, M, d, rs, code,
             _build.TORCH_DTYPE_CODES[scale.dtype], eps)
    _build.check(err, "rms_norm")
    rms_norm_cuda.launches += 1
    return out


rms_norm_cuda.launches = 0
