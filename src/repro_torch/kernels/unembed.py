"""The unembed's product on Hopper: wrapper of ``csrc/unembed.cu``.

fp32 logits = x (M, K) @ w (K, N) from bf16 x and w, on the tensor cores,
with no fp32 copy of the head. Replaces no TPU kernel: the reference
computes ``x.float() @ w.float()`` (``src/repro/models/layers.py:135-138``),
which on the H100 casts the whole head to fp32 on every call and runs an fp32
GEMM outside the tensor cores. The product of two bf16 values is exact in
fp32, so the kernel sums the same products, though not with the same
rounding: each 64-term partial sum with the tensor cores' accumulation,
whose fp32 adds truncate, and the partial sums with rounded fp32 adds (see
the source's header). Persistent blocks walk 128-column tiles; a producer thread
feeds them with TMA. ``w`` is an untied head (K, N), N-contiguous, or a tied
table's transposed view ``embed.T``, K-contiguous.

``unembed_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _w_kmajor(w: torch.Tensor) -> int:
    """1 for a K-contiguous ``w`` (a transposed (N, K) table), 0 for an
    N-contiguous one, -1 for a layout the kernel does not take. TMA reads
    rows whose byte stride is a multiple of 16."""
    K, N = w.shape
    if w.stride() == (1, K) and K % 8 == 0:
        return 1
    if w.stride() == (N, 1) and N % 8 == 0:
        return 0
    return -1


def unembed_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) and w (K, N), both bf16 on the card: x contiguous with
    16-byte aligned rows, w in a layout of :func:`_w_kmajor`. Raises on
    anything else. Returns the fp32 logits (M, N)."""
    if not (x.is_cuda and x.ndim == 2 and w.ndim == 2 and x.dtype == w.dtype == torch.bfloat16
            and x.shape[1] == w.shape[0] and x.shape[1] % 8 == 0 and x.is_contiguous()
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 and _w_kmajor(w) >= 0):
        raise ValueError(f"unembed: takes bf16 CUDA x (M, K), contiguous with K % 8 == 0, "
                         f"and w (K, N), N-contiguous with N % 8 == 0 or K-contiguous; got "
                         f"x {tuple(x.shape)} {x.dtype} on {x.device}, w {tuple(w.shape)} "
                         f"{w.dtype} strides {w.stride()}")
    if w.device != x.device:
        raise ValueError(f"unembed: w on {w.device}, expected {x.device}")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    fn = _build.entry("unembed", n_pointers=4, n_ints=4)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream, M, N, K, _w_kmajor(w))
    _build.check(err, "unembed")
    unembed_cuda.launches += 1
    return out


unembed_cuda.launches = 0
