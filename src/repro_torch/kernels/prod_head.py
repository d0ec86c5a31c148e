"""Fused ProD predictor head on Hopper: wrapper of ``csrc/prod_head.cu``.

Replaces ``prod_head_pallas`` (``src/repro/kernels/prod_head.py:61``): the
2-layer MLP (d -> hidden -> K bins), softmax, and the CDF-crossing quantile
decode with in-bin linear interpolation, for every requested CDF level in one
call. Bound on the H100 by reading W1 once (8.4 MB fp32 at d=4096,
hidden=512: ~2.5 us at 3.35 TB/s). The TPU kernel keeps W1 resident in VMEM;
it does not fit in shared memory, so the CUDA kernel streams it in d-tiles
with the hidden units split across blocks, and a one-warp-per-row epilogue
does softmax, cumsum, crossing and interpolation (see the source's header).

``prod_head_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build


def prod_head_cuda(phi: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, edges: torch.Tensor,
                   qs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """phi (B, d) fp32/bf16; weights, edges (K+1,) and qs (Q,) fp32.
    Returns (probs (B, K), quants (B, Q)), both fp32."""
    if phi.ndim != 2:
        raise ValueError(f"phi: expected (B, d), got {tuple(phi.shape)}")
    B, d = phi.shape
    if w1.ndim != 2 or w2.ndim != 2:
        raise ValueError("w1 and w2 must be matrices")
    hidden, K = w1.shape[1], w2.shape[1]
    if hidden % 32 or K > 128:
        raise ValueError(f"kernel takes hidden % 32 == 0 and K <= 128, got "
                         f"hidden={hidden}, K={K}")
    dev = phi.device
    code = _build.require(phi, "phi", ("float32", "bfloat16"))
    _build.require(w1, "w1", shape=(d, hidden), device=dev)
    _build.require(b1, "b1", shape=(hidden,), device=dev)
    _build.require(w2, "w2", shape=(hidden, K), device=dev)
    _build.require(b2, "b2", shape=(K,), device=dev)
    _build.require(edges, "edges", shape=(K + 1,), device=dev)
    _build.require(qs, "qs", device=dev)
    if qs.ndim != 1:
        raise ValueError("qs must be a vector of CDF levels")
    Q = qs.shape[0]
    f32 = torch.float32
    partial = torch.empty((B, hidden // 32, K), dtype=f32, device=dev)
    probs = torch.empty((B, K), dtype=f32, device=dev)
    quants = torch.empty((B, Q), dtype=f32, device=dev)
    fn = _build.entry("prod_head", n_pointers=11, n_ints=6)
    err = fn(phi.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             b2.data_ptr(), edges.data_ptr(), qs.data_ptr(), partial.data_ptr(),
             probs.data_ptr(), quants.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream, B, d, hidden, K, Q, code)
    _build.check(err, "prod_head")
    prod_head_cuda.launches += 1
    return probs, quants


prod_head_cuda.launches = 0
