"""Fused ProD predictor head on Hopper: wrapper of ``csrc/prod_head.cu``.

Replaces ``prod_head_pallas`` (``src/repro/kernels/prod_head.py:61``): the
2-layer MLP (d -> hidden -> K bins), softmax, and the CDF-crossing quantile
decode with in-bin linear interpolation, for every requested CDF level in one
call. Bound on the H100 by reading W1 once at serving batch (8.4 MB fp32 at
d=4096, hidden=512: ~2.5 us at 3.35 TB/s). The TPU kernel keeps W1 resident
in VMEM; it does not fit in shared memory, so the CUDA kernel splits phi W1
over d as well as over hidden, so that every SM reads a slice of W1, into an
fp32 scratch of partial sums. The splits are summed in a fixed order, then
relu, W2, softmax, cumsum, crossing and interpolation follow: for B <= 32 in
the same launch, by the last block of each tile, for larger B in a second
launch (see the source's header).

The head runs once per served batch and its device time is ~15 us, so the
host's share of a call matters. The library sizes the scratch and the
counters; the sizes are asked once per (device, B, d, hidden, K). The scratch
and the counters are a workspace kept per (device, stream) and grown when a
call needs more, as cuBLAS keeps its workspace: calls on one stream run in
order, and every counter is returned to 0 by the block that completes it, so
the counters are zeroed only when the workspace is made. A call captured into
a CUDA graph gets a workspace of its own, which the graph keeps: a graph may
be replayed on any stream. Per call, only the two outputs are allocated.

``prod_head_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_SIZES: Dict[tuple, Tuple[int, int]] = {}


def _sizes(dev: torch.device, B: int, d: int, hidden: int, K: int) -> Tuple[int, int]:
    """(fp32 scratch floats, int32 counters) of a call, from the library."""
    key = (dev, B, d, hidden, K)
    sizes = _SIZES.get(key)
    if sizes is None:
        lib = _build.load("prod_head")
        lib.prod_head_scratch_floats.restype = ctypes.c_longlong
        with torch.cuda.device(dev):   # the split follows this card's SM count
            sizes = (lib.prod_head_scratch_floats(B, d, hidden, K),
                     lib.prod_head_counters(B, d, hidden))
        _SIZES[key] = sizes
    return sizes


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
    fn = _build.entry("prod_head", n_pointers=12, n_ints=6)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)   # as Triton's launcher reads it
    scratch, counters = _build.workspace("prod_head", dev, stream, *_sizes(dev, B, d, hidden, K))
    probs = torch.empty((B, K), dtype=torch.float32, device=dev)
    quants = torch.empty((B, Q), dtype=torch.float32, device=dev)
    err = fn(phi.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             b2.data_ptr(), edges.data_ptr(), qs.data_ptr(), scratch.data_ptr(),
             counters.data_ptr(), probs.data_ptr(), quants.data_ptr(), stream,
             B, d, hidden, K, Q, code)
    _build.check(err, "prod_head")
    prod_head_cuda.launches += 1
    return probs, quants


prod_head_cuda.launches = 0
