"""Split-KV flash-decoding on Hopper: wrapper of ``csrc/decode_attention.cu``.

Replaces ``decode_attention_pallas`` (``src/repro/kernels/decode_attention.py:64``):
one query token per row against the KV cache, keys at positions >=
``lengths[b]`` masked, the G heads of a GQA group sharing their K/V rows,
online softmax in fp32. The TPU kernel carries (m, l, acc) along a sequential
grid axis; here blocks of grid (splits, KV, B) each attend one chunk of
``SPLIT`` keys and write partial (m, l, acc) to fp32 scratch allocated below,
and a second small kernel combines them. Bound by the bytes of the valid
K/V prefix (18.9 MB per layer at B=8, Sc=576, KV=8, hd=128 in bf16: ~5.6 us).

``decode_attention_cuda.launches`` counts the calls that launched the kernels.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
SPLIT = 64          # keys per split block (the kernel takes <= 128)
MAX_GROUP = 16      # query heads per KV head the kernel takes


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd), k/v (B, Sc, KV, hd), fp32 or bf16; lengths (B,) int32.
    Returns (B, H, hd) in q's dtype."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError("q must be (B, H, hd) and k/v (B, Sc, KV, hd)")
    B, H, hd = q.shape
    _, Sc, KV, _ = k.shape
    if hd not in HEAD_DIMS or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS}, H % KV == 0 and "
                         f"H/KV <= {MAX_GROUP}, got hd={hd}, H={H}, KV={KV}")
    dev = q.device
    code = _build.require(q, "q", ("float32", "bfloat16"))
    dt = (str(q.dtype).replace("torch.", ""),)
    _build.require(k, "k", dt, shape=(B, Sc, KV, hd), device=dev)
    _build.require(v, "v", dt, shape=(B, Sc, KV, hd), device=dev)
    _build.require(lengths, "lengths", ("int32",), shape=(B,), device=dev)
    G = H // KV
    n_splits = -(-Sc // SPLIT)
    f32 = torch.float32
    part_m = torch.empty((B, KV, n_splits, G), dtype=f32, device=dev)
    part_l = torch.empty((B, KV, n_splits, G), dtype=f32, device=dev)
    part_acc = torch.empty((B, KV, n_splits, G, hd), dtype=f32, device=dev)
    out = torch.empty_like(q)
    fn = _build.entry("decode_attention", n_pointers=9, n_ints=8, n_floats=1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
             out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
             B, Sc, H, KV, hd, SPLIT, n_splits, code, 1.0 / math.sqrt(hd))
    _build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
