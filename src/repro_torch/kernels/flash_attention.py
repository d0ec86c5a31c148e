"""Flash attention forward (prefill) on Hopper: wrapper of
``csrc/flash_attention.cu``.

Replaces ``flash_attention_pallas`` (``src/repro/kernels/flash_attention.py:69``):
GQA attention with causal, sliding-window and per-row key-length masks and an
online softmax in fp32. In bf16 it is a Hopper kernel: a block owns 128 query
rows of one (batch row, head); a producer warp brings Q once and K/V tiles
with TMA into a 2-stage shared-memory ring, and two consumer warpgroups run
both products with ``wgmma`` on the tensor cores and the softmax on the
accumulators in registers. Tiles that every row masks are skipped. fp32
(tiny-lm only) keeps a SIMT kernel on the CUDA cores. At the serving shape
(B=8, S=512, H=32, KV=8, hd=128, bf16) the least time is ~24 us of bytes
against ~16 us of bf16 tensor-core FLOPs (see the source's header).

MLA's expanded prefill (``models/mla.py``) runs the bf16 kernel with Q and K
of 192 columns and V of 128, the scale passed in: V comes by its own tensor
map at its true width, and O is 128 columns wide.

``flash_attention_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 112, 128, 168)
# (q/k width, v width) pairs of different widths: MLA's expanded prefill
# (models/mla.py), bf16 only
SPLIT_DIMS = ((192, 128),)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         kv_lengths: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, hd), k (B, Skv, KV, hd), v (B, Skv, KV, hd_v), fp32 or
    bf16, hd_v = hd or, in bf16, (hd, hd_v) in ``SPLIT_DIMS``;
    ``kv_lengths`` (B,) int32, the valid key prefix of each row (all of Skv
    when None); ``scale`` the scores' factor (1/sqrt(hd) when None). Returns
    (B, Sq, H, hd_v) in q's dtype."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be (B, S, heads, hd)")
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    hd_v = v.shape[-1]
    split = hd_v != hd and q.dtype == torch.bfloat16 and (hd, hd_v) in SPLIT_DIMS
    if not (hd in HEAD_DIMS and hd_v == hd or split) or H % KV:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS} (v at the same width), or in bf16 "
                         f"(hd, hd_v) in {SPLIT_DIMS}, and H % KV == 0; got hd={hd}, "
                         f"hd_v={hd_v}, H={H}, KV={KV}, {q.dtype}")
    dev = q.device
    code = _build.require(q, "q", ("float32", "bfloat16"))
    dt = (str(q.dtype).replace("torch.", ""),)
    _build.require(k, "k", dt, shape=(B, Skv, KV, hd), device=dev)
    _build.require(v, "v", dt, shape=(B, Skv, KV, hd_v), device=dev)
    if kv_lengths is None:
        kv_lengths = torch.full((B,), Skv, dtype=torch.int32, device=dev)
    _build.require(kv_lengths, "kv_lengths", ("int32",), shape=(B,), device=dev)
    out = q.new_empty((B, Sq, H, hd_v))
    fn = _build.entry("flash_attention", n_pointers=6, n_ints=10, n_floats=1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lengths.data_ptr(),
             out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
             B, Sq, Skv, H, KV, hd, hd_v, int(causal), int(window), code,
             1.0 / math.sqrt(hd) if scale is None else float(scale))
    _build.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
