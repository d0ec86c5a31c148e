"""Split-KV flash-decoding on Hopper: wrapper of ``csrc/decode_attention.cu``.

Replaces ``decode_attention_pallas`` (``src/repro/kernels/decode_attention.py:64``):
one query token per row against the KV cache, keys at positions >=
``lengths[b]`` masked, the G heads of a GQA group sharing their K/V rows,
online softmax in fp32. The TPU kernel carries (m, l, acc) along a sequential
grid axis; here blocks of grid (splits, head tiles, B*KV) each attend one
chunk of keys with 16-byte loads, and the last block of each (row, KV head,
head tile) combines the splits in the same launch. Bound by the bytes of the
valid K/V prefix (13.9 MB at B=8, Sc=576, KV=8, hd=128 in bf16 with
chip_smoke.py's ragged lengths: ~4.2 us).

The library plans the split from the shapes and the SM count alone (the
lengths stay on the device: reading them would cost a sync per layer per
step) and sizes the workspace for it; the wrapper asks once per (device,
shape), as ``prod_head``'s does, so the kernel's geometry lives in the source
only. Scratch and counters are a workspace per (device, stream)
(``_build.workspace``), so a call allocates only its output.

``decode_attention_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

Plan = Tuple[int, int, int]   # (query heads a block, splits, keys a split)
_PLANS: Dict[tuple, Tuple[Plan, Tuple[int, int]]] = {}


def _lib() -> ctypes.PyDLL:
    """The library, with the signatures of its plan and size functions set."""
    lib = _build.load("decode_attention")
    if lib.decode_attention_plan.argtypes is None:
        i = ctypes.c_int
        lib.decode_attention_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)]
        lib.decode_attention_plan.restype = i
        lib.decode_attention_scratch_floats.argtypes = [i] * 4
        lib.decode_attention_scratch_floats.restype = ctypes.c_longlong
        lib.decode_attention_counters.argtypes = [i] * 4
        lib.decode_attention_counters.restype = i
    return lib


def _sizes(B: int, H: int, KV: int, hd: int, p: Plan) -> Tuple[int, int]:
    """(fp32 scratch floats, int32 counters) of a launch with plan ``p``."""
    lib = _lib()
    return (lib.decode_attention_scratch_floats(B, H, hd, p[1]),
            lib.decode_attention_counters(B, H, KV, p[0]))


def _plan(dev: torch.device, B: int, Sc: int, H: int, KV: int, hd: int,
          code: int) -> Tuple[Plan, Tuple[int, int]]:
    key = (dev, B, Sc, H, KV, hd, code)
    got = _PLANS.get(key)
    if got is None:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(dev):   # the split follows this card's SM count
            _build.check(_lib().decode_attention_plan(B, Sc, H, KV, hd, code, out),
                         "decode_attention_plan")
        p = tuple(out)
        got = _PLANS[key] = (p, _sizes(B, H, KV, hd, p))
    return got


def plan(dev: torch.device, B: int, Sc: int, H: int, KV: int, hd: int,
         dtype: torch.dtype) -> Plan:
    """The library's plan for a call at these shapes on ``dev``."""
    return _plan(dev, B, Sc, H, KV, hd, _build.DTYPE_CODES[str(dtype).replace("torch.", "")])[0]


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *,
                          with_plan: Optional[Plan] = None) -> torch.Tensor:
    """q (B, H, hd), k/v (B, Sc, KV, hd), fp32 or bf16; lengths (B,) int32.
    Returns (B, H, hd) in q's dtype. ``with_plan`` replaces the library's
    plan (the kernel checks that it covers the cache): ``chip_smoke.py``
    times other splits against the library's with it, and the tests check
    that every split gives the same attention."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError("q must be (B, H, hd) and k/v (B, Sc, KV, hd)")
    B, H, hd = q.shape
    _, Sc, KV, _ = k.shape
    if hd not in (32, 64, 128) or H % KV:
        raise ValueError(f"kernel takes hd in (32, 64, 128) and H % KV == 0, "
                         f"got hd={hd}, H={H}, KV={KV}")
    dev = q.device
    code = _build.require(q, "q", ("float32", "bfloat16"))
    dt = (str(q.dtype).replace("torch.", ""),)
    _build.require(k, "k", dt, shape=(B, Sc, KV, hd), device=dev)
    _build.require(v, "v", dt, shape=(B, Sc, KV, hd), device=dev)
    _build.require(lengths, "lengths", ("int32",), shape=(B,), device=dev)
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, k and v must start on a 16-byte boundary")
    p, sizes = _plan(dev, B, Sc, H, KV, hd, code)
    if with_plan is not None:
        p, sizes = with_plan, _sizes(B, H, KV, hd, with_plan)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch, counters = _build.workspace("decode_attention", dev, stream, *sizes)
    out = torch.empty_like(q)
    fn = _build.entry("decode_attention", n_pointers=8, n_ints=9, n_floats=1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), scratch.data_ptr(),
             counters.data_ptr(), out.data_ptr(), stream, B, Sc, H, KV, hd, code, *p,
             1.0 / math.sqrt(hd))
    _build.check(err, f"decode_attention (plan {p})")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
