"""Chunked SSD scan on Hopper: wrapper of ``csrc/ssd_scan.cu``.

Replaces ``ssd_scan_pallas`` (``src/repro/kernels/ssd_scan.py:61``): Mamba2's
prefill scan, y = intra-chunk (C·Bᵀ ∘ L ∘ dt)·x + C·exp(cum)·h with the state h
carried across chunks, all in fp32. The TPU kernel carries h for every head in
VMEM along its sequential chunk axis; here one block owns one (head, batch
row), loops over chunks of 64 steps and keeps its head's P x N state in shared
memory, so nothing crosses blocks. The chunk length is the kernel's own and a
ragged last chunk is masked inside it. Bound by operations at the serving
shapes (Zamba2: the chunked form's least 4.6 GFLOP of fp32, ~0.068 ms,
against ~79 MB of traffic, ~0.023 ms). The (P, N) pairs it takes are
instantiated in ``csrc/ssd_scan.cu``; any other pair is refused there, and
the refusal raises here.

``ssd_scan_cuda.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor):
    """x (B, S, H, P) fp32 or bf16; dt and a (B, S, H) fp32; Bm and Cm
    (B, S, N) in x's dtype. Returns (y (B, S, H, P) in x's dtype, h
    (B, H, P, N) fp32)."""
    if x.ndim != 4 or Bm.ndim != 3:
        raise ValueError("x must be (B, S, H, P) and Bm/Cm (B, S, N)")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    dev = x.device
    code = _build.require(x, "x", ("float32", "bfloat16"))
    xdt = (str(x.dtype).replace("torch.", ""),)
    for name, t in (("dt", dt), ("a", a)):
        _build.require(t, name, ("float32",), shape=(B, S, H), device=dev)
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        _build.require(t, name, xdt, shape=(B, S, N), device=dev)
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    fn = _build.entry("ssd_scan", n_pointers=8, n_ints=6)
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             y.data_ptr(), h.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
             B, S, H, P, N, code)
    _build.check(err, f"ssd_scan (P={P}, N={N})")
    ssd_scan_cuda.launches += 1
    return y, h


ssd_scan_cuda.launches = 0
