"""Chunked SSD scan on Hopper: wrapper of ``csrc/ssd_scan.cu``.

Replaces ``ssd_scan_pallas`` (``src/repro/kernels/ssd_scan.py:61``): Mamba2's
prefill scan, y = intra-chunk (C·Bᵀ ∘ L ∘ dt)·x + C·exp(cum)·h with the state h
carried across chunks. The TPU kernel carries h for every head in VMEM along
its sequential chunk axis; here one block owns one (head, batch row), loops
over chunks of 64 steps and keeps its head's P x N state on chip, so nothing
crosses blocks. In bf16 (the served models) every product runs on the tensor
cores, the fp32 operands split into a bf16 high and low part, and each block
computes the C·Bᵀ its heads share itself (a first pass that shared it
measured slower; see the source's header). fp32 inputs keep the first
version's CUDA-core kernel. Bound by bytes at the serving shapes (Zamba2:
~79 MB, ~0.0235 ms at 3.35 TB/s). The chunk length is the kernel's own and a
ragged last chunk is masked inside it. The (P, N) pairs it takes are
instantiated in ``csrc/ssd_scan.cu`` (``by_widths``): the served widths
(64, 64) and (64, 128) in both dtypes, and (32, 32), the reference's kernel
bench shape, in fp32 only (the tensor-core kernel takes P = 64 alone). Any
other pair or dtype is refused there, and the refusal raises here.

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
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    fn = _build.entry("ssd_scan", n_pointers=8, n_ints=6)
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             y.data_ptr(), h.data_ptr(), stream, B, S, H, P, N, code)
    _build.check(err, f"ssd_scan (P={P}, N={N})")
    ssd_scan_cuda.launches += 1
    return y, h


ssd_scan_cuda.launches = 0
