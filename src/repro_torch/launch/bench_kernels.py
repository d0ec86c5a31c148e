"""Kernel micro-benchmarks on the port: the twin of the reference's
``benchmarks/bench_kernels.py``, and the one description of a kernel row on
the card, which ``chip_smoke.py``'s kernel tables use too.

The reference times four calls, all in fp32, at fixed shapes (its rows):

* ``flash_attention_512``  causal flash, B=2, S=512, H=8, KV=2, hd=64;
* ``decode_attention_4k``  decode on a full cache, B=8, Sc=4,096, H=8, KV=2, hd=64;
* ``ssd_scan_512``         the SSD scan, B=2, S=512, H=8, P=32, N=32, a = -0.5 dt;
* ``prod_head_128x1024``   the fused head, B=128, d=1,024, hidden 512, K=64,
  weights x 0.05, zero biases, 65 linear edges to 8,192.

A row is a :class:`Case`, made from its tensors by one constructor per
kernel (:func:`prod_head`, :func:`flash_attention`, :func:`decode_attention`,
:func:`ssd_scan`, :func:`unembed`, :func:`rms_norm`, :func:`rope`): the call
through ``kernels/ops.py``, its plain version, a PyTorch library call that
computes the same function (the yardstick, never used by the port), the
bytes and operations of the least time the card could take, and the
tolerance, at ``tests/test_kernels.py``'s (bf16 2e-2, fp32 2e-5, SSD 2e-4,
head probs 1e-5 / 1e-6 and quantiles 1e-4 / 1e-3) unless the row has a
criterion of its own. :func:`hold` checks a row on any device and raises
where it fails; nothing falls back to the plain version. :func:`measure`
holds each row and times it on the card: eager and device time (CUDA-graph
replays) of the kernel and of the library call, the plain version's time,
the bound and its share.

:func:`run` returns µs per call of the reference's rows, as the reference's
does: on the card eager calls between CUDA events (the host's launch work
counts where it is slower than the device); with ``device="cpu"`` the plain
versions, timed with ``time.perf_counter`` (the reference times XLA on the
CPU). Inputs are drawn from a seeded numpy generator at the reference's
shapes and scales.

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels [--device cpu] [--iters 20]
"""

from __future__ import annotations

import argparse
import importlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.decode_attention import plan as decode_plan

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# timed calls of each plain version in measure (the plain scan is a loop over
# the sequence: ~0.2 s a call at the reference's shape)
PLAIN_ITERS = 3
# device-timed calls of each plan of a decode row's split sweep
SWEEP_ITERS = 50


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms of one call of ``fn``, ``iters`` eager calls between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph(fn, calls: int, warmup: int = 3):
    """A CUDA graph of ``calls`` calls of ``fn`` (after ``warmup`` eager calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def device_time_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed between CUDA events, so the host's launch work
    (Python, checks, allocation, ctypes) is left out, for a kernel and its
    library yardstick alike. ``time_ms`` times the same calls launched from
    Python; where the host is slower than the device, that is host time."""
    g = _graph(fn, iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / iters


def time_ms_cold(fn, flush, iters: int = 20):
    """(eager ms, device ms) of one call of ``fn`` with the L2 cache cold:
    ``flush`` (larger than the 50 MB L2) is written before each call, outside
    the timed events. Eager: the device is idle when the call is launched
    from Python, as a server launches the head once per batch, so the host's
    launch work counts. Device: a one-call CUDA graph is replayed instead."""
    start = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters)]
    g = _graph(fn, 1)
    for i in range(2 * iters):
        flush.add_(1)
        torch.cuda.synchronize()
        start[i].record()
        if i < iters:
            fn()
        else:
            g.replay()
        end[i].record()
    torch.cuda.synchronize()
    del g
    times = [a.elapsed_time(b) for a, b in zip(start, end)]
    return sum(times[:iters]) / iters, sum(times[iters:]) / iters


def bound(bytes_moved: float, flops: float, peak_flops: float):
    """(ms, "bytes" or "operations"): the least time of the work on the card,
    the larger of its bytes over the memory rate and its operations over
    ``peak_flops``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_scan_flops(B: int, S: int, H: int, P: int, N: int) -> float:
    """Least operations of the SSD scan (an FMA counts 2). The
    recurrence h = exp(a) h + (dt x) B^T, y = C h needs 5 P N per (row, step,
    head): a multiply and an FMA per state entry, and an FMA for y. The
    chunked form with chunk Q needs per step, counting only products on or
    below the diagonal: Q P for (C B^T o L o dt) x, Q N / H for C B^T (one
    group shared by the H heads), 2 P N for C h, 2 P N for the state update
    and P N / Q to decay h once a chunk. Elementwise terms are left out. Its
    least over Q (Q near sqrt(N): ~4.2 P N at the served widths) is below
    the recurrence's, and is what the bound counts."""
    per_step = min(q * (P + N / H) + 4 * P * N + P * N / q for q in range(1, S + 1))
    return B * S * H * min(5 * P * N, per_step)


def sdpa_backend(*args, **kwargs) -> str:
    """The backend PyTorch's SDPA picks for these inputs (its private
    ``_fused_sdp_choice``), or why that could not be read."""
    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(*args, **kwargs)).name
    except Exception as e:  # a private API: report, do not fail the run
        return f"not determined ({type(e).__name__})"


def kernel_wrappers() -> Dict[str, Callable]:
    """Each kernel of ``_build.KERNEL_SOURCES`` by name: the wrapper
    ``<name>_cuda`` of ``repro_torch.kernels.<name>``, which counts its
    launches."""
    return {n: getattr(importlib.import_module(f"repro_torch.kernels.{n}"), f"{n}_cuda")
            for n in _build.KERNEL_SOURCES}


def report_rows(rows) -> None:
    """Achieved rates (bytes and operations) and the share of the bound, of
    the eager call and of the device time, added to each row (and printed)."""
    for r in rows:
        r["rate"] = (f"{r['bytes'] / r['ms'] / 1e9:.3g} TB/s, "
                     f"{r['flops'] / r['ms'] / 1e9:.3g} TFLOP/s")
        r["device_rate"] = (f"{r['bytes'] / r['device_ms'] / 1e9:.3g} TB/s, "
                            f"{r['flops'] / r['device_ms'] / 1e9:.3g} TFLOP/s")
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["device_bound_share"] = r["bound_ms"] / r["device_ms"]
        if "cold_device_ms" in r:
            r["cold_device_bound_share"] = r["bound_ms"] / r["cold_device_ms"]
        lib = ("none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms (device "
               + ("not measured" if r["library_device_ms"] is None
                  else f"{r['library_device_ms']:.4f} ms") + ")")
        cold = (f"; L2 cold {r['cold_ms']:.4f} ms (device {r['cold_device_ms']:.4f} ms, "
                f"{100 * r['bound_ms'] / r['cold_device_ms']:.1f}% of the bound), "
                f"library {r['library_cold_ms']:.4f} ms (device "
                f"{r['library_cold_device_ms']:.4f} ms)" if "cold_ms" in r else "")
        if "fp32_bound_ms" in r:
            cold += (f"; fp32 CUDA-core bound {r['fp32_bound_ms']:.4f} ms "
                     f"({100 * r['fp32_bound_ms'] / r['device_ms']:.1f}% device)")
        print(f"kernel {r['name']:16s} {r['shape']}: max|err| {r['max_abs_err']:.3g}  "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms)  plain "
              f"{r['plain_ms']:.4f} ms  library {lib}  bound {r['bound_ms']:.4g} ms "
              f"({r['bound_by']}), {r['rate']} ({r['device_rate']} device), "
              f"{100 * r['bound_share']:.3g}% of the bound "
              f"({100 * r['device_bound_share']:.3g}% device){cold}")


def _no_notes(got, want) -> dict:
    return {}


@dataclass
class Case:
    """One kernel row: the call through ``ops`` (the kernel on the card, the
    plain version on the CPU), the plain version, the library yardstick
    (None where no PyTorch call computes the function) and what it is, the
    bytes and operations of the bound and the peak the operations are
    bounded by, and the tolerance of each output as (rtol, atol) against
    the plain version. ``criterion(got, want)`` takes the place of that
    tolerance where the row has its own: it returns what fails, or None.
    The library's first output is held within ``tols[0]`` of the plain
    version's where ``valid`` is True (None: everywhere). ``cold``: timed
    with the L2 cold too. ``notes(got, want)`` gives, on the card, what to
    add to the row and print beside it (SDPA's backend, the decode kernel's
    split plan and sweep, an error against fp64). ``row`` names a row of the
    reference's bench. Every field is set by the table that builds the row."""
    kernel: str
    shape: str
    call: Callable
    plain: Callable
    library: Optional[Callable]
    library_what: str
    nbytes: int
    flops: float
    tols: Tuple[Tuple[float, float], ...]
    peak: float = FP32_FLOPS
    criterion: Optional[Callable] = None
    valid: Optional[torch.Tensor] = None
    cold: bool = False
    notes: Callable[..., dict] = _no_notes
    row: Optional[str] = None


def _dtype(t: torch.Tensor) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "fp32"}[t.dtype]


def _tol(t: torch.Tensor) -> float:
    return 2e-2 if t.dtype == torch.bfloat16 else 2e-5


def _peak(t: torch.Tensor) -> float:
    """The bf16 products run on the tensor cores, the fp32 ones on the CUDA cores."""
    return BF16_FLOPS if t.dtype == torch.bfloat16 else FP32_FLOPS


def _label(label: str) -> str:
    return f" ({label})" if label else ""


def prod_head(phi, w1, b1, w2, b2, edges, levels, *, label: str = "", cold: bool = False,
              criterion: Optional[Callable] = None, shape: Optional[str] = None,
              row: Optional[str] = None) -> Case:
    """The fused head (fp32) at the CDF ``levels`` (a tensor on phi's
    device: a call copies nothing from the host). Yardstick: the addmm chain
    and softmax. Bound: phi, the weights, the edges and the levels read once,
    probs and quantiles written once; the two products."""
    B, d = phi.shape
    hidden, K = w2.shape
    Q = levels.numel()
    args = (phi, w1, b1, w2, b2, edges)
    return Case(
        "prod_head", shape or f"B={B} d={d} hidden={hidden} K={K} Q={Q} fp32"
        + (f", {label}" if label else ""),
        lambda: ops.prod_head(*args, qs=levels), lambda: ref.prod_head_ref(*args, qs=levels),
        lambda: torch.softmax(torch.addmm(b2, torch.relu(torch.addmm(b1, phi, w1)), w2), dim=-1),
        "addmm chain + softmax",
        4 * (B * d + d * hidden + hidden + hidden * K + 2 * K + 1 + Q + B * K + B * Q),
        2 * B * d * hidden + 2 * B * hidden * K, ((1e-5, 1e-6), (1e-4, 1e-3)),
        criterion=criterion, cold=cold, row=row)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, kv_lengths=None,
                    scale: Optional[float] = None, label: str = "",
                    row: Optional[str] = None) -> Case:
    """Flash attention, q (B, S, H, hd), k (B, Skv, KV, hd), v (B, Skv, KV,
    hd_v). Yardstick: SDPA on the same inputs with the same scale; where a
    key is masked (lengths or window) with K and V repeated to the query
    heads and the mask as an argument, and then only on the query rows that
    have a valid key (the plain version gives a row with none the
    reference's value). Bound: q and o, and k and v of each row's valid
    keys, read or written once, the lengths; 2 (hd + hd_v) operations a
    head and (query, key) pair the mask keeps. A kernel tile padded past
    the width (hd=112, 168) does more work than the bound counts."""
    B, S, H, hd = q.shape
    Skv, KV, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    qpos, kpos = torch.arange(S, device=q.device), torch.arange(Skv, device=q.device)
    allowed = kpos[None, :] <= qpos[:, None] if causal else torch.ones(
        (S, Skv), dtype=torch.bool, device=q.device)
    if window:
        allowed = allowed & (qpos[:, None] - kpos[None, :] < window)
    lens = torch.full((B,), Skv, device=q.device) if kv_lengths is None else kv_lengths
    mask = (allowed[None] & (kpos[None, None, :] < lens[:, None, None]))[:, None]
    pairs, n_keys = int(mask.sum()), int(lens.long().sum())
    empty = int((~mask.any(-1)).sum())
    qt = q.transpose(1, 2)
    given = {} if scale is None else {"scale": scale}
    if window or n_keys < B * Skv:
        kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
        sdpa = {"attn_mask": mask, **given}
    else:
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        sdpa = {"is_causal": causal, "enable_gqa": G > 1, **given}
    keys = f"Sq={S} Skv={Skv}" if Skv != S else f"S={S}"
    wide = f"hd={hd}" + (f"/{hd_v}" if hd_v != hd else "")
    which = (" ragged" if n_keys < B * Skv else
             "" if causal or kv_lengths is None else " all keys valid")
    eb = q.element_size()
    return Case(
        "flash_attention",
        f"B={B} {keys} H={H} KV={KV} {wide} {_dtype(q)} {'causal' if causal else 'non-causal'}"
        f"{which}{f' window={window}' if window else ''}"
        f"{f' scale={scale:.5f}' if scale is not None else ''}{_label(label)}",
        lambda: ops.flash_attention(q, k, v, causal=causal, window=window,
                                    kv_lengths=kv_lengths, scale=scale),
        lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        kv_lengths=kv_lengths, scale=scale),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa).transpose(1, 2),
        ", ".join(["SDPA"] + [arg for arg, on in sdpa.items() if on is not False]),
        eb * (B * S * H * (hd + hd_v) + n_keys * KV * (hd + hd_v))
        + (4 * B if kv_lengths is not None else 0),
        2 * (hd + hd_v) * H * pairs, ((_tol(q), _tol(q)),), peak=_peak(q),
        valid=mask.any(-1).transpose(1, 2)[..., None] if empty else None,
        notes=lambda got, want: {"library_backend": sdpa_backend(qt, kt, vt, **sdpa),
                                 "pairs": pairs, "query rows with no valid key": empty},
        row=row)


def _split_sweep(q, k, v, lengths, want, plan, sweep) -> List[dict]:
    """The decode kernel under the library's plan and the plans (its head
    tile, n splits of c keys) of ``sweep``: each output within one bf16 step
    of the plain version's (both round an fp32 value to bf16; give or take
    2e-6 of fp32 error near 0) and a second call bit-identical, timed warm
    and cold."""
    step = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=q.device)
    out = []
    for p in sorted({tuple(plan)} | {(plan[0], n, c) for n, c in sweep}):
        forced = lambda: decode_attention_cuda(q, k, v, lengths, with_plan=p)
        got, again = forced(), forced()
        err = float((got.float() - want.float()).abs().max())
        if not bool(((got.float() - want.float()).abs() <= step + 2e-6).all()):
            raise RuntimeError(f"decode_attention plan {p}: more than one bf16 step from the "
                               f"plain version (max|err| {err:.3g})")
        if not torch.equal(got, again):
            raise RuntimeError(f"decode_attention plan {p}: two calls differ")
        out.append({"plan": list(p), "device_ms": device_time_ms(forced, SWEEP_ITERS),
                    "cold_device_ms": time_ms_cold(forced, flush)[1], "max_abs_err": err})
    return out


def decode_attention(q, k, v, lengths, *, label: str = "", sweep: Sequence = (),
                     shape: Optional[str] = None, row: Optional[str] = None) -> Case:
    """Decode attention, q (B, H, hd) against a cache k, v (B, Sc, KV, hd)
    of ``lengths`` valid keys. Yardstick: SDPA on the cache as the kernel
    takes it (K/V heads transposed as views, enable_gqa; the mask where a key
    is masked). bf16 rows are timed with the L2 cold too, as the serve path
    meets a layer's cache a whole step after its last read. On the card the
    library's split plan is printed, and with ``sweep`` the plans it names
    (:func:`_split_sweep`). Bound: q and o once, k and v of the valid keys
    once, the lengths; 4 hd operations a head and key."""
    B, H, hd = q.shape
    Sc, KV = k.shape[1], k.shape[2]
    n_keys = int(lengths.long().sum())
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = ((torch.arange(Sc, device=q.device)[None, :] < lengths[:, None])[:, None, None]
            if n_keys < B * Sc else None)

    def notes(got, want):
        plan = list(decode_plan(q.device, B, Sc, H, KV, hd, q.dtype))
        out = {"library_backend": sdpa_backend(qt, kt, vt, mask, enable_gqa=True),
               "plan": plan, "blocks": plan[1] * B * KV * -(-(H // KV) // plan[0])}
        if sweep:
            out["split_sweep"] = _split_sweep(q, k, v, lengths, want[0], plan, sweep)
        return out

    eb = q.element_size()
    return Case(
        "decode_attention", shape or f"B={B} Sc={Sc} H={H} KV={KV} hd={hd} {_dtype(q)} "
        f"{'ragged' if mask is not None else 'all keys valid'}{_label(label)}",
        lambda: ops.decode_attention(q, k, v, lengths),
        lambda: ref.decode_attention_ref(q, k, v, lengths),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True)[:, :, 0],
        "SDPA on the cache, enable_gqa" + (", mask" if mask is not None else ""),
        eb * (2 * B * H * hd + 2 * n_keys * KV * hd) + 4 * B, 4 * hd * H * n_keys,
        ((_tol(q), _tol(q)),), peak=_peak(q), cold=q.dtype == torch.bfloat16, notes=notes,
        row=row)


def ssd_scan(x, dt, a, Bm, Cm, *, label: str = "", row: Optional[str] = None) -> Case:
    """The SSD scan, x (B, S, H, P), dt and a (B, S, H) fp32, Bm and Cm (B,
    S, N): y within 2e-2 (bf16) or 2e-4 (fp32), the fp32 state h within
    2e-4 (the reference's SSD tolerance: chunked decays exp(cum_i - cum_j)
    against the recurrence's product of exp(a_t)). No single PyTorch call
    computes the scan. Bound: x, dt, a, Bm, Cm read once, y and h written
    once; :func:`ssd_scan_flops`; a bf16 row also gives the same work's bound
    at the fp32 CUDA-core peak (``fp32_bound_ms``)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    bf = x.dtype == torch.bfloat16
    nbytes = x.element_size() * 2 * (B * S * H * P + B * S * N) + 4 * (2 * B * S * H + B * H * P * N)
    flops = ssd_scan_flops(B, S, H, P, N)

    def notes(got, want):
        (y, h), (y_ref, h_ref) = got, want
        top = float(y_ref.float().abs().max())
        return {"y max|err|": float((y.float() - y_ref.float()).abs().max()), "max|y|": top,
                "bf16 step at max|y|": 2.0 ** (int(np.floor(np.log2(top))) - 7),
                "h max|err|": float((h - h_ref).abs().max()), "max|h|": float(h_ref.abs().max()),
                "decay over a 64-step chunk, median": float(a[:, :64].sum(1).exp().median()),
                **({"fp32_bound_ms": bound(nbytes, flops, FP32_FLOPS)[0]} if bf else {})}

    return Case(
        "ssd_scan", f"B={B} S={S} H={H} P={P} N={N} {_dtype(x)}" + (f" {label}" if label else ""),
        lambda: ops.ssd_scan(x, dt, a, Bm, Cm), lambda: ref.ssd_scan_ref(x, dt, a, Bm, Cm),
        None, "none: no single PyTorch call computes the scan", nbytes, flops,
        ((2e-2 if bf else 2e-4,) * 2, (2e-4, 2e-4)), peak=_peak(x), notes=notes, row=row)


def unembed(x, w, *, label: str = "", row: Optional[str] = None) -> Case:
    """The unembed, bf16 x (M, d) @ w (d, V) (a tied table seen as
    ``embed.T``) to fp32 logits: within 1e-5 of the logits' largest
    magnitude of the fp32 product ``ref.unembed_ref`` (the two sum the same
    exact products in another order and rounding, about 1e-6 of it apart; a
    64-term stage lost or a column misplaced moves the logits by a tenth of
    it). On the card both are printed against an fp64 product of the same
    values. Yardstick: cuBLAS's bf16 GEMM with an fp32 output, within 1e-3.
    Bound: x and w read once, the logits written once, the product at the
    bf16 peak."""
    M, d = x.shape
    V = w.shape[1]

    def criterion(got, want):
        err, top = float((got[0] - want[0]).abs().max()), float(want[0].abs().max())
        if err > 1e-5 * top:
            return f"max err {err} at max|logit| {top}"
        return None

    def notes(got, want):
        exact = x.double() @ w.double()
        err64, plain64 = (float((t.double() - exact).abs().max()) for t in (got[0], want[0]))
        return {"max|logit|": float(want[0].abs().max()), "against fp64": err64,
                "fp32 product against fp64": plain64, "ratio": err64 / plain64}

    return Case(
        "unembed", f"M={M} d={d} V={V} {'untied' if w.is_contiguous() else 'tied'}{_label(label)}",
        lambda: ops.unembed(x, w), lambda: ref.unembed_ref(x, w),
        lambda: torch.mm(x, w, out_dtype=torch.float32), "cuBLAS bf16 GEMM, fp32 output",
        2 * (M * d + d * V) + 4 * M * V, 2 * M * d * V, ((1e-3, 1e-3),), peak=BF16_FLOPS,
        criterion=criterion, notes=notes, row=row)


def _bf16_steps(got, want):
    """(share bit-identical, most bf16 steps apart) of the first outputs."""
    steps = (got[0].view(torch.int16).int() - want[0].view(torch.int16).int()).abs()
    return float((steps == 0).double().mean()), int(steps.max())


def _one_bf16_step(got, want):
    """Every element within one bf16 step of the plain version's and at
    least 99% bit-identical (``tests/test_torch_norm_rope.py``)."""
    same, most = _bf16_steps(got, want)
    if most > 1 or same < 0.99:
        return f"{same:.4f} bit-identical, max {most} steps"
    return None


def _steps_notes(got, want) -> dict:
    same, most = _bf16_steps(got, want)
    return {"bit-identical %": 100 * same, "max bf16 steps": most}


def rms_norm(x, scale, eps: float, *, shape: str, row: Optional[str] = None) -> Case:
    """RMSNorm of bf16 rows (a view read in place) with the gain 1 + scale:
    :func:`_one_bf16_step`. Yardstick: ``F.rms_norm`` with that gain, within
    bf16's 2e-2. Bound: x read and the output written once, the scale."""
    d = x.shape[-1]
    gain = 1.0 + scale
    return Case(
        "rms_norm", shape, lambda: ops.rms_norm(x, scale, eps),
        lambda: ref.rms_norm_ref(x, scale, eps), lambda: F.rms_norm(x, (d,), gain, eps),
        "F.rms_norm, gain 1 + scale", x.element_size() * (2 * x.numel() + d), 0,
        ((2e-2, 2e-2),), peak=BF16_FLOPS, criterion=_one_bf16_step, notes=_steps_notes, row=row)


def rope(x, angles, *, label: str = "", row: Optional[str] = None) -> Case:
    """RoPE's rotation of bf16 x (B, S, H, hd) (a view read in place) by
    angles (B, S, hd / 2): :func:`_one_bf16_step`. No single PyTorch call
    rotates. Bound: x read and written once, the angles once a token."""
    B, S, H, hd = x.shape
    stored = x.stride(1) // H
    return Case(
        "rope", f"B={B} S={S} H={H} hd={hd}" + (f" of {stored}" if stored != hd else "")
        + _label(label), lambda: ops.rope(x, angles), lambda: ref.rope_ref(x, angles),
        None, "none: no single PyTorch call rotates",
        2 * x.element_size() * x.numel() + 4 * angles.numel(), 0, ((2e-2, 2e-2),),
        peak=BF16_FLOPS, criterion=_one_bf16_step, notes=_steps_notes, row=row)


def inputs(seed: int = 0) -> Dict[str, tuple]:
    """The reference's four inputs as numpy arrays (fp32; lengths int32),
    from one seeded generator, at its shapes and scales."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    B, S, H, KV, hd = 2, 512, 8, 2, 64
    flash = (f32(B, S, H, hd), f32(B, S, KV, hd), f32(B, S, KV, hd))
    Sc = 4096
    decode = (f32(8, H, hd), f32(8, Sc, KV, hd), f32(8, Sc, KV, hd),
              np.full((8,), Sc, np.int32))
    x = f32(2, 512, 8, 32)
    dt = np.log1p(np.exp(f32(2, 512, 8).astype(np.float64))).astype(np.float32)
    scan = (x, dt, (-0.5 * dt).astype(np.float32), f32(2, 512, 32), f32(2, 512, 32))
    phi = f32(128, 1024)
    w1 = (f32(1024, 512) * np.float32(0.05))
    w2 = (f32(512, 64) * np.float32(0.05))
    head = (phi, w1, np.zeros(512, np.float32), w2, np.zeros(64, np.float32),
            np.linspace(0.0, 8192.0, 65).astype(np.float32))
    return {"flash_attention_512": flash, "decode_attention_4k": decode,
            "ssd_scan_512": scan, "prod_head_128x1024": head}


def cases(device: DeviceLike = None, seed: int = 0) -> List[Case]:
    """The four rows on ``device`` (``cuda`` unless the CPU is asked for)."""
    dev = resolve_device(device)
    t = {k: [torch.from_numpy(a).to(dev) for a in v] for k, v in inputs(seed).items()}
    # the median as the one quantile level, made on the device once: a call
    # then copies nothing from the host and can be captured in a CUDA graph
    level = torch.full((1,), 0.5, device=dev)
    return [flash_attention(*t["flash_attention_512"], causal=True, row="flash_attention_512"),
            decode_attention(*t["decode_attention_4k"], row="decode_attention_4k",
                             shape="B=8 Sc=4096 H=8 KV=2 hd=64 fp32 full cache"),
            ssd_scan(*t["ssd_scan_512"], label="a=-0.5dt", row="ssd_scan_512"),
            prod_head(*t["prod_head_128x1024"], level, row="prod_head_128x1024",
                      shape="B=128 d=1024 hidden=512 K=64 median fp32")]


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _time_cpu_us(fn, iters: int) -> float:
    fn()                                  # warm up
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def run(device: DeviceLike = None, iters: int = 20, verbose: bool = True) -> Dict[str, float]:
    """µs per call of the reference's four rows: the kernels on the card
    (eager, CUDA events), the plain versions on the CPU (``time.perf_counter``)."""
    dev = resolve_device(device)
    rows = {}
    for c in cases(dev):
        rows[c.row] = (time_ms(c.call, iters=iters) * 1e3 if dev.type == "cuda"
                       else _time_cpu_us(c.call, iters))
    if verbose:
        for name, us in rows.items():
            print(f"  {name:24s} {us:10.1f} us/call")
    return rows


def _max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def hold(c: Case):
    """The row's check, on any device; raises where it fails. Two calls
    and the plain version: each output of the plain version's shape and
    dtype, and within ``tols`` of it (or the row's ``criterion``); the
    second call bit-identical; on the card, two launches of the kernel for
    the two calls (nothing fell back); the library yardstick's first output
    within ``tols[0]`` of the plain version's. Returns (got, want)."""
    def fail(what):
        raise RuntimeError(f"{c.kernel} {c.shape}: {what}")

    wrapper = kernel_wrappers()[c.kernel]
    n0 = wrapper.launches
    got, again = _outputs(c.call()), _outputs(c.call())
    launches = wrapper.launches - n0
    want = _outputs(c.plain())
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"output {i} is {g.dtype} {tuple(g.shape)}, the plain version's "
                 f"{w.dtype} {tuple(w.shape)}")
    if c.criterion is not None:
        why = c.criterion(got, want)
        if why:
            fail(why)
    else:
        for i, ((rtol, atol), g, w) in enumerate(zip(c.tols, got, want)):
            if not torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol):
                fail(f"output {i} off its plain version by {_max_err((g,), (w,)):.3g} "
                     f"(rtol {rtol}, atol {atol})")
    if not all(torch.equal(g, h) for g, h in zip(got, again)):
        fail("two calls differ")
    if got[0].is_cuda and launches != 2:
        fail(f"{launches} launches of the kernel for two calls")
    if c.library is not None:
        lib, w = _outputs(c.library())[0].float(), want[0].float()
        if c.valid is not None:
            keep = c.valid.expand_as(w)
            lib, w = lib[keep], w[keep]
        rtol, atol = c.tols[0]
        if not torch.allclose(lib, w, rtol=rtol, atol=atol):
            fail(f"the library yardstick disagrees with the plain version by "
                 f"{_max_err((lib,), (w,)):.3g} (rtol {rtol}, atol {atol})")
    return got, want


def measure(cases: Iterable[Case], iters: int = 20) -> List[dict]:
    """Each row held (:func:`hold`) and timed on the card, in
    ``chip_smoke.py``'s keys (ms): eager and device ms of the kernel and of
    the library yardstick (and with the L2 cold where the row asks), the
    plain version's ms (``PLAIN_ITERS`` calls), the bound and its share, the
    achieved rates (:func:`report_rows`) and the row's notes."""
    rows, flush = [], None
    for c in cases:
        got, want = hold(c)
        if not got[0].is_cuda:
            raise ValueError("measure times the CUDA kernels; on the CPU use run(device='cpu')")
        b_ms, b_by = bound(c.nbytes, c.flops, c.peak)
        row = {"name": c.kernel, "row": c.row, "shape": c.shape,
               "max_abs_err": _max_err(got, want),
               "ms": time_ms(c.call, iters=iters), "device_ms": device_time_ms(c.call, iters),
               "plain_ms": time_ms(c.plain, iters=PLAIN_ITERS, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": c.nbytes, "flops": c.flops,
               "library": c.library_what, "library_ms": None, "library_device_ms": None}
        if c.library is not None:
            row["library_ms"] = time_ms(c.library, iters=iters)
            row["library_device_ms"] = device_time_ms(c.library, iters)
        if c.cold:
            if flush is None:
                flush = torch.empty(64 << 20, dtype=torch.uint8, device=got[0].device)
            row["cold_ms"], row["cold_device_ms"] = time_ms_cold(c.call, flush)
            row["library_cold_ms"], row["library_cold_device_ms"] = time_ms_cold(c.library, flush)
        n_fixed = len(row)
        row.update(c.notes(got, want))
        if len(row) > n_fixed:
            print(f"{c.kernel} {c.shape}: " + "; ".join(
                f"{k} {row[k]}" for k in list(row)[n_fixed:]))
        rows.append(row)
    report_rows(rows)
    print(f"{len(rows)} kernel rows held")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(dev, iters=args.iters)
    if dev.type == "cuda":
        measure(cases(dev), iters=args.iters)
    return out


if __name__ == "__main__":
    main()
