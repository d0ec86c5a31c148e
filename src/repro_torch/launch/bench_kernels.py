"""Kernel micro-benchmarks on the port: the twin of the reference's
``benchmarks/bench_kernels.py``, with the timing and bound helpers that
``chip_smoke.py`` shares.

The reference times four calls, all in fp32, at fixed shapes (its rows):

* ``flash_attention_512``  causal flash, B=2, S=512, H=8, KV=2, hd=64;
* ``decode_attention_4k``  decode on a full cache, B=8, Sc=4,096, H=8, KV=2, hd=64;
* ``ssd_scan_512``         the SSD scan, B=2, S=512, H=8, P=32, N=32, a = -0.5 dt;
* ``prod_head_128x1024``   the fused head, B=128, d=1,024, hidden 512, K=64,
  weights x 0.05, zero biases, 65 linear edges to 8,192.

:func:`run` returns µs per call of each row, as the reference's does: on the
card eager calls through ``kernels/ops.py`` between CUDA events (the host's
launch work counts where it is slower than the device); with ``device="cpu"``
the plain versions, timed with ``time.perf_counter`` (the reference times XLA
on the CPU). :func:`measure` returns the full rows on the card: eager and
device time (CUDA-graph replays), the least time the card could take and what
bounds it, the plain version's time, a PyTorch library call's time where one
computes the same function, and each kernel's error against its plain
version, at ``tests/test_kernels.py``'s tolerances (fp32 2e-5, SSD 2e-4, head
probs 1e-5 / 1e-6 and median 1e-4 / 1e-3), with a second call bit-identical.
A failure raises; nothing falls back to the plain version. Inputs are drawn
from a seeded numpy generator at the reference's shapes and scales.

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels [--device cpu] [--iters 20]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import plan as decode_plan

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# timed calls of each plain version in measure (the plain scan is a loop over
# the sequence: ~0.2 s a call at the reference's shape)
PLAIN_ITERS = 3


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


@dataclass
class Case:
    """One row of the reference's bench on ``device``: the call through
    ``ops`` (the kernel on the card, the plain version on the CPU), the plain
    version, the library yardstick (None where no PyTorch call computes the
    function), the bytes and operations of the bound and the tolerance of
    each output as (rtol, atol). ``notes`` gives, on the card, what to print
    beside the row: SDPA's backend, the decode kernel's split plan."""
    row: str
    kernel: str
    shape: str
    call: Callable
    plain: Callable
    library: Optional[Callable]
    library_what: str
    nbytes: int
    flops: float
    tols: Tuple[Tuple[float, float], ...]
    notes: Callable[[], dict] = dict


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
    fp32 = ((2e-5, 2e-5),)

    q, k, v = t["flash_attention_512"]
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    flash = Case(
        "flash_attention_512", "flash_attention", f"B={B} S={S} H={H} KV={KV} hd={hd} fp32 causal",
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True).transpose(1, 2),
        "SDPA, is_causal, enable_gqa",
        4 * (2 * B * S * H * hd + 2 * B * S * KV * hd), 4 * hd * H * B * S * (S + 1) // 2, fp32,
        lambda: {"library_backend": sdpa_backend(qt, kt, vt, None, 0.0, True, enable_gqa=True)})

    qd, kc, vc, lens = t["decode_attention_4k"]
    Bd, Sc = kc.shape[:2]
    qdt, kct, vct = qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    n_keys = int(lens.long().sum())
    decode = Case(
        "decode_attention_4k", "decode_attention",
        f"B={Bd} Sc={Sc} H={H} KV={KV} hd={hd} fp32 full cache",
        lambda: ops.decode_attention(qd, kc, vc, lens),
        lambda: ref.decode_attention_ref(qd, kc, vc, lens),
        lambda: F.scaled_dot_product_attention(qdt, kct, vct, enable_gqa=True)[:, :, 0],
        "SDPA on the full cache, enable_gqa",
        4 * (2 * Bd * H * hd + 2 * n_keys * KV * hd) + 4 * Bd, 4 * hd * H * n_keys, fp32,
        lambda: {"library_backend": sdpa_backend(qdt, kct, vct, enable_gqa=True),
                 "plan": list(decode_plan(dev, Bd, Sc, H, KV, hd, qd.dtype))})

    x, dt, a, Bm, Cm = t["ssd_scan_512"]
    Bs, Ss, Hs, P = x.shape
    N = Bm.shape[-1]
    scan = Case(
        "ssd_scan_512", "ssd_scan", f"B={Bs} S={Ss} H={Hs} P={P} N={N} fp32 a=-0.5dt",
        lambda: ops.ssd_scan(x, dt, a, Bm, Cm),
        lambda: ref.ssd_scan_ref(x, dt, a, Bm, Cm),
        None, "none: no single PyTorch call computes the scan",
        4 * (2 * Bs * Ss * Hs * P + 2 * Bs * Ss * Hs + 2 * Bs * Ss * N + Bs * Hs * P * N),
        ssd_scan_flops(Bs, Ss, Hs, P, N), ((2e-4, 2e-4), (2e-4, 2e-4)))

    phi, w1, b1, w2, b2, edges = t["prod_head_128x1024"]
    Bh, d = phi.shape
    hidden, K = w2.shape
    # the median as the one quantile level, made on the device once: a call
    # then copies nothing from the host and can be captured in a CUDA graph
    level = torch.full((1,), 0.5, device=dev)
    head = Case(
        "prod_head_128x1024", "prod_head", f"B={Bh} d={d} hidden={hidden} K={K} median fp32",
        lambda: ops.prod_head(phi, w1, b1, w2, b2, edges, qs=level),
        lambda: ref.prod_head_ref(phi, w1, b1, w2, b2, edges, qs=level),
        lambda: torch.softmax(torch.addmm(b2, torch.relu(torch.addmm(b1, phi, w1)), w2), dim=-1),
        "addmm chain + softmax",
        4 * (Bh * d + d * hidden + hidden + hidden * K + K + K + 1 + 1 + Bh * K + Bh),
        2 * Bh * d * hidden + 2 * Bh * hidden * K, ((1e-5, 1e-6), (1e-4, 1e-3)))
    return [flash, decode, scan, head]


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


def measure(device: DeviceLike = None, iters: int = 20) -> List[dict]:
    """The full rows on the card, in ``chip_smoke.py``'s keys (ms): each
    kernel against its plain version (raises outside the tolerance, or when a
    second call differs), eager and device ms of the kernel and of the
    library yardstick, the plain version's ms (``PLAIN_ITERS`` calls), the
    bound and its share, the achieved rates (:func:`report_rows`)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure times the CUDA kernels; on the CPU use run(device='cpu')")
    rows = []
    for c in cases(dev):
        got, again = _outputs(c.call()), _outputs(c.call())
        want = _outputs(c.plain())
        torch.cuda.synchronize()
        for i, ((rtol, atol), g, w) in enumerate(zip(c.tols, got, want)):
            if not torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol):
                raise RuntimeError(f"{c.row}: output {i} off its plain version by "
                                   f"{_max_err((g,), (w,)):.3g} (rtol {rtol}, atol {atol})")
        if not all(torch.equal(g, h) for g, h in zip(got, again)):
            raise RuntimeError(f"{c.row}: two calls differ")
        # fp32 inputs: every product runs on the CUDA cores
        b_ms, b_by = bound(c.nbytes, c.flops, FP32_FLOPS)
        row = {"name": c.kernel, "row": c.row, "shape": c.shape,
               "max_abs_err": _max_err(got, want),
               "ms": time_ms(c.call, iters=iters), "device_ms": device_time_ms(c.call, iters),
               "plain_ms": time_ms(c.plain, iters=PLAIN_ITERS, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": c.nbytes, "flops": c.flops,
               "library": c.library_what, "library_ms": None, "library_device_ms": None}
        if c.library is not None:
            lib = _outputs(c.library())
            # a sanity check that the yardstick computes the same function
            if not torch.allclose(lib[0], want[0], rtol=1e-3, atol=1e-3):
                raise RuntimeError(f"{c.row}: the library yardstick disagrees with the plain "
                                   f"version by {_max_err(lib[:1], want[:1]):.3g}")
            row["library_ms"] = time_ms(c.library, iters=iters)
            row["library_device_ms"] = device_time_ms(c.library, iters)
        n_fixed = len(row)
        row.update(c.notes())
        if len(row) > n_fixed:
            print(f"{c.kernel} {c.shape}: " + "; ".join(
                f"{k} {row[k]}" for k in list(row)[n_fixed:]))
        rows.append(row)
    report_rows(rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(dev, iters=args.iters)
    if dev.type == "cuda":
        measure(dev, iters=args.iters)
    return out


if __name__ == "__main__":
    main()
