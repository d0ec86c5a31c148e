#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU (Hopper: the
kernels are built for sm_90a). Phases, in order; any failure raises and the
script exits non-zero without its result line:

1. device: the card's name, and its name and power limit from ``nvidia-smi``;
2. build: ``nvcc`` builds every kernel of ``src/repro_torch/kernels/csrc``, in
   parallel, timed;
3. kernels: each CUDA kernel against its plain PyTorch version at the serving
   shapes, with the stated tolerance, timed beside the plain version, one
   PyTorch library call as a yardstick where one computes the same function
   (timed only, never used by the port) and the least time the card could
   take (``bound_ms``), with the achieved rate and its share of the bound.
   ``ms`` and ``library_ms`` are eager calls from Python, as the serve path
   makes them (``time_ms``: the host's launch work counts where it is slower
   than the device); ``device_ms`` and ``library_device_ms`` leave the host
   out (the calls replayed from a CUDA graph, ``device_time_ms``). The head
   at B=8, d=4096 and the decode attention (with SDPA on the cache as the
   kernel takes it as its yardstick) are also timed with the L2 cache cold
   (``cold_ms``, both ways). The decode attention's split plan is printed,
   and its device time under other splits (``split_sweep``: the library's
   plan against the others, each output held within one bf16 step of the
   plain version's); the fp32 scan with no decay is held against an fp64
   recurrence, beside the plain version's error there;
4. serve, once per model, each at full width and depth with seeded random
   weights, through ``RealEngine.repeated_sampling`` on 8 ragged prompts
   (256-512 tokens right-padded to 512, max_new=64), ProD-D targets,
   ``train_predictor`` on φ and median / q0.9 predictions through the fused
   head:
   - Llama-3-8B (32 layers, d=4096, bf16), r=4: flash, decode and head;
   - Zamba2-1.2B (38 Mamba2 layers + the shared attention block 6 times,
     d=2048, bf16), r=4: all four kernels;
   - Mamba2-130M (24 layers, d=768, bf16), r=2: scan and head.
   The launch counts are set to 0 before each model's run and read after it;
   each kernel the model's path runs must have risen. The head kernel is then
   held against its plain version on the trained weights and the served phi
   (and, after Llama, its disagreement is printed against the logit scale);
   one prefill and one decode step are timed and profiled;
5. table1: the paper's Table 1, fast profile (8 Track-A settings x 7
   methods), every head trained on the card; its claims must equal the
   reference's, and prod_head is the one kernel launched (32 times);
6. sim: ``--mode sim`` with the reference's defaults (a ProD-D head, 200
   requests through ``SimEngine`` under four policies): every request
   completes, prod_head is launched once per policy run, and ProD-driven SJF
   beats both FCFS rows on mean latency;
7. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


def _graph(torch, fn, calls: int, warmup: int = 3):
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


def device_time_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed between CUDA events, so the host's launch work
    (Python, checks, allocation, ctypes) is left out, for a kernel and its
    library yardstick alike. ``time_ms`` times the same calls launched from
    Python; where the host is slower than the device, that is host time."""
    g = _graph(torch, fn, iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / iters


def time_ms_cold(torch, fn, flush, iters: int = 20):
    """(eager ms, device ms) of one call of ``fn`` with the L2 cache cold:
    ``flush`` (larger than the 50 MB L2) is written before each call, outside
    the timed events. Eager: the device is idle when the call is launched
    from Python, as a server launches the head once per batch, so the host's
    launch work counts. Device: a one-call CUDA graph is replayed instead."""
    start = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters)]
    g = _graph(torch, fn, 1)
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


def ssd_fp64(torch, x, dt, a, Bm, Cm):
    """y of the SSD recurrence in fp64, step by step: the exact answer the
    fp32 kernel and the plain version approximate."""
    x, dt, a, Bm, Cm = (t.double() for t in (x, dt, a, Bm, Cm))
    h = torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1], dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(a[:, t])[:, :, None, None] * h + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1)


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_checks(torch, ref, kernels):
    """Phase 3: every kernel against its plain version at the serving shapes."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # --- prod_head: hidden=512, K=64, Q=3, fp32 (phi reaches the head as
    # fp32) at the served widths d = 4096 (Llama), 2048 (Zamba2) and 768
    # (Mamba2) with B=8, at d=4096 with B=512, and at the Track-A width d=64
    # with the batches of the sim phase (200) and Table 1 (350 test, 700
    # train); tolerance:
    # tests/test_kernels.py's prod_head tolerance (probs rtol 1e-5/atol 1e-6,
    # quantiles rtol 1e-4/atol 1e-3) — the kernel sums in another order than
    # cuBLAS' fp32 product. At B=8, d=4096 the head is also timed with W1
    # cold, as a server meets it once per batch: a 64 MB buffer (more than
    # the 50 MB L2) is written between launches, outside the timed events.
    hidden, K = 512, 64
    qs = torch.tensor([0.5, 0.9, 0.99], device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for B, d in ((8, 4096), (8, 2048), (8, 768), (512, 4096), (200, 64), (350, 64), (700, 64)):
        w1 = torch.randn(d, hidden, generator=g, device=dev) / d ** 0.5
        b1 = torch.randn(hidden, generator=g, device=dev) * 0.01
        w2 = torch.randn(hidden, K, generator=g, device=dev) / hidden ** 0.5
        b2 = torch.zeros(K, device=dev)
        edges = torch.linspace(0.0, 600.0, K + 1, device=dev)
        phi = torch.randn(B, d, generator=g, device=dev)
        args = (phi, w1, b1, w2, b2, edges)
        probs, quants = kernels["prod_head"](*args, qs)
        again = kernels["prod_head"](*args, qs)
        p_ref, q_ref = ref.prod_head_ref(*args, qs=qs)
        torch.cuda.synchronize()
        check(torch.allclose(probs, p_ref, rtol=1e-5, atol=1e-6),
              f"prod_head probs B={B} d={d}: max err {max_err(torch, probs, p_ref)}")
        check(torch.allclose(quants, q_ref, rtol=1e-4, atol=1e-3),
              f"prod_head quantiles B={B} d={d}: max err {max_err(torch, quants, q_ref)}")
        check(torch.equal(probs, again[0]) and torch.equal(quants, again[1]),
              f"prod_head B={B} d={d}: two calls differ")
        call = lambda: kernels["prod_head"](*args, qs)
        chain = lambda: torch.softmax(
            torch.addmm(b2, torch.relu(torch.addmm(b1, phi, w1)), w2), dim=-1)
        ms, dev_ms = time_ms(torch, call), device_time_ms(torch, call)
        plain_ms = time_ms(torch, lambda: ref.prod_head_ref(*args, qs=qs))
        lib_ms, lib_dev_ms = time_ms(torch, chain), device_time_ms(torch, chain)
        nbytes = 4 * (B * d + d * hidden + hidden + hidden * K + K + K + 1 + 3
                      + B * K + B * 3)
        flops = 2 * B * d * hidden + 2 * B * hidden * K
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        row = {"name": "prod_head", "shape": f"B={B} d={d} hidden={hidden} K={K} Q=3 fp32",
               "max_abs_err": max(max_err(torch, probs, p_ref), max_err(torch, quants, q_ref)),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, "bytes": nbytes, "flops": flops,
               "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
        if (B, d) == (8, 4096):
            row["cold_ms"], row["cold_device_ms"] = time_ms_cold(torch, call, flush)
            row["library_cold_ms"], row["library_cold_device_ms"] = time_ms_cold(
                torch, chain, flush)
        rows.append(row)
    del flush

    # --- flash attention at the two prefill shapes of the served models:
    # Llama-3-8B (H=32, KV=8, hd=128) and Zamba2-1.2B's shared block (H=32,
    # KV=32, hd=64, window 8192); B=8, S=512, bf16, causal, ragged key
    # lengths; tolerance bf16 2e-2 (tests/test_kernels.py): both sides
    # compute in fp32 and round the output to bf16 once.
    bf = torch.bfloat16
    B, S = 8, 512
    lens = torch.tensor([512, 300, 257, 480, 399, 511, 266, 448], dtype=torch.int32, device=dev)
    for H, KV, hd, window in ((32, 8, 128, 0), (32, 32, 64, 8192)):
        q = torch.randn(B, S, H, hd, generator=g, device=dev).to(bf)
        k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(bf)
        v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(bf)
        call = lambda: kernels["flash_attention"](q, k, v, causal=True, window=window,
                                                  kv_lengths=lens)
        out = call()
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window, kv_lengths=lens)
        torch.cuda.synchronize()
        check(torch.allclose(out.float(), want.float(), rtol=2e-2, atol=2e-2),
              f"flash_attention hd={hd}: max err {max_err(torch, out, want)}")
        ms, dev_ms = time_ms(torch, call), device_time_ms(torch, call)
        plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=True, window=window, kv_lengths=lens), iters=5)
        G = H // KV
        qt, kt, vt = (q.transpose(1, 2), k.repeat_interleave(G, dim=2).transpose(1, 2),
                      v.repeat_interleave(G, dim=2).transpose(1, 2))
        pos = torch.arange(S, device=dev)
        allowed = pos[None, :] <= pos[:, None]
        if window:
            allowed = allowed & (pos[:, None] - pos[None, :] < window)
        mask = (allowed[None] & (pos[None, None, :] < lens[:, None, None]))[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_ms, lib_dev_ms = time_ms(torch, sdpa), device_time_ms(torch, sdpa)
        pairs = int(mask.sum())               # (query, key) pairs this run computes
        nbytes = 2 * (2 * B * S * H * hd + 2 * int(lens.long().sum()) * KV * hd) + 4 * B
        flops = 4 * hd * H * pairs
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        rows.append({"name": "flash_attention",
                     "shape": f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal ragged"
                              + (f" window={window}" if window else ""),
                     "max_abs_err": max_err(torch, out, want), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "bytes": nbytes, "flops": flops,
                     "device_ms": dev_ms, "library_device_ms": lib_dev_ms})

    # --- decode attention at the two decode shapes: B=8, Sc=576, ragged
    # lengths, bf16, Llama-3-8B's heads and Zamba2's; tolerance 2e-2. The
    # yardstick is SDPA on the cache as the kernel takes it (K/V heads
    # transposed as views, enable_gqa: no copy made outside the call). Timed
    # L2 warm (the 19-38 MB cache fits the 50 MB L2) and, as the serve path
    # meets a layer's cache a whole step after its last read, L2 cold.
    from repro_torch.kernels.decode_attention import plan as decode_plan

    Sc = 576
    dl = torch.tensor([576, 301, 258, 540, 400, 575, 267, 449], dtype=torch.int32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for H, KV, hd in ((32, 8, 128), (32, 32, 64)):
        qd = torch.randn(B, H, hd, generator=g, device=dev).to(bf)
        kc = torch.randn(B, Sc, KV, hd, generator=g, device=dev).to(bf)
        vc = torch.randn(B, Sc, KV, hd, generator=g, device=dev).to(bf)
        out = kernels["decode_attention"](qd, kc, vc, dl)
        again = kernels["decode_attention"](qd, kc, vc, dl)
        want = ref.decode_attention_ref(qd, kc, vc, dl)
        torch.cuda.synchronize()
        check(torch.allclose(out.float(), want.float(), rtol=2e-2, atol=2e-2),
              f"decode_attention hd={hd}: max err {max_err(torch, out, want)}")
        check(torch.equal(out, again), f"decode_attention hd={hd}: two calls differ")
        call = lambda: kernels["decode_attention"](qd, kc, vc, dl)
        ms, dev_ms = time_ms(torch, call, iters=50), device_time_ms(torch, call, iters=50)
        plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(qd, kc, vc, dl))
        qdt, kct, vct = qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        dmask = (torch.arange(Sc, device=dev)[None, :] < dl[:, None])[:, None, None]
        sdpa = lambda: F.scaled_dot_product_attention(qdt, kct, vct, attn_mask=dmask,
                                                      enable_gqa=True)
        check(torch.allclose(sdpa()[:, :, 0].float(), want.float(), rtol=2e-2, atol=2e-2),
              f"SDPA yardstick hd={hd} disagrees with the plain version")
        lib_ms, lib_dev_ms = (time_ms(torch, sdpa, iters=50),
                              device_time_ms(torch, sdpa, iters=50))
        n_keys = int(dl.long().sum())
        nbytes = 2 * (2 * B * H * hd + 2 * n_keys * KV * hd) + 4 * B
        flops = 4 * hd * H * n_keys
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        row = {"name": "decode_attention",
               "shape": f"B={B} Sc={Sc} H={H} KV={KV} hd={hd} bf16 ragged",
               "max_abs_err": max_err(torch, out, want), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "bytes": nbytes, "flops": flops,
               "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
        row["cold_ms"], row["cold_device_ms"] = time_ms_cold(torch, call, flush)
        row["library_cold_ms"], row["library_cold_device_ms"] = time_ms_cold(torch, sdpa, flush)
        # other splits (head tile, splits, keys a split): device time warm and
        # cold, and the output against the plain version's: both round an fp32
        # value to bf16, so they may differ by one bf16 step (give or take
        # 2e-6 of fp32 error near 0), by no more
        row["plan"] = list(decode_plan(dev, B, Sc, H, KV, hd, bf))
        row["split_sweep"] = []
        G = H // KV
        for p in sorted({tuple(row["plan"])} | {
                (min(8, 1 << (G - 1).bit_length()), n, c)
                for n, c in ((1, 576), (2, 320), (3, 192), (5, 128), (6, 96), (9, 64))}):
            forced = lambda: kernels["decode_attention"](qd, kc, vc, dl, with_plan=p)
            got = forced()
            torch.cuda.synchronize()
            step = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
            check(bool(((got.float() - want.float()).abs() <= step + 2e-6).all()),
                  f"decode_attention hd={hd} plan {p}: more than one bf16 step from the "
                  f"plain version (max|err| {max_err(torch, got, want)})")
            row["split_sweep"].append({
                "plan": list(p), "device_ms": device_time_ms(torch, forced, iters=50),
                "cold_device_ms": time_ms_cold(torch, forced, flush)[1],
                "max_abs_err": max_err(torch, got, want)})
        print(f"decode_attention {row['shape']}: plan {row['plan']} (head tile, splits, keys "
              f"a split); other splits: " + "; ".join(
                  f"{e['plan']} {e['device_ms']:.4f} ms warm, {e['cold_device_ms']:.4f} cold, "
                  f"max|err| {e['max_abs_err']:.3g}"
                  for e in row["split_sweep"]))
        rows.append(row)
    del flush

    # --- ssd_scan: Zamba2's prefill shape (B=8, S=512, H=64, P=64, N=64),
    # Mamba2-130M's (H=24, N=128) and a ragged S=509, bf16 inputs as the
    # served models give them, dt = softplus(randn) and a = -dt; then both
    # widths at a ragged S with a slow decay, a = -0.01 dt, where the state
    # carried across chunks is most of y (with a = -dt, exp(cum_i) hides it
    # after a few rows of each chunk). Tolerances: y bf16 2e-2 (rounded once
    # from fp32 on both sides), h fp32 at the reference's SSD tolerance 2e-4
    # (tests/test_kernels.py: chunked decays exp(cum_i - cum_j) against the
    # recurrence's product of exp(a_t)). No single PyTorch call computes the
    # scan: library_ms is null. The bf16 kernel's products run on the tensor
    # cores, so its bound counts them at the bf16 peak (``bound_ms``); the
    # first version's bound, the same work at the fp32 CUDA-core peak, stands
    # beside it (``fp32_bound_ms``).
    for B, S, H, P, N, decay in ((8, 512, 64, 64, 64, 1.0), (8, 512, 24, 64, 128, 1.0),
                                 (8, 509, 64, 64, 64, 1.0), (8, 509, 64, 64, 64, 0.01),
                                 (8, 509, 24, 64, 128, 0.01)):
        x = torch.randn(B, S, H, P, generator=g, device=dev).to(bf)
        dt = F.softplus(torch.randn(B, S, H, generator=g, device=dev))
        a = -decay * dt
        Bm = torch.randn(B, S, N, generator=g, device=dev).to(bf)
        Cm = torch.randn(B, S, N, generator=g, device=dev).to(bf)
        args = (x, dt, a, Bm, Cm)
        y, h = kernels["ssd_scan"](*args)
        y2, h2 = kernels["ssd_scan"](*args)
        y_ref, h_ref = ref.ssd_scan_ref(*args)
        torch.cuda.synchronize()
        shape = f"B={B} S={S} H={H} P={P} N={N} bf16" + (f" a=-{decay}dt" if decay != 1 else "")
        print(f"ssd_scan {shape}: y max|err| {max_err(torch, y, y_ref):.3g} at max|y| "
              f"{float(y_ref.float().abs().max()):.4g} (bf16 step there "
              f"{2.0 ** (int(torch.log2(y_ref.float().abs().max()).floor()) - 7):.3g}); h max|err| "
              f"{max_err(torch, h, h_ref):.3g} at max|h| {float(h_ref.abs().max()):.4g}; "
              f"decay over a 64-step chunk, median {float(a[:, :64].sum(1).exp().median()):.3g}")
        check(torch.allclose(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2),
              f"ssd_scan y {shape}: max err {max_err(torch, y, y_ref)}")
        check(torch.allclose(h, h_ref, rtol=2e-4, atol=2e-4),
              f"ssd_scan h {shape}: max err {max_err(torch, h, h_ref)}")
        check(torch.equal(y, y2) and torch.equal(h, h2), f"ssd_scan {shape}: two calls differ")
        call = lambda: kernels["ssd_scan"](*args)
        ms, dev_ms = time_ms(torch, call), device_time_ms(torch, call)
        plain_ms = time_ms(torch, lambda: ref.ssd_scan_ref(*args), iters=3, warmup=1)
        nbytes = (2 * 2 * B * S * H * P + 2 * 4 * B * S * H + 2 * 2 * B * S * N
                  + 4 * B * H * P * N)
        flops = ssd_scan_flops(B, S, H, P, N)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        row = {"name": "ssd_scan", "shape": shape,
               "max_abs_err": max(max_err(torch, y, y_ref), max_err(torch, h, h_ref)),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None, "bytes": nbytes, "flops": flops,
               "device_ms": dev_ms, "library_device_ms": None,
               "fp32_bound_ms": bound(nbytes, flops, FP32_FLOPS)[0]}
        rows.append(row)

    # fp32 inputs with no decay (a = 0): the state grows over the whole
    # sequence and |y| reaches ~900, where two fp32 summation orders differ by
    # more than 2e-4; y is held against an fp64 recurrence at 2e-4 (h against
    # the plain version), as tests/test_torch_kernels_gpu.py's
    # test_ssd_scan_no_decay does, on its inputs (numpy seed 7). Printed: the
    # kernel's and the plain version's largest error against fp64, and the
    # largest share of the tolerance the kernel uses.
    import numpy as np

    for S in (65, 509):
        B, H, P, N = 2, 64, 64, 64
        rng = np.random.default_rng(7)    # drawn in the test's order
        dtn = np.log1p(np.exp(rng.standard_normal((B, S, H))))
        a = 0.0 * dtn * np.exp(0.3 * rng.standard_normal(H))
        f32 = lambda v: torch.from_numpy(v.astype(np.float32)).to(dev)
        args = (f32(rng.standard_normal((B, S, H, P))), f32(dtn), f32(a),
                f32(rng.standard_normal((B, S, N))), f32(rng.standard_normal((B, S, N))))
        y, h = kernels["ssd_scan"](*args)
        y_plain, h_plain = ref.ssd_scan_ref(*args)
        y_exact = ssd_fp64(torch, *args)
        err = (y.double() - y_exact).abs()
        share = float((err / (2e-4 + 2e-4 * y_exact.abs())).max())
        print(f"ssd_scan B={B} S={S} H={H} P={P} N={N} fp32 a=0 against fp64: kernel y "
              f"max|err| {float(err.max()):.3g}, plain version "
              f"{float((y_plain.double() - y_exact).abs().max()):.3g} at max|y| "
              f"{float(y_exact.abs().max()):.4g}; the kernel uses {100 * share:.1f}% of the "
              f"2e-4 tolerance; h against the plain version {max_err(torch, h, h_plain):.3g}")
        check(share <= 1.0, f"ssd_scan fp32 a=0 S={S}: y off the fp64 recurrence")
        if S == 65:
            # its sums run in blocks of 16 terms: as close to fp64 as the plain version
            check(float(err.max()) <= 1.5 * float((y_plain.double() - y_exact).abs().max()),
                  "ssd_scan fp32 a=0 S=65: more than 1.5x the plain version's error")
        check(torch.allclose(h, h_plain, rtol=2e-4, atol=2e-4),
              f"ssd_scan fp32 a=0 S={S}: h max err {max_err(torch, h, h_plain)}")

    for r in rows:
        # achieved rates (bytes and operations) and the share of the bound,
        # of the eager call and of the device time
        r["rate"] = (f"{r['bytes'] / r['ms'] / 1e9:.2f} TB/s, "
                     f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s")
        r["device_rate"] = (f"{r['bytes'] / r['device_ms'] / 1e9:.2f} TB/s, "
                            f"{r['flops'] / r['device_ms'] / 1e9:.1f} TFLOP/s")
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["device_bound_share"] = r["bound_ms"] / r["device_ms"]
        if "cold_device_ms" in r:
            r["cold_device_bound_share"] = r["bound_ms"] / r["cold_device_ms"]
        lib = ("none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f} ms)")
        cold = (f"; L2 cold {r['cold_ms']:.4f} ms (device {r['cold_device_ms']:.4f} ms, "
                f"{100 * r['bound_ms'] / r['cold_device_ms']:.1f}% of the bound), "
                f"library {r['library_cold_ms']:.4f} ms (device "
                f"{r['library_cold_device_ms']:.4f} ms)" if "cold_ms" in r else "")
        if "fp32_bound_ms" in r:
            cold += (f"; fp32 CUDA-core bound {r['fp32_bound_ms']:.4f} ms "
                     f"({100 * r['fp32_bound_ms'] / r['device_ms']:.1f}% device)")
        print(f"kernel {r['name']:16s} {r['shape']}: max|err| {r['max_abs_err']:.3g}  "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms)  plain "
              f"{r['plain_ms']:.4f} ms  library {lib}  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['rate']} ({r['device_rate']} device), "
              f"{100 * r['bound_share']:.1f}% of the bound "
              f"({100 * r['device_bound_share']:.1f}% device){cold}")
    return rows


# each served model: generations per prompt, and the kernels its path runs
SERVE_PHASES = (
    ("llama3-8b", 4, ("flash_attention", "decode_attention", "prod_head")),
    ("zamba2-1.2b", 4, ("ssd_scan", "flash_attention", "decode_attention", "prod_head")),
    ("mamba2-130m", 2, ("ssd_scan", "prod_head")),
)


def expected_launches(kinds, r: int, max_new: int):
    """Launches of each kernel when every row of every generation runs to
    max_new (with random weights EOS is rare): one scan per SSM layer and
    one flash call per attention layer in each prefill, one decode call per
    attention layer in each of the max_new steps, and two head calls."""
    n_attn = sum(k != "ssm" for k in kinds)
    return {"ssd_scan": r * sum(k == "ssm" for k in kinds), "flash_attention": r * n_attn,
            "decode_attention": r * max_new * n_attn, "prod_head": 2}


def model_bounds(cfg, kinds, n_params: int, B: int, Sp: int, cache_len: int):
    """Least times of one prefill and one decode step of the served model.
    Prefill: the weight products alone (2 FLOPs per weight applied per
    token; attention scores and the scan left out) at the bf16 peak. Decode
    step: every weight read once (the shared block once, an untied
    embedding table only at its B rows), the SSM states read and written in
    fp32 and the K/V prefix read, over the memory rate."""
    d, hd = cfg.d_model, cfg.head_dim
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    ssm_w = d * (2 * H * P + 2 * N + H) + H * P * d
    attn_w = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
    applied = sum(ssm_w if k == "ssm" else attn_w for k in kinds)
    prefill_flops = 2 * B * Sp * applied
    weights = n_params - (0 if cfg.tie_embeddings else cfg.vocab_size * d)
    n_ssm = sum(k == "ssm" for k in kinds)
    n_attn = len(kinds) - n_ssm
    step_bytes = (2 * weights + n_ssm * 2 * 4 * B * H * P * N
                  + n_attn * 2 * 2 * B * cache_len * cfg.n_kv_heads * hd)
    return (prefill_flops, prefill_flops / BF16_FLOPS * 1e3,
            step_bytes, step_bytes / HBM_BYTES_PER_S * 1e3)


def serve(torch, counters, name: str, r: int, kernels_on_path, sweep: bool):
    """Phase 4 for one model: the port's main path at full width and depth."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import fit_and_predict
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serving.engine import RealEngine

    dev = torch.device("cuda")
    cfg = get_config(name)                   # each model in its own dtype (bf16)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(int(p.numel()) for p in _leaves(params))
    kinds = layer_kinds(cfg)
    print(f"serve {name}: {n_params / 1e9:.3f}B params ({cfg.dtype}, d={cfg.d_model}, "
          f"{sum(k == 'ssm' for k in kinds)} SSM + {sum(k != 'ssm' for k in kinds)} attention "
          f"layers) initialised in {time.perf_counter() - t0:.1f} s")

    B, Sp, max_new = 8, 512, 64
    rng = np.random.default_rng(0)
    plens = np.array([512, 300, 257, 480, 399, 511, 266, 448])
    prompts = np.zeros((B, Sp), np.int64)
    for i, n in enumerate(plens):
        prompts[i, :n] = rng.integers(3, cfg.vocab_size, size=n)
    eng = RealEngine(model, params, max_new=max_new)

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lens, phi = eng.repeated_sampling(prompts, plens, r=r, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    out = fit_and_predict(lens, phi, cfg.predictor_bins, seed=1, qs=(0.5, 0.9), device=dev)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}

    check(phi.shape == (B, cfg.d_model) and np.isfinite(phi).all(), f"{name}: phi shape/finite")
    check(lens.shape == (B, r) and lens.min() >= 1 and lens.max() <= max_new,
          f"{name}: lengths range")
    med, quants = out["median"], out["quantiles"]
    check(np.isfinite(med).all() and np.isfinite(quants).all(), f"{name}: predictions finite")
    check((quants[:, 1] >= quants[:, 0] - 1e-4).all(), f"{name}: q0.9 >= q0.5")
    check(np.allclose(med, quants[:, 0], rtol=1e-5, atol=1e-4), f"{name}: median == q0.5 column")
    for k in kernels_on_path:
        check(launches[k] > 0, f"{name}: kernel {k} was not launched on the main path")
    for k in set(counters) - set(kernels_on_path):
        check(launches[k] == 0, f"{name}: kernel {k} launched off its path")
    expect = expected_launches(kinds, r, max_new)
    if lens.min() == max_new:
        for k in kernels_on_path:
            check(launches[k] == expect[k], f"{name}: {k} launched {launches[k]} times, "
                  f"expected {expect[k]}")
    n_tok = int(lens.sum())
    print(f"serve {name}: repeated_sampling B={B} Sp={Sp} r={r} max_new={max_new}: "
          f"{gen_s:.2f} s, {n_tok} generated tokens, {n_tok / gen_s:.1f} tokens/s, "
          f"{1e3 * gen_s / (r * max_new):.2f} ms per decode step (wall over r x max_new "
          f"steps, the r prefills included)")
    print(f"serve {name}: lengths {lens.tolist()}")
    print(f"serve {name}: median {np.round(med, 3).tolist()} q0.9 "
          f"{np.round(quants[:, 1], 3).tolist()} test MAE {out['mae']:.3f} noise radius "
          f"{out['noise_radius']:.3f} final soft-CE {out['final_loss']:.4f}")
    print(f"serve {name}: launches on the main path {json.dumps(launches)}")
    head_checks(torch, counters["prod_head"], out["predictor"],
                torch.as_tensor(phi[B // 2:], dtype=torch.float32, device=dev), sweep=sweep)

    # per-call breakdown of one prefill and one decode step (not counted)
    tokens = torch.as_tensor(prompts, device=dev)
    valid = torch.arange(Sp, device=dev)[None, :] < torch.as_tensor(plens, device=dev)[:, None]
    with torch.no_grad():
        prefill = lambda: model.prefill(params, tokens, attn_valid=valid, logits_mode="none")
        prefill_ms = time_ms(torch, prefill, iters=3, warmup=1)
        cache = model.init_cache(B, Sp + max_new, device=dev)
        pos = torch.as_tensor(plens, dtype=torch.int32, device=dev)
        nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
        step = lambda: model.decode_step(params, nxt, cache, pos, pos + 1)
        step_ms = time_ms(torch, step, iters=10, warmup=2)
        flops, flops_ms, step_bytes, bytes_ms = model_bounds(cfg, kinds, n_params, B, Sp,
                                                             Sp + max_new)
        print(f"serve {name}: prefill (B={B}, S={Sp}) {prefill_ms:.2f} ms, bound "
              f"{flops_ms:.2f} ms ({flops / 1e12:.2f} TFLOP of weight products); decode step "
              f"(B={B}, Sc={Sp + max_new}) {step_ms:.2f} ms, bound {bytes_ms:.3f} ms "
              f"({step_bytes / 1e9:.2f} GB)")
        device_profile(torch, prefill, f"{name} prefill")
        device_profile(torch, step, f"{name} decode step")
    return launches


def head_fp64(torch, phi, w1, b1, w2, b2):
    """Logits and probs of the head in fp64: the exact answer that both fp32
    versions approximate."""
    f64 = torch.float64
    h = torch.relu(phi.to(f64) @ w1.to(f64) + b1.to(f64))
    logits = h @ w2.to(f64) + b2.to(f64)
    return logits, torch.softmax(logits, dim=-1)


def head_checks(torch, prod_head, pred, phi, sweep: bool) -> None:
    """The head kernel against its plain version as the serve phase calls it:
    the trained weights, the served phi of the held-out half (B = n // 2 = 4
    rows, d of the served model), the median form (qs=None) and the quantile
    form (0.5, 0.9); same tolerance as the kernel phase. Then, with ``sweep``
    and outside the main path, how the disagreement grows with the logit
    scale at d=4096: synthetic weights with std c / sqrt(fan_in), each
    version held against the fp64 head."""
    from repro_torch.kernels import ref

    dev = phi.device
    p = pred.params
    args = (phi, p["w1"], p["b1"], p["w2"], p["b2"], pred.edges)
    logits, p64 = head_fp64(torch, *args[:5])
    for qs in (None, (0.5, 0.9)):
        levels = torch.tensor([0.5] if qs is None else qs, device=dev)
        probs, quants = prod_head(*args, levels)
        p_ref, q_ref = ref.prod_head_ref(*args, qs=None if qs is None else levels)
        quants = quants[:, 0] if qs is None else quants
        torch.cuda.synchronize()
        form = "median" if qs is None else f"qs={qs}"
        print(f"head check, trained weights, served phi B={phi.shape[0]} d={phi.shape[1]} "
              f"{form}: logit std "
              f"{float(logits.std()):.4g}, max |logit| {float(logits.abs().max()):.4g}; probs "
              f"max|kernel-plain| {max_err(torch, probs, p_ref):.3g}, |kernel-fp64| "
              f"{max_err(torch, probs, p64):.3g}, |plain-fp64| {max_err(torch, p_ref, p64):.3g}; "
              f"quantiles max|kernel-plain| {max_err(torch, quants, q_ref):.3g}")
        check(torch.allclose(probs, p_ref, rtol=1e-5, atol=1e-6),
              f"prod_head probs, trained weights, {form}: max err {max_err(torch, probs, p_ref)}")
        check(torch.allclose(quants, q_ref, rtol=1e-4, atol=1e-3),
              f"prod_head quantiles, trained weights, {form}: max err "
              f"{max_err(torch, quants, q_ref)}")
    if not sweep:
        return

    g = torch.Generator(device=dev).manual_seed(3)
    B, d, hidden, K = 40, 4096, 512, 64
    x = torch.randn(B, d, generator=g, device=dev)
    w1 = torch.randn(d, hidden, generator=g, device=dev)
    b1 = torch.randn(hidden, generator=g, device=dev) * 0.01
    w2 = torch.randn(hidden, K, generator=g, device=dev)
    b2 = torch.zeros(K, device=dev)
    edges = torch.linspace(0.0, 512.0, K + 1, device=dev)
    levels = torch.tensor([0.5], device=dev)
    for c in (1.0, 2.0, 4.0, 8.0, 0.2 * d ** 0.5):     # the last: std 0.2, as tests/test_kernels.py
        sw = (x, w1 * (c / d ** 0.5), b1, w2 * (c / hidden ** 0.5), b2)
        probs, _ = prod_head(*sw, edges, levels)
        p_ref, _ = ref.prod_head_ref(*sw, edges)
        logits, p64 = head_fp64(torch, *sw)
        ok = torch.allclose(probs, p_ref, rtol=1e-5, atol=1e-6)
        print(f"head logit-scale sweep c={c:.4g}: logit std {float(logits.std()):.4g}; probs "
              f"max|kernel-plain| {max_err(torch, probs, p_ref):.3g}, |kernel-fp64| "
              f"{max_err(torch, probs, p64):.3g}, |plain-fp64| {max_err(torch, p_ref, p64):.3g}; "
              f"within rtol 1e-5/atol 1e-6 of plain: {ok}")


# The reference's Table 1, fast profile: `benchmarks/bench_table1.py::run(fast=True,
# seed=0)` of the JAX package, run with JAX_PLATFORMS=cpu: its claims (every
# boolean True, ProD-D 4.33% below TRAIL-last) and per-backbone average test MAE
# (tokens; platform-independent numbers).
TABLE1_REF_CHECKS = {"prod_d_best_avg": True, "prod_m_at_worst_ties_best_external": True,
                     "informative_views_beat_constant": True, "egtp_underperforms": True}
TABLE1_REF_PCT = 4.33
TABLE1_REF_AVG = {"constant_median": (182.40, 147.05), "s3": (164.14, 138.33),
                  "trail_mean": (126.80, 92.77), "trail_last": (76.97, 62.35),
                  "egtp": (197.53, 143.27), "prod_m": (76.74, 62.79), "prod_d": (73.10, 60.19)}


def table1_phase(torch, counters):
    """Phase 5: the port's Table 1, fast profile (8 settings x 7 methods,
    every method training the shared head on the card; ProD-M and ProD-D
    decode the median through the head kernel on train and test phi). The
    claims must equal the reference's; each method's per-backbone average is
    printed beside the reference's."""
    from repro_torch.launch import table1

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = table1.run(fast=True, seed=0, verbose=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    rows = out["rows"]
    check(len(rows) == 7 and all(len(v) == 8 for v in rows.values())
          and all(math.isfinite(x) for v in rows.values() for x in v.values()),
          "table1: 56 finite test MAEs")
    print("table1: per-backbone average test MAE, port on the card [reference, difference]:")
    for method, ref_avg in TABLE1_REF_AVG.items():
        print(f"  {method:16s}" + "".join(
            f"  {model} {out['avg'][(method, model, 'avg')]:8.2f} [{ref:.2f}, "
            f"{100 * (out['avg'][(method, model, 'avg')] / ref - 1):+.2f}%]"
            for model, ref in zip(("qwen", "llama"), ref_avg)))
    checks = out["checks"]
    print(f"table1: claims {json.dumps(checks)} (reference: {json.dumps(TABLE1_REF_CHECKS)}, "
          f"prod_beats_trail_last_pct {TABLE1_REF_PCT})")
    print(f"table1: {wall:.1f} s wall; launches {json.dumps(launches)}")
    for k, v in TABLE1_REF_CHECKS.items():
        check(checks[k] == v, f"table1: claim {k} is {checks[k]}, the reference's is {v}")
    check(checks["prod_beats_trail_last_pct"] > 0, "table1: ProD-D does not beat TRAIL-last")
    # ProD-M and ProD-D predict train and test phi once each through the head, per setting
    check(launches["prod_head"] == 2 * 2 * 8, f"table1: prod_head launched {launches['prod_head']}")
    for k in set(counters) - {"prod_head"}:
        check(launches[k] == 0, f"table1: kernel {k} launched off its path")

    # where the phase's time goes: one of its 232 fits (ProD-D on qwen/math,
    # N=700, 400 AdamW steps), profiled (not counted)
    from repro_torch.core import bins, targets
    from repro_torch.core.predictor import train_predictor
    from repro_torch.data import make_scenario

    data = make_scenario("qwen", "math", n_train=700, n_test=350)
    pcfg = table1.scenario_pcfg(data, epochs=15)
    edges = bins.make_edges(pcfg.n_bins, pcfg.bin_max, device="cuda")
    tgt = targets.dist_target(torch.as_tensor(data.len_train, dtype=torch.float32,
                                              device="cuda"), edges)
    device_profile(torch, lambda: train_predictor(0, data.phi_train["last"], tgt, pcfg, edges,
                                                  device="cuda"),
                   "table1: one ProD-D fit (400 AdamW steps)")
    return launches


def sim_phase(torch, counters):
    """Phase 6: `--mode sim` with the reference's defaults (qwen/chat, 200
    requests, n_train 800, 20 epochs, 32 slots, KV budget 40,000, max_seq
    4096, arrival rate 2.0): a ProD-D head trained on the card, then four
    SimEngine policy runs, each annotating its 200 requests through the head."""
    from repro_torch.launch import serve as serve_launcher

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = serve_launcher.main(["--mode", "sim", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    print(f"sim: {wall:.1f} s wall; launches {json.dumps(launches)}")
    by = {r["policy"]: r for r in rows}
    check(len(rows) == 4 and all(r["completed"] == 200 for r in rows),
          "sim: every request of every policy completes")
    check(launches["prod_head"] == 4, f"sim: prod_head launched {launches['prod_head']}")
    for k in set(counters) - {"prod_head"}:
        check(launches[k] == 0, f"sim: kernel {k} launched off its path")
    sjf = by["sjf_pred+quantile"]["mean_latency"]
    check(sjf < by["fcfs+max"]["mean_latency"] and sjf < by["fcfs+quantile"]["mean_latency"],
          "sim: sjf_pred+quantile does not beat both fcfs rows on mean latency")
    return launches


# name fragments of the port's CUDA kernels (csrc/*.cu)
PORT_KERNELS = ("flash_fwd_", "decode_fwd", "ssd_scan_", "prod_head_")


def device_profile(torch, fn, label: str, top: int = 6) -> None:
    """Device busy share of one call of ``fn`` and the kernels that take
    most of its device time (torch.profiler, CUDA kernel events only). The
    profiler adds host time, so the wall time here is above the event timing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    kernels = {e.key: e.device_time_total / 1e3 for e in events}
    n_launch = sum(e.count for e in events)
    busy = sum(kernels.values())
    if not busy:
        print(f"profile {label}: device time not measured (no kernel events)")
        return
    print(f"profile {label}: wall {wall_ms:.2f} ms under the profiler, device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%), {len(kernels)} kernel names, "
          f"{n_launch} kernel launches ({1e3 * wall_ms / n_launch:.1f} us of wall each)")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    for i, (name, ms) in enumerate(ranked):
        # the top kernels, and every kernel of the port
        if i < top or any(k in name for k in PORT_KERNELS):
            print(f"  {100 * ms / busy:5.1f}%  {ms:8.3f} ms  {name[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # the plain versions are the reference: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.prod_head import prod_head_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in Path(f"{lib}.log").read_text().splitlines():
            if "Used" in line or "spill" in line or "Function properties" in line:
                print(f"  {lib.name.split('-')[0]}: {line.strip()}")

    kernels = {"prod_head": prod_head_cuda, "flash_attention": flash_attention_cuda,
               "decode_attention": decode_attention_cuda, "ssd_scan": ssd_scan_cuda}
    rows = kernel_checks(torch, ref, kernels)
    by_phase = {}
    for i, (name, r, on_path) in enumerate(SERVE_PHASES):
        by_phase[name] = serve(torch, kernels, name, r, on_path, sweep=(i == 0))
        torch.cuda.empty_cache()
    by_phase["table1"] = table1_phase(torch, kernels)
    by_phase["sim"] = sim_phase(torch, kernels)

    sources = {"prod_head": ("src/repro_torch/kernels/csrc/prod_head.cu",
                             "src/repro/kernels/prod_head.py:61"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:69"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:64"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:61")}
    report = []
    for r in rows:
        if any(k["name"] == r["name"] for k in report):
            continue             # one entry per kernel: its first (serving) shape
        src, replaces = sources[r["name"]]
        n = r["name"]
        report.append({"name": n, "route": "cuda", "source": src, "replaces": replaces,
                       "launches": sum(ph[n] for ph in by_phase.values()),
                       "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                       "shape": r["shape"], "rate": r["rate"], "bound_share": r["bound_share"],
                       "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"],
                       "device_rate": r["device_rate"],
                       "device_bound_share": r["device_bound_share"],
                       **{k: r[k] for k in ("cold_ms", "cold_device_ms", "library_cold_ms",
                                            "library_cold_device_ms", "cold_device_bound_share",
                                            "fp32_bound_ms", "plan", "split_sweep")
                          if k in r},
                       "launches_by_phase": {p: ph[n] for p, ph in by_phase.items()}})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
