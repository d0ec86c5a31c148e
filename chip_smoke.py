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
   shapes, with the stated tolerance, timed with CUDA events beside the plain
   version, one PyTorch library call as a yardstick (timed only, never used
   by the port) and the least time the card could take (``bound_ms``);
4. serve: Llama-3-8B at full width and depth (32 layers, d=4096, bf16,
   seeded random weights) through ``RealEngine.repeated_sampling`` on 8
   ragged prompts (r=4, max_new=64), ProD-D targets, ``train_predictor`` on φ
   and median / q0.9 predictions through the fused head; every kernel's
   launch count must rise during this phase. The head kernel is then held
   against its plain version on the trained weights and the served phi, and
   its disagreement is printed against the logit scale;
5. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_checks(torch, ref, kernels):
    """Phase 3: every kernel against its plain version at the serving shapes."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # --- prod_head: d=4096, hidden=512, K=64, Q=3, fp32 (phi reaches the
    # head as fp32); tolerance: tests/test_kernels.py's prod_head tolerance
    # (probs rtol 1e-5/atol 1e-6, quantiles rtol 1e-4/atol 1e-3) — the
    # kernel sums in another order than cuBLAS' fp32 product.
    d, hidden, K = 4096, 512, 64
    w1 = torch.randn(d, hidden, generator=g, device=dev) / d ** 0.5
    b1 = torch.randn(hidden, generator=g, device=dev) * 0.01
    w2 = torch.randn(hidden, K, generator=g, device=dev) / hidden ** 0.5
    b2 = torch.zeros(K, device=dev)
    edges = torch.linspace(0.0, 600.0, K + 1, device=dev)
    qs = torch.tensor([0.5, 0.9, 0.99], device=dev)
    for B in (8, 512):
        phi = torch.randn(B, d, generator=g, device=dev)
        args = (phi, w1, b1, w2, b2, edges)
        probs, quants = kernels["prod_head"](*args, qs)
        p_ref, q_ref = ref.prod_head_ref(*args, qs=qs)
        torch.cuda.synchronize()
        check(torch.allclose(probs, p_ref, rtol=1e-5, atol=1e-6),
              f"prod_head probs B={B}: max err {max_err(torch, probs, p_ref)}")
        check(torch.allclose(quants, q_ref, rtol=1e-4, atol=1e-3),
              f"prod_head quantiles B={B}: max err {max_err(torch, quants, q_ref)}")
        ms = time_ms(torch, lambda: kernels["prod_head"](*args, qs))
        plain_ms = time_ms(torch, lambda: ref.prod_head_ref(*args, qs=qs))
        lib_ms = time_ms(torch, lambda: torch.softmax(
            torch.addmm(b2, torch.relu(torch.addmm(b1, phi, w1)), w2), dim=-1))
        nbytes = 4 * (B * d + d * hidden + hidden + hidden * K + K + K + 1 + 3
                      + B * K + B * 3)
        flops = 2 * B * d * hidden + 2 * B * hidden * K
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        rows.append({"name": "prod_head", "shape": f"B={B} d={d} hidden={hidden} K={K} Q=3 fp32",
                     "max_abs_err": max(max_err(torch, probs, p_ref),
                                        max_err(torch, quants, q_ref)),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})

    # --- flash attention: B=8, S=512, H=32, KV=8, hd=128, bf16, causal,
    # ragged key lengths; tolerance bf16 2e-2 (tests/test_kernels.py): both
    # sides compute in fp32 and round the output to bf16 once.
    B, S, H, KV, hd = 8, 512, 32, 8, 128
    bf = torch.bfloat16
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(bf)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(bf)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(bf)
    lens = torch.tensor([512, 300, 257, 480, 399, 511, 266, 448], dtype=torch.int32, device=dev)
    out = kernels["flash_attention"](q, k, v, causal=True, kv_lengths=lens)
    want = ref.flash_attention_ref(q, k, v, causal=True, kv_lengths=lens)
    torch.cuda.synchronize()
    check(torch.allclose(out.float(), want.float(), rtol=2e-2, atol=2e-2),
          f"flash_attention: max err {max_err(torch, out, want)}")
    ms = time_ms(torch, lambda: kernels["flash_attention"](q, k, v, causal=True, kv_lengths=lens))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                              kv_lengths=lens), iters=5)
    G = H // KV
    qt, kt, vt = (q.transpose(1, 2), k.repeat_interleave(G, dim=2).transpose(1, 2),
                  v.repeat_interleave(G, dim=2).transpose(1, 2))
    pos = torch.arange(S, device=dev)
    mask = ((pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < lens[:, None, None]))[:, None]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    lens_l = lens.long().cpu()
    pairs = int(sum(torch.minimum(torch.arange(1, S + 1), n).sum() for n in lens_l))
    nbytes = 2 * (2 * B * S * H * hd + 2 * int(lens_l.sum()) * KV * hd) + 4 * B
    flops = 4 * hd * H * pairs
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    rows.append({"name": "flash_attention",
                 "shape": f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal ragged",
                 "max_abs_err": max_err(torch, out, want), "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})

    # --- decode attention: B=8, Sc=576, ragged lengths, bf16; tolerance 2e-2.
    Sc = 576
    qd = torch.randn(B, H, hd, generator=g, device=dev).to(bf)
    kc = torch.randn(B, Sc, KV, hd, generator=g, device=dev).to(bf)
    vc = torch.randn(B, Sc, KV, hd, generator=g, device=dev).to(bf)
    dl = torch.tensor([576, 301, 258, 540, 400, 575, 267, 449], dtype=torch.int32, device=dev)
    out = kernels["decode_attention"](qd, kc, vc, dl)
    want = ref.decode_attention_ref(qd, kc, vc, dl)
    torch.cuda.synchronize()
    check(torch.allclose(out.float(), want.float(), rtol=2e-2, atol=2e-2),
          f"decode_attention: max err {max_err(torch, out, want)}")
    ms = time_ms(torch, lambda: kernels["decode_attention"](qd, kc, vc, dl), iters=50)
    plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(qd, kc, vc, dl))
    qdt = qd[:, :, None]
    kct = kc.repeat_interleave(G, dim=2).transpose(1, 2)
    vct = vc.repeat_interleave(G, dim=2).transpose(1, 2)
    dmask = (torch.arange(Sc, device=dev)[None, :] < dl[:, None])[:, None, None]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qdt, kct, vct, attn_mask=dmask),
                     iters=50)
    n_keys = int(dl.long().sum())
    nbytes = 2 * (2 * B * H * hd + 2 * n_keys * KV * hd) + 4 * B
    flops = 4 * hd * H * n_keys
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    rows.append({"name": "decode_attention", "shape": f"B={B} Sc={Sc} H={H} KV={KV} hd={hd} bf16 ragged",
                 "max_abs_err": max_err(torch, out, want), "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    for r in rows:
        print(f"kernel {r['name']:16s} {r['shape']}: max|err| {r['max_abs_err']:.3g}  "
              f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def serve(torch, counters):
    """Phase 4: the port's main path on Llama-3-8B at full width and depth."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import fit_and_predict
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving.engine import RealEngine

    dev = torch.device("cuda")
    cfg = get_config("llama3-8b")           # bf16, 32 layers, d=4096, untied
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(int(p.numel()) for p in _leaves(params))
    print(f"serve: {cfg.name} {n_params / 1e9:.3f}B params ({cfg.dtype}) initialised in "
          f"{time.perf_counter() - t0:.1f} s")

    B, Sp, r, max_new = 8, 512, 4, 64
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
    launches = {name: c.launches for name, c in counters.items()}

    check(phi.shape == (B, cfg.d_model) and np.isfinite(phi).all(), "phi shape/finite")
    check(lens.shape == (B, r) and lens.min() >= 1 and lens.max() <= max_new, "lengths range")
    med, quants = out["median"], out["quantiles"]
    check(np.isfinite(med).all() and np.isfinite(quants).all(), "predictions finite")
    check((quants[:, 1] >= quants[:, 0] - 1e-4).all(), "q0.9 >= q0.5")
    check(np.allclose(med, quants[:, 0], rtol=1e-5, atol=1e-4), "median == q0.5 column")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    n_tok = int(lens.sum())
    print(f"serve: repeated_sampling B={B} Sp={Sp} r={r} max_new={max_new}: {gen_s:.2f} s, "
          f"{n_tok} generated tokens, {n_tok / gen_s:.1f} tokens/s")
    print(f"serve: lengths {lens.tolist()}")
    print(f"serve: median {np.round(med, 3).tolist()} q0.9 {np.round(quants[:, 1], 3).tolist()} "
          f"test MAE {out['mae']:.3f} noise radius {out['noise_radius']:.3f} "
          f"final soft-CE {out['final_loss']:.4f}")
    print(f"serve: launches on the main path {json.dumps(launches)}")
    head_checks(torch, counters["prod_head"], out["predictor"],
                torch.as_tensor(phi[B // 2:], dtype=torch.float32, device=dev))

    # per-call breakdown of one prefill and one decode step (not counted)
    tokens = torch.as_tensor(prompts, device=dev)
    valid = torch.arange(Sp, device=dev)[None, :] < torch.as_tensor(plens, device=dev)[:, None]
    with torch.no_grad():
        prefill_ms = time_ms(torch, lambda: model.prefill(params, tokens, attn_valid=valid,
                                                          logits_mode="none"), iters=3, warmup=1)
        cache = model.init_cache(B, Sp + max_new, device=dev)
        pos = torch.as_tensor(plens, dtype=torch.int32, device=dev)
        nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
        step_ms = time_ms(torch, lambda: model.decode_step(params, nxt, cache, pos, pos + 1),
                          iters=10, warmup=2)
        print(f"serve: prefill (B={B}, S={Sp}) {prefill_ms:.2f} ms; decode step (B={B}, "
              f"Sc={Sp + max_new}) {step_ms:.2f} ms")
        device_profile(torch, lambda: model.prefill(params, tokens, attn_valid=valid,
                                                    logits_mode="none"), "prefill")
        device_profile(torch, lambda: model.decode_step(params, nxt, cache, pos, pos + 1),
                       "decode step")
    return launches


def head_fp64(torch, phi, w1, b1, w2, b2):
    """Logits and probs of the head in fp64: the exact answer that both fp32
    versions approximate."""
    f64 = torch.float64
    h = torch.relu(phi.to(f64) @ w1.to(f64) + b1.to(f64))
    logits = h @ w2.to(f64) + b2.to(f64)
    return logits, torch.softmax(logits, dim=-1)


def head_checks(torch, prod_head, pred, phi) -> None:
    """The head kernel against its plain version as the serve phase calls it:
    the trained weights, the served phi of the held-out half (B = n // 2 = 4
    rows), the median form (qs=None) and the quantile form (0.5, 0.9); same
    tolerance as the kernel phase. Then, outside the main path, how the
    disagreement grows with the logit scale at d=4096: synthetic weights with
    std c / sqrt(fan_in), each version held against the fp64 head."""
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
        print(f"head check, trained weights, served phi B={phi.shape[0]} {form}: logit std "
              f"{float(logits.std()):.4g}, max |logit| {float(logits.abs().max()):.4g}; probs "
              f"max|kernel-plain| {max_err(torch, probs, p_ref):.3g}, |kernel-fp64| "
              f"{max_err(torch, probs, p64):.3g}, |plain-fp64| {max_err(torch, p_ref, p64):.3g}; "
              f"quantiles max|kernel-plain| {max_err(torch, quants, q_ref):.3g}")
        check(torch.allclose(probs, p_ref, rtol=1e-5, atol=1e-6),
              f"prod_head probs, trained weights, {form}: max err {max_err(torch, probs, p_ref)}")
        check(torch.allclose(quants, q_ref, rtol=1e-4, atol=1e-3),
              f"prod_head quantiles, trained weights, {form}: max err "
              f"{max_err(torch, quants, q_ref)}")

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
    kernels = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
    busy = sum(kernels.values())
    if not busy:
        print(f"profile {label}: device time not measured (no kernel events)")
        return
    print(f"profile {label}: wall {wall_ms:.2f} ms under the profiler, device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%), {len(kernels)} kernel names")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
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
            if "Used" in line or "spill" in line:
                print(f"  {lib.name.split('-')[0]}: {line.strip()}")

    kernels = {"prod_head": prod_head_cuda, "flash_attention": flash_attention_cuda,
               "decode_attention": decode_attention_cuda}
    rows = kernel_checks(torch, ref, kernels)
    launches = serve(torch, kernels)

    sources = {"prod_head": ("src/repro_torch/kernels/csrc/prod_head.cu",
                             "src/repro/kernels/prod_head.py:61"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:69"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:64")}
    report = []
    for r in rows:
        if any(k["name"] == r["name"] for k in report):
            continue             # one entry per kernel: its first (serving) shape
        src, replaces = sources[r["name"]]
        report.append({"name": r["name"], "route": "cuda", "source": src, "replaces": replaces,
                       "launches": launches[r["name"]], "max_abs_err": r["max_abs_err"],
                       "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                       "shape": r["shape"]})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
