#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU (Hopper: the
kernels are built for sm_90a). Its phases, in order, each with the function
and the tables that hold its shapes; any failure raises and the script exits
non-zero without its result line:

1. device: the card's name, and its name and power limit from ``nvidia-smi``;
2. build: ``nvcc`` builds every kernel of ``_build.KERNEL_SOURCES`` in
   parallel, timed;
3. kernels: each kernel held against its plain version and timed beside its
   library call and bound, as ``launch/bench_kernels.py``'s ``Case`` rows:
   ``kernel_checks`` (``HEAD_SHAPES`` to ``SCAN_SHAPES``, then
   ``scan_against_fp64``), ``gemma3_kernel_checks``, ``moe_kernel_checks``,
   ``mla_kernel_checks``, ``encdec_vlm_kernel_checks``,
   ``unembed_kernel_checks`` (``UNEMBED_SHAPES``) and
   ``norm_rope_kernel_checks`` (``NORM_SHAPES``, ``ROPE_SHAPES``);
   run: ``launch/run.py --only kernels,theory`` in this process, then the
   reference's four rows (``run_phase``);
   ep: the expert-parallel MoE layer in 4 gloo ranks sharing the card
   (``ep_phase``, ``EP_CASES``);
   dryrun: ``launch/dryrun.py`` in a child beside the cluster child
   (``DRYRUN_COMBOS``);
4. serve: each model of ``SERVE_PHASES`` through ``RealEngine`` (``serve``:
   launches against ``expected_launches``, the head held, a prefill and a step
   against ``model_bounds``);
   kimi-k2-instruct: the published MLA model on the main path (``mla_phase``);
   long: Zamba2-1.2B past its 8,192-token window (``long_phase``,
   ``LONG_LENS``);
   gemma3 long: Gemma3-27B past its 1,024-token window (``gemma3_long_phase``);
   qwen2-vl-2b embeds: Qwen2-VL on image patches, then text
   (``vlm_embeds_phase``);
   whisper-large-v3: the encoder-decoder through ``Model.prefill`` and
   ``decode_step`` (``whisper_phase``);
5. table1: Table 1, fast profile, its claims equal to ``TABLE1_REF_CHECKS``
   (``table1_phase``);
   ablations: the bins ablation, Figure 2 and Tables 2-3 (``ablations_phase``,
   ``ABLATION_REF_CHECKS``);
6. sim: ``--mode sim`` at the reference's defaults (``sim_phase``); single: the
   single-replica track (``single_phase``, ``SINGLE_REF_CHECKS``);
7. cluster: the predictor, adaptation and refine tables in a child
   (``cluster_phase``, ``CLUSTER_REF_CHECKS``), its stamp read back
   (``stamp_check``);
8. train: the trainer at Llama-3-8B's widths, 2 layers (``train_phase``); ssm
   train: ``SSM_TRAIN`` (``ssm_train_phase``); int8 kv: the int8 KV cache
   (``int8_kv_phase``);
9. online: ProD-O on real generations (``online_phase``, ``ONLINE_REF``);
10. e2e: ``launch/serve_with_prod.py`` at its defaults (``e2e_phase``);
11. a ``{"kernels": [...]}`` line (each kernel's first row and its launches by
   phase), then ``{"ok": true, "device": {...}}`` last.

From ``run`` on, each phase sets the launch counts to 0 before it and reads
them after (``launches_by_phase``). It imports nothing of JAX or of the JAX package. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result. To run one phase alone, call ``_build.build_all()`` and then its
function.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import bench_kernels as bk
    # the kernel table's rows and launch/bench_kernels.py's are one piece of code
    from repro_torch.launch.bench_kernels import (BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S,
                                                  bound, device_time_ms, kernel_wrappers,
                                                  report_rows, ssd_scan_flops, time_ms)
except ImportError as e:
    sys.exit(f"chip_smoke: run from a checkout of the repository ({e})")

# the cluster phase's stamp (``build/`` is git-ignored)
STAMP = ROOT / "build" / "chip_smoke_stamp.json"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def ssd_fp64(x, dt, a, Bm, Cm):
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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def randn(g, *shape, dtype=torch.float32):
    """Unit normals drawn in fp32 from ``g``, on its device, then cast."""
    return torch.randn(*shape, generator=g, device=g.device).to(dtype)


def head_weights(g, d: int, hidden: int, K: int):
    """w1, b1, w2, b2 of a head at its init scales, drawn from ``g``."""
    return (randn(g, d, hidden) / d ** 0.5, randn(g, hidden) * 0.01,
            randn(g, hidden, K) / hidden ** 0.5, torch.zeros(K, device=g.device))


def quantiles_in_cdf(label, args, levels):
    """A head row's criterion where a quantile may cross a wide log bin of
    little mass: probs at the head's tolerance, quantiles by
    ``hold_quantiles`` under the fp64 head."""
    def criterion(got, want):
        if not torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-6):
            return f"probs max err {max_err(got[0], want[0])}"
        hold_quantiles(label, got[1], want[1], levels, head_fp64(*args[:5])[1], args[5])
        return None
    return criterion


def flash_case(g, B, S, H, KV, hd, dtype, lens, window, label, causal=True, Skv=None,
               hd_v=None, scale=None):
    """A flash row: q, k and v unit normal from ``g``; causal with S keys, or
    non-causal over ``Skv`` keys (an encoder, or cross-attention), V of
    ``hd_v`` columns and the scores' ``scale`` where given (MLA)."""
    Skv, hd_v = Skv or S, hd_v or hd
    lens = torch.tensor(lens, dtype=torch.int32, device=g.device)
    q, k, v = (randn(g, B, n, h, w, dtype=dtype)
               for n, h, w in ((S, H, hd), (Skv, KV, hd), (Skv, KV, hd_v)))
    return bk.flash_attention(q, k, v, causal=causal, window=window, kv_lengths=lens,
                              scale=scale, label=label)


def decode_case(g, B, Sc, H, KV, hd, dtype, lens, label, sweep=()):
    """A decode row: q, k and v unit normal from ``g``; ``sweep``, the
    splits to time beside the library's plan."""
    lens = torch.as_tensor(lens, dtype=torch.int32, device=g.device)
    q, k, v = (randn(g, *s, dtype=dtype) for s in ((B, H, hd), (B, Sc, KV, hd), (B, Sc, KV, hd)))
    return bk.decode_attention(q, k, v, lens, label=label, sweep=sweep)


# the kernel phase's rows (``kernel_checks``), seed 0, in this order.
# The head (hidden 512, levels 0.5/0.9/0.99, fp32: phi reaches the head as
# fp32), (B, d, K): B=8 at the served widths d = 4096 (Llama; also timed
# with W1 cold, a 64 MB buffer written between launches, as a server meets
# it once per batch), 2048 (Zamba2) and 768 (Mamba2), d=4096 at B=512,
# the Track-A width d=64 at the sim phase's 200 and Table 1's 350 test and
# 700 train rows, the online heads at K=24 (bench_online's on tiny-lm's
# d=128 over 48 prompts and ~256 decode states, the Llama online phase's on
# 512 states), then B=8 at Qwen2.5-7B's 3584, Granite-20B's 6144,
# MiniCPM-2B's 2304, Yi-34B's 7168, Whisper's 1280 and Qwen2-VL's 1536
HEAD_SHAPES = ((8, 4096, 64), (8, 2048, 64), (8, 768, 64), (512, 4096, 64),
               (200, 64, 64), (350, 64, 64), (700, 64, 64),
               (48, 128, 24), (256, 128, 24), (512, 4096, 24),
               (8, 3584, 64), (8, 6144, 64), (8, 2304, 64), (8, 7168, 64),
               (8, 1280, 64), (8, 1536, 64))
# the cluster's heads on d=4 trace features (serving/arrivals.py's latents),
# K=32 bins log-spaced to 4096, (B, hidden, levels): hidden 128 the dispatch
# head at its padded buckets 8-64 and max_batch 512, 64 the refine table's,
# 32 the hazard head's one call on its ~24-row progress grid. d=4 is below
# the kernel's 32-row d-slice (28 rows masked); B <= 32 is one launch
TRACE_HEAD_SHAPES = ((8, 128, (0.5, 0.9)), (16, 128, (0.5, 0.9)), (32, 128, (0.5, 0.9)),
                     (64, 128, (0.5, 0.9)), (512, 128, (0.5, 0.9)), (8, 64, (0.5, 0.9)),
                     (64, 64, (0.5, 0.9)), (24, 32, (0.5,)))
# the bins ablation's grids (launch/bench_bins_ablation.py): d=64, hidden 512
# on qwen/chat's 400 test prompts, K = 16 and 128 (the kernel's largest) with
# linear and log edges up to the scenario's bin_max
BINS_SHAPES = ((16, "linear"), (16, "log"), (128, "linear"), (128, "log"))
# a serve phase's batch: 8 prompts padded to 512, and 8 caches of 576 slots
SERVE_LENS = (512, 300, 257, 480, 399, 511, 266, 448)
DECODE_SERVE_LENS = (576, 301, 258, 540, 400, 575, 267, 449)
# (n splits, c keys a split) timed beside the library's plan at Sc=576;
# WIDE_SWEEP's last also at the other widths
SWEEP = ((1, 576), (2, 320), (3, 192), (5, 128), (6, 96), (9, 64))
WIDE_SWEEP = SWEEP + ((18, 32),)
bf16, fp32 = torch.bfloat16, torch.float32
# flash at the served models' prefill (B=8, S=512, bf16, causal, ragged):
# Llama-3-8B, Zamba2's shared block (window 8192), Qwen2.5-7B (G=7),
# Granite-20B (G=48), MiniCPM-2B (MHA, hd=64), Yi-34B (G=7); decode at their
# caches (B=8, Sc=576), with the split sweep at the first two
SERVE_FLASH = tuple((8, 512, H, KV, hd, bf16, SERVE_LENS, w, "")
                    for H, KV, hd, w in ((32, 8, 128, 0), (32, 32, 64, 8192), (28, 4, 128, 0),
                                         (48, 1, 128, 0), (36, 36, 64, 0), (56, 8, 128, 0)))
SERVE_DECODE = tuple((8, 576, H, KV, hd, bf16, DECODE_SERVE_LENS, "", SWEEP if i < 2 else ())
                     for i, (H, KV, hd) in enumerate(((32, 8, 128), (32, 32, 64), (28, 4, 128),
                                                      (48, 1, 128), (36, 36, 64), (56, 8, 128))))
# fp32 at the online phase (bench_online: tiny-lm's H=4 on KV=2, hd=32, 48
# prompts of 6 tokens, every key valid; decode on 6 + 80 slots, lengths
# drawn from the generator): the SIMT kernels, not the wgmma ones
ONLINE_FLASH = (48, 6, 4, 2, 32, fp32, (6,) * 48, 0, "bench_online")
# the scan at Zamba2's prefill (H=64, N=64), Mamba2-130M's (H=24, N=128) and
# a ragged S=509, bf16 x, B and C as the models give them, dt = softplus(randn),
# a = -decay dt; decay 0.01 at both widths, where the state carried across
# chunks is most of y (with a = -dt, exp(cum_i) hides it after a few rows of
# each chunk): (B, S, H, P, N, decay)
SCAN_SHAPES = ((8, 512, 64, 64, 64, 1.0), (8, 512, 24, 64, 128, 1.0), (8, 509, 64, 64, 64, 1.0),
               (8, 509, 64, 64, 64, 0.01), (8, 509, 24, 64, 128, 0.01))


def kernel_checks():
    """Phase 3: every kernel against its plain version at the serving shapes
    (the tables above), through ``bench_kernels.measure``: held (its
    tolerance or criterion, a second call bit-identical, two launches, the
    library yardstick agreeing), timed beside its plain version and the
    library call, against its bound; then the fp32 scan against fp64
    (``scan_against_fp64``)."""
    from repro_torch.core.bins import make_edges
    from repro_torch.data import make_scenario
    from repro_torch.launch.table1 import scenario_pcfg
    from repro_torch.serving.arrivals import TraceConfig, make_trace

    g = torch.Generator(device="cuda").manual_seed(0)
    levels = torch.tensor([0.5, 0.9, 0.99], device="cuda")
    cases = []
    for B, d, K in HEAD_SHAPES:
        w = head_weights(g, d, 512, K)
        edges = torch.linspace(0.0, 600.0, K + 1, device="cuda")
        cases.append(bk.prod_head(randn(g, B, d), *w, edges, levels, cold=(B, d) == (8, 4096)))
    edges = make_edges(32, 4096.0, "log", device="cuda")
    trace_phi = np.stack([r.phi for r in make_trace(TraceConfig(n_requests=512, seed=0))])
    for B, hidden, lv in TRACE_HEAD_SHAPES:
        phi = torch.from_numpy(trace_phi[:B].astype(np.float32)).cuda()
        args = (phi, *head_weights(g, 4, hidden, 32), edges)
        lv = torch.tensor(lv, device="cuda")
        cases.append(bk.prod_head(*args, lv, label="log edges", criterion=quantiles_in_cdf(
            f"B={B} d=4 hidden={hidden}", args, lv)))
    data = make_scenario("qwen", "chat", n_train=800, n_test=400, seed=0)
    phi = torch.from_numpy(data.phi_test["last"].astype(np.float32)).cuda()
    for K, spacing in BINS_SHAPES:
        edges = make_edges(K, scenario_pcfg(data, n_bins=K).bin_max, spacing, device="cuda")
        args = (phi, *head_weights(g, phi.shape[1], 512, K), edges)
        cases.append(bk.prod_head(*args, levels, label=f"{spacing} edges", criterion=(
            quantiles_in_cdf(f"B={phi.shape[0]} d={phi.shape[1]} K={K} {spacing} edges",
                             args, levels))))
    cases += [flash_case(g, *s) for s in SERVE_FLASH]
    cases += [decode_case(g, *s) for s in SERVE_DECODE]
    cases.append(flash_case(g, *ONLINE_FLASH))
    online_lens = torch.randint(1, 87, (48,), generator=g, device="cuda", dtype=torch.int32)
    cases.append(decode_case(g, 48, 86, 4, 2, 32, fp32, online_lens, "bench_online"))
    for B, S, H, P, N, decay in SCAN_SHAPES:
        x = randn(g, B, S, H, P, dtype=bf16)
        dt = F.softplus(randn(g, B, S, H))
        cases.append(bk.ssd_scan(x, dt, -decay * dt, randn(g, B, S, N, dtype=bf16),
                                 randn(g, B, S, N, dtype=bf16),
                                 label=f"a=-{decay}dt" if decay != 1 else ""))
    rows = bk.measure(cases)
    scan_against_fp64()
    return rows


def scan_against_fp64():
    """The fp32 scan with no decay (a = 0): the state grows over the whole
    sequence and |y| reaches ~900, where two fp32 summation orders differ by
    more than 2e-4; y is held against an fp64 recurrence at 2e-4 (h against
    the plain version), as tests/test_torch_kernels_gpu.py's
    test_ssd_scan_no_decay does, on its inputs (numpy seed 7). Printed: the
    kernel's and the plain version's largest error against fp64, and the
    largest share of the tolerance the kernel uses."""
    for S in (65, 509):
        B, H, P, N = 2, 64, 64, 64
        rng = np.random.default_rng(7)    # drawn in the test's order
        dtn = np.log1p(np.exp(rng.standard_normal((B, S, H))))
        a = 0.0 * dtn * np.exp(0.3 * rng.standard_normal(H))
        f32 = lambda v: torch.from_numpy(v.astype(np.float32)).cuda()
        args = (f32(rng.standard_normal((B, S, H, P))), f32(dtn), f32(a),
                f32(rng.standard_normal((B, S, N))), f32(rng.standard_normal((B, S, N))))
        y, h = ops.ssd_scan(*args)
        y_plain, h_plain = ref.ssd_scan_ref(*args)
        y_exact = ssd_fp64(*args)
        err = (y.double() - y_exact).abs()
        share = float((err / (2e-4 + 2e-4 * y_exact.abs())).max())
        print(f"ssd_scan B={B} S={S} H={H} P={P} N={N} fp32 a=0 against fp64: kernel y "
              f"max|err| {float(err.max()):.3g}, plain version "
              f"{float((y_plain.double() - y_exact).abs().max()):.3g} at max|y| "
              f"{float(y_exact.abs().max()):.4g}; the kernel uses {100 * share:.1f}% of the "
              f"2e-4 tolerance; h against the plain version {max_err(h, h_plain):.3g}")
        check(share <= 1.0, f"ssd_scan fp32 a=0 S={S}: y off the fp64 recurrence")
        if S == 65:
            # its sums run in blocks of 16 terms: as close to fp64 as the plain version
            check(float(err.max()) <= 1.5 * float((y_plain.double() - y_exact).abs().max()),
                  "ssd_scan fp32 a=0 S=65: more than 1.5x the plain version's error")
        check(torch.allclose(h, h_plain, rtol=2e-4, atol=2e-4),
              f"ssd_scan fp32 a=0 S={S}: h max err {max_err(h, h_plain)}")


def width_checks(flash_rows, decode_rows, seed: int):
    """Both attention kernels at a model's heads (``flash_case`` and
    ``decode_case`` rows, drawn from ``seed``, flash first) through
    ``bench_kernels.measure``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return bk.measure([flash_case(g, *s) for s in flash_rows]
                      + [decode_case(g, *s) for s in decode_rows])


def gemma3_kernel_checks():
    """Phase 3, Gemma3-27B's head width (hd=168, 32 query heads on 16 KV
    heads): flash at the serve phases' B=8, S=512; at B=4, S=1,100 with the
    1,024-key window (a 20-token row whose padded queries past 1,044 have no
    valid key); decode at B=8, Sc=576 (G=2, with the split sweep) and on
    1,024-slot rings; fp32 flash and decode at a small shape. The kernel's
    tiles are 192 columns wide: 14% more P.V work than the bound counts."""
    H, KV, hd = 32, 16, 168
    flash = [(8, 512, H, KV, hd, bf16, SERVE_LENS, 0, "gemma3 serve"),
             (4, 1100, H, KV, hd, bf16, (1100, 1030, 900, 20), 1024, "gemma3 window"),
             (2, 128, 4, 2, hd, fp32, (128, 77), 0, "fp32")]
    decode = [(8, 576, H, KV, hd, bf16, DECODE_SERVE_LENS, "gemma3 serve", WIDE_SWEEP),
              (4, 1024, H, KV, hd, bf16, (1024, 1024, 1024, 577), "gemma3 ring"),
              (4, 100, 4, 2, hd, fp32, (100, 1, 57, 33), "fp32")]
    return width_checks(flash, decode, seed=19)


def moe_kernel_checks():
    """Phase 3, the MoE configs' heads: Qwen3-MoE (64 query heads on 4 KV
    heads, hd=64, G=16: decode in 2 head tiles of 8) and Kimi-K2 (64 on 8,
    hd=112: flash tiles of 128 columns, 14% more P.V work than the bound
    counts; decode 8-lane rows with 7 lanes of 16 channels, 2 head tiles of
    4), flash at the serve phases' B=8, S=512 and decode at B=8, Sc=576, in
    bf16 (Kimi's decode with the split sweep); fp32 flash and decode at
    hd=112 at a small shape."""
    flash = [(8, 512, 64, 4, 64, bf16, SERVE_LENS, 0, "qwen3-moe serve"),
             (8, 512, 64, 8, 112, bf16, SERVE_LENS, 0, "kimi serve"),
             (2, 128, 8, 1, 112, fp32, (128, 77), 0, "fp32")]
    decode = [(8, 576, 64, 4, 64, bf16, DECODE_SERVE_LENS, "qwen3-moe serve"),
              (8, 576, 64, 8, 112, bf16, DECODE_SERVE_LENS, "kimi serve", WIDE_SWEEP),
              (4, 100, 8, 1, 112, fp32, (100, 1, 57, 33), "fp32")]
    return width_checks(flash, decode, seed=20)


# an admit batch of Kimi-K2-Instruct's cell at its widest: 8 prompts padded
# to 2,048, lognormal lengths (median 512) from 64 to 2,048
KIMI_ADMIT_LENS = (2048, 1530, 977, 731, 512, 389, 202, 64)


def kimi_k2_instruct(depth: int):
    """Kimi-K2-Instruct as its ``config.json`` publishes it, as the
    benchmark holds it (``perfbench/configs/kimi-k2-instruct.json``, read
    through ``perfbench/arch/mla.py``): latent attention, the sigmoid router
    over 384 experts with its bias and scale, a shared expert, the dense
    first layer and YaRN, holding one expert-parallel rank's block of 12
    experts; cut to ``depth`` layers."""
    sys.path.insert(0, str(ROOT / "perfbench"))
    from harness import common

    from repro_torch.common.config import ModelConfig

    md = common.arch("mla").describe(common.config("kimi-k2-instruct"))
    return ModelConfig(**md).with_overrides(n_layers=depth)


def mla_kernel_checks():
    """Phase 3, Kimi-K2-Instruct's latent attention at prefill
    (``models/mla.py``): the flash kernel with Q and K of 192 columns (128
    nope + 64 rope), V and O of 128, 64 heads (K and V expanded a head
    each, so H = KV) and YaRN's softmax scale (0.13086), in bf16, at the
    admit cell's widest batch (B=8, S=2,048, ``KIMI_ADMIT_LENS``) and at
    B=8, S=512 with the serve phases' ragged lengths; SDPA timed beside it
    with the same scale and the narrower V. No decode row: the absorbed
    decode is batched products."""
    from repro_torch.models import mla

    scale = mla.softmax_scale(kimi_k2_instruct(2))
    flash = [(8, 2048, 64, 64, 192, bf16, KIMI_ADMIT_LENS, 0, "kimi-k2-instruct admit", True,
              None, 128, scale),
             (8, 512, 64, 64, 192, bf16, SERVE_LENS, 0, "kimi-k2-instruct serve", True,
              None, 128, scale)]
    return width_checks(flash, [], seed=32)


def mla_phase(counters):
    """Phase 4 for Kimi-K2-Instruct (``kimi_k2_instruct``) at its published
    widths, cut to the dense layer and one MoE layer, on the main path
    (``build_model`` -> ``RealEngine.repeated_sampling``) at the admit
    cell's widest batch (B=8, S=2,048, ``KIMI_ADMIT_LENS``), r=1, 16 new
    tokens: each prefill launches the flash kernel once a layer, with q and
    k of 192 columns, v of 128, the prompt lengths and YaRN's scale; the
    absorbed decode launches no attention kernel; the unembed one a token.
    The first layer's flash call is held on its own inputs against the plain
    version (within 2e-2 of sum p|v|, as the long phase holds V as served), a
    second call bit-identical. A prefill and a decode step are timed."""
    from repro_torch.models import mla
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving.engine import RealEngine

    dev = torch.device("cuda")
    cfg = kimi_k2_instruct(2)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device=dev)
    n_params = sum(int(p.numel()) for p in _leaves(params))
    B, Sp, r, max_new = 8, 2048, 1, 16
    g = torch.Generator().manual_seed(32)
    prompts = torch.randint(3, cfg.vocab_size, (B, Sp), generator=g).numpy()
    plens = np.array(KIMI_ADMIT_LENS)
    eng = RealEngine(model, params, max_new=max_new)
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with capture(ops, "flash_attention") as fl:
        lens, phi = eng.repeated_sampling(prompts, plens, r=r, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    check(phi.shape == (B, cfg.d_model) and np.isfinite(phi).all(),
          "kimi-k2-instruct: phi shape/finite")
    check(lens.min() >= 1 and lens.max() <= max_new, "kimi-k2-instruct: lengths range")
    expect = {"flash_attention": r * cfg.n_layers, "decode_attention": 0, "ssd_scan": 0,
              "prod_head": 0}
    if lens.min() == max_new:
        expect["unembed"] = r * (max_new + 1)
        expect.update(norm_rope_launches(cfg, r * (max_new + 1)))
    for k, n in expect.items():
        check(launches[k] == n, f"kimi-k2-instruct: {k} launched {launches[k]} times, "
              f"expected {n}")
    for k in ("unembed", "rms_norm", "rope"):
        check(launches[k] > 0, f"kimi-k2-instruct: {k} was not launched")

    (q, k, v), kw = fl.args, fl.kwargs
    scale = mla.softmax_scale(cfg)
    check(q.shape == (B, Sp, 64, 192) and k.shape == (B, Sp, 64, 192)
          and v.shape == (B, Sp, 64, 128), f"kimi-k2-instruct: flash took q {tuple(q.shape)} "
          f"k {tuple(k.shape)} v {tuple(v.shape)}")
    check(kw["scale"] == scale and abs(scale - 0.13086) < 5e-6,
          f"kimi-k2-instruct: flash scale {kw['scale']}, want {scale}")
    check(kw["kv_lengths"].tolist() == list(KIMI_ADMIT_LENS),
          f"kimi-k2-instruct: flash kv_lengths {kw['kv_lengths'].tolist()}")
    call = lambda: counters["flash_attention"](q, k, v, causal=True,
                                               kv_lengths=kw["kv_lengths"], scale=scale)
    out, again = call(), call()
    want = ref.flash_attention_ref(q, k, v, causal=True, kv_lengths=kw["kv_lengths"],
                                   scale=scale)
    mag = ref.flash_attention_ref(q, k, v.abs(), causal=True, kv_lengths=kw["kv_lengths"],
                                  scale=scale)
    torch.cuda.synchronize()
    worst, beyond = held(out, want, mag)
    check(beyond == 0, f"kimi-k2-instruct: layer 0's flash call {worst:.3f} x 2e-2 of "
          f"sum p|v| from the plain version ({beyond} elements beyond)")
    check(torch.equal(out, again), "kimi-k2-instruct: layer 0's flash call, two calls differ")

    tokens = torch.as_tensor(prompts, device=dev)
    valid = torch.arange(Sp, device=dev)[None, :] < torch.as_tensor(plens, device=dev)[:, None]
    with torch.no_grad():
        prefill_ms = time_ms(lambda: model.prefill(params, tokens, attn_valid=valid,
                                                   logits_mode="none"), iters=3, warmup=1)
        cache = model.init_cache(B, Sp + max_new, device=dev)
        check(tuple(cache[0][0].shape) == (B, Sp + max_new, 576),
              f"kimi-k2-instruct: latent cache entry {tuple(cache[0][0].shape)}")
        pos = torch.as_tensor(plens, dtype=torch.int32, device=dev)
        nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
        step_ms = time_ms(lambda: model.decode_step(params, nxt, cache, pos, pos + 1),
                          iters=10, warmup=2)
    print(f"kimi-k2-instruct: {n_params / 1e9:.3f}B params (bf16, the dense layer and one MoE "
          f"layer of 12 held experts of 384, published widths); repeated_sampling B={B} "
          f"Sp={Sp} r={r} max_new={max_new}: {gen_s:.2f} s (param_count() "
          f"{cfg.param_count() / 1e9:.3f}B, without the norms and the router bias); flash q/k 192, v 128, scale "
          f"{scale:.6f}, held at {worst:.3f} x 2e-2 of sum p|v|; prefill {prefill_ms:.2f} ms, "
          f"decode step (Sc={Sp + max_new}) {step_ms:.2f} ms; launches {json.dumps(launches)}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches


WHISPER_PLENS = (224, 32, 181, 97, 212, 64, 150, 129)     # decoder prompts, padded to 224


def encdec_vlm_kernel_checks():
    """Phase 3, the shapes Whisper-large-v3 (20 heads of 64, MHA) and
    Qwen2-VL-2B (12 query heads on 2 KV heads of 128, G=6) give the
    attention kernels, all bf16 at B=8: flash over Whisper's encoder
    (non-causal, 1,500 frames, every key valid), its decoder's causal
    self-attention over the prompts (S=224, ragged) and its cross-attention
    (non-causal, Sq=224 against the 1,500 encoder keys: the last query tile
    holds 96 rows and the last key tile 92 keys), and Qwen2-VL's causal
    prefill (S=512, ragged); decode on Whisper's self cache (Sc=288,
    ragged), on its static cross cache (Sc=1,500, every key valid) and at
    Qwen2-VL's G=6, padded to a head tile of 8 (Sc=576, with the split
    sweep)."""
    enc = (1500,) * 8
    flash = [(8, 1500, 20, 20, 64, bf16, enc, 0, "whisper encoder", False),
             (8, 224, 20, 20, 64, bf16, WHISPER_PLENS, 0, "whisper decoder self"),
             (8, 224, 20, 20, 64, bf16, enc, 0, "whisper cross", False, 1500),
             (8, 512, 12, 2, 128, bf16, SERVE_LENS, 0, "qwen2-vl serve")]
    decode = [(8, 288, 20, 20, 64, bf16, tuple(n + 64 for n in WHISPER_PLENS), "whisper self"),
              (8, 1500, 20, 20, 64, bf16, enc, "whisper cross"),
              (8, 576, 12, 2, 128, bf16, DECODE_SERVE_LENS, "qwen2-vl serve", WIDE_SWEEP)]
    return width_checks(flash, decode, seed=22)


# the unembed's shapes on the main path: (label, d, V, tied, rows). Every
# served bf16 model at B=8 (a serve phase's batch, the admit cells' batch);
# B=4, the long phases'; the collect cells' 512 rows (64 prompts x r=8).
# Whisper's decoder unembeds by its embedding table (tied).
UNEMBED_SHAPES = (
    ("llama3-8b", 4096, 128256, False, (8,)), ("qwen2.5-7b", 3584, 152064, False, (8, 512)),
    ("granite-20b", 6144, 49152, False, (8,)), ("minicpm-2b", 2304, 122753, True, (8,)),
    ("yi-34b", 7168, 64000, False, (8,)), ("gemma3-27b", 5376, 262144, True, (4, 8)),
    ("qwen3-moe-235b-a22b", 4096, 151936, False, (8, 512)),
    ("kimi-k2-1t-a32b", 7168, 163840, False, (8,)), ("qwen2-vl-2b", 1536, 151936, True, (8,)),
    ("zamba2-1.2b", 2048, 32000, False, (4, 8)), ("mamba2-130m", 768, 50280, True, (8,)),
    ("whisper-large-v3", 1280, 51866, True, (8,)))


def unembed_kernel_checks():
    """Phase 3, the unembed kernel at the main path's shapes
    (``UNEMBED_SHAPES``, ``bench_kernels.unembed``), bf16 x (unit normal)
    and head (an untied head at its init scale d^-0.5, a tied table at
    0.02, seen as ``embed.T``); the ``gpu`` tests of
    ``tests/test_torch_unembed.py`` hold the kernel's error against fp64
    within twice the fp32 product's."""
    g = torch.Generator(device="cuda").manual_seed(23)
    cases = []
    for label, d, vocab, tied, ms in UNEMBED_SHAPES:
        w = ((randn(g, vocab, d) * 0.02).to(bf16).T if tied
             else (randn(g, d, vocab) * d ** -0.5).to(bf16))
        cases += [bk.unembed(randn(g, m, d, dtype=bf16), w, label=label) for m in ms]
    rows = bk.measure(cases)
    del cases
    torch.cuda.empty_cache()
    return rows


# the norms and rotations of the admit cells' widest batch (8 x 2,048 rows):
# (label, rows' leading shape, width, stored width) and (label, heads, hd,
# stored hd, first rotated column, rope theta); None heads is kv[..., None, R:]
NORM_SHAPES = (("qwen2.5-7b ln", (), 3584, 3584), ("qwen3-moe ln", (), 4096, 4096),
               ("kimi-k2 ln", (), 7168, 7168), ("qwen3-moe q_norm", (64,), 128, 128),
               ("qwen3-moe k_norm", (4,), 128, 128), ("kimi-k2 q latent", (), 1536, 1536),
               ("kimi-k2 kv latent", (), 512, 576))
ROPE_SHAPES = (("qwen2.5-7b q", 28, 128, 128, 0, 1e6), ("qwen2.5-7b k", 4, 128, 128, 0, 1e6),
               ("qwen3-moe q", 64, 128, 128, 0, 1e6), ("kimi-k2 q_pe", 64, 64, 192, 128, 5e4),
               ("kimi-k2 k_pe", None, 64, 576, 512, 5e4))


def norm_rope_kernel_checks(batch=8, seq=2048):
    """Phase 3, the RMSNorm and RoPE kernels (``rms_norm_sm90``,
    ``rope_sm90``) at the admit cells' widest batch, bf16, views read in
    place as the models pass them (``NORM_SHAPES``, ``ROPE_SHAPES``), x
    unit normal x 2, the norm's scale x 0.1 (``tests/test_torch_norm_rope.py``
    holds the same criterion at more widths, and against fp64)."""
    from repro_torch.models.rope import rope_angles

    g = torch.Generator(device="cuda").manual_seed(29)
    cases = []
    for label, lead, d, stored in NORM_SHAPES:
        x = (randn(g, batch * seq, *lead, stored) * 2).to(bf16)[..., :d]
        shape = (f"{batch}x{seq} rows x {lead[0]} heads of {d}" if lead else
                 f"{batch}x{seq} rows of {d}" + (f" (stride {stored})" if stored != d else ""))
        cases.append(bk.rms_norm(x, (randn(g, d) * 0.1).to(bf16), 1e-6,
                                 shape=f"{shape} ({label})"))
    pos = (torch.arange(seq, device="cuda") + 250)[None].expand(batch, seq)
    for label, H, hd, stored, lo, theta in ROPE_SHAPES:
        x = (randn(g, batch, seq, stored, dtype=bf16)[..., None, lo:] if H is None
             else randn(g, batch, seq, H, stored, dtype=bf16)[..., lo:])
        cases.append(bk.rope(x, rope_angles(pos, hd, theta), label=label))
    rows = bk.measure(cases)
    del cases
    torch.cuda.empty_cache()
    return rows


# each kernel of _build.KERNEL_SOURCES (its source csrc/<name>.cu): the JAX
# code it replaces, a TPU kernel under src/repro/kernels/ or, where the
# reference has none, its plain jnp (the reference's kernel bench has rows of
# the TPU kernels only)
REPLACES = {"prod_head": "src/repro/kernels/prod_head.py:61",
            "flash_attention": "src/repro/kernels/flash_attention.py:69",
            "decode_attention": "src/repro/kernels/decode_attention.py:64",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:61",
            "unembed": "src/repro/models/layers.py:135-138",
            "rms_norm": "src/repro/models/layers.py:83-88",
            "rope": "src/repro/models/rope.py:49-56"}


def ports_tpu_kernel(name: str) -> bool:
    return REPLACES[name].startswith("src/repro/kernels/")


def run_phase(counters):
    """Phase 3b: the benchmark runner (``launch/run.py``) in this process on
    its ``kernels`` and ``theory`` entries, its CSV rows printed. The
    counts are set to 0 before it and read after: each kernel is launched 23
    times (3 warm-up and 20 timed calls of its reference row). The theory
    booleans must be True, as the reference's are. Then ``bench_kernels.measure``
    holds each kernel against its plain version at the reference's shapes
    (it raises outside the tolerance) and times it, its plain version 3
    times, beside the library call; these launches are not counted. Returns
    the launches and measure's rows."""
    from repro_torch.launch import run

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    csv = run.main(["--only", "kernels,theory"])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"run: launches {json.dumps(launches)}")
    values = {name: value for name, value, _ in csv}
    theory = {n: v for n, v in values.items() if n.startswith("theory_") and
              n != "theory_lemma3_worst_ratio"}
    check(len(theory) == 4 and all(str(v) == "True" for v in theory.values()),
          f"run: theory booleans {theory}, the reference's are all True")
    rows = bk.measure(bk.cases())
    # the reference's kernel bench times the four TPU kernels; the unembed,
    # the norm and the rotation, which replace none, are not among them and
    # must not launch here
    ported = sorted(k for k in counters if ports_tpu_kernel(k))
    check(sorted(r["name"] for r in rows) == ported,
          f"run: measure gave the kernels {[r['name'] for r in rows]}")
    for k in (k for k in counters if not ports_tpu_kernel(k)):
        check(launches[k] == 0, f"run: {k} launched off its path")
    for r in rows:
        check(r["row"] in values, f"run: no {r['row']} row")
        check(launches[r["name"]] == 23,
              f"run: {r['name']} launched {launches[r['name']]} times, expected 23")
    return launches, rows


# each served model: generations per prompt, the kernels its path runs,
# whether one prefill and one decode step are profiled, and the depth it is
# cut to (None: its full depth)
DENSE = ("flash_attention", "decode_attention", "prod_head", "unembed", "rms_norm", "rope")
SERVE_PHASES = (
    ("llama3-8b", 4, DENSE, True, None),
    ("zamba2-1.2b", 4, ("ssd_scan", "flash_attention", "decode_attention", "prod_head",
                        "unembed", "rms_norm", "rope"), True, None),
    ("mamba2-130m", 2, ("ssd_scan", "prod_head", "unembed", "rms_norm"), True, None),
    ("qwen2.5-7b", 4, DENSE, True, None),
    ("granite-20b", 2, DENSE, False, None),
    ("minicpm-2b", 2, DENSE, False, None),
    ("yi-34b", 2, DENSE, True, None),
    ("gemma3-27b", 2, DENSE, True, None),
    # the MoE family at full width, cut to what one 80 GB card holds:
    # 12 of 94 layers (61.34 GB of bf16 weights) and 1 of 61 (38.85 GB; its
    # init peaks near 61 GB, drawing a 22.5 GB fp32 expert tensor)
    ("qwen3-moe-235b-a22b", 2, DENSE, True, 12),
    ("kimi-k2-1t-a32b", 2, DENSE, True, 1),
    # on text tokens, where its three M-RoPE streams are equal
    ("qwen2-vl-2b", 2, DENSE, True, None),
)


def norm_rope_launches(cfg, passes: int):
    """The norm's and the rotation's launches in ``passes`` prefills and
    decode steps: a pass norms each SSM layer twice (ln1 and the gated
    norm), each attention layer's ln1 and ln2 (and q and k with
    ``qk_norm``, the q and kv latents in MLA) and the final hidden state
    once, and rotates each attention layer's q and k."""
    from repro_torch.models.transformer import layer_kinds

    kinds = layer_kinds(cfg)
    n_ssm = sum(k == "ssm" for k in kinds)
    n_attn = len(kinds) - n_ssm
    per_attn = 4 if cfg.qk_norm or cfg.kv_lora_rank else 2
    return {"rms_norm": passes * (2 * n_ssm + per_attn * n_attn + 1),
            "rope": passes * 2 * n_attn}


def expected_launches(cfg, r: int, max_new: int):
    """Launches of each kernel when every row of every generation runs to
    max_new (with random weights EOS is rare): one scan per SSM layer and
    one flash call per attention layer (a ``moe`` layer is one: attention,
    then the experts) in each prefill, one decode call per attention layer
    in each of the max_new steps, two head calls, one unembed (bf16) for
    each generation's first token and one in each of its max_new steps, and
    the norms and rotations of its prefill and max_new steps."""
    from repro_torch.models.transformer import layer_kinds

    kinds = layer_kinds(cfg)
    n_attn = sum(k != "ssm" for k in kinds)
    return {"ssd_scan": r * sum(k == "ssm" for k in kinds), "flash_attention": r * n_attn,
            "decode_attention": r * max_new * n_attn, "prod_head": 2,
            "unembed": r * (max_new + 1), **norm_rope_launches(cfg, r * (max_new + 1))}


def model_bounds(cfg, kinds, n_params: int, B: int, Sp: int, cache_len: int,
                 n_keys: int = 0, experts_read=None):
    """Least times of one prefill and one decode step of the served model.
    Prefill: the weight products alone (2 FLOPs per weight applied per
    token; attention scores and the scan left out) at the bf16 peak; a MoE
    layer applies its attention, its k routed experts, its shared experts
    and its router to each token. Decode step: every weight read once (the
    shared block once, an untied embedding table only at its B rows), the
    SSM states read and written in fp32 and the K/V read, over the memory
    rate: ``n_keys`` keys a layer (summed over the rows), or all B x
    cache_len slots. A MoE layer's experts are all read (what the capacity
    design reads) unless ``experts_read`` says how many the step's tokens
    routed to, over all MoE layers: then only those."""
    d, hd = cfg.d_model, cfg.head_dim
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    ssm_w = d * (2 * H * P + 2 * N + H) + H * P * d
    attn_w = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    expert_w = 3 * d * cfg.moe_d_ff
    per_kind = {"ssm": ssm_w,
                "moe": attn_w + (cfg.n_experts_per_token + cfg.n_shared_experts) * expert_w
                + d * cfg.n_experts}
    applied = sum(per_kind.get(k, attn_w + 3 * d * cfg.d_ff) for k in kinds)
    prefill_flops = 2 * B * Sp * applied
    weights = n_params - (0 if cfg.tie_embeddings else cfg.vocab_size * d)
    if experts_read is not None:
        weights -= (sum(k == "moe" for k in kinds) * cfg.n_experts - experts_read) * expert_w
    n_ssm = sum(k == "ssm" for k in kinds)
    n_attn = len(kinds) - n_ssm
    step_bytes = (2 * weights + n_ssm * 2 * 4 * B * H * P * N
                  + n_attn * 2 * 2 * (n_keys or B * cache_len) * cfg.n_kv_heads * hd)
    return (prefill_flops, prefill_flops / BF16_FLOPS * 1e3,
            step_bytes, step_bytes / HBM_BYTES_PER_S * 1e3)


def served_prompts(vocab: int):
    """The serve phases' traffic: 8 prompts of 256-512 random tokens,
    right-padded to 512."""
    rng = np.random.default_rng(0)
    plens = np.array([512, 300, 257, 480, 399, 511, 266, 448])
    prompts = np.zeros((len(plens), 512), np.int64)
    for i, n in enumerate(plens):
        prompts[i, :n] = rng.integers(3, vocab, size=n)
    return prompts, plens


class routing:
    """Within the block, ``models/moe.py``'s ``_dispatch`` records, per call
    (one per MoE layer), its capacity, how many (token, j) pairs each expert
    was given and which pairs were dropped (on the host; for the report
    only, outside every timed call)."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.orig = self.moe._dispatch

        def rec(local_ids, combine_w, E_local, capacity):
            out = self.orig(local_ids, combine_w, E_local, capacity)
            self.calls.append({
                "cap": capacity,
                # an expert-parallel shard's "not mine" id E_local is counted
                # apart and left out
                "counts": self.moe._counts(local_ids.reshape(-1), E_local + 1)[:E_local].cpu(),
                "dropped": (out[3] == E_local * capacity).cpu()})
            return out

        self.moe._dispatch = rec
        return self

    def __exit__(self, *exc):
        self.moe._dispatch = self.orig


def report_routing(name: str, prefill_calls, step_calls, plens, Sp: int):
    """Per MoE layer at the prefill: the capacity, the pairs dropped (and of
    them, those of real tokens: the rest are pads, which route too), and
    the experts no pair went to; at the decode step, the distinct experts
    routed. Returns the experts the step routed to, summed over layers."""
    real = (np.arange(len(plens) * Sp) % Sp) < np.repeat(plens, Sp)
    for i, c in enumerate(prefill_calls):
        dropped = c["dropped"].numpy()
        print(f"serve {name}: prefill layer {i}: capacity {c['cap']} slots an expert "
              f"({c['counts'].numel()} experts, {dropped.size} (token, j) pairs), "
              f"{int(dropped.sum())} pairs dropped ({int(dropped[real].sum())} of real tokens, "
              f"{int(dropped[real].any(axis=1).sum())} real tokens lost one or more), "
              f"{int((c['counts'] == 0).sum())} experts with no token, busiest expert "
              f"{int(c['counts'].max())} pairs")
    routed = [int((c["counts"] > 0).sum()) for c in step_calls]
    drops = sum(int(c["dropped"].sum()) for c in step_calls)
    print(f"serve {name}: decode step: distinct experts routed per layer {routed} (capacity "
          f"{step_calls[0]['cap']}, {drops} pairs dropped)")
    return sum(routed)


def serve(counters, name: str, r: int, kernels_on_path, sweep: bool, profile: bool,
          depth=None):
    """Phase 4 for one model: the port's main path at full width, at full
    depth or cut to ``depth`` layers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import fit_and_predict
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serving.engine import RealEngine

    from repro_torch.models import moe

    dev = torch.device("cuda")
    cfg = get_config(name)                   # each model in its own dtype (bf16)
    if depth:
        print(f"serve {name}: depth cut to {depth} of {cfg.n_layers} layers "
              f"(param_count() {cfg.param_count() / 1e9:.2f} B at full depth, "
              f"{cfg.with_overrides(n_layers=depth).param_count() / 1e9:.2f} B at {depth}); "
              f"widths as published")
        cfg = cfg.with_overrides(n_layers=depth)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    params_bytes = torch.cuda.memory_allocated() - mem0
    n_params = sum(int(p.numel()) for p in _leaves(params))
    kinds = layer_kinds(cfg)
    print(f"serve {name}: {n_params / 1e9:.3f}B params ({cfg.dtype}, d={cfg.d_model}, "
          f"{sum(k == 'ssm' for k in kinds)} SSM + {sum(k != 'ssm' for k in kinds)} attention "
          f"layers, {sum(k == 'local' for k in kinds)} of them windowed, "
          f"{sum(k == 'moe' for k in kinds)} MoE) initialised in "
          f"{time.perf_counter() - t0:.1f} s; param_count() {cfg.param_count() / 1e9:.3f}B "
          f"(the reference's formula, which counts a gelu_gated MLP as two matrices)")

    B, Sp, max_new = 8, 512, 64
    prompts, plens = served_prompts(cfg.vocab_size)
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
    expect = expected_launches(cfg, r, max_new)
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
    print(f"serve {name}: launches on the main path {json.dumps(launches)}; expected with "
          f"every row at max_new {json.dumps({k: expect[k] for k in kernels_on_path})}")
    head_checks(counters["prod_head"], out["predictor"],
                torch.as_tensor(phi[B // 2:], dtype=torch.float32, device=dev), sweep=sweep)

    # per-call breakdown of one prefill and one decode step (not counted)
    tokens = torch.as_tensor(prompts, device=dev)
    valid = torch.arange(Sp, device=dev)[None, :] < torch.as_tensor(plens, device=dev)[:, None]
    with torch.no_grad():
        prefill = lambda: model.prefill(params, tokens, attn_valid=valid, logits_mode="none")
        prefill_ms = time_ms(prefill, iters=3, warmup=1)
        mem0 = torch.cuda.memory_allocated()
        cache = model.init_cache(B, Sp + max_new, device=dev)
        cache_bytes = torch.cuda.memory_allocated() - mem0
        pos = torch.as_tensor(plens, dtype=torch.int32, device=dev)
        nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
        step = lambda: model.decode_step(params, nxt, cache, pos, pos + 1)
        step_ms = time_ms(step, iters=10, warmup=2)
        flops, flops_ms, step_bytes, bytes_ms = model_bounds(cfg, kinds, n_params, B, Sp,
                                                             Sp + max_new)
        print(f"serve {name}: prefill (B={B}, S={Sp}) {prefill_ms:.2f} ms, bound "
              f"{flops_ms:.2f} ms ({flops / 1e12:.2f} TFLOP of weight products); decode step "
              f"(B={B}, Sc={Sp + max_new}) {step_ms:.2f} ms, bound {bytes_ms:.3f} ms "
              f"({step_bytes / 1e9:.2f} GB)")
        if name == "llama3-8b":
            mesh_checks(model, params_bytes, cache_bytes, B, Sp, Sp + max_new, flops)
        if cfg.family == "moe":
            with routing(moe) as pre:
                prefill()
            with routing(moe) as dec:
                step()
            read = report_routing(name, pre.calls, dec.calls, plens, Sp)
            _, _, routed_bytes, routed_ms = model_bounds(cfg, kinds, n_params, B, Sp,
                                                         Sp + max_new, experts_read=read)
            n_moe, ew = sum(k == "moe" for k in kinds), 3 * cfg.d_model * cfg.moe_d_ff
            slot_flops = 2 * sum(c["cap"] * c["counts"].numel() for c in pre.calls) * ew
            pair_flops = 2 * n_moe * B * Sp * cfg.n_experts_per_token * ew
            print(f"serve {name}: decode step bound {bytes_ms:.3f} ms with every expert read "
                  f"(the capacity design), {routed_ms:.3f} ms ({routed_bytes / 1e9:.2f} GB) "
                  f"with only the {read} experts this step routed to; prefill expert products "
                  f"over the capacity slots {slot_flops / 1e12:.2f} TFLOP, "
                  f"{slot_flops / pair_flops:.4f}x the routed pairs' {pair_flops / 1e12:.2f}")
        if profile:
            device_profile(prefill, f"{name} prefill")
            device_profile(step, f"{name} decode step")
    print(f"serve {name}: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated; weights {2 * n_params / 1e9:.2f} GB)")
    return launches


def cdf_at(v, p64, edges):
    """F(v) of the fp64 histogram p64 (B, K) over ``edges``, linear within a
    bin (the decode's own model): the CDF level that quantile value v has."""
    e = edges.double()
    K = p64.shape[-1]
    k = (torch.searchsorted(e, v.double().contiguous(), right=True) - 1).clamp(0, K - 1)
    prev = torch.cumsum(p64, -1) - p64
    t = ((v.double() - e[k]) / (e[k + 1] - e[k])).clamp(0.0, 1.0)
    return torch.gather(prev, -1, k) + torch.gather(p64, -1, k) * t


def hold_quantiles(label, quants, q_ref, levels, p64, edges):
    """The head's quantiles against the plain version's at its tolerance
    (rtol 1e-4, atol 1e-3). Where a log-spaced bin is ~940 tokens wide and
    the bin a level crosses holds a mass p_k of a few 1e-4 or less, the
    decode (q - cdf_prev) / p_k turns the ~1e-7 by which two fp32 CDFs
    differ into tenths of a token: no fp32 order meets the token tolerance
    there. An entry that misses it is held in the CDF instead: under the
    fp64 head, the kernel's value must sit at the level within 2e-6 (32
    fp32 steps of 1.0, the worst a 32-term fp32 cumsum drifts; the plain
    version's distance is printed beside it), and such entries must be
    under 1% of the batch's."""
    tol = 1e-3 + 1e-4 * q_ref.abs()
    miss = (quants - q_ref).abs() > tol
    n_miss = int(miss.sum())
    if not n_miss:
        return
    lv = levels.double()[None].expand_as(q_ref)
    k_err = (cdf_at(quants, p64, edges) - lv).abs()[miss]
    p_err = (cdf_at(q_ref, p64, edges) - lv).abs()[miss]
    e = edges.double()
    kk = (torch.searchsorted(e, q_ref.double().contiguous(), right=True) - 1).clamp(
        0, p64.shape[-1] - 1)
    mass = torch.gather(p64, -1, kk)[miss]
    print(f"prod_head {label}: {n_miss} of {q_ref.numel()} quantiles off the plain version's "
          f"by more than rtol 1e-4/atol 1e-3 (max {max_err(quants, q_ref):.4g} tokens, "
          f"crossing-bin mass {float(mass.min()):.3g}-{float(mass.max()):.3g}); in the CDF "
          f"under the fp64 head, kernel {float(k_err.max()):.3g}, plain {float(p_err.max()):.3g}")
    check(n_miss <= 0.01 * q_ref.numel() and float(k_err.max()) <= 2e-6,
          f"prod_head quantiles {label}: {n_miss} entries off the plain version, CDF error "
          f"{float(k_err.max()):.3g}")


def head_fp64(phi, w1, b1, w2, b2):
    """Logits and probs of the head in fp64: the exact answer that both fp32
    versions approximate."""
    f64 = torch.float64
    h = torch.relu(phi.to(f64) @ w1.to(f64) + b1.to(f64))
    logits = h @ w2.to(f64) + b2.to(f64)
    return logits, torch.softmax(logits, dim=-1)


def head_checks(prod_head, pred, phi, sweep: bool) -> None:
    """The head kernel against its plain version as the serve phase calls it:
    the trained weights, the served phi of the held-out half (B = n // 2 = 4
    rows, d of the served model), the median form (qs=None) and the quantile
    form (0.5, 0.9); same tolerance as the kernel phase. Then, with ``sweep``
    and outside the main path, how the disagreement grows with the logit
    scale at d=4096: synthetic weights with std c / sqrt(fan_in), each
    version held against the fp64 head."""
    dev = phi.device
    p = pred.params
    args = (phi, p["w1"], p["b1"], p["w2"], p["b2"], pred.edges)
    logits, p64 = head_fp64(*args[:5])
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
              f"max|kernel-plain| {max_err(probs, p_ref):.3g}, |kernel-fp64| "
              f"{max_err(probs, p64):.3g}, |plain-fp64| {max_err(p_ref, p64):.3g}; "
              f"quantiles max|kernel-plain| {max_err(quants, q_ref):.3g}")
        check(torch.allclose(probs, p_ref, rtol=1e-5, atol=1e-6),
              f"prod_head probs, trained weights, {form}: max err {max_err(probs, p_ref)}")
        check(torch.allclose(quants, q_ref, rtol=1e-4, atol=1e-3),
              f"prod_head quantiles, trained weights, {form}: max err "
              f"{max_err(quants, q_ref)}")
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
        logits, p64 = head_fp64(*sw)
        ok = torch.allclose(probs, p_ref, rtol=1e-5, atol=1e-6)
        print(f"head logit-scale sweep c={c:.4g}: logit std {float(logits.std()):.4g}; probs "
              f"max|kernel-plain| {max_err(probs, p_ref):.3g}, |kernel-fp64| "
              f"{max_err(probs, p64):.3g}, |plain-fp64| {max_err(p_ref, p64):.3g}; "
              f"within rtol 1e-5/atol 1e-6 of plain: {ok}")


def _counted(counters, what, fn, expect):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after: prod_head must have launched ``expect`` times and no other kernel
    at all. Returns (fn's result, launches, wall seconds)."""
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    print(f"{what}: {wall:.1f} s wall; launches {json.dumps(launches)}")
    check(launches["prod_head"] == expect,
          f"{what}: prod_head launched {launches['prod_head']}, expected {expect}")
    for k in set(counters) - {"prod_head"}:
        check(launches[k] == 0, f"{what}: kernel {k} launched off its path")
    return out, launches, wall


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


def table1_phase(counters):
    """Phase 5: the port's Table 1, fast profile (8 settings x 7 methods,
    every method training the shared head on the card; ProD-M and ProD-D
    decode the median through the head kernel on train and test phi). The
    claims must equal the reference's; each method's per-backbone average is
    printed beside the reference's."""
    from repro_torch.launch import table1

    # ProD-M and ProD-D predict train and test phi once each through the head, per setting
    out, launches, _ = _counted(counters, "table1",
                                lambda: table1.run(fast=True, seed=0, verbose=True,
                                                   device="cuda"), 2 * 2 * 8)
    rows = out["rows"]
    check(len(rows) == 7 and all(len(v) == 8 for v in rows.values())
          and all(math.isfinite(x) for v in rows.values() for x in v.values()),
          "table1: 56 finite test MAEs")
    print("table1: per-backbone average test MAE, port on the card [reference, difference]:")
    for method, ref_avg in TABLE1_REF_AVG.items():
        print(f"  {method:16s}" + "".join(
            f"  {model} {out['avg'][(method, model, 'avg')]:8.2f} [{want:.2f}, "
            f"{100 * (out['avg'][(method, model, 'avg')] / want - 1):+.2f}%]"
            for model, want in zip(("qwen", "llama"), ref_avg)))
    checks = out["checks"]
    print(f"table1: claims {json.dumps(checks)} (reference: {json.dumps(TABLE1_REF_CHECKS)}, "
          f"prod_beats_trail_last_pct {TABLE1_REF_PCT})")
    for k, v in TABLE1_REF_CHECKS.items():
        check(checks[k] == v, f"table1: claim {k} is {checks[k]}, the reference's is {v}")
    check(checks["prod_beats_trail_last_pct"] > 0, "table1: ProD-D does not beat TRAIL-last")

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
    device_profile(lambda: train_predictor(0, data.phi_train["last"], tgt, pcfg, edges,
                                                  device="cuda"),
                   "table1: one ProD-D fit (400 AdamW steps)")
    return launches, rows


def sim_phase(counters):
    """Phase 6: `--mode sim` with the reference's defaults (qwen/chat, 200
    requests, n_train 800, 20 epochs, 32 slots, KV budget 40,000, max_seq
    4096, arrival rate 2.0): a ProD-D head trained on the card, then four
    SimEngine policy runs, each annotating its 200 requests through the head."""
    from repro_torch.launch import serve as serve_launcher

    rows, launches, _ = _counted(counters, "sim",
                                 lambda: serve_launcher.main(["--mode", "sim", "--device", "cuda"]),
                                 4)
    by = {r["policy"]: r for r in rows}
    check(len(rows) == 4 and all(r["completed"] == 200 for r in rows),
          "sim: every request of every policy completes")
    sjf = by["sjf_pred+quantile"]["mean_latency"]
    check(sjf < by["fcfs+max"]["mean_latency"] and sjf < by["fcfs+quantile"]["mean_latency"],
          "sim: sjf_pred+quantile does not beat both fcfs rows on mean latency")
    return launches


# The reference's ablations of the paper at the fast profile, seed 0: the JAX
# package's benchmarks/bench_{bins_ablation,fig2,table23}.py, run on the CPU
# with JAX_PLATFORMS=cpu from the repository root with PYTHONPATH=src:.:
#   bench_bins_ablation.run(fast=True, seed=0), bench_fig2.run(fast=True, seed=0),
#   and bench_table23.run(fast=True, seed=0, n_trials=1) with all_settings cut
#   to qwen/math and qwen/chat, validated against bench_table1.run's rows.
# Their validate booleans, and beside them the test MAEs (tokens;
# platform-independent numbers) printed next to the port's.
ABLATION_REF_CHECKS = {
    "bins": {"qwen/chat_log_grid_robust": True, "qwen/math_log_grid_robust": True},
    "fig2": {"qwen/math_repeat_beats_full_coverage": True,
             "qwen/longseq_repeat_beats_full_coverage": True,
             "qwen/chat_repeat_beats_full_coverage": True,
             "llama/longseq_repeat_beats_full_coverage": True},
    "table23": {"prod_m_best_in_ablation": True, "single_eval_noisier_than_median_eval": True},
}
ABLATION_REF_NUMBERS = {
    "bins": {"qwen/chat_log_vs_linear_pct": 1.9, "qwen/math_log_vs_linear_pct": 1.4},
    "table23": {"mean_relative_degradation_pct": -0.2026, "max_relative_degradation_pct": -0.0118},
}
BINS_REF_MAE = {("qwen", "chat"): {("linear", 16): 273.07, ("linear", 64): 156.57,
                                   ("linear", 128): 152.19, ("log", 16): 150.66,
                                   ("log", 64): 149.53, ("log", 128): 149.31},
                ("qwen", "math"): {("linear", 16): 37.84, ("linear", 64): 36.98,
                                   ("linear", 128): 37.40, ("log", 16): 37.76,
                                   ("log", 64): 36.58, ("log", 128): 36.47}}
# Figure 2: each curve's mean MAE over the 2 trials, by repeat number k
FIG2_REF_MAE = {
    ("qwen", "math"): {"prod_m": {1: 40.61, 2: 40.74, 4: 51.89, 8: 56.66, 16: 72.36},
                       "prod_d": {2: 40.70, 4: 44.62, 8: 48.11, 16: 56.79},
                       "trail_last_full": {1: 41.73}},
    ("qwen", "longseq"): {"prod_m": {1: 98.82, 2: 101.66, 4: 118.81, 8: 142.95, 16: 183.18},
                          "prod_d": {2: 99.30, 4: 114.80, 8: 117.70, 16: 148.92},
                          "trail_last_full": {1: 100.41}},
    ("qwen", "chat"): {"prod_m": {1: 163.81, 2: 167.15, 4: 208.85, 8: 212.31, 16: 231.01},
                       "prod_d": {2: 160.28, 4: 182.58, 8: 198.37, 16: 215.29},
                       "trail_last_full": {1: 166.85}},
    ("llama", "longseq"): {"prod_m": {1: 82.76, 2: 84.74, 4: 97.10, 8: 111.32, 16: 130.68},
                           "prod_d": {2: 81.11, 4: 89.83, 8: 99.15, 16: 107.01},
                           "trail_last_full": {1: 86.16}},
}
# Tables 2-3 at one trial: (eval target, method) -> (qwen/math, qwen/chat)
T23_REF_MAE = {("single", "s3"): (104.31, 319.22), ("single", "trail_mean"): (76.53, 262.88),
               ("single", "trail_last"): (62.09, 155.82), ("single", "egtp"): (100.30, 403.82),
               ("single", "prod_m"): (60.63, 149.18), ("median", "s3"): (92.08, 312.25),
               ("median", "trail_mean"): (60.56, 261.00), ("median", "trail_last"): (41.81, 144.41),
               ("median", "egtp"): (92.16, 408.26), ("median", "prod_m"): (41.84, 135.88)}
T23_SETTINGS = (("qwen", "math"), ("qwen", "chat"))


def _same_booleans(what, checks, want):
    print(f"{what}: checks {json.dumps(checks)}")
    for k, v in want.items():
        check(checks[k] == v, f"{what}: {k} is {checks[k]}, the reference's is {v}")


def ablations_phase(counters, t1_rows):
    """The paper's ablations on the card at the fast profile: the bins
    ablation (12 fits, one median through the head each), Figure 2 (4
    scenarios x (10 ProD-M + 8 ProD-D) medians through the head; TRAIL-last's
    mean decode is plain) and Tables 2-3 on qwen/math and qwen/chat at one
    trial (112 fits; ProD-M predicts train and test phi through the head, 8
    calls), validated against ``t1_rows``, Table 1's rows from the table1
    phase. Each part's validate booleans must equal the reference's. Then the
    kernel is held against its plain version on the bins ablation's 12
    trained heads and test phi (K = 16, 64, 128, linear and log edges)."""
    from repro_torch.launch import bench_bins_ablation, bench_fig2, bench_table23
    from repro_torch.launch.table1 import all_settings

    total = {k: 0 for k in counters}

    # the bins ablation, its trained heads kept for the kernel check below
    heads = []
    fit = bench_bins_ablation.train_predictor

    def keeping(seed, phi, tgt, pcfg, edges, device=None):
        heads.append((phi.shape, fit(seed, phi, tgt, pcfg, edges, device=device)))
        return heads[-1][1]

    bench_bins_ablation.train_predictor = keeping
    try:
        out, launches, _ = _counted(counters, "ablations: bins",
                                    lambda: bench_bins_ablation.run(fast=True, seed=0,
                                                                    device="cuda"), 12)
    finally:
        bench_bins_ablation.train_predictor = fit
    for k in total:
        total[k] += launches[k]
    for setting, res in out.items():
        print(f"  {'/'.join(setting)}: " + "  ".join(
            f"{sp} K={K} {v:.2f} [{BINS_REF_MAE[setting][(sp, K)]:.2f}]"
            for (sp, K), v in sorted(res.items())))
    checks = bench_bins_ablation.validate(out)
    print(f"ablations: bins reference numbers {json.dumps(ABLATION_REF_NUMBERS['bins'])}")
    _same_booleans("ablations: bins", checks, ABLATION_REF_CHECKS["bins"])

    # Figure 2
    out, launches, _ = _counted(counters, "ablations: fig2",
                                lambda: bench_fig2.run(fast=True, seed=0, device="cuda"), 72)
    for k in total:
        total[k] += launches[k]
    for setting, curves in out.items():
        for curve, points in curves.items():
            print(f"  {'/'.join(setting)} {curve:15s} by k: " + "  ".join(
                f"{k}: {v[0]:.2f} [{FIG2_REF_MAE[setting][curve][k]:.2f}]"
                for k, v in points.items()))
    _same_booleans("ablations: fig2", bench_fig2.validate(out), ABLATION_REF_CHECKS["fig2"])

    # Tables 2-3 on two settings, one trial
    def table23():
        t23 = {"single": {}, "median": {}}
        for model, scen, data, epochs in all_settings(fast=True, seed=0):
            if (model, scen) in T23_SETTINGS:
                bench_table23.run_setting(t23, model, scen, data, epochs, n_trials=1,
                                          device="cuda")
        return t23

    t23, launches, _ = _counted(counters, "ablations: table23 (qwen/math, qwen/chat)",
                                table23, 2 * 2 * 2)
    for k in total:
        total[k] += launches[k]
    for (ev, m), refs in T23_REF_MAE.items():
        print(f"  {ev:6s} eval {m:12s} " + "  ".join(
            f"{'/'.join(s)} {t23[ev][m][s][0]:8.2f} [{r:.2f}]" for s, r in zip(T23_SETTINGS, refs)))
    checks = bench_table23.validate(t23, t1_rows)
    print(f"ablations: table23 reference numbers {json.dumps(ABLATION_REF_NUMBERS['table23'])}")
    _same_booleans("ablations: table23", checks, ABLATION_REF_CHECKS["table23"])

    # the kernel on the trained heads of the bins ablation (not counted)
    from repro_torch.data import make_scenario

    levels = torch.tensor([0.5], device="cuda")
    worst = 0.0
    for i, (_, pred) in enumerate(heads):
        scen = ("qwen", "chat") if i < 6 else ("qwen", "math")
        data = make_scenario(*scen, n_train=800, n_test=400, seed=0)
        phi = torch.from_numpy(data.phi_test["last"].astype("float32")).cuda()
        p = pred.params
        args = (phi, p["w1"], p["b1"], p["w2"], p["b2"], pred.edges)
        probs, med = counters["prod_head"](*args, levels)
        again = counters["prod_head"](*args, levels)
        p_ref, m_ref = ref.prod_head_ref(*args, qs=levels)
        torch.cuda.synchronize()
        K = pred.edges.shape[0] - 1
        label = f"{'/'.join(scen)} K={K} {pred.pcfg.bin_spacing} trained"
        check(torch.allclose(probs, p_ref, rtol=1e-5, atol=1e-6),
              f"prod_head probs {label}: max err {max_err(probs, p_ref)}")
        hold_quantiles(label, med, m_ref, levels, head_fp64(*args[:5])[1],
                       pred.edges)
        check(torch.equal(probs, again[0]) and torch.equal(med, again[1]),
              f"prod_head {label}: two calls differ")
        worst = max(worst, max_err(probs, p_ref))
    print(f"ablations: the kernel on the {len(heads)} trained heads of the bins ablation, "
          f"probs within {worst:.3g} of the plain version, second calls bit-identical")
    return total


# The reference's single-replica track (benchmarks/bench_serving.py::run at its
# defaults: qwen/chat, 250 requests, seed 0), run on the CPU with
# JAX_PLATFORMS=cpu: its validate booleans, and its numbers beside the port's.
SINGLE_REF_CHECKS = {"prod_beats_naive_latency": True, "prod_reduces_waste": True,
                     "oracle_is_bound": True, "srtf_not_worse_than_sjf": True}
SINGLE_REF_NUMBERS = {"prod_latency_gain_pct": 76.14, "prod_throughput_gain_pct": 34.74,
                      "srtf_preemptions": 15}


def single_phase(counters):
    """The serving benchmark's single-replica track on the card: a ProD-D
    head trained there on qwen/chat, then six ``SimEngine`` policy runs over
    250 requests, each predicting its medians in one head call (6 launches,
    as the port's CPU path counts them: tests/test_torch_bench_serving_tables.py).
    Its validate booleans must equal the reference's."""
    from repro_torch.launch import bench_serving as bench

    (rows, checks), launches, _ = _counted(
        counters, "single",
        lambda: bench.run_table("single", seed=0, device="cuda"), len(bench.POLICIES))
    for r in rows:
        print(f"  {r['policy']:24s} mean latency {r['mean_latency']:.1f} p90 "
              f"{r['p90_latency']:.1f} throughput {r['throughput']:.3f} waste "
              f"{r['kv_waste_ratio']:.3f}")
    check(all(r["completed"] == 250 for r in rows), "single: every request completes")
    print(f"single: reference numbers {json.dumps(SINGLE_REF_NUMBERS)}")
    _same_booleans("single", checks, SINGLE_REF_CHECKS)
    return launches


# The reference's cluster tables at 8,000 requests, seed 0: the booleans of
# `validate_cluster_predictors`, `validate_cluster_adaptation` and
# `validate_cluster_refine` of the JAX package's benchmarks/bench_serving.py,
# run on the CPU with JAX_PLATFORMS=cpu from benchmarks/:
#   python -c 'import bench_serving as bs; [print(v(r(n_requests=8000, seed=0)))
#       for r, v in ((bs.run_cluster_predictors, bs.validate_cluster_predictors),
#                    (bs.run_cluster_adaptation, bs.validate_cluster_adaptation),
#                    (bs.run_cluster_refine, bs.validate_cluster_refine))]'
# Every boolean is True there; beside them the reference's numbers, printed
# next to the port's.
CLUSTER_REF_CHECKS = {
    "predictors": {"trained_head_in_loop": True, "perfect_is_bound_p99": True,
                   "trained_within_2x_oracle_p99": True,
                   "deadline_order_cuts_slo_misses": True, "replay_under_90s": True},
    "adaptation": {"static_drift_degrades": True, "adapted_holds_target": True,
                   "conformal_recovers": True, "refresh_used": True,
                   "refresh_cuts_slo_misses": True, "stationary_p99_ok": True,
                   "replay_under_120s": True},
    "refine": {"all_accounted": True, "refine_exercised": True, "prompt_only_is_inert": True,
               "mae_posterior_wins_at_some_t": True, "posterior_srtf_p99_not_worse": True,
               "posterior_srtf_slo_win": True, "hazard_laxity_goodput_not_worse": True,
               "replay_under_120s": True},
}
CLUSTER_REF_NUMBERS = {
    "predictors": {"service_mean_batch": 5.606, "trained_p99_vs_oracle_x": 1.0085,
                   "deadline_slo_gain_x": 3.124},
    "adaptation": {"static_drift_cov_drop": 0.148, "adapted_drift_cov_err": 0.019,
                   "stationary_cov_err": 0.031},
    "refine": {"mae_first_win_t": 128, "mae_final_gain_pct": 18.70, "srtf_p99_gain_pct": 5.66,
               "hazard_laxity_goodput_gain_pct": 18.56, "renorm_srtf_goodput_delta_pct": -4.56},
}


def cluster_phase(counters):
    """Phase 7: the cluster tables with the head in the loop, at 8,000
    requests on the card, each stamped to ``STAMP`` under the reference's
    key as it finishes. Returns the launches of the three tables and, per
    stamp key, the number of rows and the checks the phase printed."""
    from repro_torch.launch import bench_serving as bench
    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.arrivals import make_trace
    from repro_torch.serving.predictor import PredictorService, fit_trace_head
    from repro_torch.serving.scheduler import Policy

    total = {k: 0 for k in counters}
    tables, stamped = {}, {}
    for name in ("predictors", "adaptation", "refine"):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, checks = bench.run_table(name, n_requests=8000, seed=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        services = [r["service"] for r in rows if "service" in r]
        expect = sum(s["batches"] for s in services)
        if name == "refine":
            # fit_hazard_table evaluates its progress grid in one head call
            expect += rows[0]["annotation_service"]["batches"] + 1
            services.append(rows[0]["annotation_service"])
        mean_batch = sum(s["scored"] for s in services) / max(sum(s["batches"] for s in services), 1)
        buckets = sorted({b for s in services for b in s["buckets"]})
        print(f"cluster {name}: {len(rows)} rows in {wall:.1f} s wall; {len(services)} services, "
              f"{sum(s['batches'] for s in services)} fused batches, mean batch {mean_batch:.2f}, "
              f"buckets {buckets}; launches {json.dumps(launches)} (expected prod_head {expect})")
        for r in rows:
            label = " ".join(str(r[k]) for k in ("predictor", "trace", "mode", "order") if k in r)
            cov = (f", coverage {r['coverage']:.4f} (after the switch {r['coverage_post']:.4f})"
                   if "coverage" in r else "")
            print(f"  {label:32s} p50 {r['p50_latency']:.1f} p99 {r['p99_latency']:.1f} SLO misses "
                  f"{r['slo_violations'] + r['timed_out']} goodput {r['goodput']:.3f}{cov}")
        ref_nums = CLUSTER_REF_NUMBERS[name]
        print(f"cluster {name}: checks {json.dumps(checks)}; reference numbers "
              f"{json.dumps(ref_nums)}")
        for k, v in CLUSTER_REF_CHECKS[name].items():
            check(checks[k] == v, f"cluster {name}: {k} is {checks[k]}, the reference's is {v}")
        check(launches["prod_head"] == expect,
              f"cluster {name}: prod_head launched {launches['prod_head']}, expected {expect}")
        for k in set(counters) - {"prod_head"}:
            check(launches[k] == 0, f"cluster {name}: kernel {k} launched off its path")
        for k in total:
            total[k] += launches[k]
        key = bench.STAMP_KEYS[name]
        tables[key] = {"rows": rows, "checks": checks}
        bench._write_stamp(str(STAMP), tables, n_requests=8000, seed=0, **bench.STAMP_META)
        stamped[key] = {"rows": len(rows), "checks": checks}

    # where a replay's time goes: one trained-head replay of the predictor
    # table (psq, FCFS, q0.9 reservation), profiled (not counted)
    cfg = bench.predictor_trace_config(n_requests=8000, seed=0)
    reqs = make_trace(cfg)
    head = fit_trace_head(cfg, n_train=4000, r=16, seed=7, device="cuda")
    pol = Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096)
    device_profile(lambda: Cluster.uniform(4, 32, 8 * (256 + 4096), pol, router="psq",
                                                  predictor=PredictorService(head, window=16.0))
                   .run(reqs), "cluster: one trained-prod-d replay (8,000 requests)")
    return total, stamped


def cluster_child():
    """Starts phase 7 in a child process of its own (this script with
    ``--phase cluster``): the cluster tables are the host's NumPy simulator
    with the head in the loop (0.4% device-busy), so they run on other cores
    beside the table1, ablations, sim and single phases, which are host-bound
    too, and the script stays well inside its time limit. The child counts
    its own launches from 0 and prints them last."""
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--phase", "cluster"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def cluster_result(child, t0: float):
    """Waits for :func:`cluster_child`, prints its output, checks its stamp
    (:func:`stamp_check`) and returns its launches; fails if it failed."""
    out, _ = child.communicate(timeout=1000)
    print(out, end="")
    print(f"cluster: the child process took {time.perf_counter() - t0:.1f} s, beside the "
          f"table1, ablations, sim and single phases")
    check(child.returncode == 0, f"cluster: the child process exited {child.returncode}")
    result = json.loads(out.strip().splitlines()[-1])
    stamp_check(result["stamped"])
    return result["launches"]


def stamp_check(stamped) -> None:
    """The cluster child's stamp read back through ``check_regression``: the
    three reference keys, each with the rows and checks the phase printed,
    the reference's meta knobs, and the stamp gated against itself with no
    violation and something compared."""
    from repro_torch.launch.check_regression import compare, load_stamp

    doc = load_stamp(str(STAMP))
    check(sorted(doc["tables"]) == sorted(stamped),
          f"stamp: tables {sorted(doc['tables'])}, the phase stamped {sorted(stamped)}")
    for key, want in stamped.items():
        table = doc["tables"][key]
        check(len(table["rows"]) == want["rows"],
              f"stamp {key}: {len(table['rows'])} rows, the phase printed {want['rows']}")
        check(json.dumps(table["checks"], sort_keys=True) == json.dumps(want["checks"],
                                                                          sort_keys=True),
              f"stamp {key}: checks differ from the phase's")
    meta = {k: doc["meta"].get(k) for k in ("n_requests", "n_replicas", "max_slots", "pattern",
                                            "seed")}
    check(meta == {"n_requests": 8000, "n_replicas": 4, "max_slots": 32, "pattern": "bursty",
                   "seed": 0}, f"stamp: meta {meta}")
    violations, skipped, compared = compare(doc, doc, 0.10, 0.95)
    check(not violations and compared,
          f"stamp against itself: {len(violations)} violations, {len(compared)} compared")
    print(f"stamp: {STAMP.relative_to(ROOT)} holds {sorted(stamped)} (meta {json.dumps(meta)}, "
          f"git_sha {doc['meta']['git_sha']}); against itself {len(compared)} metrics compared, "
          f"{len(skipped)} skipped, no violation")


def train_bounds(cfg, kinds, n_params: int, B: int, S: int):
    """Least time of one training step: the forward and backward products
    (6 FLOPs per matrix weight per token: an attention layer's projections
    and MLP, a Zamba2 shared block's at each of its invocations, an SSM
    layer's w_in and w_out, the unembedding; attention scores left out) and
    three times each SSM layer's least scan operations (``ssd_scan_flops``:
    the forward, and a backward of twice its work), at the fp32 peak; then
    AdamW's pass over every parameter (read p, g, m and v, write p, m and v,
    fp32) at the memory rate. Returns (flops, flops ms, optimizer bytes,
    bytes ms)."""
    d, hd = cfg.d_model, cfg.head_dim
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
    ssm = d * (2 * H * P + 2 * N + H) + H * P * d
    n_ssm = sum(k == "ssm" for k in kinds)
    matmul = n_ssm * ssm + (len(kinds) - n_ssm) * attn + d * cfg.vocab_size
    flops = 6 * matmul * B * S + (3 * n_ssm * ssd_scan_flops(B, S, H, P, N) if n_ssm else 0)
    opt_bytes = 7 * 4 * n_params
    return flops, flops / FP32_FLOPS * 1e3, opt_bytes, opt_bytes / HBM_BYTES_PER_S * 1e3


def timed_steps(counters, step_fn, state, it, steps: int):
    """``steps`` train steps, each on the next batch of ``it`` and timed on
    the host clock between synchronisations, the launch counts set to 0
    before them and read after. Returns (state, the first batch, losses,
    gradient norms, wall ms a step, launches)."""
    for c in counters.values():
        c.launches = 0
    first, losses, norms, walls = None, [], [], []
    for _ in range(steps):
        batch = next(it)
        first = first or batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return state, first, losses, norms, walls, {k: c.launches for k, c in counters.items()}


def train_phase(counters):
    """Phase 8: the trainer at Llama-3-8B's published widths (d=4096, 32/8
    heads, hd 128, d_ff 14336, vocab 128256, untied), depth cut to 2 layers,
    fp32 as the reference's launcher trains: 5 AdamW steps (cosine
    schedule, global-norm clipping) on B=8 x 128 tokens of
    ``make_lm_dataset``. Checks: finite losses with the 5th below the 1st, a
    checkpoint round trip of the trained weights bit for bit, and the
    training forward (blocked attention, plain PyTorch) against the
    prefill's (the flash kernel) on the trained weights: logits within 1e-3
    of their largest magnitude (both fp32; at the reference's init scales
    layer 0's softmax is near one-hot, where fp32 orders differ most). No
    kernel launches on this path. Then one more step is profiled."""
    import shutil

    from repro_torch.common.config import TrainConfig
    from repro_torch.common.pytree import tree_flatten, tree_size
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_iterator, make_lm_dataset
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import layer_kinds, train_forward
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.training.trainer import init_state, make_train_step

    dev = torch.device("cuda")
    cfg = get_config("llama3-8b").with_overrides(n_layers=2, dtype="float32")
    model = build_model(cfg)
    B, S, steps = 8, 128, 5
    tcfg = TrainConfig(lr=3e-3, schedule="cosine", warmup_steps=1, decay_steps=steps,
                       remat="none")
    it = batch_iterator(make_lm_dataset(64, S, seed=0), B, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(model, 0, tcfg, device=dev)
    torch.cuda.synchronize()
    n_params = tree_size(state.params)
    print(f"train: Llama-3-8B widths, {cfg.n_layers} layers, fp32: {n_params / 1e9:.4f}B "
          f"params, initialised with AdamW state in {time.perf_counter() - t0:.1f} s")
    step_fn = make_train_step(model, tcfg)
    state, _, losses, _, walls, launches = timed_steps(counters, step_fn, state, it,
                                                       steps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops, flops_ms, opt_bytes, bytes_ms = train_bounds(cfg, layer_kinds(cfg), n_params, B, S)
    bound_ms = flops_ms + bytes_ms
    print(f"train: losses {[round(x, 4) for x in losses]}; step wall ms "
          f"{[round(x, 1) for x in walls]}")
    print(f"train: step bound {bound_ms:.1f} ms ({flops / 1e12:.2f} TFLOP at the fp32 peak "
          f"{flops_ms:.1f} ms + AdamW {opt_bytes / 1e9:.1f} GB {bytes_ms:.1f} ms); the steps "
          f"after the first at {100 * bound_ms / (sum(walls[1:]) / (steps - 1)):.1f}% of it")
    print(f"train: peak memory {peak:.2f} GB (max_memory_allocated), against params + grads + "
          f"AdamW m and v {16 * n_params / 1e9:.2f} GB; launches {json.dumps(launches)}")
    check(all(math.isfinite(x) for x in losses), "train: a loss is not finite")
    check(losses[-1] < losses[0], f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(all(v == 0 for v in launches.values()), "train: a kernel launched on the train path")

    # a checkpoint of the trained weights, written into the checkout's build/
    params = state.params
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    t0 = time.perf_counter()
    path = save_checkpoint(str(ckpt_dir), {"params": params}, step=steps)
    back = restore_checkpoint(path, {"params": params})["params"]
    torch.cuda.synchronize()
    ck_s = time.perf_counter() - t0
    same = all(torch.equal(a.detach(), b) for a, b in zip(tree_flatten(params).values(),
                                                          tree_flatten(back).values()))
    shutil.rmtree(ckpt_dir)
    print(f"train: checkpoint round trip of {4 * n_params / 1e9:.2f} GB in {ck_s:.1f} s; "
          f"bit-identical: {same}")
    check(same, "train: restored weights differ from the saved ones")
    del back

    batch = next(it)
    tokens = batch["tokens"]
    with torch.no_grad():
        want, _, _ = train_forward(params, cfg, tokens)
        got, _, _ = model.prefill(params, tokens)
        for c in counters.values():
            c.launches = 0
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    print(f"train: prefill (flash kernel) against the training forward (blocked attention) "
          f"on the trained weights: logits max|err| {err:.4g} at max|logit| {scale:.4g} "
          f"({err / scale:.3g} of it; tolerance 1e-3)")
    check(err <= 1e-3 * scale, "train: prefill logits differ from the training forward's")
    # where a step's time goes (two more steps, not counted)
    device_profile(lambda: step_fn(state, batch), "train: one AdamW step")
    return launches


# (name, B, steps) of the SSM train phase: full width and depth, S=512, fp32
SSM_TRAIN = (("mamba2-130m", 8, 5), ("zamba2-1.2b", 4, 4))


def smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ssm_train_phase(counters):
    """Phase 8b: the trainer on the SSM and hybrid models at full width and
    depth, fp32 as the reference's launcher trains: Mamba2-130M (24 layers,
    d=768, 24 scan heads of 64, state 128, tied 50,280-token vocabulary) on
    B=8 x 512 tokens for 5 AdamW steps, and Zamba2-1.2B (38 SSM layers, d=2048,
    64 scan heads of 64, state 64, the shared attention + MLP block 6 times)
    on B=4 x 512 for 4 steps; the scan is ``models/ssm.py::ssd_chunked`` at
    the configs' chunk of 256, under autograd. Checks: every loss finite, the
    first batch's loss after the steps below its loss at the first step (each
    step sees a new batch, whose own loss varies more than 5 steps move it),
    every gradient finite (the global norm is), no kernel launched on the
    train path; then ``Model.prefill`` (the ssd_scan
    kernel, and for Zamba2 the flash kernel) against the training forward on
    the trained weights: logits within 1e-3 of their largest magnitude (both
    fp32; the scan kernel sums chunks of 64, the training scan chunks of
    256), one scan launch per SSM layer and one flash launch per shared
    block invocation. Zamba2's shared block starts with wq and wk scaled by
    0.1: at the reference's init scales (wq's std 1/sqrt(H)) its softmax is
    near one-hot, where fp32 orders differ most, and there the trained
    weights' prefill stood 5.9e-3 of max|logit| off the training forward
    (on the H100 80GB HBM3 at 700 W); the tests hold the hybrid at the same
    scaling. Step wall times against ``train_bounds``, the peak memory and
    one profiled step are printed. Returns the prefills'
    launches (the train path's are all 0)."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.pytree import tree_size
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_iterator, make_lm_dataset
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import layer_kinds, train_forward
    from repro_torch.training.trainer import init_state, make_train_step

    dev = torch.device("cuda")
    card = smi()
    prefill_launches = {k: 0 for k in counters}
    for name, B, steps in SSM_TRAIN:
        cfg = get_config(name).with_overrides(dtype="float32")
        kinds = layer_kinds(cfg)
        model = build_model(cfg)
        S = 512
        tcfg = TrainConfig(lr=3e-3, schedule="cosine", warmup_steps=1, decay_steps=steps,
                           remat="none")
        ds = make_lm_dataset(64, S, seed=0)
        ds.tokens = np.minimum(ds.tokens, cfg.vocab_size - 1)
        it = batch_iterator(ds, B, seed=0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = init_state(model, 0, tcfg, device=dev)
        if "shared" in state.params:
            with torch.no_grad():      # the well-conditioned init (docstring)
                for w in ("wq", "wk"):
                    state.params["shared"]["attn"][w].mul_(0.1)
        torch.cuda.synchronize()
        n_params = tree_size(state.params)
        print(f"ssm train {name}: {sum(k == 'ssm' for k in kinds)} SSM + "
              f"{sum(k != 'ssm' for k in kinds)} shared-block layers, d={cfg.d_model}, fp32, "
              f"chunk {cfg.ssm_chunk}: {n_params / 1e9:.4f}B params, initialised with AdamW "
              f"state in {time.perf_counter() - t0:.1f} s")
        step_fn = make_train_step(model, tcfg)
        state, first, losses, norms, walls, launches = timed_steps(counters, step_fn,
                                                                   state, it, steps)
        with torch.no_grad():
            again = float(model.loss(state.params, first)[1]["loss"])
        peak = torch.cuda.max_memory_allocated() / 1e9
        flops, flops_ms, opt_bytes, bytes_ms = train_bounds(cfg, kinds, n_params, B, S)
        bound_ms = flops_ms + bytes_ms
        print(f"ssm train {name}: B={B} S={S}; losses {[round(x, 4) for x in losses]} (each "
              f"step a new batch; the first batch's after the steps {again:.4f}); grad norms "
              f"{[round(x, 3) for x in norms]}; step wall ms {[round(x, 1) for x in walls]} "
              f"({card})")
        print(f"ssm train {name}: step bound {bound_ms:.1f} ms ({flops / 1e12:.2f} TFLOP at "
              f"the fp32 peak {flops_ms:.1f} ms, the scan's share "
              f"{3 * sum(k == 'ssm' for k in kinds) * ssd_scan_flops(B, S, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state) / 1e12:.3f} "
              f"TFLOP; + AdamW {opt_bytes / 1e9:.1f} GB {bytes_ms:.1f} ms); the steps after "
              f"the first at {100 * bound_ms / (sum(walls[1:]) / (steps - 1)):.1f}% of it")
        print(f"ssm train {name}: peak memory {peak:.2f} GB (max_memory_allocated), against "
              f"params + grads + AdamW m and v {16 * n_params / 1e9:.2f} GB; launches "
              f"{json.dumps(launches)}")
        check(all(math.isfinite(x) for x in losses), f"ssm train {name}: a loss is not finite")
        check(all(math.isfinite(x) for x in norms), f"ssm train {name}: a gradient is not finite")
        check(again < losses[0],
              f"ssm train {name}: loss did not fall ({losses[0]} -> {again} on the first batch)")
        check(all(v == 0 for v in launches.values()),
              f"ssm train {name}: a kernel launched on the train path")

        params = state.params
        tokens = next(it)["tokens"]
        with torch.no_grad():
            want, _, _ = train_forward(params, cfg, tokens)
            for c in counters.values():
                c.launches = 0
            got, _, _ = model.prefill(params, tokens)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        expect = {"ssd_scan": sum(k == "ssm" for k in kinds),
                  "flash_attention": sum(k != "ssm" for k in kinds),
                  **norm_rope_launches(cfg, 1)}
        print(f"ssm train {name}: prefill (ssd_scan, flash kernels) against the training "
              f"forward (ssd_chunked, blocked attention) on the trained weights: logits "
              f"max|err| {err:.4g} at max|logit| {scale:.4g} ({err / scale:.3g} of it; "
              f"tolerance 1e-3); launches {json.dumps(launches)}")
        check(err <= 1e-3 * scale, f"ssm train {name}: prefill logits differ from training's")
        for k, c in launches.items():
            check(c == expect.get(k, 0), f"ssm train {name}: {k} launched {c} times in the "
                  f"prefill, expected {expect.get(k, 0)}")
            prefill_launches[k] += c
        batch = next(it)
        device_profile(lambda: step_fn(state, batch), f"ssm train {name}: one AdamW step")
        del state, params, step_fn, want, got
        gc.collect()
        torch.cuda.empty_cache()
    return prefill_launches


def int8_kv_phase(counters):
    """Phase 8c: the int8 KV cache (``Model.init_cache(kv_quant=True)``) on
    Llama-3-8B at full width and depth, bf16, B=8, 576 slots: 128 teacher-
    forced tokens through ``decode_step`` from an empty cache, once into the
    plain cache and once into the int8 one (the reference's protocol,
    ``tests/test_perf_variants.py:17``), with every layer's wq and wk scaled
    by 0.1, as the online phase holds Llama's per-step states: at the init
    scales the softmaxes are near one-hot and 32 layers amplify the int8
    rounding (the median gap reached 1.655x the gate there, on the H100
    80GB HBM3 at 700 W). Checks: at every step the median
    |logit gap| below 0.1 max|logit| + 0.05 (the reference's gate); the int8
    cache's bytes below 0.65x the plain one's (``:46``); decode_attention
    launched once per layer and step on both caches, the unembed, norm and
    rotation once a step's worth (``norm_rope_launches``), no other kernel. The
    two caches' step times (CUDA events, eager), the dequantization's share
    of the int8 step and one profiled step of each are printed. Returns the
    launches of the 256 steps."""
    from repro_torch.common.pytree import tree_bytes
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.model_zoo import build_model

    dev = torch.device("cuda")
    card = smi()
    cfg = get_config("llama3-8b")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    with torch.no_grad():              # the well-conditioned init (docstring)
        for lp in params["layers"]:
            for w in ("wq", "wk"):
                lp["attn"][w].mul_(0.1)
    B, Sc, T = 8, 576, 128
    caches = {"bf16": model.init_cache(B, Sc, device=dev),
              "int8": model.init_cache(B, Sc, device=dev, kv_quant=True)}
    nbytes = {k: model.cache_bytes(B, Sc, kv_quant=(k == "int8")) for k in caches}
    check(all(tree_bytes(c) == nbytes[k] for k, c in caches.items()),
          "int8 kv: cache_bytes differs from the cache's tensors")
    ratio = nbytes["int8"] / nbytes["bf16"]
    forced = torch.as_tensor(np.random.default_rng(0).integers(3, cfg.vocab_size, (T, B)),
                             device=dev)
    for c in counters.values():
        c.launches = 0
    gaps, scales = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(T):
            pos = torch.full((B,), t, dtype=torch.int32, device=dev)
            lf, _ = model.decode_step(params, forced[t], caches["bf16"], pos, pos + 1)
            lq, _ = model.decode_step(params, forced[t], caches["int8"], pos, pos + 1)
            gaps.append((lf.float() - lq.float()).abs().median())
            scales.append(lf.float().abs().max())
        gaps, scales = torch.stack(gaps).tolist(), torch.stack(scales).tolist()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    share = [g / (0.1 * s + 0.05) for g, s in zip(gaps, scales)]
    worst = max(share)
    print(f"int8 kv: Llama-3-8B bf16 (wq, wk x 0.1), B={B}, {Sc} slots, {T} teacher-forced "
          f"steps on each cache in {wall:.2f} s; median |logit gap| {min(gaps):.4g}-"
          f"{max(gaps):.4g} at max|logit| {min(scales):.4g}-{max(scales):.4g}, at most "
          f"{worst:.3f} of the gate at step {share.index(worst)} (steps 0, 31, 63, 127: "
          f"{[round(share[i], 3) for i in (0, 31, 63, 127)]}) "
          f"(0.1 max|logit| + 0.05); cache {nbytes['int8'] / 1e6:.2f} MB int8 + scales against "
          f"{nbytes['bf16'] / 1e6:.2f} MB bf16 ({ratio:.4f}x; gate 0.65); launches "
          f"{json.dumps(launches)} ({card})")
    check(worst < 1.0, "int8 kv: a step's logit gap passes the reference's gate")
    check(ratio < 0.65, f"int8 kv: the int8 cache is {ratio:.4f}x the plain one")
    check(launches["decode_attention"] == 2 * T * cfg.n_layers,
          f"int8 kv: decode_attention launched {launches['decode_attention']} times")
    check(launches["unembed"] == 2 * T, f"int8 kv: unembed launched {launches['unembed']} times")
    for k, n in norm_rope_launches(cfg, 2 * T).items():
        check(launches[k] == n, f"int8 kv: {k} launched {launches[k]} times, expected {n}")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("decode_attention", "unembed", "rms_norm", "rope")),
          "int8 kv: a kernel launched off the decode path")

    with torch.no_grad():
        pos = torch.full((B,), T, dtype=torch.int32, device=dev)
        nxt = forced[0]
        steps = {k: (lambda c=c: model.decode_step(params, nxt, c, pos, pos + 1))
                 for k, c in caches.items()}
        step_ms = {k: time_ms(f, iters=10, warmup=2) for k, f in steps.items()}
        quant = [e for e in caches["int8"] if len(e) == 4]

        def dequantize():
            for k, v, ks, vs in quant:
                transformer._dequantize(k, ks, torch.bfloat16)
                transformer._dequantize(v, vs, torch.bfloat16)

        deq_ms = time_ms(dequantize, iters=10, warmup=2)
        print(f"int8 kv: decode step (B={B}, Sc={Sc}) {step_ms['bf16']:.2f} ms on the bf16 "
              f"cache, {step_ms['int8']:.2f} ms on the int8 cache, of which the {2 * len(quant)} "
              f"dequantizations take {deq_ms:.2f} ms ({100 * deq_ms / step_ms['int8']:.1f}%; "
              f"CUDA events, eager) ({card})")
        for k, f in steps.items():
            device_profile(f, f"int8 kv: one decode step on the {k} cache")
    del params, caches
    return launches


def per_step_errors(model, params, out, prompts, plens):
    """Relative L2 error of each valid per-step state of ``out`` (a
    ``generate(..., collect_per_step=True)``) against the flash prefill's
    hidden state at its position in prompt + generated tokens."""
    dev = torch.device("cuda")
    sh, sv = out["step_hidden"], out["step_valid"]
    B, max_new = sv.shape
    seq = np.zeros((B, prompts.shape[1] + max_new), np.int64)
    n_valid = sv.sum(axis=1)                       # valid steps are a prefix of the row
    for b in range(B):
        seq[b, :plens[b]] = prompts[b, :plens[b]]
        seq[b, plens[b]:plens[b] + n_valid[b]] = out["tokens"][b, :n_valid[b]]
    valid = (torch.arange(seq.shape[1], device=dev)[None, :]
             < torch.as_tensor(plens + n_valid, device=dev)[:, None])
    with torch.no_grad():
        _, hidden, _ = model.prefill(params, torch.as_tensor(seq, device=dev),
                                     attn_valid=valid, logits_mode="none")
    rel = []
    for b in range(B):
        want = hidden[b, plens[b]:plens[b] + n_valid[b]].float()
        got = torch.as_tensor(sh[b, :n_valid[b]], device=dev)
        rel.append(((got - want).norm(dim=-1) / want.norm(dim=-1)).cpu().numpy())
    return np.concatenate(rel)


def one_ulp_spread(model, params, prompts, plens):
    """Relative L2 change of the prefill's hidden state at every valid
    prompt position when every embedding entry moves to its next float."""
    dev = torch.device("cuda")
    tok = torch.as_tensor(prompts, device=dev)
    valid = (torch.arange(tok.shape[1], device=dev)[None, :]
             < torch.as_tensor(plens, device=dev)[:, None])
    with torch.no_grad():
        _, h0, _ = model.prefill(params, tok, attn_valid=valid, logits_mode="none")
        e = params["embed"]
        nudged = {**params, "embed": torch.nextafter(e, torch.full_like(e, math.inf))}
        _, h1, _ = model.prefill(nudged, tok, attn_valid=valid, logits_mode="none")
        del nudged
    rel = [((h1[b, :n] - h0[b, :n]).float().norm(dim=-1)
            / h0[b, :n].float().norm(dim=-1)).cpu().numpy() for b, n in enumerate(plens)]
    return np.concatenate(rel)


def sharp_score_witness(kernels, cfg, params, prompts, plens):
    """Layer 0 of the served bf16 model at its init scales: q, k, v of the
    prompts as the prefill computes them in bf16, and again in fp32 from the
    same weights. Prints each (row, head, query)'s score spread over its
    valid keys and the share whose winning key differs between the two
    (bf16 rounding alone). Then the bf16 flash kernel (every query) and the
    bf16 decode kernel (each row's last prompt token against its keys) on
    the captured bf16 q, k, v, whose scores are as sharp as the served
    model's: each against an fp64 attention beside its plain version (mean
    error within 1.25x of the plain version's), and against the plain
    version at the bf16 tolerance 2e-2 with v scaled by the power of two
    that brings its std into (0.5, 1] (exact in bf16; attention is linear
    in v): the tolerance is set for unit-scale v (tests/test_kernels.py),
    and the served v has a std of ~22.6. Calls made here are not counted."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.rope import positions_from_tokens, rope_angles

    dev = torch.device("cuda")
    tok = torch.as_tensor(prompts, device=dev)
    B, S = tok.shape
    lens = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    angles = rope_angles(positions_from_tokens(B, S, device=dev), cfg.head_dim, cfg.rope_theta)
    lp = params["layers"][0]
    G, hd = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    qkv = {}
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            h = rms_norm(params["embed"][tok].to(dt), lp["ln1"], cfg.norm_eps)
            qkv[dt] = attn.qkv_project({k: w.to(dt) for k, w in lp["attn"].items()}, h, cfg,
                                       angles)
        pos = torch.arange(S, device=dev)
        valid = ((pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < lens[:, None, None]))
        rows = (pos[None, :] < lens[:, None]) & (pos[None, :] >= 1)          # (B, S) queries
        winners, spread, gap = {}, None, None
        for dt, (q, k, _) in qkv.items():
            kq = k.float().repeat_interleave(G, dim=2)
            sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq) / math.sqrt(hd)
            sc = sc.masked_fill(~valid[:, None], float("-inf"))
            winners[dt] = sc.argmax(dim=-1)
            if dt == torch.float32:
                top = sc.topk(2, dim=-1).values
                lo = sc.masked_fill(~valid[:, None], float("inf")).amin(dim=-1)
                sel = rows[:, None].expand_as(lo)
                spread = (top[..., 0] - lo)[sel]
                gap = (top[..., 0] - top[..., 1])[sel]
            del sc
        sel = rows[:, None].expand(B, cfg.n_heads, S)
        flips = float((winners[torch.bfloat16] != winners[torch.float32])[sel].float().mean())
        print(f"online (b) witness, layer 0 at the init scales: {int(sel.sum())} (row, head, "
              f"query) softmaxes over 2-{S} keys; score spread median "
              f"{float(spread.median()):.4g}, top-2 gap median {float(gap.median()):.4g} "
              f"(share under 0.5: {float((gap < 0.5).float().mean()):.4f}); winning key moved "
              f"by bf16 rounding of q, k: {100 * flips:.2f}%")

        q, k, v = qkv[torch.bfloat16]
        last = lens.long() - 1
        qd = q[torch.arange(B, device=dev), last]
        o64 = torch.empty(q.shape, dtype=torch.float64, device=dev)
        for b in range(B):                 # exact attention, one row at a time
            s64 = torch.einsum("qhd,khd->hqk", q[b].double(),
                               k[b].double().repeat_interleave(G, dim=1)) / math.sqrt(hd)
            p64 = torch.softmax(s64.masked_fill(~valid[b][None], float("-inf")), dim=-1)
            o64[b] = torch.einsum("hqk,khd->qhd", p64, v[b].double().repeat_interleave(G, dim=1))
        d64 = o64[torch.arange(B, device=dev), last]
        got = {"flash": (kernels["flash_attention"](q, k, v, causal=True, kv_lengths=lens),
                         ref.flash_attention_ref(q, k, v, causal=True, kv_lengths=lens), o64),
               "decode": (kernels["decode_attention"](qd, k, v, lens),
                          ref.decode_attention_ref(qd, k, v, lens), d64)}
        shift = math.ceil(math.log2(float(v.float().std())))
        vs = v * 2.0 ** -shift
        scaled = {"flash": (kernels["flash_attention"](q, k, vs, causal=True, kv_lengths=lens),
                            ref.flash_attention_ref(q, k, vs, causal=True, kv_lengths=lens)),
                  "decode": (kernels["decode_attention"](qd, k, vs, lens),
                             ref.decode_attention_ref(qd, k, vs, lens))}
        torch.cuda.synchronize()
    print(f"online (b) witness: v std {float(v.float().std()):.4g}, max|v| "
          f"{float(v.float().abs().max()):.4g}; the bf16 kernels on layer 0's captured q, k, v:")
    for name, (out, want, exact) in got.items():
        e_k, e_p = (out.double() - exact).abs(), (want.double() - exact).abs()
        o_s, w_s = scaled[name]
        e_s = max_err(o_s, w_s)
        print(f"  {name}: against fp64, kernel max|err| {float(e_k.max()):.4g} mean "
              f"{float(e_k.mean()):.4g}, plain version max|err| {float(e_p.max()):.4g} mean "
              f"{float(e_p.mean()):.4g} (max|out| {float(exact.abs().max()):.4g}); kernel "
              f"against the plain version {max_err(out, want):.4g}, with v x 2^-{shift} "
              f"{e_s:.3g} (tolerance 2e-2)")
        check(float(e_k.mean()) <= 1.25 * float(e_p.mean()),
              f"online (b) witness: {name} at sharp scores further from fp64 than its plain "
              f"version")
        check(torch.allclose(o_s.float(), w_s.float(), rtol=2e-2, atol=2e-2),
              f"online (b) witness: {name} at sharp scores, v x 2^-{shift}: max err {e_s}")
    return flips


# The reference's bench_online at seed 0 (benchmarks/bench_online.py::run(seed=0),
# JAX on the CPU): both booleans True, average remaining-length MAE (tokens).
ONLINE_REF = {"online_error_shrinks_with_progress": True, "online_beats_static_remaining": True,
              "online_avg_mae": 16.94, "static_avg_mae": 20.91}


def online_phase(counters):
    """Phase 9: ProD-O on real generations.
    (a) ``launch/bench_online.py``'s run at seed 0 on the card (tiny-lm
    trained 150 steps, 48 prompts x 80 tokens with per-step states, a static
    ProD-D head and the online head): flash, decode and the head must
    launch, and ``online_beats_static_remaining`` must be the reference's
    True (the shrink boolean is printed, not held: the reference gives False
    at seed 2).
    (b) Llama-3-8B at full width and depth (bf16, the serve phases' 8
    prompts): one ``generate(..., collect_per_step=True)`` of 64 tokens,
    ``build_online_dataset`` -> ``train_online_predictor`` at d=4096 and its
    512 states predicted through the head (the two-launch path). Then each
    valid step's hidden state against the flash prefill's at the same
    position of prompt + generated tokens, relative L2 per state: printed
    at the init scales, where softmaxes are near one-hot; the witness of
    ``sharp_score_witness`` there (bf16 flips of layer 0's winning keys;
    the bf16 kernels held at those scores); held within 5e-2 with every wq
    and wk scaled by 0.1; and in fp32 at the init scales, at depth 1, 4, 8,
    16 and 32, held within the prefill's own spread under one ulp of its
    input (``one_ulp_spread``) and, at depth 1, within 5e-2."""
    from repro_torch.common.config import PredictorConfig
    from repro_torch.configs import get_config
    from repro_torch.core import online
    from repro_torch.launch import bench_online
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving.engine import RealEngine

    dev = torch.device("cuda")
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = bench_online.run(seed=0, verbose=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_a = {k: c.launches for k, c in counters.items()}
    checks = bench_online.validate(rep)
    print(f"online (a) bench_online, seed 0: {wall:.1f} s wall; launches {json.dumps(launches_a)}")
    print(f"online (a): checks {json.dumps(checks)}; reference {json.dumps(ONLINE_REF)}")
    for k in ("flash_attention", "decode_attention", "prod_head", "rms_norm", "rope"):
        check(launches_a[k] > 0, f"online (a): kernel {k} was not launched on the main path")
    check(launches_a["ssd_scan"] == 0, "online (a): ssd_scan launched off its path")
    # one prefill per generation (1 + r=4), 4 attention layers each; the
    # static and the online head predict once each
    check(launches_a["flash_attention"] == 5 * 4, "online (a): flash launches")
    check(launches_a["prod_head"] == 2, "online (a): prod_head launches")
    check(checks["online_beats_static_remaining"] is True,
          "online (a): the online head does not beat the static remaining baseline")

    # (b) Llama-3-8B, per-step states at full width and depth
    cfg = get_config("llama3-8b")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    prompts, plens = served_prompts(cfg.vocab_size)
    B, max_new = len(plens), 64
    eng = RealEngine(model, params, max_new=max_new)
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, plens, torch.Generator(device=dev).manual_seed(0),
                       collect_per_step=True)
    phi_t, rem, ts, b_idx = online.build_online_dataset(out["step_hidden"], out["step_valid"],
                                                        out["lengths"])
    pcfg = PredictorConfig(n_bins=24, bin_max=float(rem.max() + 4), epochs=25, batch_size=64)
    head = online.train_online_predictor(3, phi_t, rem, pcfg, device=dev)
    pred = head.predict(phi_t)
    _, quants = head.quantiles(phi_t, [0.5, 0.9])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_b = {k: c.launches for k, c in counters.items()}
    sh, sv = out["step_hidden"], out["step_valid"]
    print(f"online (b) Llama-3-8B: generate B={B} max_new={max_new} with per-step states, "
          f"{phi_t.shape[0]} states, online head at d={phi_t.shape[1]} trained and predicted in "
          f"{wall:.1f} s; lengths {out['lengths'].tolist()}; launches {json.dumps(launches_b)}")
    check(sh.shape == (B, max_new, cfg.d_model) and np.isfinite(sh).all(),
          "online (b): step_hidden shape/finite")
    n_layers = cfg.n_layers
    steps = int(sv.any(axis=0).sum())
    check(launches_b["flash_attention"] == n_layers and
          launches_b["decode_attention"] == n_layers * steps,
          f"online (b): flash / decode launches {launches_b}")
    check(launches_b["prod_head"] == 2, "online (b): prod_head launches")
    check(launches_b["unembed"] == steps + 1, f"online (b): unembed launches {launches_b}")
    for k, n in norm_rope_launches(cfg, steps + 1).items():
        check(launches_b[k] == n, f"online (b): {k} launched {launches_b[k]} times, expected {n}")
    mae = float((pred.cpu() - torch.as_tensor(rem)).abs().mean())
    q = quants.cpu().numpy()
    print(f"online (b): train MAE of the online head {mae:.3f} tokens (remaining 0-"
          f"{int(rem.max())}); q0.9 >= q0.5 everywhere: {bool((q[:, 1] >= q[:, 0] - 1e-4).all())}")
    check(np.isfinite(q).all() and (q[:, 1] >= q[:, 0] - 1e-4).all(),
          "online (b): quantiles finite and ordered")

    # Each state against the prefill of prompt + generated tokens (not
    # counted). At the reference's init scales (wq, wk std 1/sqrt(fan_in),
    # fan_in = H), a head's scores spread widely over the keys, so each
    # softmax is near one-hot, and the decode and prefill orders of the same
    # sums part: those states are printed, not held. The witness: how often
    # bf16 rounding moves layer 0's winning key, and the bf16 kernels at
    # those scores against fp64 and their plain versions; the fp32 depth
    # sweep below. The bf16 model with every wq and wk scaled by 0.1 (scores
    # 100x smaller) is held: a second generation, every state within 5e-2.
    rel = per_step_errors(model, params, out, prompts, plens)
    print(f"online (b): {rel.size} per-step states against the flash prefill at the init "
          f"scales: relative L2 error median {np.median(rel):.3g}, 99th percentile "
          f"{np.quantile(rel, 0.99):.3g}, worst {rel.max():.4g}; within 5e-2: "
          f"{100 * np.mean(rel <= 5e-2):.1f}%")
    sharp_score_witness(counters, cfg, params, prompts, plens)
    for lp in params["layers"]:
        lp["attn"]["wq"].mul_(0.1)
        lp["attn"]["wk"].mul_(0.1)
    out = eng.generate(prompts, plens, torch.Generator(device=dev).manual_seed(0),
                       collect_per_step=True)
    rel = per_step_errors(model, params, out, prompts, plens)
    print(f"online (b): {rel.size} per-step states, wq and wk scaled by 0.1: relative L2 "
          f"error median {np.median(rel):.3g}, 99th percentile {np.quantile(rel, 0.99):.3g}, "
          f"worst {rel.max():.4g} (tolerance 5e-2, bf16)")
    check(rel.max() <= 5e-2, "online (b): per-step hidden states off the prefill's")
    del params, model, eng, out
    torch.cuda.empty_cache()

    # The model in fp32 at the init scales, full width, depth 1, 4, 8, 16
    # and 32 (the first layers of one set of 32 GB of weights; the fp32
    # flash and decode kernels): each depth's per-step states against its
    # prefill, beside the prefill's own spread under one ulp of its input.
    # Where the two grow together with depth, the init amplifies rounding
    # (any order of the same sums), not a kernel: each depth's per-step
    # median must stay within twice the one-ulp median (+5e-2), and at
    # depth 1, where nothing amplifies, every state within 5e-2.
    cfg32 = cfg.with_overrides(dtype="float32")
    full = build_model(cfg32).init(seed=0, device=dev)
    for depth in (1, 4, 8, 16, 32):
        model = build_model(cfg32.with_overrides(n_layers=depth))
        params = {**full, "layers": full["layers"][:depth]}
        eng = RealEngine(model, params, max_new=max_new)
        out = eng.generate(prompts, plens, torch.Generator(device=dev).manual_seed(0),
                           collect_per_step=True)
        rel = per_step_errors(model, params, out, prompts, plens)
        ulp = one_ulp_spread(model, params, prompts, plens)
        print(f"online (b): fp32 model at the init scales, depth {depth}: {rel.size} per-step "
              f"states against the prefill, relative L2 median {np.median(rel):.3g}, worst "
              f"{rel.max():.4g}; the prefill under one ulp of its input, {ulp.size} states: "
              f"median {np.median(ulp):.3g}, worst {ulp.max():.4g}")
        check(np.median(rel) <= 2 * np.median(ulp) + 5e-2,
              f"online (b): fp32 depth {depth}: per-step states further from the prefill "
              f"than its one-ulp spread")
        if depth == 1:
            check(rel.max() <= 5e-2, "online (b): fp32 depth 1 per-step states off the prefill's")
        del model, params, eng, out
    del full
    torch.cuda.empty_cache()
    return {k: launches_a[k] + launches_b[k] for k in counters}


def held(got, want, scale):
    """Held on V as served: (the worst |got - want| / (2e-2 * scale), the
    elements beyond 1), ``scale`` being sum_k p_k |v_k| (the plain version
    on |v|): a bf16 softmax-weighted sum errs in proportion to that sum,
    not to |o|, which cancellation can make small."""
    r = (got.float() - want.float()).abs() / (2e-2 * scale.float()).clamp_min(1e-30)
    return float(r.max()), int((r > 1).sum())


class capture:
    """Within the block, ``ops.<name>`` records the inputs of its calls
    numbered in ``at`` (0 = the first; tensors cloned) in ``calls[i] =
    (args, kwargs)`` and returns what the kernel returns; restored after.
    ``args`` and ``kwargs`` are those of the first recorded call."""

    def __init__(self, ops, name: str, at=(0,)):
        self.ops, self.name, self.at, self.calls, self.n = ops, name, set(at), {}, 0

    def __enter__(self):
        self.orig = getattr(self.ops, self.name)

        def rec(*args, **kwargs):
            if self.n in self.at:
                clone = lambda t: t.clone() if hasattr(t, "clone") else t
                self.calls[self.n] = ([clone(a) for a in args],
                                      {k: clone(v) for k, v in kwargs.items()})
            self.n += 1
            return self.orig(*args, **kwargs)

        setattr(self.ops, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)

    @property
    def args(self):
        return self.calls[min(self.calls)][0]

    @property
    def kwargs(self):
        return self.calls[min(self.calls)][1]


LONG_LENS = (8960, 8704, 8300, 512)


def long_phase(counters):
    """Zamba2-1.2B past its 8,192-token window: B=4 prompts of 8,960 / 8,704 /
    8,300 / 512 tokens right-padded to Sp=8,960, max_new=64, one generation.
    The prefill's flash calls run with the window biting at full shape and
    the scan at S=8,960; the shared block decodes on 8,192-slot rings
    (lengths min(len, W)); the 512-token row has 257 padded query rows with
    no valid key (the reference's empty-row value). Then each kernel is
    held against its plain version on the phase's own inputs (captured in a
    second prefill and decode step, not counted): flash (the plain version a
    query chunk of 512 at a time, through q_offset: whole, it would hold a
    41 GB score tensor) and decode on the rings, the scan's y at 2e-2 and h
    at 2e-4. Flash and decode are held on V as served (|v| reaches ~43),
    each output element within 2e-2 of sum_k p_k |v_k|, its plain version
    on |v|: a bf16 softmax-weighted sum errs in proportion to that sum, not
    to |o|, which cancellation can make small. Two planted faults must fail
    that check: the flash kernel without its window, and its output with
    the rows that have no valid key set to 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serving.engine import RealEngine

    dev = torch.device("cuda")
    cfg = get_config("zamba2-1.2b")
    W = cfg.attn_window
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device=dev)
    kinds = layer_kinds(cfg)
    n_attn, n_ssm = sum(k != "ssm" for k in kinds), sum(k == "ssm" for k in kinds)
    n_params = sum(int(p.numel()) for p in _leaves(params))
    B, Sp, max_new = len(LONG_LENS), max(LONG_LENS), 64
    plens = np.array(LONG_LENS)
    rng = np.random.default_rng(1)
    prompts = np.zeros((B, Sp), np.int64)
    for i, n in enumerate(plens):
        prompts[i, :n] = rng.integers(3, cfg.vocab_size, size=n)
    eng = RealEngine(model, params, max_new=max_new)

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, plens, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    lens, phi = out["lengths"], out["phi"]
    check(phi.shape == (B, cfg.d_model) and np.isfinite(phi).all(), "long: phi shape/finite")
    check(lens.min() >= 1 and lens.max() <= max_new, "long: lengths range")
    check(launches["ssd_scan"] == n_ssm and launches["flash_attention"] == n_attn,
          f"long: prefill launches {launches}")
    check(launches["decode_attention"] > 0 and launches["prod_head"] == 0,
          f"long: decode launches {launches}")
    if lens.min() == max_new:
        check(launches["decode_attention"] == max_new * n_attn, f"long: decode launches {launches}")
        check(launches["unembed"] == max_new + 1, f"long: unembed launches {launches}")
        for k, n in norm_rope_launches(cfg, max_new + 1).items():
            check(launches[k] == n, f"long: {k} launched {launches[k]} times, expected {n}")
    check(launches["rms_norm"] > 0 and launches["rope"] > 0, f"long: norm launches {launches}")
    n_tok = int(lens.sum())
    print(f"long: Zamba2-1.2B B={B} prompts {list(LONG_LENS)} padded to {Sp}, window {W}, "
          f"max_new={max_new}: {gen_s:.2f} s, {n_tok} generated tokens, "
          f"{n_tok / gen_s:.1f} tokens/s (prefill included); lengths {lens.tolist()}; "
          f"launches {json.dumps(launches)}")

    tokens = torch.as_tensor(prompts, device=dev)
    lens_t = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    valid = torch.arange(Sp, device=dev)[None, :] < lens_t[:, None]
    nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
    with torch.no_grad():
        prefill = lambda: model.prefill(params, tokens, attn_valid=valid, logits_mode="none")
        prefill_ms = time_ms(prefill, iters=2, warmup=1)
        with capture(ops, "flash_attention") as fl, capture(ops, "ssd_scan") as sc:
            _, _, pcache = prefill()
        cache = model.decode_cache(pcache, Sp + max_new)
        del pcache
        rings = [e[0].shape[1] for e in cache if not isinstance(e, dict)]
        check(rings == [W] * n_attn, f"long: shared-block caches {rings}, expected rings of {W}")
        step = lambda: model.decode_step(params, nxt, cache, lens_t, lens_t + 1)
        with capture(ops, "decode_attention") as dc:
            step()
        step_ms = time_ms(step, iters=10, warmup=2)
    # bounds: the prefill's weight products plus its attention pairs at the
    # bf16 peak; a decode step's weights, states and K/V of min(len+1, W) keys
    qpos = np.arange(Sp)[None, :]
    lo = np.maximum(0, qpos - W + 1)
    hi = np.minimum(qpos, plens[:, None] - 1)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())            # per head
    n_empty = int((hi < lo).sum())
    attn_flops = 4 * cfg.head_dim * cfg.n_heads * pairs * n_attn
    n_keys = int(np.minimum(plens + 1, W).sum())
    flops, flops_ms, step_bytes, bytes_ms = model_bounds(cfg, kinds, n_params, B, Sp,
                                                         Sp + max_new, n_keys=n_keys)
    print(f"long: prefill (B={B}, S={Sp}) {prefill_ms:.1f} ms, bound "
          f"{(flops + attn_flops) / BF16_FLOPS * 1e3:.2f} ms ({flops / 1e12:.2f} TFLOP of "
          f"weight products + {attn_flops / 1e12:.2f} of attention); decode step on the rings "
          f"{step_ms:.2f} ms, bound {bytes_ms:.3f} ms ({step_bytes / 1e9:.3f} GB, K/V of "
          f"{n_keys} keys a layer); {n_empty} padded query rows with no valid key; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    rows = []

    # flash, on the first shared block's prefill inputs, v as served
    q, k, v = fl.args
    kw = fl.kwargs
    flash = lambda window: counters["flash_attention"](q, k, v, causal=True, window=window,
                                                       kv_lengths=kw["kv_lengths"])
    call = lambda: flash(kw["window"])
    got = call()

    def plain(vv=v):
        return torch.cat([ref.flash_attention_ref(
            q[:, i:i + 512], k, vv, causal=True, window=kw["window"], q_offset=i,
            kv_lengths=kw["kv_lengths"]) for i in range(0, Sp, 512)], dim=1)

    want = plain()
    scale = plain(v.abs())                           # sum_k p_k |v_k|, per element
    torch.cuda.synchronize()
    check(kw["window"] == W, f"long: flash window {kw['window']}")
    empty = torch.as_tensor(hi < lo, device=dev)                     # (B, Sp)
    err_empty = float((got.float() - want.float()).abs()[empty].max())
    worst, beyond = held(got, want, scale)
    print(f"long: flash B={B} S={Sp} window {W}, v as served (max|v| "
          f"{float(v.float().abs().max()):.3g}): max|kernel-plain| {max_err(got, want):.3g}"
          f", on the {n_empty} rows with no valid key {err_empty:.3g} (max|out| there "
          f"{float(want.float().abs()[empty].max()):.3g}); worst error {worst:.3g} of its "
          f"tolerance 2e-2 * sum p|v| (median sum p|v| {float(scale.float().median()):.3g})")
    check(beyond == 0, f"long: flash_attention {beyond} elements beyond 2e-2 * sum p|v| "
          f"(worst {worst:.3g} of it)")
    faults = {"no window": flash(0),
              "empty rows 0": got.masked_fill(empty[:, :, None, None], 0)}
    for name, bad in faults.items():
        worst, beyond = held(bad, want, scale)
        print(f"long: planted fault '{name}': {beyond} elements beyond the tolerance, worst "
              f"{worst:.3g} of it")
        check(beyond > 0, f"long: the flash check passes the planted fault '{name}'")
    del faults, scale
    lib_ms = lib_dev_ms = None
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        pos = torch.arange(Sp, device=dev)
        mask = ((pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W))[None] & \
            (pos[None, None, :] < lens_t[:, None, None])
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def sdpa():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None])

        lib_ms = time_ms(sdpa, iters=3, warmup=1)
        lib_dev_ms = device_time_ms(sdpa, iters=3)
    except RuntimeError as e:                   # no backend takes this mask here
        print(f"long: SDPA yardstick not measured ({str(e).splitlines()[0][:120]})")
    nbytes = 2 * (2 * B * Sp * cfg.n_heads * cfg.head_dim
                  + 2 * int(plens.sum()) * cfg.n_kv_heads * cfg.head_dim) + 4 * B
    fl_flops = 4 * cfg.head_dim * cfg.n_heads * pairs
    b_ms, b_by = bound(nbytes, fl_flops, BF16_FLOPS)
    rows.append({"name": "flash_attention",
                 "shape": f"B={B} S={Sp} H=32 KV=32 hd=64 bf16 causal window={W} ragged (long)",
                 "max_abs_err": max_err(got, want), "ms": time_ms(call, iters=3),
                 "plain_ms": time_ms(plain, iters=1, warmup=0), "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, "bytes": nbytes, "flops": fl_flops,
                 "device_ms": device_time_ms(call, iters=3),
                 "library_device_ms": lib_dev_ms})
    del got, want

    # decode, on the first shared block's ring at the step above, v as served
    qd, kc, vc, dlen = dc.args
    check(dlen.tolist() == [min(n + 1, W) for n in LONG_LENS], f"long: ring lengths {dlen.tolist()}")
    call = lambda: counters["decode_attention"](qd, kc, vc, dlen)
    got = call()
    want = ref.decode_attention_ref(qd, kc, vc, dlen)
    worst, beyond = held(got, want, ref.decode_attention_ref(qd, kc, vc.abs(), dlen))
    torch.cuda.synchronize()
    print(f"long: decode on the rings, lengths {dlen.tolist()}, v as served: max|kernel-plain| "
          f"{max_err(got, want):.3g}, worst error {worst:.3g} of its tolerance "
          f"2e-2 * sum p|v|")
    check(beyond == 0, f"long: decode_attention {beyond} elements beyond 2e-2 * sum p|v| "
          f"(worst {worst:.3g} of it)")
    dmask = (torch.arange(W, device=dev)[None, :] < dlen[:, None])[:, None, None]
    sdpa = lambda: F.scaled_dot_product_attention(qd[:, :, None], kc.transpose(1, 2),
                                                  vc.transpose(1, 2), attn_mask=dmask)
    nk = int(dlen.long().sum())
    nbytes = 2 * (2 * B * cfg.n_heads * cfg.head_dim + 2 * nk * cfg.n_kv_heads * cfg.head_dim)
    d_flops = 4 * cfg.head_dim * cfg.n_heads * nk
    b_ms, b_by = bound(nbytes, d_flops, BF16_FLOPS)
    rows.append({"name": "decode_attention",
                 "shape": f"B={B} Sc={W} H=32 KV=32 hd=64 bf16 ring lengths {dlen.tolist()} (long)",
                 "max_abs_err": max_err(got, want),
                 "ms": time_ms(call, iters=50), "plain_ms": time_ms(lambda: ref.decode_attention_ref(qd, kc, vc, dlen)),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(sdpa, iters=50),
                 "bytes": nbytes, "flops": d_flops,
                 "device_ms": device_time_ms(call, iters=50),
                 "library_device_ms": device_time_ms(sdpa, iters=50)})
    del cache, qd, kc, vc

    # the scan, on the first SSM layer's prefill inputs
    sargs = sc.args
    call = lambda: counters["ssd_scan"](*sargs)
    y, h = call()
    y_ref, h_ref = ref.ssd_scan_ref(*sargs)
    torch.cuda.synchronize()
    Bs, S_, H, P = sargs[0].shape
    N = sargs[3].shape[-1]
    print(f"long: ssd_scan B={Bs} S={S_} H={H} P={P} N={N}: y max|err| "
          f"{max_err(y, y_ref):.3g} at max|y| {float(y_ref.float().abs().max()):.4g}; "
          f"h max|err| {max_err(h, h_ref):.3g} at max|h| {float(h_ref.abs().max()):.4g}")
    check(torch.allclose(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2),
          f"long: ssd_scan y max err {max_err(y, y_ref)}")
    check(torch.allclose(h, h_ref, rtol=2e-4, atol=2e-4),
          f"long: ssd_scan h max err {max_err(h, h_ref)}")
    nbytes = 2 * 2 * Bs * S_ * H * P + 2 * 4 * Bs * S_ * H + 2 * 2 * Bs * S_ * N + 4 * Bs * H * P * N
    s_flops = ssd_scan_flops(Bs, S_, H, P, N)
    b_ms, b_by = bound(nbytes, s_flops, BF16_FLOPS)
    rows.append({"name": "ssd_scan", "shape": f"B={Bs} S={S_} H={H} P={P} N={N} bf16 (long)",
                 "max_abs_err": max(max_err(y, y_ref), max_err(h, h_ref)),
                 "ms": time_ms(call, iters=5),
                 "plain_ms": time_ms(lambda: ref.ssd_scan_ref(*sargs), iters=1, warmup=0),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "bytes": nbytes,
                 "flops": s_flops, "device_ms": device_time_ms(call, iters=5),
                 "library_device_ms": None})
    report_rows(rows)
    return launches


G3_LONG_LENS = (1100, 1030, 960, 900)


def gemma3_long_phase(counters):
    """Gemma3-27B past its 1,024-token window at full width and depth (62
    layers, bf16): 4 prompts of 1,100 / 1,030 / 960 / 900 tokens right-padded
    to 1,100, max_new=32, one generation. The 52 local layers take the
    window in the prefill's flash calls and decode on 1,024-slot rings built
    from the prefill's last 1,024 padded positions (lengths min(len, W));
    the 10 full layers keep the whole cache. Then the flash and decode calls
    of the first local layer and the first full one (layers 0 and 5) are
    captured in a second prefill and decode step (not counted) and held
    against their plain versions on V as served, each element within 2e-2
    of sum_k p_k |v_k| (``held``, as ``long_phase``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serving.engine import RealEngine

    dev = torch.device("cuda")
    cfg = get_config("gemma3-27b")
    W = cfg.attn_window
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device=dev)
    kinds = layer_kinds(cfg)
    B, Sp, max_new = len(G3_LONG_LENS), max(G3_LONG_LENS), 32
    plens = np.array(G3_LONG_LENS)
    rng = np.random.default_rng(2)
    prompts = np.zeros((B, Sp), np.int64)
    for i, n in enumerate(plens):
        prompts[i, :n] = rng.integers(3, cfg.vocab_size, size=n)
    eng = RealEngine(model, params, max_new=max_new)

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, plens, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    lens, phi = out["lengths"], out["phi"]
    check(phi.shape == (B, cfg.d_model) and np.isfinite(phi).all(),
          "gemma3 long: phi shape/finite")
    check(lens.min() >= 1 and lens.max() <= max_new, "gemma3 long: lengths range")
    check(launches["flash_attention"] == len(kinds) and launches["ssd_scan"] == 0
          and launches["prod_head"] == 0, f"gemma3 long: prefill launches {launches}")
    check(launches["decode_attention"] > 0, f"gemma3 long: decode launches {launches}")
    if lens.min() == max_new:
        check(launches["decode_attention"] == max_new * len(kinds),
              f"gemma3 long: decode launches {launches}")
        check(launches["unembed"] == max_new + 1, f"gemma3 long: unembed launches {launches}")
        for k, n in norm_rope_launches(cfg, max_new + 1).items():
            check(launches[k] == n, f"gemma3 long: {k} launched {launches[k]} times, expected {n}")
    check(launches["rms_norm"] > 0 and launches["rope"] > 0,
          f"gemma3 long: norm launches {launches}")
    n_tok = int(lens.sum())
    print(f"gemma3 long: B={B} prompts {list(G3_LONG_LENS)} padded to {Sp}, window {W} on "
          f"{kinds.count('local')} of {len(kinds)} layers, max_new={max_new}: {gen_s:.2f} s, "
          f"{n_tok} generated tokens (prefill included); lengths {lens.tolist()}; launches "
          f"{json.dumps(launches)}")

    tokens = torch.as_tensor(prompts, device=dev)
    lens_t = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    valid = torch.arange(Sp, device=dev)[None, :] < lens_t[:, None]
    nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
    full = kinds.index("full")
    with torch.no_grad():
        prefill = lambda: model.prefill(params, tokens, attn_valid=valid, logits_mode="none")
        prefill_ms = time_ms(prefill, iters=2, warmup=1)
        with capture(ops, "flash_attention", at=(0, full)) as fl:
            _, _, pcache = prefill()
        cache = model.decode_cache(pcache, Sp + max_new)
        del pcache
        slots = [e[0].shape[1] for e in cache]
        check(slots == [W if k == "local" else Sp + max_new for k in kinds],
              f"gemma3 long: cache slots {slots}")
        step = lambda: model.decode_step(params, nxt, cache, lens_t, lens_t + 1)
        with capture(ops, "decode_attention", at=(0, full)) as dc:
            step()
        step_ms = time_ms(step, iters=5, warmup=1)
    print(f"gemma3 long: prefill (B={B}, S={Sp}) {prefill_ms:.1f} ms; decode step, local "
          f"layers on rings, {step_ms:.2f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    for i, kind in ((0, "local"), (full, "full")):
        kw = fl.calls[i][1]
        check(kw["causal"] and kw["window"] == (W if kind == "local" else 0),
              f"gemma3 long: layer {i} flash causal {kw['causal']} window {kw['window']}")
        _hold_flash(counters, f"gemma3 long: layer {i} ({kind})", fl.calls[i])
        (_, kc, _, dl), _ = dc.calls[i]
        want_len = [min(n + 1, W) if kind == "local" else n + 1 for n in G3_LONG_LENS]
        check(dl.tolist() == want_len and kc.shape[1] == slots[i],
              f"gemma3 long: layer {i} decode lengths {dl.tolist()} on {kc.shape[1]} slots")
        _hold_decode(counters, f"gemma3 long: layer {i} ({kind})", dc.calls[i])
    return launches


def encdec_bounds(cfg, B: int, plens, cache_len: int, n_keys: int = 0):
    """Least times of one Whisper prefill and one decode step (the encdec
    branch of ``model_bounds``). Prefill, at the bf16 peak: the encoder's
    weight products over B x F frames and its non-causal attention pairs
    (4 hd FLOPs a pair a head: Q K^T and P V), the cross K/V projections
    over the frames, the decoder's weight products over B x Sp tokens (self
    q, k, v, o, cross q and o, the MLP), its causal self-attention pairs
    (ragged: a padded query row sees its row's keys) and its cross pairs
    over every frame. Decode step, over the memory rate: the decoder's
    weights (the cross K/V projections are not read: the cross K/V are
    cached), the embedding once (the unembed reads it all), the cross K/V
    (B x F keys a layer) and the self K/V (``n_keys`` a layer, or all B x
    cache_len slots). Returns (prefill FLOPs, ms, step bytes, ms)."""
    d, hd, L, F = cfg.d_model, cfg.head_dim, cfg.n_layers, cfg.encoder_seq
    H, KV = cfg.n_heads, cfg.n_kv_heads
    attn_w = d * (H + 2 * KV) * hd + H * hd * d
    mlp_w, kv_w, qo_w = 2 * d * cfg.d_ff, 2 * d * KV * hd, 2 * d * H * hd
    Sp = max(plens)
    self_pairs = sum(min(q + 1, n) for n in plens for q in range(Sp))
    flops = (2 * B * F * cfg.n_encoder_layers * (attn_w + mlp_w)
             + cfg.n_encoder_layers * 4 * hd * H * B * F * F
             + 2 * B * F * L * kv_w
             + 2 * B * Sp * L * (attn_w + qo_w + mlp_w)
             + L * 4 * hd * H * (self_pairs + B * Sp * F))
    step_bytes = 2 * (L * (attn_w + qo_w + mlp_w) + cfg.vocab_size * d
                      + L * 2 * (B * F + (n_keys or B * cache_len)) * KV * hd)
    return flops, flops / BF16_FLOPS * 1e3, step_bytes, step_bytes / HBM_BYTES_PER_S * 1e3


def _sample(logits, gen, temp: float = 0.8):
    """``RealEngine._sample``: a draw from softmax(logits / T) by the
    Gumbel argmax, at the engine's temperature."""
    e = torch.empty_like(logits).exponential_(generator=gen)
    return torch.argmax(logits / temp - torch.log(e), dim=-1)


def _hold_flash(counters, label, call):
    """A captured flash call against its plain version on its own inputs,
    held on V as served (``held``)."""
    (q, k, v), kw = call
    got = counters["flash_attention"](q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    worst, beyond = held(got, want, ref.flash_attention_ref(q, k, v.abs(), **kw))
    torch.cuda.synchronize()
    print(f"{label}: flash q {tuple(q.shape)} k {tuple(k.shape)} causal={kw['causal']}: "
          f"max|kernel-plain| {max_err(got, want):.3g}, worst error {worst:.3g} of its "
          f"tolerance 2e-2 * sum p|v|")
    check(beyond == 0, f"{label}: flash {beyond} elements beyond 2e-2 * sum p|v|")


def _hold_decode(counters, label, call):
    """A captured decode call, as ``_hold_flash``."""
    (q, kc, vc, dl), _ = call
    got = counters["decode_attention"](q, kc, vc, dl)
    want = ref.decode_attention_ref(q, kc, vc, dl)
    worst, beyond = held(got, want, ref.decode_attention_ref(q, kc, vc.abs(), dl))
    torch.cuda.synchronize()
    print(f"{label}: decode on {kc.shape[1]} slots, lengths {dl.tolist()}: max|kernel-plain| "
          f"{max_err(got, want):.3g}, worst error {worst:.3g} of its tolerance "
          f"2e-2 * sum p|v|")
    check(beyond == 0, f"{label}: decode {beyond} elements beyond 2e-2 * sum p|v|")


def whisper_phase(counters):
    """Whisper-large-v3 at full width and depth (32 encoder + 32 decoder
    layers, d=1280, bf16, seeded random weights), driven through
    ``Model.prefill`` and ``Model.decode_step`` as the reference's own tests
    drive it (its ``RealEngine`` feeds tokens only; the port's refuses an
    encoder-decoder): B=8 utterances of 1,500 stub frames
    (``audio_frame_embeds``, Whisper's 30 s window), decoder prompts of
    32-224 tokens right-padded to 224, max_new=64 (positions stay inside
    the 448-token decoder context), r=2 generations sampled from a seeded
    ``torch.Generator`` at ``RealEngine``'s temperature, a row stopping at
    EOS. φ goes through ``fit_and_predict`` and the head. Launches, counted
    from 0 over the r generations and the head: per prefill 32 encoder + 32
    self + 32 cross flash calls, per decode step 32 self + 32 cross decode
    calls, the head twice, no scan. Then one prefill and one decode step are
    timed against ``encdec_bounds`` and profiled, and (captured in a second,
    uncounted prefill and step) the flash calls of encoder layer 0 and of
    decoder layer 0's self- and cross-attention and the decode calls of its
    self and cross caches are held against their plain versions on their
    own inputs, on V as served."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import fit_and_predict
    from repro_torch.models.frontend import audio_frame_embeds
    from repro_torch.models.model_zoo import build_model, last_token_hidden

    dev = torch.device("cuda")
    name = "whisper-large-v3"
    cfg = get_config(name)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(int(p.numel()) for p in _leaves(params))
    L, F = cfg.n_layers, cfg.encoder_seq
    print(f"serve {name}: {n_params / 1e9:.3f}B params ({cfg.dtype}, d={cfg.d_model}, "
          f"{cfg.n_encoder_layers} encoder + {L} decoder layers, {F} frames) initialised in "
          f"{time.perf_counter() - t0:.1f} s; param_count() {cfg.param_count() / 1e9:.3f}B "
          f"(the reference's formula, which counts the one embedding table twice)")

    B, Sp, max_new, r = 8, 224, 64, 2
    plens = np.array(WHISPER_PLENS)
    rng = np.random.default_rng(0)
    prompts = np.zeros((B, Sp), np.int64)
    for i, n in enumerate(plens):
        prompts[i, :n] = rng.integers(3, cfg.vocab_size, size=n)
    tokens = torch.as_tensor(prompts, device=dev)
    lens_t = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    valid = torch.arange(Sp, device=dev)[None, :] < lens_t[:, None]
    frames = audio_frame_embeds(torch.Generator(device=dev).manual_seed(1), cfg, B)
    eos = 2

    @torch.no_grad()
    def generate(gen):
        """RealEngine.generate's loop with the encoder input: returns the
        lengths, φ and the decode steps run."""
        _, hidden, pcache = model.prefill(params, tokens, attn_valid=valid, enc_embeds=frames,
                                          logits_mode="none")
        last = last_token_hidden(hidden, lens_t)
        logits = model.unembed(params, last)
        cache = model.decode_cache(pcache, Sp + max_new)
        del pcache
        lengths = lens_t.clone()
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        gen_len = torch.zeros(B, dtype=torch.int64, device=dev)
        steps = 0
        for step in range(max_new):
            nxt = torch.where(finished, torch.full_like(lens_t, eos, dtype=torch.long),
                              _sample(logits, gen))
            newly = ~finished & (nxt == eos)
            finished = finished | (nxt == eos)
            gen_len = torch.where(newly, step + 1, gen_len)
            if bool(finished.all()):
                break
            logits, _ = model.decode_step(params, nxt, cache, lengths, lengths + 1)
            steps += 1
            lengths = lengths + (~finished).to(torch.int32)
        gen_len = torch.where(gen_len == 0, max_new, gen_len)
        return gen_len.cpu().numpy(), last.float().cpu().numpy(), steps

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lens = np.zeros((B, r), np.int64)
    steps = 0
    for j in range(r):
        lens[:, j], phi_j, n = generate(torch.Generator(device=dev).manual_seed(j))
        if j == 0:
            phi = phi_j
        steps += n
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    out = fit_and_predict(lens, phi, cfg.predictor_bins, seed=1, qs=(0.5, 0.9), device=dev)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}

    check(phi.shape == (B, cfg.d_model) and np.isfinite(phi).all(), f"{name}: phi shape/finite")
    check(lens.min() >= 1 and lens.max() <= max_new, f"{name}: lengths range")
    med, quants = out["median"], out["quantiles"]
    check(np.isfinite(med).all() and np.isfinite(quants).all(), f"{name}: predictions finite")
    check((quants[:, 1] >= quants[:, 0] - 1e-4).all(), f"{name}: q0.9 >= q0.5")
    expect = {"flash_attention": r * (cfg.n_encoder_layers + 2 * L),
              "decode_attention": 2 * L * steps, "prod_head": 2, "ssd_scan": 0,
              "unembed": r + steps, "rms_norm": 0, "rope": 0}
    print(f"serve {name}: launches on the main path {json.dumps(launches)}; expected "
          f"{json.dumps(expect)} ({steps} decode steps over r={r})")
    check(launches == expect, f"{name}: launches {launches}, expected {expect}")
    n_tok = int(lens.sum())
    print(f"serve {name}: B={B} x {F} frames, Sp={Sp} r={r} max_new={max_new}: {gen_s:.2f} s, "
          f"{n_tok} generated tokens, {n_tok / gen_s:.1f} tokens/s, "
          f"{1e3 * gen_s / max(steps, 1):.2f} ms per decode step (wall over {steps} steps, "
          f"the r prefills included)")
    print(f"serve {name}: lengths {lens.tolist()}")
    print(f"serve {name}: median {np.round(med, 3).tolist()} q0.9 "
          f"{np.round(quants[:, 1], 3).tolist()} test MAE {out['mae']:.3f} noise radius "
          f"{out['noise_radius']:.3f} final soft-CE {out['final_loss']:.4f}")
    head_checks(counters["prod_head"], out["predictor"],
                torch.as_tensor(phi[B // 2:], dtype=torch.float32, device=dev), sweep=False)

    nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
    with torch.no_grad():
        prefill = lambda: model.prefill(params, tokens, attn_valid=valid, enc_embeds=frames,
                                        logits_mode="none")
        prefill_ms = time_ms(prefill, iters=3, warmup=1)
        enc = cfg.n_encoder_layers
        with capture(ops, "flash_attention", at=(0, enc, enc + 1)) as fl:
            _, _, pcache = prefill()
        cache = model.decode_cache(pcache, Sp + max_new)
        del pcache
        check([tuple(e["ck"].shape) for e in cache[:1]] == [(B, F, cfg.n_kv_heads, cfg.head_dim)]
              and cache[0]["k"].shape[1] == Sp + max_new,
              f"{name}: decode cache {tuple(cache[0]['k'].shape)} / {tuple(cache[0]['ck'].shape)}")
        step = lambda: model.decode_step(params, nxt, cache, lens_t, lens_t + 1)
        with capture(ops, "decode_attention", at=(0, 1)) as dc:
            step()
        step_ms = time_ms(step, iters=10, warmup=2)
        flops, flops_ms, step_bytes, bytes_ms = encdec_bounds(cfg, B, plens, Sp + max_new)
        print(f"serve {name}: prefill (B={B}, {F} frames, Sp={Sp}) {prefill_ms:.2f} ms, bound "
              f"{flops_ms:.2f} ms ({flops / 1e12:.2f} TFLOP: encoder, cross K/V, decoder and "
              f"attention pairs); decode step (B={B}, Sc={Sp + max_new}, cross {F}) "
              f"{step_ms:.2f} ms, bound {bytes_ms:.3f} ms ({step_bytes / 1e9:.2f} GB)")
        device_profile(prefill, f"{name} prefill")
        device_profile(step, f"{name} decode step")
    _hold_flash(counters, f"{name} encoder layer 0", fl.calls[0])
    _hold_flash(counters, f"{name} decoder layer 0 self", fl.calls[enc])
    _hold_flash(counters, f"{name} decoder layer 0 cross", fl.calls[enc + 1])
    check(fl.calls[enc + 1][1]["causal"] is False and fl.calls[enc + 1][0][1].shape[1] == F,
          f"{name}: cross-attention call {fl.calls[enc + 1][1]}")
    (_, _, _, self_len), _ = dc.calls[0]
    (_, ck, _, cross_len), _ = dc.calls[1]
    check(self_len.tolist() == [n + 1 for n in plens.tolist()]
          and cross_len.tolist() == [F] * B and ck.shape[1] == F,
          f"{name}: decode lengths {self_len.tolist()} / {cross_len.tolist()}")
    _hold_decode(counters, f"{name} decoder layer 0 self", dc.calls[0])
    _hold_decode(counters, f"{name} decoder layer 0 cross", dc.calls[1])
    print(f"serve {name}: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated; weights {2 * n_params / 1e9:.2f} GB, cross K/V "
          f"{4 * L * B * F * cfg.n_kv_heads * cfg.head_dim / 1e9:.2f} GB)")
    return launches


VLM_PATCHES = 256     # Qwen2-VL's stub image: a 16 x 16 grid of patches


def vlm_embeds_phase(counters):
    """Qwen2-VL-2B at full width and depth on the embeds path: B=8 rows of
    ``vlm_embeds`` (256 stub patches on a 16 x 16 grid, then text, S=512),
    prefilled with their (3, B, S) M-RoPE positions (the three streams apart
    on the patches), then 8 decode steps sampled at ``RealEngine``'s
    temperature, each step's position given to all three streams (the first
    at S, as in the reference). Launches, counted from 0: 28 flash calls, 8
    x 28 decode calls, nothing else. Then the prefill and a step are timed
    against ``model_bounds`` and profiled, and layer 0's flash call and a
    step's first decode call (captured, uncounted) are held against their
    plain versions on V as served. Before the prefill, the position streams
    are checked: patch i at (0, i // 16, i % 16), the text after them at
    t = h = w = 1, 2, ..."""
    from repro_torch.configs import get_config
    from repro_torch.models.frontend import vlm_embeds
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import layer_kinds

    dev = torch.device("cuda")
    name = "qwen2-vl-2b"
    cfg = get_config(name)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device=dev)
    n_params = sum(int(p.numel()) for p in _leaves(params))
    kinds = layer_kinds(cfg)
    B, S, steps = 8, 512, 8
    emb, pos = vlm_embeds(torch.Generator(device=dev).manual_seed(2), cfg, B, S,
                          n_patches=VLM_PATCHES)
    i = torch.arange(VLM_PATCHES, device=dev)
    text = torch.arange(1, S - VLM_PATCHES + 1, device=dev)
    check(torch.equal(pos[:, 0, :VLM_PATCHES].long(), torch.stack([0 * i, i // 16, i % 16]))
          and torch.equal(pos[:, 0, VLM_PATCHES:].long(), text.expand(3, -1)),
          f"{name}: M-RoPE position streams")
    gen = torch.Generator(device=dev).manual_seed(3)

    @torch.no_grad()
    def run():
        _, hidden, pcache = model.prefill(params, embeds=emb, positions=pos, logits_mode="none")
        logits = model.unembed(params, hidden[:, -1])
        cache = model.decode_cache(pcache, S + steps)
        del pcache
        at = torch.full((B,), S, dtype=torch.int32, device=dev)
        for t in range(steps):
            logits, hid = model.decode_step(params, _sample(logits, gen), cache, at + t,
                                            at + t + 1)
        return hidden[:, -1], hid

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phi, last = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    expect = {"flash_attention": len(kinds), "decode_attention": steps * len(kinds),
              "prod_head": 0, "ssd_scan": 0, "unembed": steps + 1,
              **norm_rope_launches(cfg, steps + 1)}
    print(f"{name} embeds: B={B} S={S} ({VLM_PATCHES} patches on a 16 x 16 grid, then "
          f"text), {steps} decode steps: {wall:.2f} s, {B * steps / wall:.1f} tokens/s "
          f"(prefill included); launches {json.dumps(launches)}, expected {json.dumps(expect)}")
    check(launches == expect, f"{name} embeds: launches {launches}, expected {expect}")
    check(bool(torch.isfinite(phi).all() and torch.isfinite(last).all()),
          f"{name} embeds: hidden states finite")

    with torch.no_grad():
        prefill = lambda: model.prefill(params, embeds=emb, positions=pos, logits_mode="none")
        prefill_ms = time_ms(prefill, iters=3, warmup=1)
        with capture(ops, "flash_attention") as fl:
            _, _, pcache = prefill()
        cache = model.decode_cache(pcache, S + steps)
        del pcache
        at = torch.full((B,), S, dtype=torch.int32, device=dev)
        nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
        step = lambda: model.decode_step(params, nxt, cache, at, at + 1)
        with capture(ops, "decode_attention") as dc:
            step()
        step_ms = time_ms(step, iters=10, warmup=2)
        flops, flops_ms, step_bytes, bytes_ms = model_bounds(cfg, kinds, n_params, B, S,
                                                             S + steps, n_keys=B * (S + 1))
        print(f"{name} embeds: prefill (B={B}, S={S}) {prefill_ms:.2f} ms, bound "
              f"{flops_ms:.2f} ms ({flops / 1e12:.2f} TFLOP of weight products); decode step "
              f"(B={B}, {S + 1} keys a row) {step_ms:.2f} ms, bound {bytes_ms:.3f} ms "
              f"({step_bytes / 1e9:.2f} GB)")
        device_profile(prefill, f"{name} embeds prefill")
        device_profile(step, f"{name} embeds decode step")
    _hold_flash(counters, f"{name} embeds layer 0", fl.calls[0])
    _hold_decode(counters, f"{name} embeds layer 0", dc.calls[0])
    print(f"{name} embeds: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(weights {2 * n_params / 1e9:.2f} GB)")
    return launches


def e2e_phase(counters):
    """``launch/serve_with_prod.py`` at its defaults on the card (tiny-lm
    trained 300 steps, 64 prompts x 8 generations of up to 96 tokens, the
    head, then 96 served requests through stages 4-9); it prints each
    stage's rows. Flash, decode and the head must launch; the scan must not."""
    from repro_torch.launch import serve_with_prod

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = serve_with_prod.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    print(f"e2e: {wall:.1f} s wall; launches {json.dumps(launches)}")
    check(out["lengths"].shape == (64, 8), f"e2e: lengths {out['lengths'].shape}")
    for k in ("flash_attention", "decode_attention", "prod_head", "rms_norm", "rope"):
        check(launches[k] > 0, f"e2e: {k} was not launched")
    check(launches["ssd_scan"] == 0, "e2e: ssd_scan launched off its path")
    check(launches["flash_attention"] == 8 * 4, f"e2e: flash launches {launches}")
    check(all(r["service"]["batches"] > 0 for r in out["service"]), "e2e: no fused batches")
    check(out["prefix"][1]["kv_amplification"] > 1.0, "e2e: shared prefix pages unused")
    check(np.isfinite(out["head_mae"]), "e2e: head MAE not finite")
    return launches


# name fragments of the port's CUDA kernels (csrc/*.cu)
PORT_KERNELS = ("flash_fwd_", "decode_fwd", "ssd_scan_", "prod_head_")


def device_profile(fn, label: str, top: int = 6) -> None:
    """Device busy share of one call of ``fn`` and the kernels that take
    most of its device time (torch.profiler, CUDA kernel events only: the
    device ranges of the program's spans, ``common/scopes.py``, are user
    annotations and are left out, or each kernel would count twice). The
    profiler adds host time, so the wall time here is above the event timing.
    Returns the wall and busy ms, the launches and each kernel's ms (None
    without device events)."""
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
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and e.device_time_total > 0 and not e.is_user_annotation]
    kernels = {e.key: e.device_time_total / 1e3 for e in events}
    n_launch = sum(e.count for e in events)
    busy = sum(kernels.values())
    if not busy:
        print(f"profile {label}: device time not measured (no kernel events)")
        return None
    print(f"profile {label}: wall {wall_ms:.2f} ms under the profiler, device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%), {len(kernels)} kernel names, "
          f"{n_launch} kernel launches ({1e3 * wall_ms / n_launch:.1f} us of wall each)")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    for i, (name, ms) in enumerate(ranked):
        # the top kernels, and every kernel of the port
        if i < top or any(k in name for k in PORT_KERNELS):
            print(f"  {100 * ms / busy:5.1f}%  {ms:8.3f} ms  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "launches": n_launch, "kernels": kernels}


# the ep phase: one Qwen3-MoE-235B-A22B MoE layer at full width (d=4096, 128
# experts, top-8, moe_d_ff=1536, bf16), T = 4 x 128 tokens, over 4 ranks
# (gloo on one card here; NCCL, one rank per card, in
# tests/test_torch_moe_ep_nccl.py); each (mesh, FSDP mode) of models/moe.py's
# EP branch
EP_CASES = (((2, 2), "gather"), ((2, 2), "partial"), ((1, 4), "gather"))
EP_RANKS = 4
EP_LEAVES = ("x", "router", "w_gate", "w_up", "w_down")
# the served mesh of the NCCL run: Qwen3-MoE at the single-card phase's depth
MESH_SERVE = ("qwen3-moe-235b-a22b", 12, 2)          # name, layers, generations
MESH_SERVE_ONE_CARD = "177.6 tokens/s, 2,014 launches a decode step, 64.68 GB peak"


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _moved(kind: str, n: int, nbytes: int) -> float:
    """Bytes a rank moves in one collective, nccl-tests' bus convention: an
    all-reduce 2 (n - 1) / n of its buffer, an all-gather and a
    reduce-scatter (n - 1) / n of the gathered or scattered buffer
    (``nbytes`` is what a rank puts in)."""
    return {"all_reduce": 2 * (n - 1) / n * nbytes, "all_gather": (n - 1) * nbytes,
            "reduce_scatter": (n - 1) / n * nbytes}[kind]


def _bus_rates(colls) -> str:
    """The collectives of one call by (kind, ranks, bytes a rank puts in):
    calls, ms each (host clock between device synchronisations, so a rank's
    wait for the others counts) and the bus rate."""
    by = {}
    for kind, _, n, nbytes, sec in colls:
        c = by.setdefault((kind, n, nbytes), [0, 0.0])
        c[0] += 1
        c[1] += sec
    return "; ".join(f"{kind} over {n} of {nbytes / 1e6:.2f} MB x{calls}: "
                     f"{1e3 * sec / calls:.3f} ms each, bus "
                     f"{_moved(kind, n, nbytes) * calls / sec / 1e9:.1f} GB/s"
                     for (kind, n, nbytes), (calls, sec) in sorted(by.items()))


def _bus_sweep(dist, mesh, colls, reps: int = 10):
    """Each distinct collective of ``colls`` alone at its size: a warm-up
    call, the ranks meet at a barrier, then ``reps`` calls between CUDA
    events. Returns [kind, ranks, bytes a rank puts in, ms each, bus GB/s]."""
    out = []
    for kind, axes, n, nbytes in sorted({(k, tuple(a), n, b) for k, a, n, b, _ in colls}):
        t = torch.ones(nbytes // 2, dtype=torch.bfloat16, device="cuda")
        mesh._run(kind, t, axes)
        dist.barrier()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            mesh._run(kind, t, axes)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        out.append([kind, n, nbytes, ms, _moved(kind, n, nbytes) / ms / 1e6])
    return out


def ep_phase(counters, backend: str = "gloo"):
    """The expert-parallel MoE (``models/moe.py``) in 4 processes
    (``chip_smoke.py --phase ep RANK PORT DIR BACKEND``, ``ep_child``). Over
    gloo (this script) the 4 ranks share this card: NCCL refuses two ranks
    on one GPU, and gloo is a host transport, so ``launch/mesh.py`` stages
    each collective through host memory and the times are no measure of
    NVLink. Over NCCL (tests/test_torch_moe_ep_nccl.py, 4 cards) each rank
    has a card of its own and the collectives run over NVLink; nothing falls
    back to gloo. Each rank holds the layer's global seeded weights (4.8 GB;
    their checksums all-gathered must agree) and runs moe_apply on the
    global tokens. Checks: at no drop (capacity factor 0, slack 1) each
    mode's output within 2e-2 of max|out| of the single-device path on the
    card (bf16; the psum over ``model`` sums in another order), and the
    gradient of sum(y * c) for a seeded cotangent c (over NCCL on all 4 x
    128 tokens; over gloo on the first 128, since four ranks' expert
    buffers and gradients at 512 tokens would pass one card's memory): x's
    and the router's whole on every rank, each expert weight's on the
    rank's block and zero elsewhere, each within 2e-2 of the leaf's
    max|grad| of the single-device gradient; at the defaults (1.25, 2.0) a
    second call bit-identical. Prints the pairs each shard drops at the
    defaults, each mode's forward and backward time per rank (CUDA events),
    the collectives' share and each collective's bus rate, over NCCL also
    each collective alone at its size. No kernel runs on this path (the expert
    products are batched matmuls, as the reference's einsums). Over NCCL the
    ranks then serve Qwen3-MoE through a (1, 4) mesh (``mesh_serve``)."""
    out_dir = ROOT / "build" / f"chip_smoke_ep_{backend}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("rank*.json"):
        f.unlink()
    port = _free_port()
    t0 = time.perf_counter()
    # where four ranks share a card, expandable segments lose less of each
    # rank's cache to fragmentation
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--phase", "ep",
                               str(r), str(port), str(out_dir), backend], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(EP_RANKS)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [f"rank {r} exited {proc.returncode}:\n{log[-2000:]}"
              for r, (proc, log) in enumerate(zip(procs, logs)) if proc.returncode != 0]
    check(not failed, "ep: " + "\n".join(failed))
    res = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(EP_RANKS)]
    where = "sharing one card" if backend == "gloo" else "one per card"
    print(f"ep: 4 {backend} ranks {where} ({res[0]['device']}), "
          f"{time.perf_counter() - t0:.1f} s wall in all; peak memory per rank (GB) "
          f"{[round(x['peak_gb'], 2) for x in res]}, {sum(x['peak_gb'] for x in res):.2f} GB "
          f"together; seeded weights the same on every rank (checksums all-gathered) "
          f"{[x['same_weights'] for x in res]}")
    check(all(x["same_weights"] for x in res), "ep: the ranks' seeded weights differ")
    for case in res[0]["cases"]:
        per_rank = [x["cases"][case] for x in res]
        r0 = res[0]["cases"][case]
        transport = ("gloo through host memory: not an NVLink time" if backend == "gloo"
                     else "NCCL")
        print(f"ep {case}: no-drop output against the single-device path max|err| "
              f"{r0['err']:.4g} at max|out| {r0['scale']:.4g} ({r0['err'] / r0['scale']:.3g} "
              f"of it; tolerance 2e-2); defaults: second call bit-identical "
              f"{[x['same'] for x in per_rank]}, pairs dropped per shard "
              f"{[x['dropped'] for x in per_rank]} of {[x['pairs'] for x in per_rank]} "
              f"at capacity {r0['cap']}; ms per call per rank (CUDA events) "
              f"{[round(x['ms'], 2) for x in per_rank]}, collectives' share "
              f"{[round(x['coll_ms'] / x['ms'], 3) for x in per_rank]} ({transport})")
        print(f"ep {case}: no-drop gradient of sum(y * c) on {r0['bwd_rows']} x 128 tokens "
              f"against the single-device one "
              + ", ".join(f"{k} max|err| {r0['grad_err'][k]:.4g} at max|grad| "
                          f"{r0['grad_scale'][k]:.4g} ({r0['grad_err'][k] / r0['grad_scale'][k]:.3g})"
                          for k in EP_LEAVES)
              + f" (rank 0's block of each weight; tolerance 2e-2); each rank's weight "
              f"gradients zero outside its block {[x['zero_outside'] for x in per_rank]}, x's "
              f"and the router's the same on every rank {r0['grads_agree']}; backward ms per "
              f"rank {[round(x['bwd_ms'], 2) for x in per_rank]}, collectives' share "
              f"{[round(x['bwd_coll_ms'] / x['bwd_ms'], 3) for x in per_rank]}")
        print(f"ep {case}: rank 0's collectives, timed default call: {_bus_rates(r0['colls'])}; "
              f"backward: {_bus_rates(r0['bwd_colls'])}")
        if backend == "nccl":
            print(f"ep {case}: rank 0's collectives alone at these sizes (10 calls after a "
                  f"barrier, CUDA events): " + "; ".join(
                      f"{k} over {n} of {b / 1e6:.2f} MB: {ms:.4f} ms, bus {gbs:.1f} GB/s"
                      for k, n, b, ms, gbs in r0["bus"])
                  + " (NVLink's data-sheet rate: 450 GB/s each way)")
        check(r0["err"] <= 2e-2 * r0["scale"], f"ep {case}: differs from the single device")
        for k in EP_LEAVES:
            check(r0["grad_err"][k] <= 2e-2 * r0["grad_scale"][k],
                  f"ep {case}: the gradient of {k} differs from the single device's")
        check(all(x["zero_outside"] for x in per_rank),
              f"ep {case}: a weight gradient is nonzero outside the rank's block")
        check(r0["grads_agree"], f"ep {case}: x's or the router's gradient differs between ranks")
        check(all(x["same"] for x in per_rank), f"ep {case}: a second call differs")
        check(all(x["finite"] for x in per_rank), f"ep {case}: output not finite")
    launches = {k: sum(x["launches"][k] for x in res) for k in counters}
    print(f"ep: launches {json.dumps(launches)} (no kernel on the EP path)")
    check(not any(launches.values()), "ep: a kernel launched on the EP path")
    if backend == "nccl":
        mesh_serve_report([x["serve"] for x in res])
    return launches


def _timed_collectives(mesh, log):
    """Time each of ``mesh``'s collectives (host clock between device
    synchronisations) into ``log`` as (kind, axes, ranks, bytes in,
    seconds)."""
    run = mesh._run

    def timed_run(kind, t, axes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(kind, t, axes)
        torch.cuda.synchronize()
        log.append((kind, axes, mesh._size(axes), t.numel() * t.element_size(),
                    time.perf_counter() - t0))
        return out

    mesh._run = timed_run
    return run


def _checksums_agree(dist, backend, tensors) -> bool:
    """Whether every rank holds the same ``tensors``: their sums and norms
    in fp64, all-gathered and compared exactly."""
    sums = torch.stack([v for t in tensors for v in (t.sum(dtype=torch.float64),
                                                     torch.linalg.vector_norm(
                                                         t, dtype=torch.float64))])
    sums = sums if backend == "nccl" else sums.cpu()
    every = [torch.empty_like(sums) for _ in range(EP_RANKS)]
    dist.all_gather(every, sums)
    return all(torch.equal(e, every[0]) for e in every)


def ep_child(counters, rank: int, port: int, out_dir: Path,
             backend: str = "gloo") -> None:
    """One rank of ``ep_phase`` (``chip_smoke.py --phase ep RANK PORT DIR
    [BACKEND]``): gloo ranks share card 0, an NCCL rank takes card RANK."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models.layers import init_tree

    init = dict(init_method=f"tcp://localhost:{port}", rank=rank, world_size=EP_RANKS,
                timeout=datetime.timedelta(seconds=600))
    if backend == "nccl":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        dist.init_process_group("nccl", device_id=dev, **init)
    else:
        dev = torch.device("cuda")
        dist.init_process_group("gloo", **init)
    cfg = get_config("qwen3-moe-235b-a22b")
    E, d = cfg.n_experts, cfg.d_model
    p = init_tree(moe.moe_spec(cfg), torch.Generator(device=dev).manual_seed(0),
                  torch.bfloat16, dev)
    x = torch.randn((4, 128, d), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    c = torch.randn((4, 128, d), generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    same_weights = _checksums_agree(dist, backend, [x, c, *p.values()])
    meshes = {shape: make_test_mesh(*shape) for shape in {s for s, _ in EP_CASES}}
    for cnt in counters.values():
        cnt.launches = 0

    def grads(xs, cs, **kw):
        """y and the gradient of sum(y * c) for x and each of p's leaves."""
        leaves = {"x": xs.detach().requires_grad_(),
                  **{k: v.detach().requires_grad_() for k, v in p.items()}}
        y = moe.moe_apply({k: leaves[k] for k in p}, leaves["x"], cfg, **kw)[0]
        return y, dict(zip(EP_LEAVES, torch.autograd.grad(
            (y.float() * cs).sum(), [leaves[k] for k in EP_LEAVES])))

    # the backward's rows: all 4 with a card a rank; 1 where the 4 ranks
    # share one card (at no drop each rank's expert buffers at T = 512, and
    # their gradients, would pass the card's 80 GB with the four copies of
    # the weights and their gradients)
    bwd_rows = x.shape[0] if backend == "nccl" else 1
    want = want_g = None
    keep = E // min(s[1] for s, _ in EP_CASES)          # the experts rank 0 holds in any case
    if rank == 0:
        # without drops a token's output is its own routing's alone, so the
        # single-device path runs a row at a time (its capacity buffer for
        # all 512 tokens, 128 experts x 4,096 slots, would be 4.3 GB), and
        # the gradient is the rows' sum (one row's as it is, a sum in fp32;
        # the weights' kept for the experts rank 0 holds)
        rows, gx, want_g = [], [], {}
        for i in range(x.shape[0]):
            if i >= bwd_rows:
                with torch.no_grad():
                    rows.append(moe.moe_apply(p, x[i:i + 1], cfg, capacity_factor=0.0)[0])
                continue
            y, g = grads(x[i:i + 1], c[i:i + 1], capacity_factor=0.0)
            rows.append(y.detach())
            gx.append(g.pop("x"))
            for k, v in g.items():
                v = v[:keep].clone() if k.startswith("w_") else v
                want_g[k] = v if k not in want_g else want_g[k].float() + v
            del y, g
        want, want_g["x"] = torch.cat(rows), torch.cat(gx)
        torch.cuda.empty_cache()
    dist.barrier()
    cases = {}
    for shape, mode in EP_CASES:
        mesh = meshes[shape]
        log = []
        run = _timed_collectives(mesh, log)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        # no drop: the output, then the gradient on bwd_rows (the backward timed)
        nodrop_kw = dict(mesh=mesh, capacity_factor=0.0, cap_slack=1.0, fsdp_mode=mode)
        with torch.no_grad():
            nodrop = moe.moe_apply(p, x, cfg, **nodrop_kw)[0]
        leaves = {"x": x[:bwd_rows].detach().requires_grad_(),
                  **{k: v.detach().requires_grad_() for k, v in p.items()}}
        y = moe.moe_apply({k: leaves[k] for k in p}, leaves["x"], cfg, **nodrop_kw)[0]
        loss = (y.float() * c[:bwd_rows]).sum()
        del y
        dist.barrier()
        torch.cuda.synchronize()
        del log[:]
        start.record()
        got_g = dict(zip(EP_LEAVES, torch.autograd.grad(loss, [leaves[k] for k in EP_LEAVES])))
        end.record()
        torch.cuda.synchronize()
        case = {"finite": bool(torch.isfinite(nodrop).all()), "bwd_rows": bwd_rows,
                "bwd_ms": start.elapsed_time(end),
                "bwd_coll_ms": 1e3 * sum(r[-1] for r in log), "bwd_colls": list(log)}
        # this rank's block of each weight: its experts over `model`, its
        # slice of d over `data`
        n_data, n_model = shape
        e_l, d_l = E // n_model, d // n_data
        mi, di = mesh.axis_index("model"), mesh.axis_index("data")
        blocks = {"w_gate": (slice(mi * e_l, (mi + 1) * e_l), slice(di * d_l, (di + 1) * d_l)),
                  "w_down": (slice(mi * e_l, (mi + 1) * e_l), slice(None),
                             slice(di * d_l, (di + 1) * d_l))}
        blocks["w_up"] = blocks["w_gate"]
        case["grads_agree"] = _checksums_agree(dist, backend,
                                               [got_g["x"], got_g["router"]])
        if rank == 0:
            case["err"] = float((nodrop.float() - want.float()).abs().max())
            case["scale"] = float(want.float().abs().max())
            case["grad_err"], case["grad_scale"] = {}, {}
            for k in EP_LEAVES:
                # rank 0's block starts at the origin
                g = got_g[k][blocks[k]] if k in blocks else got_g[k]
                w = want_g[k][blocks[k]] if k in blocks else want_g[k]
                case["grad_err"][k] = float((g.float() - w.float()).abs().max())
                case["grad_scale"][k] = float(w.float().abs().max())
        # zero outside the block: the block cleared in place, then the
        # extremes (a count of nonzeros would take 8 bytes an element)
        for k, b in blocks.items():
            got_g[k][b] = 0
        case["zero_outside"] = all(float(got_g[k].max()) == 0 == float(got_g[k].min())
                                   for k in blocks)
        del nodrop, loss, leaves, got_g
        torch.cuda.empty_cache()
        # the defaults: drops, a second call bit-identical, the call timed
        with routing(moe) as rec:
            a = moe.moe_apply(p, x, cfg, mesh=mesh, fsdp_mode=mode)[0]
        call = rec.calls[0]
        case["cap"] = call["cap"]
        case["pairs"] = int(call["counts"].sum())
        case["dropped"] = int((call["counts"] - call["cap"]).clamp(min=0).sum())
        dist.barrier()
        torch.cuda.synchronize()
        del log[:]
        start.record()
        b = moe.moe_apply(p, x, cfg, mesh=mesh, fsdp_mode=mode)[0]
        end.record()
        torch.cuda.synchronize()
        case.update(same=bool(torch.equal(a, b)), ms=start.elapsed_time(end),
                    coll_ms=1e3 * sum(r[-1] for r in log), colls=list(log))
        case["finite"] = case["finite"] and bool(torch.isfinite(a).all())
        mesh._run = run
        if backend == "nccl":
            case["bus"] = _bus_sweep(dist, mesh, case["colls"] + case["bwd_colls"])
        cases[f"{shape[0]}x{shape[1]} {mode}"] = case
        del a, b
        torch.cuda.empty_cache()
    out = {"rank": rank, "device": torch.cuda.get_device_name(dev), "cases": cases,
           "same_weights": same_weights, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: cnt.launches for k, cnt in counters.items()}}
    if backend == "nccl":
        del p, x, c, want, want_g
        gc.collect()
        torch.cuda.empty_cache()
        out["serve"] = mesh_serve(counters, dist, rank, dev)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def mesh_serve(counters, dist, rank: int, dev):
    """On each NCCL rank: Qwen3-MoE-235B-A22B at full width and
    MESH_SERVE's depth served through ``RealEngine`` on ``build_model(cfg,
    mesh=(1, 4) mesh)`` (the reference's ``RealEngine(model, params,
    rt=Runtime(mesh=...))``): the serve phases' traffic and head, every
    rank with the whole seeded weights, each MoE layer's experts split over
    ``model`` and summed by one all-reduce. Rank 0 also holds each MoE
    layer of one prefill against the single-device expert FFN on the same
    inputs at the same capacity, and its prefill logits against a mesh-less
    model's on the same params."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import fit_and_predict
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model, last_token_hidden
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serving.engine import RealEngine

    name, depth, r = MESH_SERVE
    cfg = get_config(name).with_overrides(n_layers=depth)
    mesh = make_test_mesh(1, EP_RANKS)
    model = build_model(cfg, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device=dev)
    leaves = list(_leaves(params))
    res = {"n_params": sum(int(t.numel()) for t in leaves),
           "same_params": _checksums_agree(dist, "nccl", leaves)}
    B, Sp, max_new = 8, 512, 64
    prompts, plens = served_prompts(cfg.vocab_size)
    eng = RealEngine(model, params, max_new=max_new)
    for cnt in counters.values():
        cnt.launches = 0
    lens, toks, phi = np.zeros((B, r), np.int64), [], None
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(r):                 # RealEngine.repeated_sampling, its tokens kept
        gen = torch.Generator(device=dev).manual_seed(j)
        o = eng.generate(prompts, plens, gen, collect_hidden=(j == 0))
        lens[:, j], phi = o["lengths"], o["phi"] if j == 0 else phi
        toks.append(o["tokens"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    pred = fit_and_predict(lens, phi, cfg.predictor_bins, seed=1, qs=(0.5, 0.9), device=dev)
    torch.cuda.synchronize()
    res["launches"] = {k: cnt.launches for k, cnt in counters.items()}
    res["expected"] = expected_launches(cfg, r, max_new)
    res.update(gen_s=gen_s, n_tok=int(lens.sum()), lens_max=int(lens.max()),
               lens_min=int(lens.min()),
               finite=bool(np.isfinite(phi).all() and np.isfinite(pred["median"]).all()
                           and np.isfinite(pred["quantiles"]).all()))
    mine = torch.as_tensor(np.stack(toks), device=dev)
    every = [torch.empty_like(mine) for _ in range(EP_RANKS)]
    dist.all_gather(every, mine)
    steps_differ = [int((e != every[0]).any(dim=(0, 1)).nonzero()[0]) if not torch.equal(
        e, every[0]) else None for e in every]
    res["first_step_differing"] = steps_differ
    # one prefill and one decode step timed, the step profiled and its
    # collectives counted
    tokens = torch.as_tensor(prompts, device=dev)
    lens_t = torch.as_tensor(plens, device=dev)
    valid = torch.arange(Sp, device=dev)[None, :] < lens_t[:, None]
    with torch.no_grad():
        prefill = lambda: model.prefill(params, tokens, attn_valid=valid, logits_mode="none")
        res["prefill_ms"] = time_ms(prefill, iters=3, warmup=1)
        cache = model.init_cache(B, Sp + max_new, device=dev)
        pos = lens_t.to(torch.int32)
        nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
        step = lambda: model.decode_step(params, nxt, cache, pos, pos + 1)
        res["step_ms"] = time_ms(step, iters=10, warmup=2)
        res["profile"] = device_profile(step, f"mesh serve rank {rank} decode step")
        log = []
        run = _timed_collectives(mesh, log)
        step()
        mesh._run = run
        res["step_colls"] = [[k, n] for k, _, n, _, _ in log]
        res["n_moe"] = sum(k == "moe" for k in layer_kinds(cfg))
        del cache
        # rank 0: one prefill's MoE layers captured (inputs, routing, output)
        calls = []
        orig = moe._expert_parallel

        def capture(xf, top_ids, combine, p, *a, **kw):
            out = orig(xf, top_ids, combine, p, *a, **kw)
            if rank == 0:
                calls.append((xf, top_ids, combine, p, out))
            return out

        moe._expert_parallel = capture
        try:
            with routing(moe) as rec:
                _, hidden, _ = prefill()
        finally:
            moe._expert_parallel = orig
        logits = model.unembed(params, last_token_hidden(hidden, lens_t)).float()
        del hidden
        if rank == 0:
            caps = [cl["cap"] for cl in rec.calls]
            errs = []
            for (xf, ids, cw, p, out), cap in zip(calls, caps):
                w, _ = moe._expert_ffn_local(xf, ids, cw, p["w_gate"], p["w_up"], p["w_down"], cap)
                errs.append([float((out.float() - w.float()).abs().max()),
                             float(w.float().abs().max())])
            res["layer_errs"] = errs
            del calls
            # the mesh-less model at the capacity the mesh's shard gave the
            # prefill's T = B x Sp tokens
            T, k, E = B * Sp, cfg.n_experts_per_token, cfg.n_experts
            cf = (caps[0] - 1) * E / (T * k)
            res["cap"], res["cap_single"] = caps[0], moe._capacity(T, k, E, cf)
            single = build_model(cfg, capacity_factor=cf)
            _, h1, _ = single.prefill(params, tokens, attn_valid=valid, logits_mode="none")
            want = single.unembed(params, last_token_hidden(h1, lens_t)).float()
            res["logits_err"] = float((logits - want).abs().max())
            res["logits_scale"] = float(want.abs().max())
            res["logits_rel_l2"] = float(torch.linalg.vector_norm(logits - want)
                                         / torch.linalg.vector_norm(want))
            del h1, want
    dist.barrier()
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def mesh_serve_report(res) -> None:
    """Print and check ``mesh_serve``'s results (one per rank)."""
    name, depth, r = MESH_SERVE
    r0 = res[0]
    # NCCL's kernels run on a stream of their own, beside the step's, and
    # last until every rank has arrived: their time is counted apart
    prof = [x["profile"] or {} for x in res]
    nccl = [sum(ms for k, ms in p["kernels"].items() if "nccl" in k.lower()) if p else None
            for p in prof]
    busy = [round((p["busy_ms"] - t) / p["wall_ms"], 3) if p else None
            for p, t in zip(prof, nccl)]
    print(f"mesh serve {name} ({depth} layers, {r0['n_params'] / 1e9:.3f}B params on every "
          f"rank, the same there {[x['same_params'] for x in res]}) on a (1, 4) mesh over "
          f"NCCL, B=8 Sp=512 r={r} max_new=64: tokens/s per rank "
          f"{[round(x['n_tok'] / x['gen_s'], 1) for x in res]}; prefill ms "
          f"{[round(x['prefill_ms'], 2) for x in res]}; decode step ms "
          f"{[round(x['step_ms'], 2) for x in res]}, device-busy share without NCCL's "
          f"kernels {busy} (NCCL's kernels ms {[t and round(t, 2) for t in nccl]} under the "
          f"profiler), launches a step {[p.get('launches') for p in prof]}; peak memory (GB) "
          f"{[round(x['peak_gb'], 2) for x in res]} (one card, chip run 1, PR 20: "
          f"{MESH_SERVE_ONE_CARD})")
    print(f"mesh serve: collectives of one decode step (rank 0) {r0['step_colls']}; sampled "
          f"tokens against rank 0's, the first step that differs per rank "
          f"{r0['first_step_differing']}; launches per rank "
          f"{[x['launches'] for x in res]}, expected with every row at max_new "
          f"{r0['expected']}")
    print(f"mesh serve: rank 0's prefill, each MoE layer against the single-device expert "
          f"FFN on its inputs at capacity {r0['cap']} (max|err| / max|out|) "
          f"{[round(e / s, 4) for e, s in r0['layer_errs']]} (tolerance 2e-2); logits against "
          f"a mesh-less model at capacity {r0['cap_single']}: max|err| {r0['logits_err']:.4g} "
          f"at max|logit| {r0['logits_scale']:.4g}, relative L2 {r0['logits_rel_l2']:.4g} "
          f"(tolerance 5e-2)")
    check(all(x["same_params"] for x in res), "mesh serve: the ranks' seeded weights differ")
    check(all(s is None for s in r0["first_step_differing"]),
          "mesh serve: the ranks sampled different tokens")
    check(all(x["finite"] and 1 <= x["lens_min"] <= x["lens_max"] <= 64 for x in res),
          "mesh serve: lengths or predictions out of range")
    for x in res:
        got = x["launches"]
        for kname in ("flash_attention", "decode_attention", "prod_head", "unembed",
                      "rms_norm", "rope"):
            check(got[kname] > 0, f"mesh serve: {kname} was not launched")
            if x["lens_min"] == 64:
                check(got[kname] == x["expected"][kname],
                      f"mesh serve: {kname} launched {got[kname]} times, expected "
                      f"{x['expected'][kname]}")
        check(got["ssd_scan"] == 0, "mesh serve: ssd_scan launched off its path")
    check(r0["step_colls"] == [["all_reduce", EP_RANKS]] * r0["n_moe"],
          "mesh serve: a decode step is not one all-reduce over model per MoE layer")
    check(r0["cap_single"] == r0["cap"], "mesh serve: the mesh-less capacity differs")
    check(all(e <= 2e-2 * s for e, s in r0["layer_errs"]),
          "mesh serve: a MoE layer differs from the single-device expert FFN")
    check(r0["logits_rel_l2"] <= 5e-2, "mesh serve: prefill logits differ from the mesh-less model")


# the dryrun phase's combinations (launch/dryrun.py on the 16x16 pod mesh)
DRYRUN_COMBOS = (("llama3-8b", "decode_32k"), ("qwen3-moe-235b-a22b", "prefill_32k"))


def dryrun_child_start():
    """The dryrun phase in a child process (``chip_smoke.py --phase
    dryrun``): its fake 256-rank process group must not meet the ep
    phase's real one. It traces on the host's CPU, so it runs beside the
    host-bound table1, ablations, sim and single phases, as the cluster
    child does, and not beside the timed kernel and serve phases."""
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--phase", "dryrun"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dryrun_result(child, t0: float):
    """Wait for the dryrun child; print its report and check each combination
    traced. Returns its launches (none: it traces fake CPU tensors)."""
    log, _ = child.communicate(timeout=600)
    print(log.rstrip())
    check(child.returncode == 0, f"dryrun: the child exited {child.returncode}")
    out = json.loads(log.strip().splitlines()[-1])
    print(f"dryrun: {time.perf_counter() - t0:.1f} s from its start to its result")
    check(all(r["ok"] for r in out["results"]), "dryrun: a combination failed to trace")
    check(not any(out["launches"].values()), "dryrun: a kernel launched")
    return out["launches"]


def dryrun_child(counters) -> None:
    """``launch/dryrun.py``'s run_one for DRYRUN_COMBOS on the pod mesh, the
    roofline table of the results, and the card's memory against
    ``launch/mesh.py``'s HBM_BYTES. Prints a JSON line last."""
    from repro_torch.launch import dryrun, mesh, roofline

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dryrun: torch.cuda.get_device_properties(0).total_memory {total} "
          f"(launch/mesh.py HBM_BYTES {mesh.HBM_BYTES})")
    check(total == mesh.HBM_BYTES, "dryrun: HBM_BYTES is not this card's memory")
    rows = []
    for arch, shape in DRYRUN_COMBOS:
        r = dryrun.run_one(arch, shape, multi_pod=False)
        rows.append(r)
        print(f"dryrun {arch} x {shape}: ok {r['ok']} in {r['total_s']} s "
              f"({r.get('graph_nodes')} graph nodes); per device {r.get('flops_per_device', 0):.4g} "
              f"FLOP, {r.get('bytes_per_device', 0):.4g} HBM bytes, argument bytes "
              f"{r.get('memory', {}).get('argument_bytes')}; expert-parallel collectives "
              f"{json.dumps({k: v for k, v in r.get('expert_parallel', {}).items() if k.endswith('_count') and v})}"
              + (f"\n{r['traceback']}" if not r["ok"] else ""))
    print(roofline.table(rows))
    for line in roofline.notes(rows):
        print(f"  {line}")
    print(json.dumps({"results": [{k: r.get(k) for k in ("arch", "shape", "ok", "total_s")}
                                  for r in rows],
                      "launches": {k: c.launches for k, c in counters.items()}}))


def mesh_checks(model, params_bytes: int, cache_bytes: int, B: int, Sp: int,
                cache_len: int, flops_bound: float) -> None:
    """The serve phase's check of the mesh tooling on Llama-3-8B: on a (1, 1)
    mesh the per-device argument bytes of the params and a B x cache_len
    cache (``common/sharding.py``) equal what init and init_cache allocated
    on the card, within 0.1%; the prefill traced on fake tensors
    (``launch/graph_analysis.py``) does at least the weight products'
    FLOPs and at most those plus the attention pairs'."""
    from repro_torch.common.pytree import fake_tensor
    from repro_torch.common.sharding import map_axes, shard_shape, tree_shardings
    from repro_torch.launch import graph_analysis
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(1, 1)
    want = 0
    for axes, shapes in ((model.param_axes(), model.param_shapes()),
                         (model.cache_axes(), model.cache_shapes(B, cache_len))):
        specs = tree_shardings(axes, shapes, mesh)
        sizes = []
        map_axes(lambda _a, t, s: sizes.append(int(np.prod(shard_shape(t.shape, s, mesh)))
                                               * t.dtype.itemsize), axes, shapes, specs)
        want += sum(sizes)
    got = params_bytes + cache_bytes
    print(f"mesh: (1, 1) argument bytes of params + the B={B}, {cache_len}-slot cache "
          f"{want} against {got} allocated by init + init_cache ({got / want - 1:+.2e}; "
          f"tolerance 1e-3)")
    check(abs(got - want) <= 1e-3 * want, "mesh: argument bytes differ from the allocation")
    t0 = time.perf_counter()
    cfg = model.cfg
    gm = graph_analysis.trace(lambda p, t: model.prefill(p, t, logits_mode="none")[1],
                              model.param_shapes(), fake_tensor((B, Sp), torch.long))
    flops = graph_analysis.analyze(gm).flops
    attn = 4.0 * B * Sp * Sp * cfg.n_heads * cfg.head_dim * cfg.n_layers
    print(f"mesh: traced prefill (B={B}, S={Sp}) {flops / 1e12:.3f} TFLOP in "
          f"{time.perf_counter() - t0:.1f} s: weight products {flops_bound / 1e12:.3f}, "
          f"attention pairs (QK and PV over every pair) {attn / 1e12:.3f}")
    check(flops_bound <= flops <= flops_bound + attn, "mesh: traced prefill FLOPs out of bounds")



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
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    kernels = kernel_wrappers()
    # the ep ranks and the dryrun child build no kernel (an NCCL rank's serve
    # loads what its parent built)
    if sys.argv[1:3] == ["--phase", "ep"]:              # a rank of ep_phase
        ep_child(kernels, int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5]),
                 *sys.argv[6:7])
        return 0
    if sys.argv[1:] == ["--phase", "dryrun"]:           # the child of dryrun_child_start
        dryrun_child(kernels)
        return 0
    # the plain versions are the reference: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi())

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in Path(f"{lib}.log").read_text().splitlines():
            if "Used" in line or "spill" in line or "Function properties" in line:
                print(f"  {lib.name.split('-')[0]}: {line.strip()}")

    if sys.argv[1:] == ["--phase", "cluster"]:          # the child of cluster_child
        launches, stamped = cluster_phase(kernels)
        print(json.dumps({"launches": launches, "stamped": stamped}))
        return 0
    wall, since = {}, [time.perf_counter()]

    def mark(phase: str) -> None:
        """Wall seconds of the phase that just ended (printed before the
        kernels line: the script must end well inside its time limit)."""
        now = time.perf_counter()
        wall[phase], since[0] = round(now - since[0], 1), now

    rows = kernel_checks()
    rows += gemma3_kernel_checks()
    rows += moe_kernel_checks()
    rows += mla_kernel_checks()
    rows += encdec_vlm_kernel_checks()
    rows += unembed_kernel_checks()
    rows += norm_rope_kernel_checks()
    mark("kernels")
    by_phase = {}
    by_phase["run"], run_rows = run_phase(kernels)
    rows += run_rows
    mark("run")
    by_phase["ep"] = ep_phase(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    mark("ep")
    for i, (name, r, on_path, profile, depth) in enumerate(SERVE_PHASES):
        by_phase[name] = serve(kernels, name, r, on_path, sweep=(i == 0),
                               profile=profile, depth=depth)
        gc.collect()                 # each model's weights go before the next's
        torch.cuda.empty_cache()
        mark(name)
    by_phase["kimi-k2-instruct"] = mla_phase(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    mark("kimi-k2-instruct")
    by_phase["long"] = long_phase(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    mark("long")
    by_phase["gemma3 long"] = gemma3_long_phase(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    mark("gemma3 long")
    by_phase["qwen2-vl-2b embeds"] = vlm_embeds_phase(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    mark("qwen2-vl-2b embeds")
    by_phase["whisper-large-v3"] = whisper_phase(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    mark("whisper-large-v3")
    STAMP.parent.mkdir(exist_ok=True)
    STAMP.unlink(missing_ok=True)                       # the child stamps anew
    t_child, child = time.perf_counter(), cluster_child()
    t_dryrun, dry_child = time.perf_counter(), dryrun_child_start()
    try:
        by_phase["table1"], t1_rows = table1_phase(kernels)
        mark("table1")
        by_phase["ablations"] = ablations_phase(kernels, t1_rows)
        mark("ablations")
        by_phase["sim"] = sim_phase(kernels)
        by_phase["single"] = single_phase(kernels)
        mark("sim, single")
        by_phase["cluster"] = cluster_result(child, t_child)
        mark("cluster (the wait for its child)")
        by_phase["dryrun"] = dryrun_result(dry_child, t_dryrun)
        mark("dryrun (the wait for its child)")
    finally:
        for c in (child, dry_child):
            if c.poll() is None:
                c.kill()
                c.wait()
    by_phase["train"] = train_phase(kernels)
    torch.cuda.empty_cache()
    mark("train")
    by_phase["ssm train"] = ssm_train_phase(kernels)
    mark("ssm train")
    by_phase["int8 kv"] = int8_kv_phase(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    mark("int8 kv")
    by_phase["online"] = online_phase(kernels)
    mark("online")
    by_phase["e2e"] = e2e_phase(kernels)
    mark("e2e")
    print(f"phase wall times (s): {json.dumps(wall)}; {sum(wall.values()):.1f} s from the "
          f"kernel phase to the end")

    report = []
    for r in rows:
        if any(k["name"] == r["name"] for k in report):
            continue             # one entry per kernel: its first (serving) shape
        n = r["name"]
        report.append({"name": n, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{n}.cu",
                       "replaces": REPLACES[n],
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
