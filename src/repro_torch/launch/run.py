"""Benchmark runner on the port — one entry per paper table/figure + system
benches: the twin of the reference's ``benchmarks/run.py``.

Prints the same ``name,value,derived`` CSV rows, in the same order, from the
port's twins (``bench_fig1``, ``bench_theory``, ``table1``, ``bench_table23``,
``bench_fig2``, ``bench_serving``, ``bench_online``, ``bench_bins_ablation``,
``bench_kernels``); Table 1's rows feed Tables 2-3's ``validate``, as in the
reference. The kernel rows are µs per call of the CUDA kernels (eager), or of
the plain versions with ``--device cpu``. The reference's ``roofline`` entry
reads the TPU dry-run's artifacts, which the port does not have yet (ROADMAP
Queue 1, the TPU-mesh tooling), so it is not in the default set and
``--only roofline`` exits non-zero. Usage:

    PYTHONPATH=src python -m repro_torch.launch.run [--full] [--only table1,...]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from repro_torch.common.device import resolve_device

ENTRIES = ("fig1", "theory", "table1", "table23", "fig2", "serving", "online", "bins",
           "kernels")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale splits (slow; default is the fast profile)")
    ap.add_argument("--only", default=None,
                    help="comma list: " + ",".join(ENTRIES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fast = not args.full
    only = set(args.only.split(",")) if args.only else None
    if only and "roofline" in only:
        raise SystemExit("--only roofline: the roofline reads the TPU dry-run's artifacts, "
                         "which are not ported (ROADMAP Queue 1: the TPU-mesh tooling)")
    if only and not only <= set(ENTRIES):
        ap.error(f"unknown entries {sorted(only - set(ENTRIES))}; choose from "
                 f"{','.join(ENTRIES)}")
    dev = resolve_device(args.device)
    rows = []

    def emit(name, value, derived=""):
        rows.append((name, value, derived))
        print(f"{name},{value},{derived}", flush=True)

    def want(name):
        return only is None or name in only

    t_all = time.time()

    if want("fig1"):
        print("== Figure 1 / A.4: key observations ==", flush=True)
        from repro_torch.launch import bench_fig1
        out = bench_fig1.run(device=dev)
        checks = bench_fig1.validate(out)
        emit("fig1_calibration_max_rel_err", f"{checks['max_calibration_rel_err']:.3f}",
             "vs paper noise radii")
        emit("fig1_heavy_tails_present", checks["heavy_tails_present"], "")
        sp = bench_fig1.system_prompt_effect(device=dev)
        emit("fig1_system_prompt_radius_reduction_pct",
             f"{sp['radius_reduction_pct']:.1f}", "A.3 analog")

    if want("theory"):
        print("== Theorem 1 / Lemma 3 ==", flush=True)
        from repro_torch.launch import bench_theory
        out = bench_theory.run()
        checks = bench_theory.validate(out)
        for k, v in checks.items():
            emit(f"theory_{k}", v, "")
        emit("theory_lemma3_worst_ratio",
             f"{max(v['ratio'] for v in out['lemma3'].values()):.3f}", "bound: 2.0")

    t1_rows = None
    if want("table1"):
        print("== Table 1: prompt-only MAE ==", flush=True)
        from repro_torch.launch import table1
        out = table1.run(fast=fast, device=dev)
        t1_rows = out["rows"]
        for (method, model, _), v in sorted(out["avg"].items()):
            emit(f"table1_avg_{method}_{model}", f"{v:.2f}", "MAE tokens")
        for k, v in out["checks"].items():
            emit(f"table1_{k}", v if not isinstance(v, float) else f"{v:.1f}", "")

    if want("table23"):
        print("== Tables 2-3: single-sample ablation ==", flush=True)
        from repro_torch.launch import bench_table23
        out = bench_table23.run(fast=fast, device=dev)
        if t1_rows is not None:
            checks = bench_table23.validate(out, t1_rows)
            for k, v in checks.items():
                emit(f"table23_{k}", v if not isinstance(v, float) else f"{v:.1f}", "")

    if want("fig2"):
        print("== Figure 2: budget fairness ==", flush=True)
        from repro_torch.launch import bench_fig2
        out = bench_fig2.run(fast=fast, device=dev)
        for k, v in bench_fig2.validate(out).items():
            emit(f"fig2_{k}", v, "")

    if want("serving"):
        print("== Serving impact (beyond paper) ==", flush=True)
        from repro_torch.launch import bench_serving
        srows = bench_serving.run(fast=fast, device=dev)
        for k, v in bench_serving.validate(srows).items():
            emit(f"serving_{k}", v if not isinstance(v, float) else f"{v:.1f}", "")

    if want("online"):
        print("== ProD-O: online remaining-length (beyond paper) ==", flush=True)
        from repro_torch.launch import bench_online
        rep = bench_online.run(device=dev)
        for k, v in bench_online.validate(rep).items():
            emit(f"online_{k}", v if not isinstance(v, float) else f"{v:.2f}", "")

    if want("bins"):
        print("== Bin-spacing ablation (beyond paper) ==", flush=True)
        from repro_torch.launch import bench_bins_ablation
        out = bench_bins_ablation.run(fast=fast, device=dev)
        for k, v in bench_bins_ablation.validate(out).items():
            emit(f"bins_{k}", v, "")

    if want("kernels"):
        print("== Kernel micro-benchmarks ==", flush=True)
        from repro_torch.launch import bench_kernels
        how = "cuda eager" if dev.type == "cuda" else "plain/cpu"
        for name, us in bench_kernels.run(device=dev).items():
            emit(name, f"{us:.1f}", f"us_per_call ({how})")

    print(f"\ntotal bench time: {time.time()-t_all:.0f}s ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
