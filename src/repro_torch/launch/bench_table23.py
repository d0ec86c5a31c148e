"""Tables 2–3 — single-sample supervision ablation, on the port.

Every predictor family retrained with ONE sampled length per prompt;
evaluated against (T2) the single-label target and (T3) the 16-sample median
target, mean ± std over trials. ProD-D is omitted (degenerate under a single
sample — paper §3.3). Validates: single-sample supervision degrades every
method vs Table 1, and ProD-M stays best. The twin of the reference's
``benchmarks/bench_table23.py``; ProD-M decodes the median through the fused
head kernel, the other methods by argmax or mean.

    PYTHONPATH=src python -m repro_torch.launch.bench_table23 [--full]
        [--validate] [--device cpu]

``--validate`` also runs Table 1 (``launch/table1.py``) at the same profile
and prints ``validate(t23, its rows)``.
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.baselines import run_method
from repro_torch.launch import table1
from repro_torch.launch.table1 import all_settings, scenario_pcfg

ABLATION_METHODS = ("s3", "trail_mean", "trail_last", "egtp", "prod_m")


def fit_seed(method: str, t: int) -> int:
    """Trial ``t``'s seed of ``method``: the integer the reference makes its
    key of, ``PRNGKey(1000 * t + zlib.crc32(method.encode()) % 997)``."""
    return 1000 * t + zlib.crc32(method.encode()) % 997


def run_setting(out, model, scen, data, epochs, n_trials=3, device: DeviceLike = None):
    """One setting's rows of both tables, added to ``out``: every method of
    :data:`ABLATION_METHODS` × eval target × trial, trial ``t`` supervised by
    the ``t``-th sampled length."""
    pcfg = scenario_pcfg(data, epochs=epochs)
    for method in ABLATION_METHODS:
        for ev in ("single", "median"):
            maes = []
            for t in range(n_trials):
                res = run_method(fit_seed(method, t), data, method, pcfg,
                                 supervision="single", single_idx=t,
                                 eval_target=ev, device=device)
                maes.append(res.test_mae)
            out[ev].setdefault(method, {})[(model, scen)] = (
                float(np.mean(maes)), float(np.std(maes)))
    return out


def run(fast=True, seed=0, n_trials=3, verbose=True, device: DeviceLike = None):
    dev = resolve_device(device)
    out = {"single": {}, "median": {}}
    for model, scen, data, epochs in all_settings(fast=fast, seed=seed):
        run_setting(out, model, scen, data, epochs, n_trials, dev)
        if verbose:
            m, s = out["median"]["prod_m"][(model, scen)]
            print(f"  [{model}/{scen}] prod_m(single-sup, median-eval) = {m:.1f}±{s:.1f}",
                  flush=True)
    return out


def validate(t23, t1_rows) -> dict:
    settings = list(t23["median"]["prod_m"].keys())
    avg23 = lambda m: float(np.mean([t23["median"][m][s][0] for s in settings]))
    # per-setting RELATIVE degradation (a flat average is dominated by chat,
    # where both regimes are feature-noise-bound and supervision noise is
    # immaterial — consistent with the paper's pattern of smaller relative
    # gaps on chat)
    rel = [
        (t23["median"]["prod_m"][s][0] - t1_rows["prod_m"][s])
        / max(t1_rows["prod_m"][s], 1e-9) for s in settings
    ]
    avg_single_eval = float(np.mean(
        [t23["single"]["prod_m"][s][0] for s in settings]))
    avg_median_eval = avg23("prod_m")
    return {
        "prod_m_best_in_ablation": avg23("prod_m") <= min(
            avg23(m) for m in ABLATION_METHODS),
        # paper's T2 > T3 pattern: the one-shot test target injects its own
        # noise on top of the predictor error
        "single_eval_noisier_than_median_eval":
            avg_single_eval > avg_median_eval,
        "mean_relative_degradation_pct": float(100 * np.mean(rel)),
        "max_relative_degradation_pct": float(100 * np.max(rel)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the paper's split sizes and 30 epochs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validate", action="store_true",
                    help="also run Table 1 and print validate(t23, its rows)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(fast=not args.full, seed=args.seed, device=dev)
    print("\nTable 2/3 averages (single-sample supervision):")
    for ev in ("single", "median"):
        for method in ABLATION_METHODS:
            vals = [v[0] for v in out[ev][method].values()]
            print(f"  eval={ev:7s} {method:12s} {np.mean(vals):8.2f}")
    if args.validate:
        t1 = table1.run(fast=not args.full, seed=args.seed, verbose=False, device=dev)
        print("checks:", validate(out, t1["rows"]))
    return out


if __name__ == "__main__":
    main()
