"""Table 1 — prompt-only length prediction (main result), on the port.

Test MAE against the 16-sample median target for every method across the
eight (served model × scenario) settings, plus the Noise Radius reference
line, and the paper's claims on it (``validate``): ProD-D < ProD-M <
TRAIL-last < others, and the ProD average advantage over the best external
baseline. The twin of the reference's ``benchmarks/bench_table1.py``, with
the helpers it takes from ``benchmarks/common.py``. Every method trains the
same head; ProD-M and ProD-D decode the median through the fused head kernel.

    PYTHONPATH=src python -m repro_torch.launch.table1 [--full] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.common.config import PredictorConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.baselines import METHODS, run_method
from repro_torch.core.metrics import noise_radius
from repro_torch.data import make_scenario
from repro_torch.data.scenarios import MODELS, SCENARIOS

# the reference's profiles: reduced splits (fast), or the paper's (--full)
FAST = dict(n_train=700, n_test=350, epochs=15)
FULL = dict(n_train=None, n_test=None, epochs=30, full_paper_splits=True)


def scenario_pcfg(data, n_bins=64, epochs=15) -> PredictorConfig:
    bin_max = float(np.quantile(data.len_train, 0.999) * 1.3)
    return PredictorConfig(n_bins=n_bins, bin_max=bin_max, epochs=epochs)


def all_settings(fast=True, seed=0):
    prof = FAST if fast else FULL
    for model in MODELS:
        for scen in SCENARIOS:
            data = make_scenario(
                model, scen, seed=seed,
                n_train=prof.get("n_train"), n_test=prof.get("n_test"),
                full_paper_splits=prof.get("full_paper_splits", False),
            )
            yield model, scen, data, prof["epochs"]


def fold_in(seed: int, i: int) -> int:
    """Method ``i``'s seed, the port's ``jax.random.fold_in(key, i)``: the
    first 32-bit word of ``np.random.SeedSequence([seed, i])``."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def run(fast=True, seed=0, verbose=True, device: DeviceLike = None):
    dev = resolve_device(device)
    rows = {}
    radii = {}
    for model, scen, data, epochs in all_settings(fast=fast, seed=seed):
        pcfg = scenario_pcfg(data, epochs=epochs)
        for i, method in enumerate(METHODS):
            res = run_method(fold_in(seed, i), data, method, pcfg,
                             supervision="repeat", eval_target="median", device=dev)
            rows.setdefault(method, {})[(model, scen)] = res.test_mae
        radii[(model, scen)] = noise_radius(torch.as_tensor(data.len_test))
        if verbose:
            print(f"  [{model}/{scen}] " + "  ".join(
                f"{m}={rows[m][(model, scen)]:.1f}" for m in METHODS), flush=True)

    table = {}
    for method in METHODS:
        for model in MODELS:
            vals = [rows[method][(model, s)] for s in SCENARIOS]
            table[(method, model, "avg")] = float(np.mean(vals))
    checks = validate(rows, radii)
    return {"rows": rows, "noise_radius": radii, "avg": table, "checks": checks}


def validate(rows, radii) -> dict:
    """The paper's qualitative claims on Table 1:
    ProD-D strictly best on average (both backbones); ProD-M at worst ties the
    strongest external baseline (the paper's own gap is ~5%); the informative
    views beat Constant-Median; EGTP is allowed to underperform — the paper
    itself reports it losing to Constant on qwen/chat ("entropy-weighted
    selection concentrates on early tokens")."""
    settings = list(rows["prod_d"].keys())
    avg = lambda m: float(np.mean([rows[m][s] for s in settings]))
    externals = ("s3", "trail_mean", "trail_last", "egtp")
    checks = {
        "prod_d_best_avg": avg("prod_d") <= min(
            avg(m) for m in rows if m != "prod_d") + 1e-9,
        "prod_m_at_worst_ties_best_external": avg("prod_m")
        <= 1.03 * min(avg(m) for m in externals),
        "prod_beats_trail_last_pct": 100.0 * (avg("trail_last") - avg("prod_d"))
        / avg("trail_last"),
        "informative_views_beat_constant": all(
            avg(m) < avg("constant_median")
            for m in ("trail_mean", "trail_last", "prod_m", "prod_d")),
        "egtp_underperforms": avg("egtp") > avg("trail_last"),
    }
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the paper's split sizes and 30 epochs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(fast=not args.full, seed=args.seed, device=args.device)
    print("\nTable 1 averages (test MAE, lower better):")
    for (method, model, _), v in sorted(out["avg"].items()):
        print(f"  {method:16s} {model:6s} {v:8.2f}")
    print("claims:", out["checks"])
    return out


if __name__ == "__main__":
    main()
