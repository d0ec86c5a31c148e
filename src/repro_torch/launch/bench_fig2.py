"""Figure 2 — budget fairness: MAE vs repeat number under a fixed inference
budget, on the port. With repeat number k only ceil(B/k) unique prompts are
kept; compares ProD-M / ProD-D against the full-coverage single-sample
TRAIL-last baseline. Validates: repeated sampling pays off at fixed budget
on the hard scenarios. The twin of the reference's
``benchmarks/bench_fig2.py``: the same subsamples (NumPy), the head seeded
with the integers the reference makes its keys of; ProD-M and ProD-D decode
the median through the fused head kernel, TRAIL-last the mean.

    PYTHONPATH=src python -m repro_torch.launch.bench_fig2 [--full] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import bins as B
from repro_torch.core import targets as T
from repro_torch.core.metrics import mae
from repro_torch.core.predictor import train_predictor
from repro_torch.data import make_scenario
from repro_torch.launch.table1 import scenario_pcfg

REPEATS = (1, 2, 4, 8, 16)


def _fit(seed, phi, lens, kind, decode, pcfg, device: DeviceLike = None):
    edges = B.make_edges(pcfg.n_bins, pcfg.bin_max, device=device)
    tgt = T.build_target(torch.as_tensor(lens, dtype=torch.float32, device=device),
                         edges, kind)
    p = train_predictor(seed, phi, tgt, pcfg, edges, device=device)
    return p, decode


def run(scenarios=(("qwen", "math"), ("qwen", "longseq"), ("qwen", "chat"),
                   ("llama", "longseq")),
        fast=True, seed=0, n_trials=2, verbose=True, device: DeviceLike = None):
    dev = resolve_device(device)
    out = {}
    for model, scen in scenarios:
        data = make_scenario(model, scen, n_train=800 if fast else None,
                             n_test=400 if fast else None, seed=seed,
                             full_paper_splits=not fast)
        pcfg = scenario_pcfg(data, epochs=15 if fast else 30)
        Bn = data.len_train.shape[0]
        y_test = T.sample_median(torch.as_tensor(data.len_test, dtype=torch.float32,
                                                 device=dev))
        phi_te = torch.as_tensor(data.phi_test["last"], dtype=torch.float32, device=dev)
        curves = {}
        for k in REPEATS:
            n_keep = int(np.ceil(Bn / k))
            for method, kind, decode in (("prod_m", "median", "median"),
                                         ("prod_d", "dist", "median")):
                maes = []
                for t in range(n_trials):
                    rng = np.random.default_rng(seed * 77 + t)
                    idx = rng.permutation(Bn)[:n_keep]
                    lens_k = data.len_train[idx][:, :k]
                    if k == 1 and method == "prod_d":
                        continue  # degenerate
                    p, dec = _fit(t, data.phi_train["last"][idx], lens_k,
                                  kind if k > 1 else "single", decode, pcfg, dev)
                    maes.append(mae(p.predict(phi_te, dec), y_test))
                if maes:
                    curves.setdefault(method, {})[k] = (
                        float(np.mean(maes)), float(np.std(maes)))
        # full-coverage single-sample TRAIL-last baseline
        maes = []
        for t in range(n_trials):
            p, dec = _fit(100 + t, data.phi_train["last"], data.len_train[:, t: t + 1],
                          "single", "mean", pcfg, dev)
            maes.append(mae(p.predict(phi_te, dec), y_test))
        curves["trail_last_full"] = {1: (float(np.mean(maes)), float(np.std(maes)))}
        out[(model, scen)] = curves
        if verbose:
            best_k = min(curves["prod_d"], key=lambda k: curves["prod_d"][k][0])
            print(f"  [{model}/{scen}] trail_full={curves['trail_last_full'][1][0]:.1f} "
                  f"prod_d best k={best_k} ({curves['prod_d'][best_k][0]:.1f})", flush=True)
    return out


def validate(out) -> dict:
    checks = {}
    for (model, scen), curves in out.items():
        base = curves["trail_last_full"][1][0]
        best = min(v[0] for v in curves["prod_d"].values())
        checks[f"{model}/{scen}_repeat_beats_full_coverage"] = bool(best <= base * 1.02)
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the paper's split sizes and 30 epochs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(fast=not args.full, seed=args.seed, device=args.device)
    print("checks:", validate(out))
    return out


if __name__ == "__main__":
    main()
