"""Beyond-paper ablation: bin-grid spacing under heavy tails, on the port.

The paper uses linear bins. Heavy-tailed length laws suggest log-spaced bins
(constant RELATIVE resolution), especially on chat where the cross-prompt
median spans two orders of magnitude. Also sweeps K to show robustness of the
ProD-D pipeline to the grid. The twin of the reference's
``benchmarks/bench_bins_ablation.py``: every fit decodes the median through
the fused head kernel, at K = 16, 64 and 128 bins (128 is the kernel's
largest K) with linear and log edges.

    PYTHONPATH=src python -m repro_torch.launch.bench_bins_ablation [--full] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import bins as B
from repro_torch.core import targets as T
from repro_torch.core.metrics import mae
from repro_torch.core.predictor import train_predictor
from repro_torch.data import make_scenario
from repro_torch.launch.table1 import scenario_pcfg


def run(scenarios=(("qwen", "chat"), ("qwen", "math")), fast=True, seed=0,
        verbose=True, device: DeviceLike = None):
    dev = resolve_device(device)
    out = {}
    for model, scen in scenarios:
        data = make_scenario(model, scen, n_train=800 if fast else None,
                             n_test=400 if fast else None, seed=seed,
                             full_paper_splits=not fast)
        y_test = T.sample_median(torch.as_tensor(data.len_test, dtype=torch.float32,
                                                 device=dev))
        len_train = torch.as_tensor(data.len_train, dtype=torch.float32, device=dev)
        phi_tr = torch.as_tensor(data.phi_train["last"], dtype=torch.float32, device=dev)
        phi_te = torch.as_tensor(data.phi_test["last"], dtype=torch.float32, device=dev)
        res = {}
        for spacing in ("linear", "log"):
            for K in (16, 64, 128):
                pcfg = dataclasses.replace(
                    scenario_pcfg(data, n_bins=K, epochs=15 if fast else 30),
                    bin_spacing=spacing)
                edges = B.make_edges(K, pcfg.bin_max, spacing, device=dev)
                tgt = T.dist_target(len_train, edges)
                p = train_predictor(seed, phi_tr, tgt, pcfg, edges, device=dev)
                res[(spacing, K)] = mae(p.predict(phi_te), y_test)
        out[(model, scen)] = res
        if verbose:
            for k, v in sorted(res.items()):
                print(f"  [{model}/{scen}] {k[0]:6s} K={k[1]:3d}  MAE {v:7.2f}", flush=True)
    return out


def validate(out) -> dict:
    checks = {}
    for (model, scen), res in out.items():
        lin = min(v for (sp, _), v in res.items() if sp == "linear")
        log = min(v for (sp, _), v in res.items() if sp == "log")
        checks[f"{model}/{scen}_log_vs_linear_pct"] = round(
            100 * (lin - log) / lin, 1)
        # the insight: LOG grids stay robust across K even on heavy-tailed
        # scenarios, while coarse LINEAR grids can blow up (chat, K=16)
        logs = [v for (sp, _), v in res.items() if sp == "log"]
        checks[f"{model}/{scen}_log_grid_robust"] = bool(
            max(logs) < 1.25 * min(logs))
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
