"""Figure 1 / Appendix A.4 — the key observations. The twin of the
reference's ``benchmarks/bench_fig1.py``.

(a) prompt-level median-centered noise radius across the 8 settings
    (validated against the paper's reported medians),
(b/c) heavy-tail diagnostics: max/median ratios over 100-repeat pools and the
    Hill tail-index, light5/heavy5 split.

The lengths are the port's NumPy copies of the reference's samplers (the
same draws); the per-prompt statistics (Median-MAE, max/median, noise ratio)
run through ``core/metrics.py`` on ``device``.

    PYTHONPATH=src python -m repro_torch.launch.bench_fig1 [--device cpu]
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import metrics as M
from repro_torch.data.lengths import sample_lengths, sample_prompt_latents
from repro_torch.data.scenarios import MODELS, SCENARIOS, get_spec


def run(seed=0, n_noise=1200, verbose=True, device: DeviceLike = None):
    dev = resolve_device(device)
    on_dev = lambda a: torch.as_tensor(a, device=dev)
    out = {}
    for model in MODELS:
        for scen in SCENARIOS:
            spec = get_spec(model, scen)
            rng = np.random.default_rng(seed)
            lat = sample_prompt_latents(rng, spec.law, n_noise)
            L16 = sample_lengths(rng, lat, 16, spec.law)
            mm = M.median_mae_per_prompt(on_dev(L16)).cpu().numpy()
            # heavy-tail pool: 10 frozen prompts x 100 repeats (paper A.4)
            lat10 = sample_prompt_latents(rng, spec.law, 10)
            L100 = sample_lengths(rng, lat10, 100, spec.law)
            m2m = np.sort(M.max_to_median(on_dev(L100)).cpu().numpy())
            out[(model, scen)] = {
                "noise_radius_median": float(np.median(mm)),
                "noise_radius_mean": float(np.mean(mm)),
                "noise_radius_p90": float(np.quantile(mm, 0.9)),
                "noise_ratio_median": float(np.median(M.noise_ratio(on_dev(L16)).cpu().numpy())),
                "paper_noise_radius": spec.paper_noise_radius,
                "light5_max_to_median": float(np.mean(m2m[:5])),
                "heavy5_max_to_median": float(np.mean(m2m[5:])),
                "hill_tail_index": M.hill_tail_index(L100),
            }
            if verbose:
                o = out[(model, scen)]
                print(f"  [{model}/{scen}] radius med={o['noise_radius_median']:5.1f} "
                      f"(paper {o['paper_noise_radius']:5.1f}) "
                      f"heavy5 max/med={o['heavy5_max_to_median']:.2f} "
                      f"hill α={o['hill_tail_index']:.2f}")
    return out


def system_prompt_effect(seed=0, n=500, r=16, verbose=True, device: DeviceLike = None):
    """Appendix A.3 analog: a fixed system prompt regularizes generations —
    modeled as a body-σ/tail-weight reduction (the paper measures ~the same
    on MBPP/Qwen: mean length down, variance down, Median-MAE left-shifted).
    Reports the noise-radius shift and the headroom it buys a predictor."""
    dev = resolve_device(device)
    spec = get_spec("qwen", "coding")
    law_no = replace(spec.law, sigma_body=spec.law.sigma_body * 1.35,
                     tail_weight=spec.law.tail_weight * 1.8)
    law_sys = spec.law
    rng = np.random.default_rng(seed)
    out = {}
    for name, law in (("without_system_prompt", law_no),
                      ("with_system_prompt", law_sys)):
        lat = sample_prompt_latents(rng, law, n)
        L = sample_lengths(rng, lat, r, law)
        mm = M.median_mae_per_prompt(torch.as_tensor(L, device=dev)).cpu().numpy()
        out[name] = {"median_mae_median": float(np.median(mm)),
                     "median_mae_mean": float(np.mean(mm)),
                     "mean_len": float(np.mean(L))}
        if verbose:
            print(f"  {name:24s} Median-MAE med={np.median(mm):6.1f} "
                  f"mean={np.mean(mm):6.1f}")
    out["radius_reduction_pct"] = 100 * (
        1 - out["with_system_prompt"]["median_mae_median"]
        / out["without_system_prompt"]["median_mae_median"])
    return out


def validate(out) -> dict:
    checks = {}
    rel_errs = [abs(v["noise_radius_median"] - v["paper_noise_radius"])
                / v["paper_noise_radius"] for v in out.values()]
    checks["calibration_within_25pct"] = bool(max(rel_errs) < 0.25)
    checks["max_calibration_rel_err"] = float(max(rel_errs))
    checks["heavy_tails_present"] = bool(
        min(v["heavy5_max_to_median"] for v in out.values()) > 1.3)
    checks["nontrivial_noise_ratio"] = bool(
        min(v["noise_ratio_median"] for v in out.values()) > 0.08)
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(seed=args.seed, device=args.device)
    print("checks:", validate(out))
    return out


if __name__ == "__main__":
    main()
