"""Serving launcher of the port: ``--mode real`` (Track B).

Mirrors ``run_real`` of ``repro/launch/serve.py``: decode a served model with
batched requests through :class:`RealEngine`, collect r generations per
prompt, turn the lengths into ProD-D targets, train the shared head on φ of
the first half of the prompts, and predict the second half's median through
the fused head. ``--model`` picks any ported config (default ``tiny-lm``, as
the reference) with seeded random weights; ``--device`` defaults to ``cuda``.
``--mode sim`` (the cluster simulator) waits for its slice.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode real --model tiny-lm
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.common.config import ModelConfig, PredictorConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import bins as bins_mod
from repro_torch.core import targets as targets_mod
from repro_torch.core.metrics import mae, noise_radius
from repro_torch.core.predictor import train_predictor
from repro_torch.data.tokenizer import N_TOPICS, ToyTokenizer
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.engine import RealEngine


def toy_prompts(n: int, seed: int):
    """The reference's request batch: 6 toy-tokenizer tokens right-padded to 8."""
    rng = np.random.default_rng(seed)
    tok = ToyTokenizer()
    prompts = np.zeros((n, 8), np.int32)
    for i in range(n):
        prompts[i, :6] = tok.prompt(rng, int(rng.integers(0, N_TOPICS)))[:6]
    return prompts, np.full(n, 6)


def fit_and_predict(lens: np.ndarray, phi: np.ndarray, n_bins: int, seed: int = 1,
                    qs=(0.5, 0.9), device: DeviceLike = None) -> Dict[str, object]:
    """ProD-D targets from the (N, r) lengths, the head trained on the first
    half's φ, then the second half's median and quantiles through the fused
    head. Returns the predictions, their test MAE beside the noise radius, and
    the trained ``predictor``."""
    dev = resolve_device(device)
    lens_t = torch.as_tensor(lens, device=dev)
    phi_t = torch.as_tensor(phi, dtype=torch.float32, device=dev)
    n = lens.shape[0]
    pcfg = PredictorConfig(n_bins=n_bins, bin_max=float(lens.max() + 8), epochs=40)
    edges = bins_mod.make_edges(pcfg.n_bins, pcfg.bin_max, device=dev)
    tgt = targets_mod.dist_target(lens_t, edges)
    split = n // 2
    pred = train_predictor(seed, phi_t[:split], tgt[:split], pcfg, edges, device=dev)
    est = pred.predict(phi_t[split:])
    _, quants = pred.quantiles(phi_t[split:], list(qs))
    true_med = targets_mod.sample_median(lens_t[split:])
    return {"median": est.cpu().numpy(), "quantiles": quants.cpu().numpy(),
            "qs": tuple(qs), "mae": mae(est, true_med),
            "noise_radius": noise_radius(lens_t),
            "final_loss": float(pred.losses[-1]), "predictor": pred}


def serving_config(name: str) -> ModelConfig:
    """The config ``--mode real`` serves: the model's own dtype (bf16 for
    Llama-3-8B, Zamba2-1.2B and Mamba2-130M), except tiny-lm, which the
    reference serves in fp32."""
    cfg = get_config(name)
    return cfg.with_overrides(dtype="float32") if cfg.name == "tiny-lm" else cfg


def run_real(args) -> Dict[str, object]:
    dev = resolve_device(args.device)
    cfg = serving_config(args.model)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    eng = RealEngine(model, params, max_new=args.max_new)
    prompts, plens = toy_prompts(args.n_requests, args.seed)
    lens, phi = eng.repeated_sampling(prompts, plens, r=args.r, seed=args.seed)
    print(f"collected {lens.shape} generations; median lengths "
          f"{np.median(lens, axis=1)[:8]}")
    out = fit_and_predict(lens, phi, cfg.predictor_bins, seed=1, device=dev)
    print(f"ProD-D on real generations: test MAE {out['mae']:.2f} "
          f"(noise radius {out['noise_radius']:.2f})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["real"], default="real",
                    help="'sim' (the cluster simulator) is not ported yet")
    ap.add_argument("--model", default="tiny-lm")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-requests", type=int, default=200)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    return run_real(ap.parse_args(argv))


if __name__ == "__main__":
    main()
