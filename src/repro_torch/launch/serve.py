"""Serving launcher of the port. Two modes, as the reference's
``repro/launch/serve.py``:

  --mode sim   (default) the discrete-event simulator over a calibrated
               Track-A scenario workload: train a ProD-D head on the
               scenario's last-token φ, then serve the test split through
               ``SimEngine`` under FCFS/max-reserve, FCFS/quantile, ProD-driven
               SJF + quantile reservation, and the oracle. The head predicts
               each run's medians through the fused head kernel.
  --mode real  decode a served model with batched requests through
               :class:`RealEngine`, collect r generations per prompt, turn the
               lengths into ProD-D targets, train the shared head on φ of the
               first half of the prompts, and predict the second half's median
               through the fused head. ``--model`` picks any ported config
               (default ``tiny-lm``, as the reference; Llama-3-8B,
               Qwen2.5-7B, Granite-20B, MiniCPM-2B, Yi-34B, Gemma3-27B,
               Zamba2-1.2B, Mamba2-130M and Qwen2-VL-2B (on text) at full size in
               bf16) with seeded random
               weights, or the weights of a ``launch/train.py`` checkpoint
               (``--ckpt``; its whole train state, AdamW moments included,
               is checked against the model's before the params are taken).
               A model whose init (its leaves in its dtype, plus the fp32
               draw of the largest) passes the card's memory is refused
               before anything is allocated:
               Qwen3-MoE-235B-A22B (463 GB of bf16) and Kimi-K2 (2.09 TB)
               at full depth; ``chip_smoke.py`` serves them cut in depth.
               Whisper-large-v3 is refused too: the engine feeds prompt
               tokens only and an encoder-decoder needs its encoder input
               (``chip_smoke.py`` drives it through ``Model.prefill`` and
               ``Model.decode_step``).

``--device`` defaults to ``cuda``.

    PYTHONPATH=src python -m repro_torch.launch.serve [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --mode real --model tiny-lm
    PYTHONPATH=src python -m repro_torch.launch.serve --mode real --model qwen2.5-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --mode real --model gemma3-27b
    PYTHONPATH=src python -m repro_torch.launch.serve --mode real --model kimi-k2-1t-a32b  # refused
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig, PredictorConfig, TrainConfig
from repro_torch.common.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.common.pytree import tree_items
from repro_torch.configs import get_config, list_archs
from repro_torch.core import bins as bins_mod
from repro_torch.core import targets as targets_mod
from repro_torch.core.metrics import mae, noise_radius
from repro_torch.core.predictor import train_predictor
from repro_torch.data import make_scenario
from repro_torch.data.tokenizer import N_TOPICS, ToyTokenizer
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.engine import RealEngine, SimEngine, check_token_only
from repro_torch.serving.request import workload_from_scenario
from repro_torch.serving.scheduler import Policy
from repro_torch.training.checkpoint import restore_checkpoint
from repro_torch.training.trainer import init_state


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
    every ported config but tiny-lm, which the reference serves in fp32)."""
    cfg = get_config(name)
    return cfg.with_overrides(dtype="float32") if cfg.name == "tiny-lm" else cfg


def run_sim(args):
    """Train a ProD-D head on a scenario's train split, then serve its test
    split through ``SimEngine`` under four policies. Returns the four
    ``ServeStats`` rows. The reference seeds the head with
    ``PRNGKey(seed)``; the port with ``seed`` itself."""
    dev = resolve_device(args.device)
    data = make_scenario(args.model_tag, args.scenario,
                         n_train=args.n_train, n_test=max(args.n_requests, 200),
                         seed=args.seed)
    bin_max = float(np.quantile(data.len_train, 0.999) * 1.3)
    pcfg = PredictorConfig(n_bins=64, bin_max=bin_max, epochs=args.epochs)
    edges = bins_mod.make_edges(pcfg.n_bins, pcfg.bin_max, device=dev)
    target = targets_mod.dist_target(
        torch.as_tensor(data.len_train, dtype=torch.float32, device=dev), edges)
    pred = train_predictor(args.seed, data.phi_train["last"], target, pcfg, edges,
                           device=dev)
    reqs = workload_from_scenario(data, args.n_requests, seed=args.seed,
                                  arrival_rate=args.arrival_rate)
    print(f"scenario={args.model_tag}/{args.scenario} requests={len(reqs)} "
          f"noise_radius={noise_radius(torch.as_tensor(data.len_test)):.1f}")
    rows = []
    for policy in (
        Policy("fcfs", "max", max_seq_len=args.max_seq),
        Policy("fcfs", "quantile", max_seq_len=args.max_seq),
        Policy("sjf_pred", "quantile", max_seq_len=args.max_seq),
        Policy("sjf_oracle", "oracle", max_seq_len=args.max_seq),
    ):
        eng = SimEngine(args.slots, args.kv_budget, policy, predictor=pred)
        st = eng.run(reqs)
        rows.append(st.row())
        print(f"{st.policy:22s} mean_lat={st.mean_latency:9.1f} "
              f"p90={st.p90_latency:9.1f} thr={st.throughput:6.2f} "
              f"waste={st.kv_waste_ratio:.3f} overflow={st.overflow_events}")
    return rows


def init_bytes(cfg: ModelConfig) -> Tuple[int, int]:
    """What ``Model.init`` allocates, counted from the model's spec without
    allocating: (the bytes of every leaf in the config's dtype, the bytes of
    the largest leaf drawn in fp32). ``init_tree`` draws each random leaf in
    fp32 and then casts it, so that draw is live beside the leaves made before
    it; in an fp32 model the cast is the draw itself."""
    itemsize = torch_dtype(cfg.dtype).itemsize
    specs = [spec for _, spec in tree_items(build_model(cfg).spec())]
    leaves = itemsize * sum(math.prod(s.shape) for s in specs)
    drawn = [4 * math.prod(s.shape) for s in specs if s.init not in ("zeros", "ones")]
    return leaves, (max(drawn, default=0) if itemsize != 4 else 0)


def refuse_if_too_large(cfg: ModelConfig, total_memory: int) -> None:
    """Exit, naming the sizes, when what the init allocates (``init_bytes``:
    the leaves in the config's dtype plus the fp32 draw of the largest) passes
    the card's ``total_memory`` bytes."""
    leaves, draw = init_bytes(cfg)
    if leaves + draw > total_memory:
        raise SystemExit(
            f"{cfg.name}: {leaves / 1e9:.1f} GB of {cfg.dtype} leaves plus the "
            f"{draw / 1e9:.1f} GB fp32 draw of the largest ({cfg.n_layers} layers) do not "
            f"fit the card's {total_memory / 1e9:.1f} GB; not allocating. Serve it cut in "
            f"depth (get_config(...).with_overrides(n_layers=...)), as chip_smoke.py does.")


def run_real(args) -> Dict[str, object]:
    dev = resolve_device(args.device)
    cfg = serving_config(args.model)
    try:
        check_token_only(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if dev.type == "cuda":
        refuse_if_too_large(cfg, torch.cuda.get_device_properties(dev).total_memory)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    if args.ckpt:
        like = init_state(model, 0, TrainConfig(), params=params).tree()
        params = restore_checkpoint(args.ckpt, like)["params"]
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
    ap.add_argument("--mode", choices=["sim", "real"], default="sim")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-requests", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    # --mode sim
    ap.add_argument("--model-tag", default="qwen", choices=["qwen", "llama"])
    ap.add_argument("--scenario", default="chat")
    ap.add_argument("--n-train", type=int, default=800)
    ap.add_argument("--arrival-rate", type=float, default=2.0)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--kv-budget", type=int, default=40_000)
    ap.add_argument("--max-seq", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=20)
    # --mode real
    ap.add_argument("--model", default="tiny-lm", choices=list_archs())
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)
    return run_sim(args) if args.mode == "sim" else run_real(args)


if __name__ == "__main__":
    main()
