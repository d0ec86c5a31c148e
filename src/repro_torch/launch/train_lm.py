"""Train a language model on the heavy-tailed toy corpus with the full
substrate (pipeline -> optimizer -> schedule -> checkpointing): the port's
twin of ``examples/train_lm.py``, with its arguments and defaults, plus
``--device`` (default ``cuda``). tiny-lm trains as it is; any other
``--arch`` trains its ``reduced()`` config, all in fp32 (a MoE config: 4
experts top-2 of width 128, the loss CE + 0.01 x the router's aux, which
each logged step prints beside the CE; an SSM or hybrid config: 2 layers
with state 16, 4 scan heads of 32 and a chunk of 16, the training scan in
``models/ssm.py::ssd_chunked``). An encoder-decoder is refused: its loss
needs the encoder's input, which the token pipeline has none of.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 200 --ckpt-dir build/ck
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --arch qwen2.5-7b
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --arch gemma3-27b
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --arch qwen3-moe-235b-a22b
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --arch zamba2-1.2b
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.common.config import TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.data.pipeline import batch_iterator, make_lm_dataset
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import check_trainable
from repro_torch.training.trainer import TrainState, train_loop


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm", choices=list_archs())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "constant"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.arch != "tiny-lm":
        cfg = cfg.reduced()
    cfg = cfg.with_overrides(dtype="float32")
    model = build_model(cfg)
    check_trainable(cfg)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_count():,} (analytic)")
    tcfg = TrainConfig(lr=args.lr, schedule=args.schedule,
                       warmup_steps=max(args.steps // 20, 2),
                       decay_steps=args.steps,
                       stable_steps=args.steps // 2 if args.schedule == "wsd" else 0,
                       seed=args.seed)
    ds = make_lm_dataset(4096, args.seq, seed=args.seed)
    ds.tokens = np.minimum(ds.tokens, cfg.vocab_size - 1)
    it = batch_iterator(ds, args.batch, seed=args.seed, device=dev)
    state = train_loop(model, tcfg, it, args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.steps // 2 if args.ckpt_dir else 0, device=dev)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    main()
