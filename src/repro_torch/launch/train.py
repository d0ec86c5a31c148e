"""Training launcher of the port (the reference's ``repro/launch/train.py``).

Trains a ported decoder config in fp32 on the toy corpus: tiny-lm as it
is, any other arch (or tiny-lm with ``--smoke``) at the reference's reduced
size (2 layers, d_model <= 256; the SSM and hybrid configs with the
training scan of ``models/ssm.py::ssd_chunked``). VLM and encoder-decoder
configs are refused, as the reference refuses them. ``--device`` defaults
to ``cuda``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch mamba2-130m --steps 5
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.common.config import TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.data.pipeline import batch_iterator, make_lm_dataset
from repro_torch.models.model_zoo import build_model
from repro_torch.training.trainer import TrainState, train_loop


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-data", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke or args.arch != "tiny-lm":
        cfg = cfg.reduced()
    cfg = cfg.with_overrides(dtype="float32")
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("use family-specific examples for vlm/encdec training")
    model = build_model(cfg)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       decay_steps=args.steps, seed=args.seed, remat="none")
    ds = make_lm_dataset(args.n_data, args.seq, seed=args.seed)
    # clamp token ids into this model's vocab
    ds.tokens = np.minimum(ds.tokens, cfg.vocab_size - 1)
    it = batch_iterator(ds, args.batch, seed=args.seed, device=dev)
    state = train_loop(model, tcfg, it, args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=max(args.steps // 2, 1), device=dev)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    main()
