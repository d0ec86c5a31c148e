"""AdamW, the constant LR schedule and global-norm clipping, by hand.

Written out rather than taken from ``torch.optim.AdamW`` to keep the
reference's rules (``repro/training/optim.py``): the learning rate of update
``step`` is ``sched(step + 1)``, bias correction uses t = step + 1, and weight
decay applies only to tensors with ``ndim >= 2``. Unlike the reference's pure
functions, ``update`` changes the parameters and moments in place (PyTorch
idiom; it saves a copy of every tensor) and returns them.
Adafactor and the cosine / WSD schedules come with the trainer's slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.common.config import TrainConfig

Tensors = Dict[str, torch.Tensor]


def lr_schedule(cfg: TrainConfig) -> Callable[[float], float]:
    peak = cfg.lr
    warm = max(cfg.warmup_steps, 1)

    def constant(step):
        return peak * min(step / warm, 1.0)

    if cfg.schedule != "constant":
        raise NotImplementedError(f"schedule {cfg.schedule!r} is not ported yet "
                                  f"(ROADMAP.md, queue 1)")
    return constant


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors, int], Tuple[Tensors, Any]]
    # update(grads, state, params, step) -> (params, state), both updated in place


def adamw(cfg: TrainConfig) -> Optimizer:
    sched = lr_schedule(cfg)
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, 1e-8, cfg.weight_decay

    def init(params: Tensors):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": {k: z(p) for k, p in params.items()},
                "v": {k: z(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, step: int):
        lr = sched(step + 1)
        t = torch.tensor(step + 1, dtype=torch.float32)
        bc1 = float(1 - b1 ** t)
        bc2 = float(1 - b2 ** t)
        for name, p in params.items():
            g32 = grads[name].to(torch.float32)
            m = state["m"][name].mul_(b1).add_((1 - b1) * g32)
            v = state["v"][name].mul_(b2).add_((1 - b2) * torch.square(g32))
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if p.ndim >= 2:
                upd = upd + wd * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * upd).to(p.dtype))
        return params, state

    return Optimizer(init, update)
