"""Optimizers and LR schedules by hand: AdamW, Adafactor, plain SGD; the
cosine, constant and WSD (warmup-stable-decay, MiniCPM [arXiv:2404.06395])
schedules; global-norm clipping.

Written out rather than taken from ``torch.optim`` to keep the reference's
rules (``repro/training/optim.py``): the learning rate of update ``step`` is
``sched(step + 1)``, bias correction uses t = step + 1, AdamW decays only
leaves with ``ndim >= 2``, and Adafactor factors a leaf's second moment over
its last two axes and clips its update by the RMS over the whole leaf. The
schedules compute in fp32 as the reference does (its ``cos`` and ``pow``
taken in fp64 and rounded once, which is how XLA's agree with fp64's). Unlike
the reference's pure functions, ``update`` changes the parameters and
moments in place (PyTorch idiom; it saves a copy of every tensor) and
returns them.

**Leaves are the reference's.** The reference stacks the layers of each
segment on a leading ``layers`` axis (``repro/models/transformer.py:119-132``),
so one of its leaves holds every block's copy of a weight: ``ln1`` is
(L, d), not (d,). The port keeps one dict per layer. To keep the
reference's semantics, the optimizers take ``groups``: one :class:`Group` per
reference leaf, naming the port's tensors it stacks. A group's rank is its
tensors' rank plus one when stacked, so per-layer norms are decayed by AdamW
and factored by Adafactor (over the layers and d), and Adafactor's RMS clip
couples the layers of a segment, exactly as in the reference. Without
``groups`` every tensor is a leaf of its own (the ProD head's flat dict).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.common.config import TrainConfig

Tensors = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_schedule(cfg: TrainConfig) -> Callable[[float], float]:
    peak = cfg.lr
    warm = max(cfg.warmup_steps, 1)

    def cosine(step):
        s = _f32(step)
        frac = torch.clamp((s - warm) / max(cfg.decay_steps - warm, 1), 0.0, 1.0)
        cos = _f32(math.cos(float(math.pi * frac)))
        return float(peak * torch.where(s < warm, s / warm, 0.5 * (1 + cos)))

    def constant(step):
        return peak * min(step / warm, 1.0)

    def wsd(step):
        """Warmup -> stable plateau -> exponential-ish decay (MiniCPM)."""
        s = _f32(step)
        stable_end = warm + cfg.stable_steps
        decay_len = max(cfg.decay_steps - stable_end, 1)
        frac = torch.clamp((s - stable_end) / decay_len, 0.0, 1.0)
        decay = _f32(0.5 ** float(frac * 10.0))
        return float(peak * torch.where(
            s < warm, s / warm, torch.where(s < stable_end, _f32(1.0), decay)))

    return {"cosine": cosine, "constant": constant, "wsd": wsd}[cfg.schedule]


# ---------------------------------------------------------------------------
# gradient utilities
# ---------------------------------------------------------------------------


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Group:
    """One leaf of the reference's parameter tree: the names of the port's
    tensors it holds, in layer order, and whether the reference stacks them
    on a leading layers axis (it does for every segment leaf, even a
    segment of one block)."""

    names: Tuple[str, ...]
    stacked: bool = False


def leaf_groups(params: Tensors, groups: Optional[Sequence[Group]]) -> Tuple[Group, ...]:
    if groups is None:
        return tuple(Group((k,)) for k in params)
    names = [n for g in groups for n in g.names]
    if sorted(names) != sorted(params):
        raise ValueError("groups must name every parameter exactly once")
    return tuple(groups)


def _rank(params: Tensors, g: Group) -> int:
    return params[g.names[0]].ndim + int(g.stacked)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors, int], Tuple[Tensors, Any]]
    # update(grads, state, params, step) -> (params, state), both updated in place


def adamw(cfg: TrainConfig, groups: Optional[Sequence[Group]] = None) -> Optimizer:
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
        for g in leaf_groups(params, groups):
            decays = _rank(params, g) >= 2
            for name in g.names:
                p = params[name]
                g32 = grads[name].to(torch.float32)
                m = state["m"][name].mul_(b1).add_((1 - b1) * g32)
                v = state["v"][name].mul_(b2).add_((1 - b2) * torch.square(g32))
                upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if decays:
                    upd = upd + wd * p.to(torch.float32)
                p.copy_((p.to(torch.float32) - lr * upd).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def _stack(tensors: Tensors, g: Group) -> torch.Tensor:
    """The reference's leaf: the group's tensors stacked on a leading axis
    (fp32), or its one tensor."""
    if g.stacked:
        return torch.stack([tensors[n].to(torch.float32) for n in g.names])
    return tensors[g.names[0]].to(torch.float32)


def adafactor(cfg: TrainConfig, groups: Optional[Sequence[Group]] = None) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern). For rank>=2 leaves
    keeps row/col statistics only. The state is keyed by the first tensor's
    name of each group and shaped as the reference's stacked leaf."""
    sched = lr_schedule(cfg)
    eps = 1e-30
    clip_thresh = 1.0

    def init(params: Tensors):
        state = {}
        for g in leaf_groups(params, groups):
            p = params[g.names[0]]
            shape = ((len(g.names),) if g.stacked else ()) + tuple(p.shape)
            zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=p.device)
            state[g.names[0]] = ({"vr": zeros(shape[:-1]), "vc": zeros(shape[:-2] + shape[-1:])}
                                 if len(shape) >= 2 else {"v": zeros(shape)})
        return state

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, step: int):
        lr = sched(step + 1)
        beta2 = float(1.0 - _f32((step + 1.0) ** -0.8))
        for g in leaf_groups(params, groups):
            st = state[g.names[0]]
            g32 = _stack(grads, g)
            g2 = torch.square(g32) + eps
            if g32.ndim >= 2:
                vr = st["vr"].mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-1))
                vc = st["vc"].mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-2))
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
                v = vr[..., None] * vc[..., None, :] / denom[..., None]
            else:
                v = st["v"].mul_(beta2).add_((1 - beta2) * g2)
            u = g32 / torch.sqrt(v + eps)
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms_u / clip_thresh, min=1.0)
            for i, name in enumerate(g.names):
                p = params[name]
                ui = u[i] if g.stacked else u
                p.copy_((p.to(torch.float32) - lr * ui).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig, groups: Optional[Sequence[Group]] = None) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[cfg.optimizer](cfg, groups)


def sgd_simple(lr: float) -> Optimizer:
    """Plain SGD (used by tiny property tests)."""

    def init(params: Tensors):
        return {}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors, step: int):
        for name, p in params.items():
            p.copy_((p.to(torch.float32) - lr * grads[name].to(torch.float32)).to(p.dtype))
        return params, state

    return Optimizer(init, update)
