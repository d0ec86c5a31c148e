"""Training loop: a train step with token-weighted gradient accumulation
(microbatching), global-norm clipping and the LR schedule, and periodic
checkpointing. The port of ``repro/training/trainer.py`` on one device.

Parameters are the model's tree (``models/transformer.py``) with every
tensor a leaf that requires grad; the step takes the gradients with
``torch.autograd.grad`` (zeros for a leaf the loss never reads, as
``jax.grad`` gives) and the optimizer updates the tensors in place. The
optimizer sees the reference's leaves (:func:`param_groups`), so a layer
stack trains as the reference's stacked tree does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.device import DeviceLike
from repro_torch.common.pytree import tree_flatten
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import layer_plan
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optim import Group, clip_by_global_norm, make_optimizer

Batch = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int
    history: List[Dict[str, torch.Tensor]] = field(default_factory=list)
    # per-step metrics of train_loop (0-d tensors, left on the device)

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "step": torch.tensor(float(self.step))}


def param_groups(cfg: ModelConfig, names) -> List[Group]:
    """The reference's leaves over the port's parameter paths: each weight of
    a segment's ``layer_j`` stacks the blocks' copies (``layers/<i>/...``
    for the segment's layers of kind j, block by block); the embedding, the
    final norm, the head and the shared block are leaves of their own. An
    encoder-decoder's ``encoder/<i>/...`` and ``decoder/<i>/...`` weights
    stack over i, as the reference's stacked trees."""
    names = list(names)
    if cfg.family == "encdec":
        groups = [Group((n,)) for n in names if not n.startswith(("encoder/", "decoder/"))]
        for stack, n_layers in (("encoder", cfg.n_encoder_layers), ("decoder", cfg.n_layers)):
            first = f"{stack}/0/"
            for leaf in [n[len(first):] for n in names if n.startswith(first)]:
                groups.append(Group(tuple(f"{stack}/{i}/{leaf}" for i in range(n_layers)),
                                    stacked=True))
        return groups
    groups = [Group((n,)) for n in names if not n.startswith("layers/")]
    offset = 0
    for seg in layer_plan(cfg):
        width = len(seg.kinds)
        for j in range(width):
            idx = [offset + b * width + j for b in range(seg.n_blocks)]
            first = f"layers/{idx[0]}/"
            for leaf in [n[len(first):] for n in names if n.startswith(first)]:
                groups.append(Group(tuple(f"layers/{i}/{leaf}" for i in idx), stacked=True))
        offset += width * seg.n_blocks
    return groups


def _optimizer(model: Model, tcfg: TrainConfig):
    return make_optimizer(tcfg, param_groups(model.cfg, tree_flatten(model.spec())))


def init_state(model: Model, seed: int, tcfg: TrainConfig, device: DeviceLike = None,
               params: Optional[Any] = None) -> TrainState:
    """Seeded weights (or ``params``, trained from as given), each leaf made
    to require grad, and the optimizer's zeroed state."""
    if params is None:
        params = model.init(seed=seed, device=device)
    flat = tree_flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=_optimizer(model, tcfg).init(flat), step=0)


def make_train_step(model: Model, tcfg: TrainConfig
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns train_step(state, batch) -> (state, metrics); the state is
    updated in place. The metrics are {"loss", "grad_norm"} and, without
    microbatches, the model's own (the CE as "loss", the router's "aux"),
    as the reference's."""
    opt = _optimizer(model, tcfg)

    def train_step(state: TrainState, batch: Batch):
        flat = tree_flatten(state.params)
        names, leaves = list(flat), list(flat.values())

        def loss_and_grads(b: Batch):
            loss, metrics = model.loss(state.params, b, remat=tcfg.remat)
            # a leaf the loss never reads (an SSM layer's dt_bias) gets zeros,
            # as jax.grad gives it; clipping and AdamW then see the reference's
            # tree (the zeros add nothing to the norm; AdamW still decays it)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            return loss.detach(), grads, {k: v.detach() for k, v in metrics.items()}

        n_micro = max(tcfg.microbatch, 1)
        if n_micro > 1:
            mb = batch["tokens"].shape[0] // n_micro
            g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            l_acc = w_acc = 0.0
            for i in range(n_micro):
                sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                # microbatches with a loss_mask carry different numbers of
                # supervised tokens and each loss is a mean over its own, so
                # weight by that count (the [1:] shift of lm_loss's targets):
                # the mean of means is then the full batch's mean, for the
                # loss and the grads
                if "loss_mask" in sub:
                    w = torch.clamp(torch.sum(sub["loss_mask"][:, 1:].to(torch.float32)),
                                    min=1.0)
                else:
                    w = torch.tensor(float(mb), device=batch["tokens"].device)
                loss, g, _ = loss_and_grads(sub)
                g_acc = [a + w * gk for a, gk in zip(g_acc, g)]
                l_acc = l_acc + w * loss
                w_acc = w_acc + w
            grads = {k: a / w_acc for k, a in zip(names, g_acc)}
            loss, metrics = l_acc / w_acc, {}
        else:
            loss, g, metrics = loss_and_grads(batch)
            grads = dict(zip(names, g))
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        opt.update(grads, state.opt_state, flat, state.step)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


def train_loop(model: Model, tcfg: TrainConfig, data_iter: Iterator[Batch], n_steps: int,
               log_every: int = 20, ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
               verbose: bool = True, device: DeviceLike = None,
               params: Optional[Any] = None) -> TrainState:
    """``n_steps`` steps from seeded weights (``tcfg.seed``) or from
    ``params``; a checkpoint of the whole state every ``ckpt_every`` steps
    into ``ckpt_dir``. The state's ``history`` holds each step's metrics."""
    state = init_state(model, tcfg.seed, tcfg, device=device, params=params)
    step_fn = make_train_step(model, tcfg)
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, metrics = step_fn(state, next(data_iter))
        state.history.append(metrics)
        if verbose and (i % log_every == 0 or i == n_steps - 1):
            aux = (f"aux {float(metrics['aux']):.4f}  "
                   if model.cfg.family == "moe" and "aux" in metrics else "")
            print(f"step {i:5d}  loss {float(metrics['loss']):.4f}  {aux}"
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state.tree(), step=i + 1)
    return state
