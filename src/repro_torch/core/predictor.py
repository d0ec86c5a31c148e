"""LengthPredictor: train the shared head on repeated-sampling targets and
serve single-shot point predictions (paper §2.4).

``train_predictor`` is the one function every method variant goes through —
ProD-M / ProD-D / single-sample baselines differ ONLY in the target matrix
and decode rule. The reference seeds its minibatch order with
``jax.random.randint(key)``; the port takes that integer, ``seed``, directly
(and seeds its head init with it on a cold start).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.common import scopes
from repro_torch.common.config import PredictorConfig, TrainConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import bins as bins_mod
from repro_torch.core.heads import (head_init, head_logits, head_predict,
                                    head_probs, head_quantiles)
from repro_torch.core.losses import soft_ce
from repro_torch.training.optim import adamw


@dataclass
class LengthPredictor:
    params: Dict[str, torch.Tensor]
    edges: torch.Tensor
    pcfg: PredictorConfig
    losses: Optional[torch.Tensor] = None   # soft-CE of every optimizer step

    def _features(self, phi) -> torch.Tensor:
        """φ as given: a tensor passes through; NumPy (or any array) becomes
        fp32 on the predictor's device, as the reference takes any array."""
        if isinstance(phi, torch.Tensor):
            return phi
        return torch.as_tensor(np.asarray(phi), dtype=torch.float32,
                               device=self.edges.device)

    @torch.no_grad()
    def predict(self, phi, how: Optional[str] = None) -> torch.Tensor:
        return head_predict(self.params, self._features(phi), self.edges,
                            how or self.pcfg.decode)

    @torch.no_grad()
    def predict_dist(self, phi) -> torch.Tensor:
        return head_probs(self.params, self._features(phi))

    @torch.no_grad()
    def quantile(self, phi, q: float) -> torch.Tensor:
        """Conservative right-edge decode: the upper edge of the bin where the
        CDF crosses ``q`` (bin 0 when it never does). For the interpolated
        variant see :meth:`quantiles`."""
        cdf = torch.cumsum(self.predict_dist(phi), dim=-1)
        k = torch.argmax((cdf >= q).to(torch.int8), dim=-1)
        return self.edges[k + 1]

    @torch.no_grad()
    def quantiles(self, phi, qs: Sequence[float]):
        """Fused histogram + interpolated quantiles in ONE head evaluation:
        ``(probs (B, K), quants (B, len(qs)))`` through the fused kernel
        (the span ``head.quantiles`` under the profiler)."""
        with scopes.span("head.quantiles"):
            return head_quantiles(self.params, self._features(phi), self.edges, qs)


def train_predictor(
    seed: int,
    phi,                       # (N, d) features
    target,                    # (N, K) one-hot or histogram
    pcfg: PredictorConfig,
    edges: Optional[torch.Tensor] = None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> LengthPredictor:
    """Fit the shared 2-layer head on (features, binned target) pairs.

    ``init_params`` warm-starts from existing head weights: warm starts take
    ``pcfg.epochs`` at face value; cold starts keep the ~400-optimizer-step
    floor so tiny datasets still converge. Training differentiates the plain
    head (autograd), as the reference does; the kernel serves inference.
    """
    dev = resolve_device(device)
    phi = torch.as_tensor(phi, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    N, d = phi.shape
    K = target.shape[1]
    if edges is None:
        edges = bins_mod.make_edges(pcfg.n_bins, pcfg.bin_max, pcfg.bin_spacing,
                                    device=dev)
    init = (head_init(seed, d, pcfg.hidden, K, device=dev) if init_params is None
            else init_params)
    params = {k: v.detach().to(dev, torch.float32).clone().requires_grad_(True)
              for k, v in init.items()}
    opt = adamw(TrainConfig(lr=pcfg.lr, schedule="constant",
                            warmup_steps=1, weight_decay=pcfg.weight_decay,
                            beta1=0.9, beta2=0.999))
    state = opt.init(params)
    bs = min(pcfg.batch_size, N)
    steps_per_epoch = max(N // bs, 1)
    min_epochs = -(-400 // steps_per_epoch) if init_params is None else 1
    n_epochs = max(pcfg.epochs, min_epochs)

    rng = np.random.default_rng(seed)
    losses = []
    it = 0
    for _ in range(n_epochs):
        perm = torch.as_tensor(rng.permutation(N), device=dev)
        for s in range(steps_per_epoch):
            idx = perm[s * bs:(s + 1) * bs]
            loss = soft_ce(head_logits(params, phi[idx]), target[idx])
            grads = torch.autograd.grad(loss, list(params.values()))
            opt.update(dict(zip(params, grads)), state, params, it)
            losses.append(loss.detach())
            it += 1
    return LengthPredictor(params={k: v.detach() for k, v in params.items()},
                           edges=edges, pcfg=pcfg, losses=torch.stack(losses))
