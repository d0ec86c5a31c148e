"""Baseline probes (paper §3.1) and the unified method runner.

Every trainable method is (feature view, training target, decode rule) over
the SAME 2-layer MLP head — the paper's controlled comparison:

| method          | φ view                  | target (Table 1) | decode  |
|-----------------|-------------------------|------------------|---------|
| Constant Median | —                       | train median     | const   |
| S³              | auxiliary proxy         | median one-hot   | argmax  | (+ num_bins/bin_max sweep, App. A.2)
| TRAIL-mean      | mean-pooled hidden      | median one-hot   | mean    |
| TRAIL-last      | last-token hidden       | median one-hot   | mean    |
| EGTP            | entropy-weighted pooled | median one-hot   | mean    | (+ num_bins sweep)
| ProD-M          | last-token hidden       | median one-hot   | median  |
| ProD-D          | last-token hidden       | histogram        | median  |

Supervision regimes: ``repeat`` (Table 1) trains on the 16-sample targets;
``single`` (Tables 2–3) trains every method on one sampled length.

The reference takes a ``jax.random`` key and splits it for the S³/EGTP
sweep; the port takes an integer ``seed``. A method with one fit trains with
``seed`` itself; a sweep trains its i-th grid point with ``fit_seeds(seed,
n)[i]``. ProD-M and ProD-D decode the median through the fused head kernel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.config import PredictorConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import bins as bins_mod
from repro_torch.core import targets as targets_mod
from repro_torch.core.metrics import mae
from repro_torch.core.predictor import LengthPredictor, train_predictor

METHODS = (
    "constant_median", "s3", "trail_mean", "trail_last", "egtp",
    "prod_m", "prod_d",
)

_VIEW = {
    "s3": "proxy", "trail_mean": "mean", "trail_last": "last",
    "egtp": "entropy", "prod_m": "last", "prod_d": "last",
}
_DECODE = {
    "s3": "argmax", "trail_mean": "mean", "trail_last": "mean",
    "egtp": "mean", "prod_m": "median", "prod_d": "median",
}
_TARGET = {
    "s3": "median", "trail_mean": "median", "trail_last": "median",
    "egtp": "median", "prod_m": "median", "prod_d": "dist",
}

S3_NUM_BINS_GRID = (7, 10, 13, 15, 20)


@dataclass
class MethodResult:
    method: str
    test_mae: float
    pred: np.ndarray
    predictor: Optional[LengthPredictor] = None
    selected: Optional[dict] = None


def _bin_max_grid(train_lengths: np.ndarray) -> Sequence[float]:
    """Scene-adaptive bin_max grid in the spirit of App. A.2 (p95–p99.9×1.3)."""
    hi = float(np.quantile(train_lengths, 0.999)) * 1.3
    lo = float(np.quantile(train_lengths, 0.95))
    return tuple(np.linspace(lo, hi, 4))


def fit_seeds(seed: int, n: int) -> List[int]:
    """The seeds of a sweep's ``n`` fits, the port's ``jax.random.split(key,
    n)``: the first 32-bit word of each of ``n`` children spawned from
    ``np.random.SeedSequence(seed)``."""
    return [int(child.generate_state(1)[0])
            for child in np.random.SeedSequence(seed).spawn(n)]


def run_method(
    seed: int,
    data,                       # repro_torch.data ScenarioData
    method: str,
    pcfg: PredictorConfig,
    supervision: str = "repeat",     # repeat | single
    single_idx: int = 0,
    eval_target: str = "median",     # median | single
    device: DeviceLike = None,
) -> MethodResult:
    dev = resolve_device(device)
    len_train_np = np.asarray(data.len_train, np.float32)                # (N, r)
    len_train = torch.as_tensor(len_train_np, device=dev)
    len_test = torch.as_tensor(np.asarray(data.len_test, np.float32), device=dev)
    if eval_target == "median":
        y_test = targets_mod.sample_median(len_test)
    else:
        y_test = len_test[:, single_idx]

    if method == "constant_median":
        const = float(torch.quantile(targets_mod.sample_median(len_train), 0.5))
        pred = np.full(len_test.shape[0], const, np.float32)
        return MethodResult(method, mae(torch.as_tensor(pred, device=dev), y_test), pred,
                            selected={"constant": const})

    view = _VIEW[method]
    phi_tr = torch.as_tensor(data.phi_train[view], dtype=torch.float32, device=dev)
    phi_te = torch.as_tensor(data.phi_test[view], dtype=torch.float32, device=dev)

    target_kind = _TARGET[method] if supervision == "repeat" else "single"
    if method == "prod_d" and supervision == "single":
        raise ValueError("ProD-D is undefined under single-sample supervision "
                         "(degenerate distribution target) — paper §3.3")
    decode_rule = _DECODE[method]

    def fit_eval(n_bins: int, bin_max: float, fit_seed: int):
        edges = bins_mod.make_edges(n_bins, bin_max, pcfg.bin_spacing, device=dev)
        tgt = targets_mod.build_target(len_train, edges, target_kind, single_idx)
        p = train_predictor(fit_seed, phi_tr, tgt,
                            dataclasses.replace(pcfg, n_bins=n_bins, bin_max=bin_max),
                            edges=edges, device=dev)
        pred_tr = p.predict(phi_tr, decode_rule)
        y_tr = (targets_mod.sample_median(len_train)
                if supervision == "repeat" else len_train[:, single_idx])
        return p, mae(pred_tr, y_tr)

    selected = {}
    if method in ("s3", "egtp"):
        # hyper-parameter sweep on the train split (App. A.2 protocol)
        best = None
        grids = [(nb, bm) for nb in S3_NUM_BINS_GRID
                 for bm in (_bin_max_grid(len_train_np)
                            if method == "s3" else (pcfg.bin_max,))]
        for (nb, bm), s in zip(grids, fit_seeds(seed, len(grids))):
            p, train_mae = fit_eval(nb, float(bm), s)
            if best is None or train_mae < best[0]:
                best = (train_mae, p, {"num_bins": nb, "bin_max": float(bm)})
        _, predictor, selected = best
    else:
        predictor, _ = fit_eval(pcfg.n_bins, pcfg.bin_max, seed)

    pred = predictor.predict(phi_te, decode_rule)
    return MethodResult(method, mae(pred, y_test), pred.cpu().numpy(), predictor,
                        selected)
