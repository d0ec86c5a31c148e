"""Carry weights across from the JAX package's parameter trees.

The input is a tree of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)`` on the JAX side), so the port never imports JAX. The reference
stacks the blocks of each segment on a leading ``layers`` axis
(``repro/models/transformer.py:119-132``) under ``segments[i]["layer_j"]``;
the port keeps one dict per layer, in execution order (block by block, each
block's layers in turn). A hybrid's ``shared_attn`` layers are empty dicts in
both trees, and the weight-shared block is carried as ``shared``. Tensor
layouts are the reference's (``wq`` is (d, H, hd), ``wo`` is (H, hd, d)).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models.transformer import layer_kinds


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: move the raw bits
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Reference param pytree (numpy leaves) -> the port's params, in the
    config's dtype on ``device``."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    conv = lambda a: _tensor(a, dt, dev)
    out: Dict[str, Any] = {"embed": conv(tree["embed"]),
                           "final_norm": conv(tree["final_norm"])}
    if "head" in tree:
        out["head"] = conv(tree["head"])
    layers: List[Dict[str, Any]] = []
    for seg in tree["segments"]:
        names = sorted(seg, key=lambda s: int(s.split("_")[1]))
        # a shared_attn layer is an empty dict: count blocks on another
        n_blocks = next(np.asarray(seg[n]["ln1"]).shape[0] for n in names if seg[n])
        for i in range(n_blocks):
            for name in names:
                layers.append(_map(seg[name], lambda a: conv(np.asarray(a)[i])))
    kinds = layer_kinds(cfg)
    if [not lp for lp in layers] != [k == "shared_attn" for k in kinds]:
        raise ValueError(f"tree's layers do not follow {cfg.name}'s plan "
                         f"({len(layers)} layers, plan {len(kinds)})")
    out["layers"] = layers
    if "shared" in tree:
        out["shared"] = _map(tree["shared"], conv)
    return out


def head_from_jax(params: Dict[str, Any], device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Reference ProD head params (w1, b1, w2, b2 as numpy) -> fp32 tensors."""
    dev = resolve_device(device)
    return {k: _tensor(v, torch.float32, dev) for k, v in params.items()}
