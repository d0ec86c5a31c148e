"""Checkpointing: flat-path npz arrays + JSON manifest, the reference's
format (``repro/training/checkpoint.py``).

Works for any tree of tensors (params, optimizer state, predictor heads).
Keys are the port's tree paths (``common/pytree.py``: ``params/layers/0/
attn/wq``); the reference's checkpoints key its stacked trees
(``params/segments/0/layer_0/attn/wq``). To serve one, load it with
``np.load``, rebuild the tree with ``pytree.tree_unflatten`` and carry it
across with ``models/convert.py::from_jax_params``. A bfloat16 tensor is
stored as float32 (exact) and restored to the dtype of ``like``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common.pytree import tree_flatten


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.cpu().numpy()


def save_checkpoint(directory: str, tree: Any, step: int = 0, name: str = "ckpt") -> str:
    os.makedirs(directory, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in tree_flatten(tree).items()}
    path = os.path.join(directory, f"{name}_{step:08d}.npz")
    np.savez(path, **flat)
    manifest = {
        "step": step,
        "n_arrays": len(flat),
        "total_bytes": int(sum(v.nbytes for v in flat.values())),
        "keys": sorted(flat),
    }
    with open(os.path.join(directory, f"{name}_{step:08d}.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def latest_checkpoint(directory: str, name: str = "ckpt") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    cands = sorted(
        f for f in os.listdir(directory)
        if f.startswith(name + "_") and f.endswith(".npz")
    )
    return os.path.join(directory, cands[-1]) if cands else None


def restore_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: every leaf's key and shape
    must match; each comes back in its ``like`` leaf's dtype and device."""
    flat_like = tree_flatten(like)
    with np.load(path) as data:
        missing = set(flat_like) - set(data.files)
        extra = set(data.files) - set(flat_like)
        if missing or extra:
            raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                             f"extra={sorted(extra)[:5]}")
        out: Dict[str, torch.Tensor] = {}
        for key, leaf in flat_like.items():
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            out[key] = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    return _rebuild(like, out)


def _rebuild(like: Any, flat: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    """``like``'s structure (empty dicts included) with the leaves of ``flat``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(like)]
    return flat[prefix[:-1]]
