"""Parameter specs with their initialisers, and the elementary layers.

A model is described once as a tree of :class:`ParamSpec` leaves (shape +
initialiser), as in ``repro.models.layers``; ``init_tree`` materialises it
from a seeded ``torch.Generator`` with the reference's scales: normal with
std 1/sqrt(fan_in), fan_in = ``shape[-2]`` (the last dim for vectors), or
an explicit ``scale``; embeddings normal with std 0.02; norm scales zero;
``ones`` for the SSM's skip ``D``. The draws differ from
``jax.random``'s, so parity tests carry the reference's weights across
(``models/convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in) for "normal"


def init_tree(spec: Any, generator: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> Any:
    """Materialise a nested dict/list of ParamSpecs, drawing in tree order."""
    if isinstance(spec, dict):
        return {k: init_tree(v, generator, dtype, device) for k, v in spec.items()}
    if isinstance(spec, list):
        return [init_tree(v, generator, dtype, device) for v in spec]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "embed":
        scale = 0.02
    elif spec.scale is not None:
        scale = spec.scale
    else:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / np.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a zero-initialised scale applied as (1 + scale)."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def mlp_spec(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {"w_gate": ParamSpec((d_model, d_ff)),
            "w_up": ParamSpec((d_model, d_ff)),
            "w_down": ParamSpec((d_ff, d_model))}


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def embed_spec(vocab: int, d_model: int) -> ParamSpec:
    return ParamSpec((vocab, d_model), init="embed")


def unembed(x: torch.Tensor, w_embed: torch.Tensor,
            w_head: Optional[torch.Tensor]) -> torch.Tensor:
    """Project hidden states to vocab logits in fp32 (for sampling stability)."""
    w = w_embed.T if w_head is None else w_head
    return x.to(torch.float32) @ w.to(torch.float32)
