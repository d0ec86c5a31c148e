"""Parameter specs with their initialisers, and the elementary layers.

A model is described once as a tree of :class:`ParamSpec` leaves (shape,
logical sharding axes and initialiser), as in ``repro.models.layers``; ``init_tree`` materialises it
from a seeded ``torch.Generator`` with the reference's scales: normal with
std 1/sqrt(fan_in), fan_in = ``shape[-2]`` (the last dim for vectors), or
an explicit ``scale``; embeddings normal with std 0.02; RMS norm scales
zero; ``ones`` for the SSM's skip ``D`` and the LayerNorm scales. The draws differ from
``jax.random``'s, so parity tests carry the reference's weights across
(``models/convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common import scopes
from repro_torch.kernels import ops, ref


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical names (``common/sharding.py``)
    init: str = "normal"        # normal | zeros | ones | embed
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in) for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def axes_tree(spec: Any) -> Any:
    """The spec tree with each leaf replaced by its logical axes."""
    if isinstance(spec, dict):
        return {k: axes_tree(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(axes_tree(v) for v in spec)
    return spec.axes


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
    """RMSNorm with a zero-initialised scale applied as (1 + scale), fp32
    inside and rounded once to x's dtype (``kernels/ops.py::rms_norm``: the
    plain version on the CPU and under autograd, one kernel on the card)."""
    return ops.rms_norm(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics (biased variance), rounded once to x's
    dtype (``repro/models/layers.py:91-99``)."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form: jax.nn.gelu's default (approximate=True), and so
    the reference's ``gelu`` and ``gelu_gated``."""
    return F.gelu(x, approximate="tanh")


# the activation of each MLP: the gate of a gated MLP (silu, gelu_gated), or
# the one activation of the plain two-matrix MLP (gelu, Whisper's)
ACTS = {"silu": F.silu, "gelu_gated": _gelu, "gelu": _gelu}
GATED = ("silu", "gelu_gated")


def mlp_spec(d_model: int, d_ff: int, act: str) -> Dict[str, ParamSpec]:
    """A gated MLP's three matrices, or the plain MLP's two (act="gelu")."""
    spec = {"w_up": ParamSpec((d_model, d_ff), ("embed", "ffn")),
            "w_down": ParamSpec((d_ff, d_model), ("ffn", "embed"))}
    if act in GATED:
        spec = {"w_gate": ParamSpec((d_model, d_ff), ("embed", "ffn")), **spec}
    return spec


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated MLP: act(x W_gate) * (x W_up), then W_down; the plain MLP:
    act(x W_up), then W_down."""
    if "w_gate" in p:
        h = ACTS[act](x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = ACTS[act](x @ p["w_up"])
    return h @ p["w_down"]


def embed_spec(vocab: int, d_model: int) -> ParamSpec:
    return ParamSpec((vocab, d_model), ("vocab", "embed"), init="embed")


def unembed(x: torch.Tensor, w_embed: torch.Tensor,
            w_head: Optional[torch.Tensor]) -> torch.Tensor:
    """Project hidden states to vocab logits in fp32 (for sampling stability);
    the span ``model.unembed`` under the profiler.

    The logits are the fp32 product of x and the head (``head``, or the tied
    ``embed.T``) as stored, computed by ``kernels/ops.py::unembed``: a head
    stored in fp32, and any CPU tensor, take ``x.float() @ w.float()``
    (``kernels/ref.py::unembed_ref``), as the reference does; a bf16 head on
    the card takes the ``unembed`` kernel, on the tensor cores from the bf16
    head, with no fp32 copy of it. The product of two bf16 values is exact
    in fp32. The kernel takes each 64-term partial sum of these products
    with the tensor cores' accumulation, whose fp32 adds truncate, and adds
    the partial sums with rounded fp32 adds; its largest error against an
    fp64 product of the same values is at most twice that of
    ``x.float() @ w.float()`` (``tests/test_torch_unembed.py``). Under
    autograd (training) the unembed is ``x.float() @ w.float()`` on either
    device, which autograd differentiates.
    """
    w = w_embed.T if w_head is None else w_head
    with scopes.span("model.unembed"):
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return ref.unembed_ref(x, w)
        return ops.unembed(x, w)
