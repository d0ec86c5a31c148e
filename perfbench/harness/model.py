"""The served model's weights as the benchmark draws them, whatever its
architecture: the leaves of a parameter tree, and the weights drawn on the
card from the seed.

A configuration file (``perfbench/configs/<name>.json``) holds the published
``config.json`` keys, with what was cut listed under ``reduced``; ``arch``
names the module (``perfbench/arch/<arch>.py``) whose ``describe`` maps it
onto the port's ``ModelConfig`` fields and whose ``layout`` gives the port's
parameter tree; ``init`` holds the scales of the seeded weights.

The weights are the benchmark's input, handed alike to the port and to the
reference: one flat buffer in the served dtype, filled with normal draws
from a generator on the card in a few large calls, then cut into the
layout's leaves in their order and each leaf scaled in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
DRAW_CHUNK = 1 << 30          # elements a draw call fills


def seed_of(seed: int, *stream: int) -> int:
    """An independent 63-bit seed for one stream of the run's draws."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *stream])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


@dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    kind: str          # matrix, or a kind the init block scales by "<kind>_std"
    fan_in: int = 1


def leaves(tree, path=()) -> List[Tuple[tuple, Leaf]]:
    if isinstance(tree, Leaf):
        return [(path, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [x for k, v in items for x in leaves(v, path + (k,))]


def n_params(tree) -> int:
    return sum(math.prod(l.shape) for _, l in leaves(tree))


def _std(leaf: Leaf, init: Dict[str, float]) -> float:
    if leaf.kind == "matrix":
        return 1.0 / math.sqrt(leaf.fan_in)
    return init[f"{leaf.kind}_std"]


def _fill(n: int, dtype, device, gen) -> torch.Tensor:
    buf = torch.empty(n, dtype=dtype, device=device)
    for a in range(0, n, DRAW_CHUNK):
        buf[a:a + DRAW_CHUNK].normal_(generator=gen)
    return buf


def _assign(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make_params(lay: Dict[str, Any], dtype: str, init: Dict[str, float], seed: int,
                device: torch.device) -> Dict[str, Any]:
    """The weights of the parameter tree ``lay`` from ``seed``, in ``dtype``
    (a ``torch_dtype`` name), on ``device``."""
    items = leaves(lay)
    dtype = DTYPES[dtype]
    total = n_params(lay)
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 1))
    buf = _fill(total, dtype, device, gen)
    out = _skeleton(lay)
    off = 0
    for path, leaf in items:
        n = math.prod(leaf.shape)
        t = buf[off:off + n].view(leaf.shape)
        t.mul_(_std(leaf, init))
        _assign(out, path, t)
        off += n
    return out


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def make_head(md: Dict[str, Any], init: Dict[str, Any], seed: int,
              device: torch.device) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The ProD-D head's fp32 weights (d -> hidden -> K bins) and its linear
    bin edges on [0, bin_max]."""
    d, hid, K = md["d_model"], init["head_hidden"], init["head_bins"]
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 2))
    buf = _fill(d * hid + hid + hid * K + K, torch.float32, device, gen)
    w1, b1, w2, b2 = torch.split(buf, [d * hid, hid, hid * K, K])
    head = {"w1": w1.view(d, hid).mul_(1 / math.sqrt(d)), "b1": b1.mul_(init["head_bias_std"]),
            "w2": w2.view(hid, K).mul_(1 / math.sqrt(hid)), "b2": b2.mul_(init["head_bias_std"])}
    edges = torch.linspace(0.0, float(init["bin_max"]), K + 1, dtype=torch.float32,
                           device=device)
    return head, edges
