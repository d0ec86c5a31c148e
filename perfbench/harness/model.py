"""The served model as the benchmark sees it: its sizes, the parameter layout
the port takes, and the weights drawn on the card from the seed.

A configuration file (``perfbench/configs/<name>.json``) holds the published
``config.json`` keys, with what was cut listed under ``reduced``; ``port``
adds what the published keys do not say (the family, ``qk_norm``), and
``init`` the scales of the seeded weights. :func:`describe` maps it onto the
port's ``ModelConfig`` fields, a plain dict that the reference reads too.

The weights are the benchmark's input, handed alike to the port and to the
reference: one flat buffer in the served dtype, filled with normal draws
from a generator on the card in a few large calls, then cut into the port's
leaves and each leaf scaled in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# published config.json key -> the port's ModelConfig field
HF_KEYS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab_size", "head_dim": "head_dim",
    "rope_theta": "rope_theta", "num_experts": "n_experts",
    "num_experts_per_tok": "n_experts_per_token", "moe_intermediate_size": "moe_d_ff",
    "tie_word_embeddings": "tie_embeddings", "rms_norm_eps": "norm_eps",
    "torch_dtype": "dtype",
}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
DRAW_CHUNK = 1 << 30          # elements a draw call fills


def describe(cfg_json: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration file -> the port's ModelConfig keyword arguments."""
    md = {"name": cfg_json["name"]}
    for hf, field in HF_KEYS.items():
        if hf in cfg_json and cfg_json[hf] is not None:
            md[field] = cfg_json[hf]
    md.update(cfg_json.get("port", {}))
    if cfg_json.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{md['name']}: only SiLU-gated MLPs are described here")
    md.setdefault("head_dim", md["d_model"] // md["n_heads"])
    return md


def seed_of(seed: int, *stream: int) -> int:
    """An independent 63-bit seed for one stream of the run's draws."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *stream])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


@dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    kind: str          # matrix | embed | router | norm
    fan_in: int = 1


def layout(md: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameter tree (``transformer.model_spec``): names, shapes
    and what each leaf is, for a dense or a MoE decoder."""
    d, H, KV, hd, V = (md["d_model"], md["n_heads"], md["n_kv_heads"], md["head_dim"],
                       md["vocab_size"])
    norm = Leaf((d,), "norm")

    def layer():
        attn = {"wq": Leaf((d, H, hd), "matrix", d), "wk": Leaf((d, KV, hd), "matrix", d),
                "wv": Leaf((d, KV, hd), "matrix", d), "wo": Leaf((H, hd, d), "matrix", H * hd)}
        if md.get("qk_norm"):
            attn["q_norm"] = Leaf((hd,), "norm")
            attn["k_norm"] = Leaf((hd,), "norm")
        if md["family"] == "moe":
            E, f = md["n_experts"], md["moe_d_ff"]
            ffn = {"moe": {"router": Leaf((d, E), "router"),
                           "w_gate": Leaf((E, d, f), "matrix", d),
                           "w_up": Leaf((E, d, f), "matrix", d),
                           "w_down": Leaf((E, f, d), "matrix", f)}}
        elif md["family"] == "dense":
            f = md["d_ff"]
            ffn = {"mlp": {"w_gate": Leaf((d, f), "matrix", d), "w_up": Leaf((d, f), "matrix", d),
                           "w_down": Leaf((f, d), "matrix", f)}}
        else:
            raise ValueError(f"{md['name']}: family {md['family']!r} is not described here")
        return {"ln1": norm, "attn": attn, "ln2": norm, **ffn}

    tree: Dict[str, Any] = {"embed": Leaf((V, d), "embed"), "final_norm": norm}
    if not md.get("tie_embeddings"):
        tree["head"] = Leaf((d, V), "matrix", d)
    tree["layers"] = [layer() for _ in range(md["n_layers"])]
    return tree


def leaves(tree, path=()) -> List[Tuple[tuple, Leaf]]:
    if isinstance(tree, Leaf):
        return [(path, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [x for k, v in items for x in leaves(v, path + (k,))]


def n_params(md: Dict[str, Any]) -> int:
    return sum(math.prod(l.shape) for _, l in leaves(layout(md)))


def _std(leaf: Leaf, init: Dict[str, float]) -> float:
    if leaf.kind == "matrix":
        return 1.0 / math.sqrt(leaf.fan_in)
    return {"embed": init["embed_std"], "router": init["router_std"],
            "norm": init["norm_std"]}[leaf.kind]


def _fill(n: int, dtype, device, gen) -> torch.Tensor:
    buf = torch.empty(n, dtype=dtype, device=device)
    for a in range(0, n, DRAW_CHUNK):
        buf[a:a + DRAW_CHUNK].normal_(generator=gen)
    return buf


def _assign(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make_params(md: Dict[str, Any], init: Dict[str, float], seed: int,
                device: torch.device) -> Dict[str, Any]:
    """The model's weights from ``seed``, in the served dtype, on ``device``."""
    lay = layout(md)
    items = leaves(lay)
    dtype = DTYPES[md.get("dtype", "bfloat16")]
    total = sum(math.prod(l.shape) for _, l in items)
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
