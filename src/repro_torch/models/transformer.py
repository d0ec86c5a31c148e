"""Decoder-only models of the dense, SSM and hybrid families: prefill and
cached decode.

Architectures follow the reference's *layer plan*: a list of segments, each
a ``(kinds, n_blocks)`` pair (``repro/models/transformer.py:58-82``):

* uniform dense:   [ (('full',), L) ]
* mamba2:          [ (('ssm',), L) ]
* zamba2 hybrid:   [ (('shared_attn',) + ('ssm',)*k, L//k), (('ssm',)*(L%k), 1) ]

Parameters are a dict with the reference's names; the reference's stacked
``segments`` become ``layers``, a plain list of per-layer dicts in execution
order (``models/convert.py`` maps one onto the other). A ``shared_attn``
layer's dict is empty: it applies ``params["shared"]``, the one weight-shared
attention + SiLU MLP block (Zamba2), with a K/V cache of its own per
invocation.

The cache is a list with one entry per layer in execution order: a
``(k, v)`` pair of (B, cache_len, KV, hd) tensors for an attention layer, an
``{"h", "conv"}`` dict for an SSM layer (``models/ssm.py``). Prefill returns
K/V of the prompt's length; :func:`decode_cache` grows them to
``prompt_len + max_new`` (where the reference pads the prefill cache,
``RealEngine._grow_cache``). Each decode step writes its token's K/V in place
at row ``b``, position ``pos[b]`` (``transformer.py:409-411`` does so out of
place) and replaces each SSM entry with the new state.

The shared block's window (Zamba2: 8192) goes to the prefill kernel. The
reference keeps that block's decode cache as a ring of the window's length;
the port keeps full caches, which give the same answers while
``prompt_len + max_new <= attn_window``, and raises beyond that. MoE, dense
sliding windows and local/global mixes, ``qk_norm`` and M-RoPE raise
``NotImplementedError`` until their slices (ROADMAP.md); the int8 KV cache
has no switch in the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamSpec, embed_spec, mlp_apply,
                                       mlp_spec, rms_norm, unembed)
from repro_torch.models.rope import positions_from_tokens, rope_angles

Entry = Union[Tuple[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]
Cache = List[Entry]


def check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "family": cfg.family not in ("dense", "ssm", "hybrid"),
        "attn_window / local_global_ratio (ring caches)":
            bool(cfg.local_global_ratio) or (cfg.family == "dense" and bool(cfg.attn_window)),
        "qk_norm": cfg.qk_norm,
        "use_mrope": cfg.use_mrope,
        "act": cfg.act != "silu",
    }
    missing = [k for k, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet — the port serves "
            f"the dense, ssm and hybrid families (see ROADMAP.md, queue 1)")


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    kinds: Tuple[str, ...]
    n_blocks: int


def layer_plan(cfg: ModelConfig) -> List[Segment]:
    L = cfg.n_layers
    if cfg.family == "dense":
        return [Segment(("full",), L)]
    if cfg.family == "ssm":
        return [Segment(("ssm",), L)]
    if cfg.family == "hybrid":
        k = max(cfg.attn_every, 1)
        segs = []
        if L // k:
            segs.append(Segment(("shared_attn",) + ("ssm",) * k, L // k))
        if L % k:
            segs.append(Segment(("ssm",) * (L % k), 1))
        return segs
    raise ValueError(cfg.family)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The plan flattened into execution order: block by block, each block's
    kinds in turn (the reference scans blocks and unrolls kinds)."""
    return [kind for seg in layer_plan(cfg) for _ in range(seg.n_blocks)
            for kind in seg.kinds]


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.attn_window if kind == "shared_attn" else 0


# ---------------------------------------------------------------------------
# parameter spec
# ---------------------------------------------------------------------------


def _norm(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), init="zeros")


def shared_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """Attention + SiLU MLP: Zamba2's shared block, and a dense layer."""
    return {"ln1": _norm(cfg), "attn": attn.attn_spec(cfg), "ln2": _norm(cfg),
            "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}


def _layer_spec(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    if kind == "full":
        return shared_block_spec(cfg)
    if kind == "ssm":
        return {"ln1": _norm(cfg), "ssm": ssm_mod.ssm_spec(cfg)}
    if kind == "shared_attn":
        return {}  # weights live in params["shared"]
    raise ValueError(kind)


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"embed": embed_spec(cfg.vocab_size, cfg.d_model),
                            "final_norm": _norm(cfg)}
    if not cfg.tie_embeddings:
        spec["head"] = ParamSpec((cfg.d_model, cfg.vocab_size))
    spec["layers"] = [_layer_spec(cfg, kind) for kind in layer_kinds(cfg)]
    if cfg.family == "hybrid":
        spec["shared"] = shared_block_spec(cfg)
    return spec


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _ffn(lp, x, cfg: ModelConfig):
    return x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))


def _has_attention(kinds: List[str]) -> bool:
    return any(k != "ssm" for k in kinds)


def forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            attn_valid: Optional[torch.Tensor] = None, logits_mode: str = "all"):
    """Prefill pass over (B, S) tokens. ``attn_valid`` (B, S) marks the valid
    (right-padded) prompt positions. Returns (logits (B, S, V) fp32 or None
    with ``logits_mode="none"``, hidden (B, S, d), the per-layer cache)."""
    B, S = tokens.shape
    kinds = layer_kinds(cfg)
    x = params["embed"][tokens]
    angles = kv_lengths = None
    if _has_attention(kinds):
        angles = rope_angles(positions_from_tokens(B, S, device=tokens.device),
                             cfg.head_dim, cfg.rope_theta)
        kv_lengths = None if attn_valid is None else attn.prefix_lengths(attn_valid)
    shared = params.get("shared")
    cache: Cache = []
    for kind, lp in zip(kinds, params["layers"]):
        if kind == "ssm":
            y, state = ssm_mod.ssm_prefill(lp["ssm"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                                           cfg)
            x = x + y
            cache.append(state)
            continue
        p = shared if kind == "shared_attn" else lp
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(p["attn"], h, cfg, angles)
        o = attn.prefill_attention(q, k, v, window=_window(cfg, kind),
                                   kv_lengths=kv_lengths)
        x = _ffn(p, x + attn.out_project(p["attn"], o), cfg)
        cache.append((k, v))
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (unembed(hidden, params["embed"], params.get("head"))
              if logits_mode == "all" else None)
    return logits, hidden, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _check_cache_len(cfg: ModelConfig, cache_len: int) -> None:
    windows = {_window(cfg, kind) for kind in layer_kinds(cfg)} - {0}
    if any(cache_len > w for w in windows):
        raise NotImplementedError(
            f"{cfg.name}: a decode cache of {cache_len} positions outgrows the "
            f"shared block's window ({min(windows)}); ring caches are not ported "
            f"yet (see ROADMAP.md, queue 1)")


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype,
               device: torch.device) -> Cache:
    """Zeroed decode cache: K/V (B, cache_len, KV, hd) in the model dtype per
    attention layer, h (B, H, P, N) fp32 and conv (B, W-1, C) in the model
    dtype per SSM layer."""
    _check_cache_len(cfg, cache_len)
    cache: Cache = []
    for kind in layer_kinds(cfg):
        if kind == "ssm":
            H, P, N, d_conv = ssm_mod.ssm_dims(cfg)
            cache.append({
                "h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_conv), dtype=dtype,
                                    device=device)})
        else:
            shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
            cache.append((torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device)))
    return cache


def decode_cache(cfg: ModelConfig, prefill_cache: Cache, cache_len: int) -> Cache:
    """The prefill cache as a decode cache of ``cache_len`` positions: each
    attention entry's K/V copied into the front of a zeroed (B, cache_len,
    KV, hd) pair; each SSM state carried over as it is."""
    _check_cache_len(cfg, cache_len)
    out: Cache = []
    for entry in prefill_cache:
        if isinstance(entry, dict):
            out.append(entry)
            continue
        k, v = entry
        B, S, KV, hd = k.shape
        kc = k.new_zeros((B, cache_len, KV, hd))
        vc = v.new_zeros((B, cache_len, KV, hd))
        kc[:, :S] = k
        vc[:, :S] = v
        out.append((kc, vc))
    return out


def decode_step(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
                cache: Cache, pos: torch.Tensor, lengths: torch.Tensor):
    """One decode step for (B,) new tokens at positions ``pos`` (B,);
    ``lengths`` (B,) int32 is each row's valid cache length AFTER this token.
    Writes the new K/V into ``cache`` in place and replaces its SSM states.
    Returns (logits (B, V) fp32, hidden (B, d))."""
    B = tokens.shape[0]
    kinds = layer_kinds(cfg)
    x = params["embed"][tokens][:, None]                        # (B, 1, d)
    angles = (rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
              if _has_attention(kinds) else None)
    bidx = torch.arange(B, device=tokens.device)
    slot = pos.to(torch.long)
    shared = params.get("shared")
    for i, (kind, lp) in enumerate(zip(kinds, params["layers"])):
        if kind == "ssm":
            y, cache[i] = ssm_mod.ssm_decode_step(
                lp["ssm"], rms_norm(x, lp["ln1"], cfg.norm_eps), cache[i], cfg)
            x = x + y
            continue
        p = shared if kind == "shared_attn" else lp
        kc, vc = cache[i]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(p["attn"], h, cfg, angles)
        kc[bidx, slot] = k[:, 0]
        vc[bidx, slot] = v[:, 0]
        o = attn.decode_attention(q, kc, vc, lengths)
        x = _ffn(p, x + attn.out_project(p["attn"], o), cfg)
    hidden = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    logits = unembed(hidden, params["embed"], params.get("head"))
    return logits, hidden
