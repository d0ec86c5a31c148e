"""Decoder-only transformer, dense family: prefill and cached decode.

Parameters are a dict with the reference's names; the reference's stacked
``segments`` (a leading ``layers`` axis per segment) become a plain list of
per-layer dicts (``models/convert.py`` maps one onto the other).

The decode cache is a list of per-layer ``(k, v)`` tensors of shape
(B, cache_len, KV, hd), allocated once at ``prompt_len + max_new`` (where the
reference pads the prefill cache, ``RealEngine._grow_cache``) and written in
place: each decode step scatters its token's K/V at row ``b``, position
``pos[b]``, as ``transformer.py:409-411`` does out of place.

Other families, sliding-window / ring caches and the int8 KV cache raise
``NotImplementedError`` until their slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamSpec, embed_spec, mlp_apply,
                                       mlp_spec, rms_norm, unembed)
from repro_torch.models.rope import positions_from_tokens, rope_angles

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "family": cfg.family != "dense",
        "attn_window / local_global_ratio (ring caches)":
            bool(cfg.attn_window or cfg.local_global_ratio),
        "qk_norm": cfg.qk_norm,
        "use_mrope": cfg.use_mrope,
        "act": cfg.act != "silu",
    }
    missing = [k for k, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet — this slice "
            f"serves the dense family (see ROADMAP.md, queue 1)")


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    norm = lambda: ParamSpec((cfg.d_model,), init="zeros")
    spec: Dict[str, Any] = {"embed": embed_spec(cfg.vocab_size, cfg.d_model),
                            "final_norm": norm()}
    if not cfg.tie_embeddings:
        spec["head"] = ParamSpec((cfg.d_model, cfg.vocab_size))
    spec["layers"] = [{"ln1": norm(), "attn": attn.attn_spec(cfg), "ln2": norm(),
                       "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}
                      for _ in range(cfg.n_layers)]
    return spec


def _ffn(lp, x, cfg: ModelConfig):
    return x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))


def forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            attn_valid: Optional[torch.Tensor] = None, logits_mode: str = "all"):
    """Prefill pass over (B, S) tokens. ``attn_valid`` (B, S) marks the valid
    (right-padded) prompt positions. Returns (logits (B, S, V) fp32 or None
    with ``logits_mode="none"``, hidden (B, S, d), per-layer [(k, v)])."""
    B, S = tokens.shape
    x = params["embed"][tokens]
    angles = rope_angles(positions_from_tokens(B, S, device=tokens.device),
                         cfg.head_dim, cfg.rope_theta)
    kv_lengths = None if attn_valid is None else attn.prefix_lengths(attn_valid)
    cache: Cache = []
    for lp in params["layers"]:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(lp["attn"], h, cfg, angles)
        o = attn.prefill_attention(q, k, v, kv_lengths=kv_lengths)
        x = _ffn(lp, x + attn.out_project(lp["attn"], o), cfg)
        cache.append((k, v))
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (unembed(hidden, params["embed"], params.get("head"))
              if logits_mode == "all" else None)
    return logits, hidden, cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype,
               device: torch.device) -> Cache:
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def decode_step(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
                cache: Cache, pos: torch.Tensor, lengths: torch.Tensor):
    """One decode step for (B,) new tokens at positions ``pos`` (B,);
    ``lengths`` (B,) int32 is each row's valid cache length AFTER this token.
    Writes the new K/V into ``cache`` in place. Returns (logits (B, V) fp32,
    hidden (B, d))."""
    B = tokens.shape[0]
    x = params["embed"][tokens][:, None]                        # (B, 1, d)
    angles = rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
    bidx = torch.arange(B, device=tokens.device)
    slot = pos.to(torch.long)
    for lp, (kc, vc) in zip(params["layers"], cache):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(lp["attn"], h, cfg, angles)
        kc[bidx, slot] = k[:, 0]
        vc[bidx, slot] = v[:, 0]
        o = attn.decode_attention(q, kc, vc, lengths)
        x = _ffn(lp, x + attn.out_project(lp["attn"], o), cfg)
    hidden = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    logits = unembed(hidden, params["embed"], params.get("head"))
    return logits, hidden
