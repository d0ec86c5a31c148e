"""Whisper-style encoder-decoder backbone [arXiv:2212.04356]: the port of
``repro/models/encdec.py``.

The audio frontend (mel-spectrogram + conv downsampling) is a stub
(``models/frontend.py::audio_frame_embeds``): the encoder takes frame
embeddings (B, encoder_seq, d_model). LayerNorm and plain-GELU MLPs,
sinusoidal positions computed on the fly (so any decode position works), no
RoPE.

Parameters keep the reference's names; its stacked ``encoder`` and
``decoder`` trees become lists of per-layer dicts (``models/convert.py``
maps one onto the other). The decoder's unembed reuses ``embed``, although
the config does not tie embeddings (so ``param_count()`` counts the table
twice, as the reference's does).

Prefill runs the flash kernel three ways a layer: the encoder
bidirectionally over its frames (``causal=False``, Sq = Skv), the decoder's
self-attention causally with the prompts' key lengths, and its
cross-attention over the encoder's keys (``causal=False``, Sq = prompt
length, Skv = frames). It returns, per decoder layer, the self K/V of the
prompt and the cross K/V of the frames. The decode cache
(:func:`decode_cache`) grows the self K/V to ``cache_len`` positions and
keeps the cross K/V as they are: static, every key valid. A decode step
runs the decode kernel twice a layer: on the self cache at each row's length,
and on the cross cache at ``encoder_seq``. Training (:func:`whisper_loss`)
runs :func:`attention.blocked_attention` in plain PyTorch under autograd, as
the reference's train mode does, with no key mask.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamSpec, embed_spec, layer_norm, mlp_apply, mlp_spec,
                                       unembed)

Cache = List[Dict[str, torch.Tensor]]


def _ln_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def _ln(p, x, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _enc_layer_spec(cfg: ModelConfig):
    return {"ln1": _ln_spec(cfg.d_model), "attn": attn.attn_spec(cfg),
            "ln2": _ln_spec(cfg.d_model), "mlp": mlp_spec(cfg.d_model, cfg.d_ff, "gelu")}


def _dec_layer_spec(cfg: ModelConfig):
    return {"ln1": _ln_spec(cfg.d_model), "self_attn": attn.attn_spec(cfg),
            "ln2": _ln_spec(cfg.d_model), "cross_attn": attn.attn_spec(cfg),
            "ln3": _ln_spec(cfg.d_model), "mlp": mlp_spec(cfg.d_model, cfg.d_ff, "gelu")}


def whisper_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "encoder": [_enc_layer_spec(cfg) for _ in range(cfg.n_encoder_layers)],
        "enc_final_ln": _ln_spec(cfg.d_model),
        "decoder": [_dec_layer_spec(cfg) for _ in range(cfg.n_layers)],
        "dec_final_ln": _ln_spec(cfg.d_model),
    }


def sinusoid_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal embedding rows (..., d) fp32 for integer positions (...)."""
    half = d_model // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0)) *
                      torch.arange(half, dtype=torch.float32) / max(half - 1, 1))
    ang = positions[..., None].to(torch.float32) * freqs.to(positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attend(q, k, v, causal: bool, kv_lengths, train: bool):
    """The flash kernel (prefill) or the plain blocked attention (training,
    where the reference passes no key mask)."""
    if train:
        return attn.blocked_attention(q, k, v, causal=causal)
    return attn.prefill_attention(q, k, v, causal=causal, kv_lengths=kv_lengths)


def encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
           train: bool = False) -> torch.Tensor:
    """Bidirectional encoder over the stub frame embeddings (B, Senc, d)."""
    B, S, d = enc_embeds.shape
    pos = torch.arange(S, device=enc_embeds.device)
    x = enc_embeds + sinusoid_at(pos, d)[None].to(enc_embeds.dtype)
    for lp in params["encoder"]:
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn.qkv_project(lp["attn"], h, cfg, None)
        x = x + attn.out_project(lp["attn"], _attend(q, k, v, False, None, train))
        x = x + mlp_apply(lp["mlp"], _ln(lp["ln2"], x, cfg.norm_eps), "gelu")
    return _ln(params["enc_final_ln"], x, cfg.norm_eps)


def decoder_forward(params, cfg: ModelConfig, tokens: torch.Tensor, enc_out: torch.Tensor,
                    attn_valid: Optional[torch.Tensor] = None, logits_mode: str = "all",
                    train: bool = False):
    """Causal decoder with cross-attention over ``enc_out`` (B, Senc, d).
    ``attn_valid`` (B, S) marks the valid (right-padded) prompt positions of
    the self-attention. Returns (logits (B, S, V) fp32 or None with
    ``logits_mode="none"``, hidden (B, S, d), the per-layer prefill cache
    {"k", "v": (B, S, KV, hd), "ck", "cv": (B, Senc, KV, hd)}; [] when
    ``train``)."""
    B, S = tokens.shape
    x = params["embed"][tokens]
    x = x + sinusoid_at(torch.arange(S, device=x.device), cfg.d_model)[None].to(x.dtype)
    kv_lengths = None if attn_valid is None else attn.prefix_lengths(attn_valid)
    cache: Cache = []
    for lp in params["decoder"]:
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn.qkv_project(lp["self_attn"], h, cfg, None)
        x = x + attn.out_project(lp["self_attn"], _attend(q, k, v, True, kv_lengths, train))
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        p = lp["cross_attn"]
        qc = attn.head_project(h, p["wq"])
        kc, vc = attn.head_project(enc_out, p["wk"]), attn.head_project(enc_out, p["wv"])
        x = x + attn.out_project(p, _attend(qc, kc, vc, False, None, train))
        x = x + mlp_apply(lp["mlp"], _ln(lp["ln3"], x, cfg.norm_eps), "gelu")
        if not train:
            cache.append({"k": k, "v": v, "ck": kc, "cv": vc})
    hidden = _ln(params["dec_final_ln"], x, cfg.norm_eps)
    logits = unembed(hidden, params["embed"], None) if logits_mode == "all" else None
    return logits, hidden, cache


def whisper_loss(params, cfg: ModelConfig, tokens: torch.Tensor, enc_embeds: torch.Tensor,
                 loss_mask: Optional[torch.Tensor] = None):
    """Next-token cross-entropy of the decoder over ``tokens`` given the
    frames, the mean over ``loss_mask[:, 1:]`` where a mask is given.
    Returns (loss, {"loss": loss})."""
    enc_out = encode(params, cfg, enc_embeds, train=True)
    logits, _, _ = decoder_forward(params, cfg, tokens, enc_out, train=True)
    targets = tokens[:, 1:].to(torch.long)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if loss_mask is not None:
        m = loss_mask[:, 1:].to(torch.float32)
        loss = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss, {"loss": loss}


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> List[Dict[str, ParamSpec]]:
    """The decode cache as ParamSpecs, per decoder layer: self K/V (B, Sc, KV,
    hd), Sc = ``min(attn_window, cache_len)`` with a window (a ring, as the
    reference's ``decoder_cache_spec``) else ``cache_len``, and cross K/V
    (B, encoder_seq, KV, hd)."""
    W = cfg.attn_window
    Sc = min(W, cache_len) if W else cache_len
    ax = ("batch", "cache_seq", "cache_kv_heads", "head_dim")
    kv = lambda S: ParamSpec((batch, S, cfg.n_kv_heads, cfg.head_dim), ax)
    return [{"k": kv(Sc), "v": kv(Sc), "ck": kv(cfg.encoder_seq), "cv": kv(cfg.encoder_seq)}
            for _ in range(cfg.n_layers)]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype,
               device: torch.device) -> Cache:
    """Zeroed decode cache of :func:`cache_spec` in the model dtype."""
    return [{k: torch.zeros(s.shape, dtype=dtype, device=device) for k, s in e.items()}
            for e in cache_spec(cfg, batch, cache_len)]


def decode_cache(prefill_cache: Cache, cache_len: int) -> Cache:
    """The prefill cache as a decode cache: each layer's self K/V placed in a
    zeroed (B, cache_len, KV, hd) pair, the cross K/V kept as they are."""
    out: Cache = []
    for e in prefill_cache:
        B, S, KV, hd = e["k"].shape
        if S > cache_len:
            raise ValueError(f"a decode cache of {cache_len} positions is shorter than "
                             f"the prefill ({S})")
        k, v = e["k"].new_zeros((B, cache_len, KV, hd)), e["v"].new_zeros((B, cache_len, KV, hd))
        k[:, :S], v[:, :S] = e["k"], e["v"]
        out.append({"k": k, "v": v, "ck": e["ck"], "cv": e["cv"]})
    return out


def decoder_decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: Cache,
                        pos: torch.Tensor, lengths: torch.Tensor):
    """One decoder token for each row: ``tokens`` (B,) at positions ``pos``
    (B,); ``lengths`` (B,) int32, each row's valid self-cache length AFTER
    this token. Writes the new self K/V into ``cache`` in place at ``pos``
    (``pos % window`` in a ring of ``attn_window`` slots, attending to
    ``min(lengths, window)`` of them) and attends to every cross key. Returns (logits (B, V) fp32, hidden (B,
    d))."""
    B = tokens.shape[0]
    x = params["embed"][tokens][:, None]                                  # (B, 1, d)
    x = x + sinusoid_at(pos[:, None], cfg.d_model).to(x.dtype)
    bidx = torch.arange(B, device=tokens.device)
    slot, n_self = pos.to(torch.long), lengths
    W = cfg.attn_window
    if W and cache[0]["k"].shape[1] == W:
        slot, n_self = torch.remainder(slot, W), attn.ring_cache_valid(lengths, W)
    all_keys = None
    for lp, e in zip(params["decoder"], cache):
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn.qkv_project(lp["self_attn"], h, cfg, None)
        e["k"][bidx, slot] = k[:, 0]
        e["v"][bidx, slot] = v[:, 0]
        x = x + attn.out_project(lp["self_attn"],
                                 attn.decode_attention(q, e["k"], e["v"], n_self))
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        if all_keys is None:
            all_keys = torch.full((B,), e["ck"].shape[1], dtype=torch.int32,
                                  device=tokens.device)
        p = lp["cross_attn"]
        qc = attn.head_project(h, p["wq"])
        x = x + attn.out_project(p, attn.decode_attention(qc, e["ck"], e["cv"], all_keys))
        x = x + mlp_apply(lp["mlp"], _ln(lp["ln3"], x, cfg.norm_eps), "gelu")
    hidden = _ln(params["dec_final_ln"], x[:, 0], cfg.norm_eps)
    return unembed(hidden, params["embed"], None), hidden
