"""Decoder-only models of the dense, VLM, MoE, SSM and hybrid families:
prefill and cached decode; the training forward and its next-token loss.
The encoder-decoder family is ``models/encdec.py``.

Architectures follow the reference's *layer plan*: a list of segments, each
a ``(kinds, n_blocks)`` pair (``repro/models/transformer.py:58-82``):

* uniform dense:   [ (('full',), L) ]   (a VLM's language model too)
* dense, windowed: [ (('local',), L) ]
* gemma3 5:1:      [ (('local',)*5 + ('full',), L//6), (('local',)*(L%6), 1) ]
* MoE:             [ (('moe',), L) ]
* mamba2:          [ (('ssm',), L) ]
* zamba2 hybrid:   [ (('shared_attn',) + ('ssm',)*k, L//k), (('ssm',)*(L%k), 1) ]

Parameters are a dict with the reference's names; the reference's stacked
``segments`` become ``layers``, a plain list of per-layer dicts in execution
order (``models/convert.py`` maps one onto the other). A ``shared_attn``
layer's dict is empty: it applies ``params["shared"]``, the one weight-shared
attention + SiLU MLP block (Zamba2), with a K/V cache of its own per
invocation.

The cache is a list with one entry per layer in execution order: a
``(k, v)`` pair of (B, Sc, KV, hd) tensors for an attention layer, an
``{"h", "conv"}`` dict for an SSM layer (``models/ssm.py``). The int8 KV
cache (:func:`init_cache` with ``kv_quant``, the reference's
``cache_spec(kv_quant=True)``) holds ``(k, v, k_s, v_s)`` instead: int8 K/V
and their fp32 scales (B, Sc, KV), one per token and KV head. Its form
decides the path, as ``"k_s" in entry`` does in the reference: a decode step
quantizes the new K/V into their slot (:func:`_quantize_kv`), dequantizes
the whole cache to the model dtype and calls the same decode kernel, as the
reference calls its decode kernel on the dequantized cache
(``repro/models/transformer.py:424-431``). Only :func:`init_cache` makes
one; the prefill and :func:`decode_cache` keep the model dtype. Prefill returns
K/V of the prompt's length; :func:`decode_cache` makes the decode cache of
``cache_len = prompt_len + max_new`` positions from it (where the reference
pads the prefill cache, ``RealEngine._grow_cache``). A full layer's K/V are
grown to ``cache_len``. A windowed layer (``local``, and Zamba2's
``shared_attn``) keeps ``Sc = min(window, cache_len)`` slots, as the
reference's ``cache_spec`` does; where that is the window the cache is a
ring: position t sits at slot t % window, and a prefill longer than the
window leaves its last ``window`` *padded* positions there
(``_ring_from_prefill``, ``repro/models/transformer.py:230-244``; a short
row in a long batch so attends to pad K/V, as in the reference). Each
decode step writes its token's K/V in place at row ``b``, slot ``pos[b]``
(``pos[b] % window`` in a ring; the reference writes out of place) and
attends to ``min(lengths, window)`` slots of a ring
(:func:`attention.ring_cache_valid`), and replaces each SSM entry with the
new state. The window also goes to the prefill kernel. ``local`` layers
take their own rope base (``rope_theta_local``).

Gemma3's pieces: a local/global mix (``local_global_ratio``: blocks of that
many ``local`` layers and one ``full`` one, the rest ``local``),
``qk_norm`` (``attention.qkv_project``) and the tanh-GELU gated MLP
(``act="gelu_gated"``, ``layers.mlp_apply``). A ``moe`` layer is
attention and ``models/moe.py``'s capacity-dispatched experts in place of
the MLP (``_apply_ffn``, the reference's ``transformer.py:197-207``); the
serving passes drop its router loss, the training forward sums it over the
layers and ``lm_loss`` adds ``router_aux_coef`` times it. The MLP is the
config's ``act``: gated (``silu``, ``gelu_gated``) or the plain two-matrix
``gelu`` (``layers.mlp_apply``); the hybrid's shared block is gated SiLU
whatever the config says, as the reference's.

Qwen2-VL (family ``vlm``): M-RoPE (``use_mrope``: three position streams
drive three sections of the rotary bands, ``models/rope.py``), and the
``embeds=`` / ``positions=`` input of :func:`forward`, :func:`decode_step`,
:func:`train_forward` and :func:`lm_loss`, which the stub vision tower
feeds (``models/frontend.py::vlm_embeds``). Without them, tokens are
embedded and the three streams are the text positions, where M-RoPE is RoPE.
A decode step gives its position to all three streams, as the reference's
(``repro/models/transformer.py:453-456``): after patches the first decoded
position is the prompt's length S, not the text's next id.

The training forward (:func:`train_forward`, :func:`lm_loss`) runs the
attention layers with :func:`attention.blocked_attention` in plain PyTorch,
causal with a ``local`` layer's window (and Zamba2's shared block with its
own) and no key mask, each layer with its own rope base, and the SSM layers
with ``models/ssm.py::ssm_apply_train``, as the reference's train mode does
(``repro/models/transformer.py:210-227``); it can recompute each layer in
the backward pass (``remat``, the reference's ``jax.checkpoint``,
``transformer.py:307``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

import torch.utils.checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.pytree import tree_map
from repro_torch.common.scopes import scope
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ACTS, ParamSpec, embed_spec, mlp_apply,
                                       mlp_spec, rms_norm, unembed)
from repro_torch.models.moe import MoeKnobs, moe_apply, moe_spec
from repro_torch.models.rope import (angles_by_base, positions_from_tokens,
                                     text_mrope_positions)

Entry = Union[Tuple[torch.Tensor, ...], Dict[str, torch.Tensor]]   # (k, v[, k_s, v_s]) | SSM
Cache = List[Entry]


FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family or an MLP activation the reference has no model
    for."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} (one of {FAMILIES})")
    if cfg.act not in ACTS:
        raise ValueError(f"{cfg.name}: unknown act {cfg.act!r} (one of {tuple(ACTS)})")


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    kinds: Tuple[str, ...]
    n_blocks: int


def layer_plan(cfg: ModelConfig) -> List[Segment]:
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.local_global_ratio > 0:
            blk = ("local",) * cfg.local_global_ratio + ("full",)
            segs = []
            if L // len(blk):
                segs.append(Segment(blk, L // len(blk)))
            if L % len(blk):
                segs.append(Segment(("local",) * (L % len(blk)), 1))
            return segs
        kind = "moe" if cfg.family == "moe" else ("local" if cfg.attn_window else "full")
        return [Segment((kind,), L)]
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
    return cfg.attn_window if kind in ("local", "shared_attn") else 0


def _angles(cfg: ModelConfig, kinds: List[str], positions: torch.Tensor):
    """kind -> its rope angle table (None for SSM layers); ``positions`` (B,
    S), or (3, B, S) with M-RoPE."""
    table = angles_by_base(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_theta_local,
                           kinds, use_mrope=cfg.use_mrope)
    return lambda kind: (None if kind == "ssm" else
                         table["local" if kind == "local" else "global"])


# ---------------------------------------------------------------------------
# parameter spec
# ---------------------------------------------------------------------------


def _norm(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), ("embed",), init="zeros")


def shared_block_spec(cfg: ModelConfig, act: str = "silu") -> Dict[str, Any]:
    """Attention + MLP: Zamba2's shared block (gated SiLU, whatever the
    config's act), and a dense layer (the config's act)."""
    return {"ln1": _norm(cfg), "attn": attn.attn_spec(cfg), "ln2": _norm(cfg),
            "mlp": mlp_spec(cfg.d_model, cfg.d_ff, act)}


def _layer_spec(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    if kind in ("full", "local"):
        return shared_block_spec(cfg, cfg.act)
    if kind == "moe":
        return {"ln1": _norm(cfg), "attn": attn.attn_spec(cfg), "ln2": _norm(cfg),
                "moe": moe_spec(cfg)}
    if kind == "ssm":
        return {"ln1": _norm(cfg), "ssm": ssm_mod.ssm_spec(cfg)}
    if kind == "shared_attn":
        return {}  # weights live in params["shared"]
    raise ValueError(kind)


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"embed": embed_spec(cfg.vocab_size, cfg.d_model),
                            "final_norm": _norm(cfg)}
    if not cfg.tie_embeddings:
        spec["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    spec["layers"] = [_layer_spec(cfg, kind) for kind in layer_kinds(cfg)]
    if cfg.family == "hybrid":
        spec["shared"] = shared_block_spec(cfg)
    return spec


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _apply_ffn(lp, x, cfg: ModelConfig, moe: MoeKnobs):
    """The layer's FFN on its residual: the MLP, or the MoE experts of a
    layer that has them. Returns (x, the router's aux loss, None for an MLP)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        y, aux = moe_apply(lp["moe"], h, cfg, mesh=moe.mesh, capacity_factor=moe.capacity_factor,
                           cap_slack=moe.cap_slack, fsdp_mode=moe.fsdp_mode)
        return x + y, aux
    return x + mlp_apply(lp["mlp"], h, cfg.act), None


def _has_attention(kinds: List[str]) -> bool:
    return any(k != "ssm" for k in kinds)


def _inputs(params, cfg: ModelConfig, tokens, embeds, positions):
    """The first layer's input (B, S, d) and the rope positions: ``embeds``
    as given or the tokens' embeddings; ``positions`` as given or the text
    positions ((3, B, S) with M-RoPE)."""
    x = params["embed"][tokens] if embeds is None else embeds
    if positions is None:
        B, S = x.shape[:2]
        make = text_mrope_positions if cfg.use_mrope else positions_from_tokens
        positions = make(B, S, device=x.device)
    return x, positions


def forward(params: Dict[str, Any], cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            attn_valid: Optional[torch.Tensor] = None, logits_mode: str = "all",
            moe: MoeKnobs = MoeKnobs(), embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None):
    """Prefill pass over (B, S) tokens, or over ``embeds`` (B, S, d) in the
    model dtype (the VLM's patch + text embeddings) at ``positions`` ((B, S),
    or (3, B, S) with M-RoPE; the text positions when None). ``attn_valid``
    (B, S) marks the valid (right-padded) prompt positions; a MoE layer
    routes every position, pads included, with ``moe``'s knobs. Returns
    (logits (B, S, V) fp32 or None with ``logits_mode="none"``, hidden (B,
    S, d), the per-layer cache)."""
    kinds = layer_kinds(cfg)
    x, positions = _inputs(params, cfg, tokens, embeds, positions)
    angles = _angles(cfg, kinds, positions)
    kv_lengths = None
    if _has_attention(kinds) and attn_valid is not None:
        kv_lengths = attn.prefix_lengths(attn_valid)
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
        q, k, v = attn.qkv_project(p["attn"], h, cfg, angles(kind))
        o = attn.prefill_attention(q, k, v, window=_window(cfg, kind),
                                   kv_lengths=kv_lengths)
        x, _ = _apply_ffn(p, x + attn.out_project(p["attn"], o), cfg, moe)
        cache.append((k, v))
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (unembed(hidden, params["embed"], params.get("head"))
              if logits_mode == "all" else None)
    return logits, hidden, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _slots(cfg: ModelConfig, kind: str, cache_len: int) -> int:
    """Slots of an attention layer's decode cache: ``min(window, cache_len)``
    for a windowed layer (the reference's ``cache_spec``), else cache_len."""
    W = _window(cfg, kind)
    return min(W, cache_len) if W else cache_len


KV_AXES = ("batch", "cache_seq", "cache_kv_heads", "head_dim")


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int, kv_quant: bool = False):
    """The decode cache as ParamSpecs (shapes and logical axes), in the
    cache's structure: K/V (B, Sc, KV, hd) per attention layer (Sc from
    :func:`_slots`), or with ``kv_quant`` int8 K/V and fp32 scales (B, Sc,
    KV); h (B, H, P, N) fp32 and conv (B, W-1, C) per SSM layer. The axes
    are the reference's ``cache_spec``'s less its leading ``layers``."""
    cache = []
    for kind in layer_kinds(cfg):
        if kind == "ssm":
            H, P, N, d_conv = ssm_mod.ssm_dims(cfg)
            cache.append({
                "h": ParamSpec((batch, H, P, N), ("batch", "ssm_heads", None, None),
                               init="f32"),
                "conv": ParamSpec((batch, cfg.ssm_conv_width - 1, d_conv),
                                  ("batch", None, "ssm_inner"))})
            continue
        shape = (batch, _slots(cfg, kind, cache_len), cfg.n_kv_heads, cfg.head_dim)
        if kv_quant:
            kv = ParamSpec(shape, KV_AXES, init="int8")
            scale = ParamSpec(shape[:3], KV_AXES[:3], init="f32")
            cache.append((kv, kv, scale, scale))
        else:
            kv = ParamSpec(shape, KV_AXES)
            cache.append((kv, kv))
    return cache


def cache_dtype(spec: ParamSpec, dtype: torch.dtype) -> torch.dtype:
    """int8 for quantized K/V, fp32 for their scales and the SSM state, the
    model dtype else."""
    return {"int8": torch.int8, "f32": torch.float32}.get(spec.init, dtype)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype: torch.dtype,
               device: torch.device, kv_quant: bool = False) -> Cache:
    """Zeroed decode cache of :func:`cache_spec`."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=cache_dtype(s, dtype), device=device),
                    cache_spec(cfg, batch, cache_len, kv_quant))


def decode_cache(cfg: ModelConfig, prefill_cache: Cache, cache_len: int) -> Cache:
    """The prefill cache as a decode cache of ``cache_len`` positions: each
    attention entry's K/V placed in a zeroed (B, Sc, KV, hd) pair, position t
    at slot t (t % window in a ring, which keeps the last ``window`` padded
    positions of a longer prefill); each SSM state carried over as it is."""
    out: Cache = []
    for kind, entry in zip(layer_kinds(cfg), prefill_cache):
        if isinstance(entry, dict):
            out.append(entry)
            continue
        k, v = entry
        B, S, KV, hd = k.shape
        Sc = _slots(cfg, kind, cache_len)
        if S > Sc and not _window(cfg, kind):
            raise ValueError(f"a decode cache of {cache_len} positions is shorter than "
                             f"the prefill ({S})")
        kc = k.new_zeros((B, Sc, KV, hd))
        vc = v.new_zeros((B, Sc, KV, hd))
        if S <= Sc:
            kc[:, :S] = k
            vc[:, :S] = v
        else:            # a ring shorter than the prefill: its last Sc positions
            slots = torch.arange(S - Sc, S, device=k.device) % Sc
            kc[:, slots] = k[:, S - Sc:]
            vc[:, slots] = v[:, S - Sc:]
        out.append((kc, vc))
    return out


def _quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, KV, hd) -> (int8 values, fp32 scales (B, KV)): scale = max|t| /
    127, values rounded half to even and clipped to +-127 (the reference's
    ``_quantize_kv``, ``repro/models/transformer.py:386-390``)."""
    t = t.to(torch.float32)
    scale = t.abs().amax(dim=-1) / 127.0
    q = torch.round(t / torch.clamp(scale[..., None], min=1e-8))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _dequantize(c: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (c.to(torch.float32) * s[..., None]).to(dtype)


def decode_step(params: Dict[str, Any], cfg: ModelConfig, tokens: Optional[torch.Tensor],
                cache: Cache, pos: torch.Tensor, lengths: torch.Tensor,
                moe: MoeKnobs = MoeKnobs(), embeds: Optional[torch.Tensor] = None):
    """One decode step for (B,) new tokens, or their ``embeds`` ((B, d) or
    (B, 1, d)), at positions ``pos`` (B,), which M-RoPE gives to all three
    streams; ``lengths`` (B,) int32 is each row's valid cache length AFTER
    this token. Writes the new K/V into ``cache`` in place (at ``pos %
    window`` in a ring, attending to ``min(lengths, window)`` slots there;
    quantized in an int8 cache) and replaces its SSM states. Returns
    (logits (B, V) fp32, hidden (B, d))."""
    B = pos.shape[0]
    kinds = layer_kinds(cfg)
    if embeds is None:
        x = params["embed"][tokens][:, None]                    # (B, 1, d)
    else:
        x = embeds[:, None] if embeds.ndim == 2 else embeds
    positions = pos[:, None]
    if cfg.use_mrope:
        positions = positions[None].expand(3, B, 1)
    angles = _angles(cfg, kinds, positions)
    bidx = torch.arange(B, device=pos.device)
    slot = pos.to(torch.long)
    W = cfg.attn_window
    # where a ring of W slots writes and how many it attends to: once a step
    ring = (torch.remainder(slot, W), attn.ring_cache_valid(lengths, W)) if W else None
    shared = params.get("shared")
    for i, (kind, lp) in enumerate(zip(kinds, params["layers"])):
        if kind == "ssm":
            y, cache[i] = ssm_mod.ssm_decode_step(
                lp["ssm"], rms_norm(x, lp["ln1"], cfg.norm_eps), cache[i], cfg)
            x = x + y
            continue
        p = shared if kind == "shared_attn" else lp
        kc, vc = cache[i][:2]
        at, n = ring if _window(cfg, kind) and kc.shape[1] == W else (slot, lengths)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(p["attn"], h, cfg, angles(kind))
        if len(cache[i]) == 4:                  # int8 K/V and their scales
            ks, vs = cache[i][2:]
            kc[bidx, at], ks[bidx, at] = _quantize_kv(k[:, 0])
            vc[bidx, at], vs[bidx, at] = _quantize_kv(v[:, 0])
            with scope("fusedkernel_decode_attention_dequant"):
                kc, vc = _dequantize(kc, ks, q.dtype), _dequantize(vc, vs, q.dtype)
        else:
            kc[bidx, at] = k[:, 0]
            vc[bidx, at] = v[:, 0]
        o = attn.decode_attention(q, kc, vc, n)
        x, _ = _apply_ffn(p, x + attn.out_project(p["attn"], o), cfg, moe)
    hidden = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    logits = unembed(hidden, params["embed"], params.get("head"))
    return logits, hidden


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------


def _train_layer(p, x, cfg: ModelConfig, kind: str, angles, moe: MoeKnobs):
    """One layer of the training forward (``p`` is ``params["shared"]`` for
    a ``shared_attn`` layer). Returns (x, the router's aux loss or None)."""
    if kind == "ssm":
        return x + ssm_mod.ssm_apply_train(p["ssm"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                           cfg), None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(p["attn"], h, cfg, angles)
    o = attn.blocked_attention(q, k, v, window=_window(cfg, kind))
    return _apply_ffn(p, x + attn.out_project(p["attn"], o), cfg, moe)


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for an encoder-decoder, which the token-only trainer cannot
    train: its loss needs the encoder's input (``Model.loss`` takes it as
    ``batch["enc_embeds"]``)."""
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: an encoder-decoder trains on batches with "
                         f"enc_embeds (Model.loss); the token pipeline has none")


def train_forward(params: Dict[str, Any], cfg: ModelConfig,
                  tokens: Optional[torch.Tensor] = None, remat: bool = False,
                  moe: MoeKnobs = MoeKnobs(), embeds: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None):
    """Full-sequence causal pass for training, differentiable by autograd,
    over tokens or ``embeds`` at ``positions`` (as :func:`forward`).
    Returns (logits (B, S, V) fp32, hidden (B, S, d), the layers' summed
    router loss (fp32; 0 without MoE layers)). With ``remat`` each layer
    keeps only its input and is recomputed in the backward pass."""
    check_trainable(cfg)
    kinds = layer_kinds(cfg)
    x, positions = _inputs(params, cfg, tokens, embeds, positions)
    angles = _angles(cfg, kinds, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared")
    for kind, lp in zip(kinds, params["layers"]):
        p = shared if kind == "shared_attn" else lp
        args = (p, x, cfg, kind, angles(kind), moe)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(_train_layer, *args,
                                                       use_reentrant=False)
        else:
            x, aux = _train_layer(*args)
        if aux is not None:
            aux_total = aux_total + aux
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(hidden, params["embed"], params.get("head")), hidden, aux_total


def lm_loss(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None, remat: bool = False,
            moe: MoeKnobs = MoeKnobs(), embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None):
    """Next-token cross-entropy of ``tokens`` (the targets, also the input
    unless ``embeds`` is given), the mean over ``loss_mask[:, 1:]`` where a
    mask is given, plus ``router_aux_coef`` times the MoE layers' router
    loss. Returns (that total, {"loss": the cross-entropy, "aux": the router
    loss}), as the reference's ``lm_loss`` (``transformer.py:506-520``)."""
    logits, _, aux = train_forward(params, cfg, tokens, remat=remat,
                                   moe=moe, embeds=embeds,
                                   positions=positions)
    targets = tokens[:, 1:].to(torch.long)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if loss_mask is not None:
        m = loss_mask[:, 1:].to(torch.float32)
        loss = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss + cfg.router_aux_coef * aux, {"loss": loss, "aux": aux}
