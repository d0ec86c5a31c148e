"""Model facade: ``build_model(cfg)`` returns a :class:`Model` whose methods
are plain functions of (params, batch).

The port has no ``Runtime``: its knobs are fields of :class:`Model` or
arguments. The MoE ``capacity_factor`` (default 1.25, 0 = no drop, as the
reference's), the ``mesh`` (``launch/mesh.py``) and the expert-parallel
``moe_cap_slack`` (2.0) and ``moe_fsdp_mode`` ("gather" | "partial") reach
every MoE layer of ``loss``, ``prefill`` and ``decode_step``, as the
reference's ``Runtime`` threads them (``models/moe.py``); ``remat`` is an
argument of :meth:`Model.loss` and ``kv_quant`` of :meth:`Model.init_cache`.
Two of the reference's knobs are read by nothing:

* ``causal_skip`` (and the block sizes): the kernels choose their own tiles
  and always skip fully masked ones;
* ``seq_shard``: a GSPMD layout hint (``with_sharding_constraint``) with no
  numeric effect, and the port has no automatic partitioner to take it.

``param_shapes`` / ``cache_shapes`` give shape-only stand-ins (fake tensors,
``common/pytree.py``) and ``param_axes`` / ``cache_axes`` the logical axes of
each leaf (``common/sharding.py`` resolves them on a mesh).
The ProD predictor head consumes ``hidden`` from prefill: the served model's
last-layer hidden state of the last prompt token (paper §2.4).

An encoder-decoder (``family="encdec"``, Whisper) dispatches to
``models/encdec.py``: ``prefill`` takes its encoder input as
``enc_embeds``, and ``loss`` as ``batch["enc_embeds"]``; its cache is a
per-decoder-layer list of {"k", "v", "ck", "cv"}. A VLM's prefill and
loss take ``embeds`` and (3, B, S) ``positions`` in place of tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.common import scopes
from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.common.pytree import fake_tensor, tree_bytes, tree_map
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import axes_tree, init_tree, unembed
from repro_torch.models.moe import MoeKnobs


def last_token_hidden(hidden: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """φ(x): last-layer hidden state of the last (non-pad) prompt token."""
    idx = torch.clamp(lengths.to(torch.long) - 1, 0, hidden.shape[1] - 1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    capacity_factor: float = 1.25
    mesh: Any = None
    moe_cap_slack: float = 2.0
    moe_fsdp_mode: str = "gather"

    @property
    def moe(self) -> MoeKnobs:
        return MoeKnobs(self.capacity_factor, self.mesh, self.moe_cap_slack,
                        self.moe_fsdp_mode)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def spec(self):
        if self.is_encdec:
            return encdec.whisper_spec(self.cfg)
        return transformer.model_spec(self.cfg)

    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
        """Seeded random weights in the config's dtype, made on ``device``."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        return init_tree(self.spec(), g, self.dtype, dev)

    def param_shapes(self, dtype: Optional[torch.dtype] = None):
        """The parameters as shape-only stand-ins, in ``dtype`` (the
        config's by default)."""
        dt = dtype or self.dtype
        return tree_map(lambda s: fake_tensor(s.shape, dt), self.spec())

    def param_axes(self):
        return axes_tree(self.spec())

    def loss(self, params, batch: Dict[str, torch.Tensor], remat: str = "none"):
        """Training objective: next-token CE over ``batch["tokens"]``, masked
        by ``batch["loss_mask"]`` if present, plus the MoE router loss (an
        encoder-decoder: given ``batch["enc_embeds"]``; a VLM: over
        ``batch["embeds"]`` at ``batch["positions"]`` where given).
        ``remat="full"`` recomputes each layer in the backward pass. Returns
        (loss, {"loss": the CE, "aux": the router loss}; an encoder-decoder
        has no "aux")."""
        if self.is_encdec:
            return encdec.whisper_loss(params, self.cfg, batch["tokens"], batch["enc_embeds"],
                                       loss_mask=batch.get("loss_mask"))
        return transformer.lm_loss(params, self.cfg, batch["tokens"],
                                   loss_mask=batch.get("loss_mask"),
                                   remat=remat == "full", moe=self.moe,
                                   embeds=batch.get("embeds"),
                                   positions=batch.get("positions"))

    def prefill(self, params, tokens: Optional[torch.Tensor] = None,
                attn_valid: Optional[torch.Tensor] = None, logits_mode: str = "all",
                enc_embeds: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None):
        """Returns (logits, hidden (B, S, d), the per-layer cache: (k, v) for
        attention layers, {"h", "conv"} for SSM layers; an encoder-decoder's
        {"k", "v", "ck", "cv"}). An encoder-decoder encodes ``enc_embeds``
        (B, encoder_seq, d) and decodes ``tokens``; a VLM may take
        ``embeds`` and ``positions`` in place of tokens."""
        with scopes.span("model.prefill"):
            if self.is_encdec:
                enc_out = encdec.encode(params, self.cfg, enc_embeds)
                return encdec.decoder_forward(params, self.cfg, tokens, enc_out,
                                              attn_valid=attn_valid, logits_mode=logits_mode)
            return transformer.forward(params, self.cfg, tokens, attn_valid=attn_valid,
                                       logits_mode=logits_mode, moe=self.moe,
                                       embeds=embeds, positions=positions)

    def decode_step(self, params, tokens, cache, pos, lengths, embeds=None):
        """tokens, pos (B,), lengths (B,) int32 (or a VLM's ``embeds`` (B, d)
        for the tokens). Returns (logits, hidden), writes the new K/V into
        ``cache`` and replaces its SSM states."""
        with scopes.span("model.decode_step"):
            if self.is_encdec:
                return encdec.decoder_decode_step(params, self.cfg, tokens, cache, pos, lengths)
            return transformer.decode_step(params, self.cfg, tokens, cache, pos, lengths,
                                           moe=self.moe, embeds=embeds)

    def unembed(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return unembed(hidden, params["embed"], params.get("head"))

    def init_cache(self, batch: int, cache_len: int, device: DeviceLike = None,
                   kv_quant: bool = False):
        """Zeroed decode cache; ``kv_quant`` makes each attention layer's K/V
        int8 with fp32 scales (the reference's int8 KV cache). An
        encoder-decoder's cache is the same either way, as the reference's."""
        return self._cache(batch, cache_len, resolve_device(device), kv_quant)

    def cache_bytes(self, batch: int, cache_len: int, kv_quant: bool = False) -> int:
        """Bytes of :meth:`init_cache`'s cache, counted without allocating it
        (the sizes of the reference's ``cache_shapes``)."""
        cache = self._cache(batch, cache_len, torch.device("meta"), kv_quant)
        return tree_bytes(cache)

    def cache_specs(self, batch: int, cache_len: int, kv_quant: bool = False):
        """The cache's ParamSpecs (shapes and logical axes), in its structure."""
        if self.is_encdec:
            return encdec.cache_spec(self.cfg, batch, cache_len)
        return transformer.cache_spec(self.cfg, batch, cache_len, kv_quant=kv_quant)

    def cache_shapes(self, batch: int, cache_len: int, kv_quant: bool = False):
        """:meth:`init_cache`'s cache as shape-only stand-ins."""
        return tree_map(lambda s: fake_tensor(s.shape, transformer.cache_dtype(s, self.dtype)),
                        self.cache_specs(batch, cache_len, kv_quant))

    def cache_axes(self, kv_quant: bool = False):
        return axes_tree(self.cache_specs(1, 2, kv_quant))

    def _cache(self, batch: int, cache_len: int, device: torch.device, kv_quant: bool):
        if self.is_encdec:
            return encdec.init_cache(self.cfg, batch, cache_len, self.dtype, device)
        return transformer.init_cache(self.cfg, batch, cache_len, self.dtype, device,
                                      kv_quant=kv_quant)

    def decode_cache(self, prefill_cache, cache_len: int):
        """The cache ``prefill`` returned, made a decode cache of
        ``cache_len`` positions: full K/V grown to it, a windowed layer's
        K/V a ring of its window once ``cache_len`` outgrows it, an
        encoder-decoder's cross K/V kept as they are."""
        if self.is_encdec:
            return encdec.decode_cache(prefill_cache, cache_len)
        return transformer.decode_cache(self.cfg, prefill_cache, cache_len)


def build_model(cfg: ModelConfig, capacity_factor: float = 1.25, **knobs) -> Model:
    """``knobs``: ``mesh``, ``moe_cap_slack``, ``moe_fsdp_mode``."""
    transformer.check_supported(cfg)
    return Model(cfg=cfg, capacity_factor=capacity_factor, **knobs)
