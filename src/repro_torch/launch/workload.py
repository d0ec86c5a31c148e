"""Workload construction for the dry-run: the port of
``repro/launch/workload.py``. Per-(arch x shape) config overrides,
shape-only input stand-ins with their logical axes, the PartitionSpecs of
every argument, and the three step functions (train / prefill+predict /
decode+predict).

The ProD head is part of the serving steps: prefill returns (last-token
logits, cache, length distribution, median prediction), the paper's "reuse
the served LLM's hidden states" integration; decode re-predicts from each
new hidden state. Stand-ins are fake CPU tensors (``common/pytree.py``), so
nothing of a full-size model is allocated; the steps call the port's
``Model`` and ``kernels.ops.prod_head``, which take their plain versions on
such tensors. The prefill passes no ``attn_valid`` (the reference's prefill
spec has none, and ``models/attention.py::prefix_lengths`` reads the mask's
data, which a shape-only trace cannot).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.common.config import InputShape, ModelConfig, TrainConfig
from repro_torch.common.device import torch_dtype
from repro_torch.common.pytree import fake_mode, fake_tensor, tree_flatten
from repro_torch.common.sharding import default_rules, is_axes, tree_shardings
from repro_torch.kernels import ops
from repro_torch.models.model_zoo import build_model, last_token_hidden
from repro_torch.training.optim import leaf_groups, make_optimizer
from repro_torch.training.trainer import TrainState, make_train_step, param_groups


# ---------------------------------------------------------------------------
# per-shape config adaptation
# ---------------------------------------------------------------------------


def cfg_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """long_500k requires sub-quadratic attention / sub-linear KV memory.

    * ssm / hybrid / gemma3 run their native mechanism (gemma3's 10 global
      layers keep the full 500k cache, context-parallel over the data axis);
    * all other attention archs run the sliding-window decode variant
      (8192-token KV ring): full-attention 500k is NOT claimed.
    """
    if shape.name == "long_500k":
        if cfg.family == "ssm" or cfg.attn_window or cfg.local_global_ratio:
            return cfg
        return cfg.with_overrides(attn_window=8192)
    return cfg


def tpu_shardable_cfg(cfg: ModelConfig, model_axis: int) -> ModelConfig:
    """Pad head counts to make attention/SSD shardable over the ``model``
    mesh axis, on any device (the name is the reference's).

    With a fixed tensor axis, head counts not divisible by it leave the whole
    attention (or SSD) replicated across the axis. The fix (MaxText-style)
    is to pad:

    * GQA: pad q-heads-per-group so kv_heads x G' is divisible (yi: G 7->8);
    * MHA: pad whole (q,k,v) head triplets (whisper 20->32, minicpm 36->48);
    * SSD: pad state heads (mamba2 24->32).

    head_dim is preserved (the ``nopad`` variant measures not doing it).
    """
    kw = {}
    if cfg.family != "ssm" and cfg.n_heads % model_axis:
        KV, G = cfg.n_kv_heads, cfg.q_per_kv
        if KV % model_axis == 0 or (G > 1 and KV < model_axis):
            # pad G until KV*G divisible by axis (keeps kv cache size)
            Gp = G
            while (KV * Gp) % model_axis:
                Gp += 1
            kw.update(n_heads=KV * Gp)
        else:
            # MHA-style: pad whole head triplets
            Hp = cfg.n_heads
            while Hp % model_axis:
                Hp += 1
            kw.update(n_heads=Hp, n_kv_heads=Hp if KV == cfg.n_heads else KV)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_n_heads % model_axis:
        Hs = cfg.ssm_n_heads
        while Hs % model_axis:
            Hs += 1
        kw.update(ssm_heads=Hs)
    return cfg.with_overrides(**kw) if kw else cfg


def train_cfg_for(cfg: ModelConfig) -> TrainConfig:
    """Arch-appropriate training setup for the dry-run train_step."""
    opt = "adafactor" if cfg.param_count() > 1e11 else "adamw"
    sched = "wsd" if cfg.name.startswith("minicpm") else "cosine"
    return TrainConfig(optimizer=opt, schedule=sched, stable_steps=1000, remat="full")


# ---------------------------------------------------------------------------
# input stand-ins (fake tensors; zero allocation)
# ---------------------------------------------------------------------------


_DTYPES = {"int32": torch.int32, "float32": torch.float32}


def _sds(shape, dtype: str) -> torch.Tensor:
    return fake_tensor(shape, _DTYPES.get(dtype) or torch_dtype(dtype))


def input_specs(cfg: ModelConfig, shape: InputShape) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (stand-ins, logical_axes) for the model-input batch."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}

    def add(name, shp, dt, ax):
        specs[name] = _sds(shp, dt)
        axes[name] = ax

    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            add("embeds", (B, S, cfg.d_model), cfg.dtype, ("batch", "seq", "act_embed"))
            add("positions", (3, B, S), "int32", (None, "batch", "seq"))
            if shape.kind == "train":
                # next-token targets (text stream) alongside the embeddings
                add("tokens", (B, S), "int32", ("batch", "seq"))
        else:
            add("tokens", (B, S), "int32", ("batch", "seq"))
        if cfg.family == "encdec":
            add("enc_embeds", (B, cfg.encoder_seq, cfg.d_model), cfg.dtype,
                ("batch", "seq", "act_embed"))
        if shape.kind == "train":
            add("loss_mask", (B, S), "int32", ("batch", "seq"))
        else:
            add("lengths", (B,), "int32", ("batch",))
    else:  # decode
        add("tokens", (B,), "int32", ("batch",))
        add("pos", (B,), "int32", ("batch",))
        add("lengths", (B,), "int32", ("batch",))
    return specs, axes


def head_specs(cfg: ModelConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    d, h, K = cfg.d_model, cfg.predictor_hidden, cfg.predictor_bins
    specs = {
        "w1": _sds((d, h), "float32"), "b1": _sds((h,), "float32"),
        "w2": _sds((h, K), "float32"), "b2": _sds((K,), "float32"),
        "edges": _sds((K + 1,), "float32"),
    }
    axes = {
        "w1": ("embed", "pred_hidden"), "b1": ("pred_hidden",),
        "w2": ("pred_hidden", "bins"), "b2": ("bins",), "edges": (None,),
    }
    return specs, axes


def _axes_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, tuple]]:
    """(path, axes) pairs of an axes tree, in ``pytree.tree_items`` order."""
    if is_axes(tree):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _axes_items(tree[k], f"{prefix}{k}/")
    else:
        for i, v in enumerate(tree):
            yield from _axes_items(v, f"{prefix}{i}/")


def opt_state_axes(params_axes: Any, optimizer: str, cfg: ModelConfig = None) -> Any:
    """Optimizer-state logical axes in the port optimizer's layout, like the
    params but with the weight d_model dim remapped to ``opt_embed`` (ZeRO
    over the data axes; moments are only touched elementwise). AdamW keeps
    ``{"m", "v"}`` keyed by parameter path; Adafactor keys each of the
    reference's leaves by its first tensor's path (``cfg``'s layer groups,
    ``training/trainer.py::param_groups``), the stacked ones with the
    reference's leading ``layers`` axis, and factors it over the last two."""
    zero = lambda ax: tuple("opt_embed" if a == "embed" else a for a in ax)
    flat = dict(_axes_items(params_axes))
    if optimizer == "adamw":
        remapped = {k: zero(ax) for k, ax in flat.items()}
        return {"m": remapped, "v": dict(remapped)}
    groups = leaf_groups(flat, None if cfg is None else param_groups(cfg, flat))
    out = {}
    for g in groups:
        ax = (("layers",) if g.stacked else ()) + zero(flat[g.names[0]])
        out[g.names[0]] = {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]} if len(ax) >= 2 else {"v": ax}
    return out


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


# The reference's variants but those that set ``causal_skip`` or
# ``seq_shard``, which the port does not read (``models/model_zoo.py``):
# ``causal_skip`` and ``seqpar``, and ``train_opt`` and ``train_tight``,
# which are ``moe_tight`` plus those two.
VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    "moe_tight": {"moe_cap_slack": 1.0},
    "moe_partial": {"moe_fsdp_mode": "partial"},
    "int8kv": {"kv_quant": True},
    "nopad": {"pad_heads": False},
    # a composite used by the hillclimbs
    "decode_opt": {"kv_quant": True, "moe_fsdp_mode": "partial"},
}


def build_steps(cfg: ModelConfig, shape: InputShape, mesh=None, pad_heads: bool = True,
                variant: str = "baseline") -> Dict[str, Any]:
    """Everything the dry-run needs for one (arch, shape) pair: a dict with
    ``step`` (a function of the arguments), ``arg_specs`` (tuple of trees of
    stand-ins), ``arg_axes`` (their logical axes), ``arg_pspecs`` (their
    PartitionSpecs on ``mesh``, None without one), ``model``, ``cfg`` (and
    ``tcfg`` for a train shape)."""
    knobs = dict(VARIANTS[variant])
    if not knobs.pop("pad_heads", True):
        pad_heads = False
    kv_quant = knobs.pop("kv_quant", False)
    cfg = cfg_for_shape(cfg, shape)
    if mesh is not None and pad_heads and "model" in mesh.axis_names:
        cfg = tpu_shardable_cfg(cfg, int(mesh.shape["model"]))
    model = build_model(cfg, mesh=mesh, **knobs)
    rules = None
    if mesh is not None:
        rules = default_rules(mesh)
        if shape.kind == "decode":
            # KV-cache layout: shard kv-heads over `model` when divisible;
            # otherwise context-parallel, the cache sequence over `model`.
            # long_500k (batch=1) also spreads the sequence over data.
            kv_ok = cfg.n_kv_heads % int(mesh.shape.get("model", 1)) == 0
            long_ctx = shape.name == "long_500k"
            if kv_ok:
                rules["cache_seq"] = ("data",) if long_ctx else None
            else:
                rules["cache_seq"] = ("data", "model") if long_ctx else ("model",)

    def shard(axes_tree, shape_tree):
        return None if mesh is None else tree_shardings(axes_tree, shape_tree, mesh, rules)

    p_shapes, p_axes = model.param_shapes(), model.param_axes()
    b_specs, b_axes = input_specs(cfg, shape)

    if shape.kind == "train":
        tcfg = train_cfg_for(cfg)
        flat = tree_flatten(p_shapes)
        for p in flat.values():
            p.requires_grad_(True)
        with fake_mode():
            o_shapes = make_optimizer(tcfg, param_groups(cfg, flat)).init(flat)
        o_axes = opt_state_axes(p_axes, tcfg.optimizer, cfg)
        state_specs = {"params": p_shapes, "opt_state": o_shapes,
                       "step": _sds((), "float32")}
        state_axes = {"params": p_axes, "opt_state": o_axes, "step": ()}
        step_fn = make_train_step(model, tcfg)

        def train_step(state, batch):
            st, metrics = step_fn(TrainState(state["params"], state["opt_state"], 0), batch)
            return {"params": st.params, "opt_state": st.opt_state}, metrics

        axes, specs = (state_axes, b_axes), (state_specs, b_specs)
        return dict(step=train_step, arg_specs=specs, arg_axes=axes,
                    arg_pspecs=None if mesh is None else tuple(map(shard, axes, specs)),
                    model=model, cfg=cfg, tcfg=tcfg)

    h_specs, h_axes = head_specs(cfg)

    if shape.kind == "prefill":

        def prefill_step(params, head, batch):
            _, hidden, cache = model.prefill(
                params, batch.get("tokens"), logits_mode="none",
                enc_embeds=batch.get("enc_embeds"), embeds=batch.get("embeds"),
                positions=batch.get("positions"))
            phi = last_token_hidden(hidden, batch["lengths"])
            last_logits = model.unembed(params, phi)
            probs, pred = ops.prod_head(phi, head["w1"], head["b1"], head["w2"], head["b2"],
                                        head["edges"])
            return last_logits, cache, probs, pred

        axes = (p_axes, h_axes, b_axes)
        specs = (p_shapes, h_specs, b_specs)
        return dict(step=prefill_step, arg_specs=specs, arg_axes=axes,
                    arg_pspecs=None if mesh is None else tuple(map(shard, axes, specs)),
                    model=model, cfg=cfg)

    # decode: one token vs. a cache of shape.seq_len
    c_shapes = model.cache_shapes(shape.global_batch, shape.seq_len, kv_quant=kv_quant)
    c_axes = model.cache_axes(kv_quant=kv_quant)

    def decode_step(params, head, batch, cache):
        logits, hidden = model.decode_step(params, batch["tokens"], cache, batch["pos"],
                                           batch["lengths"])
        probs, pred = ops.prod_head(hidden, head["w1"], head["b1"], head["w2"], head["b2"],
                                    head["edges"])
        return logits, cache, pred

    axes = (p_axes, h_axes, b_axes, c_axes)
    specs = (p_shapes, h_specs, b_specs, c_shapes)
    return dict(step=decode_step, arg_specs=specs, arg_axes=axes,
                arg_pspecs=None if mesh is None else tuple(map(shard, axes, specs)),
                model=model, cfg=cfg)
