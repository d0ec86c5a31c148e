"""Mixture-of-Experts FFN with capacity-based dispatch: the single-device path
of ``repro/models/moe.py`` (its ``mesh=None`` branch, ``:132-158`` and the
shared expert ``:249-251``).

* **Router** (``_router``): fp32 softmax over the experts, top-k, combine
  weights renormalised over the k, and the Switch load-balance loss.
* **Sigmoid router** (``_router_sigmoid``, ``router_scoring="sigmoid"``):
  DeepSeek-V3's and Kimi-K2's ``noaux_tc`` with one expert group: fp32
  sigmoid scores, the top-k of score + a correction bias (the leaf
  ``bias``), combine weights the unbiased scores normalised over the k and
  times ``routed_scale``.
* **The experts held** (``experts_held`` from ``expert_offset``): a device
  holds a block of the router's ``n_experts`` (the model-configs guide's
  chip share of expert parallelism). It routes over all of them, maps the
  pairs to other experts to the overflow bucket as the expert-parallel
  branch does (``_held_ids``), and computes its experts' part at the
  capacity of all ``n_experts``; on one device there is no exchange.
* **Capacity dispatch** (``_dispatch``): the (token, j) pairs are sorted by
  expert id (a *stable* sort, as ``jnp.argsort``, so an expert's slots fill
  in flat (token, j) order and the same pairs overflow as in the reference)
  into a static ``(E, cap, d)`` buffer; pairs past an expert's ``cap``
  slots are dropped. Every position of the (B, S) batch routes, right
  padding included (T = B·S): a pad can take a slot before a later row's
  real token, as in the reference.
* **Experts** (``_expert_mats``): batched ``(E, cap, d) x (E, d, f)``
  products, as the reference's einsums (no Pallas kernel there).
* **Combine** (``_combine``): the reference scatter-adds the weighted expert
  rows into (T + 1, d) in the model dtype, in flat (expert, slot) order.
  Here each (token, j) pair knows its slot, and a token's k rows are summed
  in that same expert order, one row at a time in the model dtype: no
  atomics, so two calls agree bit for bit on the card.

**Expert parallelism** (``:152-247``): with a mesh whose ``model`` axis
has more than one device and divides E, each rank holds ``E / model`` experts
(d-sharded over the data axes, the FSDP of ``embed_fsdp``) and its block of
the tokens (sharded over ``pod``/``data`` where they divide, else
replicated). The router and the aux loss stay replicated. :func:`moe_apply`
keeps the reference's caller contract, global ``x`` and params in and
global out: it takes this rank's blocks by the reference's in_specs
(``common/sharding.py::shard_tensor``), runs :func:`shard_fn` (FSDP mode
"gather": all-gather the expert weights over the data axes, dispatch
locally, psum over ``model``) or :func:`shard_fn_partial` (mode
"partial": gather the tokens instead, d-sliced partial products summed
over the data axes), and all-gathers the output over the token axes (the
out_specs). The capacity is per shard-local tokens with the global E, times
``cap_slack``. Collectives are ``launch/mesh.py::Mesh``'s; the whole branch
runs under the ``expert_parallel`` scope (``common/scopes.py``), so the
dry-run's analyzer counts it per rank.

Under a mesh :func:`moe_apply` is a function of the global tensors, as the
reference's ``shard_map`` is, and so is its gradient: the region's entry
and exit (``Mesh.shard_in`` / ``shard_out``) transpose as that
``shard_map`` does, so every rank gets the whole gradient of ``x`` (and,
through the combine weights, of the router) and, of each expert weight,
the block it holds by ``wspec_up`` / ``wspec_dn``, zero elsewhere: summed
over the ranks, the global gradient.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common import scopes
from repro_torch.common.config import ModelConfig
from repro_torch.common.scopes import scoped_kernel_vjp
from repro_torch.common.sharding import P, shard_index, shard_tensor
from repro_torch.models.layers import ParamSpec, mlp_apply, mlp_spec


@dataclass(frozen=True)
class MoeKnobs:
    """What a model call threads to each MoE layer: the reference's
    ``Runtime`` fields ``capacity_factor``, ``mesh``, ``moe_cap_slack`` and
    ``moe_fsdp_mode``."""

    capacity_factor: float = 1.25
    mesh: Any = None
    cap_slack: float = 2.0
    fsdp_mode: str = "gather"


def moe_spec(cfg: ModelConfig) -> Dict[str, object]:
    """The router over all ``n_experts`` (and, with sigmoid scoring, its
    correction bias), the weights of the experts held (``held_experts``) and
    any shared expert."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    Eh = cfg.held_experts
    s: Dict[str, object] = {
        "router": ParamSpec((d, E), ("embed", "experts"), scale=0.02),
        # expert weights: expert-sharded over `model` and d-sharded over the
        # data axes (FSDP), gathered or partial-summed in the EP branch
        "w_gate": ParamSpec((Eh, d, f), ("experts", "embed_fsdp", "expert_ffn")),
        "w_up": ParamSpec((Eh, d, f), ("experts", "embed_fsdp", "expert_ffn")),
        "w_down": ParamSpec((Eh, f, d), ("experts", "expert_ffn", "embed_fsdp")),
    }
    if cfg.router_scoring == "sigmoid":
        s["bias"] = ParamSpec((E,), ("experts",), init="zeros")
    if cfg.n_shared_experts:
        s["shared"] = mlp_spec(d, cfg.moe_d_ff * cfg.n_shared_experts, "silu")
    return s


def _router(logits32: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. Returns (expert_ids (T, k), combine_w (T, k), aux_loss)."""
    T, E = logits32.shape
    probs = torch.softmax(logits32, dim=-1)
    top_p, top_ids = torch.topk(probs, k, dim=-1)
    combine = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: the expected assignments per token of
    # each expert (counts are exact in fp32) against its mean probability
    frac_tokens = _counts(top_ids.reshape(-1), E).to(torch.float32) / T
    mean_prob = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens / k * mean_prob)
    return top_ids, combine, aux


def _router_sigmoid(logits32: torch.Tensor, bias: torch.Tensor, k: int, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's ``noaux_tc`` routing (one expert group): scores s =
    sigmoid(logits), the top-k of s + bias chosen, their unbiased s
    normalised over the k and times ``scale``. Returns (expert_ids (T, k),
    combine_w (T, k), aux_loss): the aux term is the Switch loss of
    :func:`_router` on the sigmoid scores, which serving does not read (the
    published model trains its bias instead of a loss)."""
    T, E = logits32.shape
    s = torch.sigmoid(logits32)
    top_ids = torch.topk(s + bias.to(torch.float32), k, dim=-1).indices
    top_s = torch.gather(s, 1, top_ids)
    combine = top_s / torch.clamp(top_s.sum(dim=-1, keepdim=True), min=1e-20) * scale
    frac_tokens = _counts(top_ids.reshape(-1), E).to(torch.float32) / T
    aux = E * torch.sum(frac_tokens / k * s.mean(dim=0))
    return top_ids, combine, aux


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How many of ``ids`` equal each of 0 .. n-1 (int64). A scatter-add of
    integers: exact in any order, and no host sync (``torch.bincount`` on
    the card reads the largest id back first)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _capacity(T: int, k: int, E_local: int, factor: float) -> int:
    cap = int(T * k * factor / max(E_local, 1)) + 1
    return max(8, min(cap, T * k))


def _dispatch(local_ids: torch.Tensor, combine_w: torch.Tensor, E_local: int,
              capacity: int):
    """Sort-based capacity dispatch bookkeeping (no data movement).

    Returns the reference's (gather_tok (E_local, cap) token index per
    expert slot, valid (E_local, cap), weight (E_local, cap)) and ``slot``
    (T, k): the flat slot ``e * cap + c`` each (token, j) pair fills, or
    ``E_local * cap`` where it is dropped (over capacity, or an id of
    ``E_local``, "not mine")."""
    T, k = local_ids.shape
    Tk = T * k
    flat_ids = local_ids.reshape(Tk)
    order = torch.argsort(flat_ids, stable=True)       # overflow ids last
    tok_of_sorted = order // k                          # token index per sorted row
    w_sorted = combine_w.reshape(Tk)[order]
    counts = _counts(flat_ids, E_local + 1)[:E_local]
    offsets = torch.cumsum(counts, 0) - counts          # (E_local,)
    c = torch.arange(capacity, device=local_ids.device)
    valid = c[None, :] < counts[:, None]
    idx_c = torch.where(valid, offsets[:, None] + c[None, :], Tk - 1)
    weight = w_sorted[idx_c] * valid
    # each pair's rank among its expert's pairs: its sorted position less
    # the expert's offset
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(Tk, device=order.device))
    mine = flat_ids < E_local
    e = torch.where(mine, flat_ids, 0)
    rank = pos - offsets[e]
    slot = torch.where(mine & (rank < capacity), e * capacity + rank, E_local * capacity)
    return tok_of_sorted[idx_c], valid, weight, slot.reshape(T, k)


def _expert_mats(xe, w_gate, w_up, w_down):
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def _combine(ye: torch.Tensor, weight: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """(E, cap, d) expert rows -> (T, d): each row weighted in the model
    dtype, then a token's rows summed in expert order (its slots ascending;
    a dropped pair reads a zero row last).

    The E * cap slots hold at most E * cap // (j + 1) tokens with a (j+1)-th
    kept pair. Where that is fewer than T (a device that holds a block of
    the experts, whose pairs to the others are dropped here), step j reads
    only that many tokens, those with the most kept pairs first: the rows it
    leaves out are zero rows, so the sums are the same bits."""
    E, cap, d = ye.shape
    T, k = slot.shape
    rows = (ye * weight[..., None].to(ye.dtype)).reshape(E * cap, d)
    rows = torch.cat([rows, rows.new_zeros(1, d)])
    slot = torch.sort(slot, dim=1).values
    out = torch.zeros((T, d), dtype=ye.dtype, device=ye.device)
    if E * cap // k >= T:
        for j in range(k):
            out = out + rows[slot[:, j]]
        return out
    by_kept = torch.argsort((slot < E * cap).sum(dim=1), descending=True, stable=True)
    for j in range(k):
        idx = by_kept[:min(T, E * cap // (j + 1))]
        out.index_copy_(0, idx, out.index_select(0, idx) + rows.index_select(0, slot[idx, j]))
    return out


def _expert_ffn_local(
    x: torch.Tensor,            # (T, d)
    local_ids: torch.Tensor,    # (T, k) in [0, E_local]; E_local == "not mine"
    combine_w: torch.Tensor,    # (T, k)
    w_gate: torch.Tensor,       # (E_local, d, f)
    w_up: torch.Tensor,
    w_down: torch.Tensor,       # (E_local, f, d)
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatch expert computation. Returns (T, d) and ``_dispatch``'s
    ``slot`` (T, k); the dispatch, the expert products and the combine are
    the spans ``moe.dispatch``, ``moe.experts`` and ``moe.combine``."""
    E_local = w_gate.shape[0]
    with scopes.span("moe.dispatch"):
        gather_tok, valid, weight, slot = _dispatch(local_ids, combine_w, E_local, capacity)
    with scopes.span("moe.experts"):
        xe = x[gather_tok.reshape(-1)].view(E_local, capacity, x.shape[1])
        xe = torch.where(valid[..., None], xe, torch.zeros((), dtype=x.dtype, device=x.device))
        ye = _expert_mats(xe, w_gate, w_up, w_down)
        del xe                  # freed before the combine
    with scopes.span("moe.combine"):
        return _combine(ye, weight, slot), slot


def _local_ids(ids: torch.Tensor, mesh, E_local: int) -> torch.Tensor:
    """Global expert ids -> this ``model`` rank's, the others' experts
    mapped to the overflow bucket ``E_local``."""
    return _held_ids(ids, mesh.axis_index("model") * E_local, E_local)


def _held_ids(ids: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Global expert ids -> those of the block of ``n`` experts from ``lo``,
    the others mapped to the overflow bucket ``n``."""
    return torch.where((ids >= lo) & (ids < lo + n), ids - lo, n)


def shard_fn(mesh, fsdp, cap, xf_l, ids_l, cw_l, wg_l, wu_l, wd_l):
    """FSDP mode "gather": all-gather the d-sharded expert weights per layer
    (train-friendly: weight traffic amortized over many tokens)."""
    wg_l = mesh.all_gather(wg_l, 1, fsdp)
    wu_l = mesh.all_gather(wu_l, 1, fsdp)
    wd_l = mesh.all_gather(wd_l, 2, fsdp)
    out_l, _ = _expert_ffn_local(xf_l, _local_ids(ids_l, mesh, wg_l.shape[0]), cw_l,
                                 wg_l, wu_l, wd_l, cap)
    return mesh.all_reduce(out_l, ("model",))


def shard_fn_partial(mesh, fsdp, cap_fn, xf_l, ids_l, cw_l, wg_l, wu_l, wd_l):
    """FSDP mode "partial": the weights stay d-sharded; the tokens are
    gathered over the data axes, the pre-activations partial-summed there.
    No weight traffic; activation traffic ~ O(tokens x f)."""
    E_local = wg_l.shape[0]
    n_fsdp = int(np.prod([mesh.shape[a] for a in fsdp]))
    didx = shard_index(fsdp, mesh)
    T_l, d = xf_l.shape
    x_g = mesh.all_gather(xf_l, 0, fsdp)
    ids_g = mesh.all_gather(ids_l, 0, fsdp)
    cw_g = mesh.all_gather(cw_l, 0, fsdp)
    T_g, d_l = x_g.shape[0], d // n_fsdp
    x_slice = x_g[:, didx * d_l:(didx + 1) * d_l]
    gtok, valid, weight, slot = _dispatch(_local_ids(ids_g, mesh, E_local), cw_g, E_local,
                                          cap_fn(T_g))
    xe = x_slice[gtok.reshape(-1)].view(E_local, -1, d_l)
    xe = torch.where(valid[..., None], xe, torch.zeros((), dtype=xe.dtype, device=xe.device))
    pre_g = mesh.all_reduce(torch.bmm(xe, wg_l), fsdp)
    pre_u = mesh.all_reduce(torch.bmm(xe, wu_l), fsdp)
    ye = torch.bmm(F.silu(pre_g) * pre_u, wd_l)                     # (E_l, cap_g, d_l)
    out_g = _combine(ye, weight, slot)                                # (T_g, d_l)
    out_full = mesh.all_gather(out_g, 1, fsdp)
    out_l = out_full[didx * T_l:(didx + 1) * T_l]
    return mesh.all_reduce(out_l, ("model",))


def _expert_parallel(xf, top_ids, combine, p, cfg: ModelConfig, mesh, cf: float,
                     cap_slack: float, fsdp_mode: str) -> torch.Tensor:
    """The reference's ``shard_map`` branch on this rank. Returns (T, d)."""
    T = xf.shape[0]
    k, E = cfg.n_experts_per_token, cfg.n_experts
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    fsdp = tuple(a for a in data_axes if mesh.shape[a] > 1)
    n_data = int(np.prod([mesh.shape[a] for a in data_axes]))
    if T % max(n_data, 1) == 0 and n_data > 1:
        xspec, tokens_sharded = P(data_axes, None), True
    else:
        xspec, tokens_sharded = P(None, None), False   # decode batch=1: replicated
    # capacity per SHARD-LOCAL tokens, with the global E
    T_loc = T // n_data if tokens_sharded else T
    cap_fn = lambda n: max(8, min(int(_capacity(n, k, E, cf) * cap_slack), n * k))
    wspec_up = P("model", fsdp if fsdp else None, None)
    wspec_dn = P("model", None, fsdp if fsdp else None)

    def region(xf, top_ids, combine, w_gate, w_up, w_down):
        args = [mesh.shard_in(xf, xspec, whole=True), shard_tensor(top_ids, xspec, mesh),
                mesh.shard_in(combine, xspec, whole=True),
                mesh.shard_in(w_gate, wspec_up, whole=False),
                mesh.shard_in(w_up, wspec_up, whole=False),
                mesh.shard_in(w_down, wspec_dn, whole=False)]
        if fsdp_mode == "partial":
            out = shard_fn_partial(mesh, fsdp, cap_fn, *args)
        else:
            out = shard_fn(mesh, fsdp, cap_fn(T_loc), *args)
        return mesh.shard_out(out, xspec)           # out_specs: the global tokens

    return scoped_kernel_vjp("expert_parallel", region)(
        xf, top_ids, combine, p["w_gate"], p["w_up"], p["w_down"])


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, mesh=None,
              capacity_factor: float = 1.25, cap_slack: float = 2.0, fsdp_mode: str = "gather"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN on x (B, S, d). Returns (out (B, S, d), aux_loss fp32 scalar).
    ``capacity_factor`` 0 means no drop (the capacity of E experts' worth).
    A device that holds a block of the experts (``experts_held`` from
    ``expert_offset``) routes over all ``n_experts`` and computes its own
    experts' part of the output (and the shared expert, if any): the
    model-configs guide's chip share, with no exchange.
    ``mesh``, ``cap_slack`` and ``fsdp_mode`` ("gather" | "partial") drive
    the expert-parallel branch, as the reference's. The reference's
    ``batch_spec`` is left out: nothing sets it."""
    B, S, d = x.shape
    T = B * S
    k, E, Eh = cfg.n_experts_per_token, cfg.n_experts, cfg.held_experts
    xf = x.reshape(T, d)
    with scopes.span("moe.router"):
        logits32 = xf.to(torch.float32) @ p["router"].to(torch.float32)
        if cfg.router_scoring == "sigmoid":
            top_ids, combine, aux = _router_sigmoid(logits32, p["bias"], k, cfg.routed_scale)
        else:
            top_ids, combine, aux = _router(logits32, k)
    cf = capacity_factor if capacity_factor else float(E)
    ep = (mesh is not None and "model" in mesh.axis_names and mesh.shape["model"] > 1
          and E % mesh.shape["model"] == 0)
    if ep:
        if Eh != E:
            raise ValueError(f"{cfg.name}: the expert-parallel branch cuts its blocks from "
                             f"all {E} experts; this device holds {Eh}")
        out = _expert_parallel(xf, top_ids, combine, p, cfg, mesh, cf, cap_slack,
                               fsdp_mode).reshape(B, S, d)
    else:
        # the capacity of the router's E experts, as the expert-parallel
        # branch takes the global E for its shard
        cap = _capacity(T, k, E, cf)
        ids = top_ids if Eh == E else _held_ids(top_ids, cfg.expert_offset, Eh)
        out, slot = _expert_ffn_local(xf, ids, combine, p["w_gate"], p["w_up"],
                                      p["w_down"], cap)
        out = out.reshape(B, S, d)
        # the pairs routed to held experts, and (counted when read) those of
        # them past capacity; a pair to another device's expert is neither
        if Eh == E:
            scopes.count("moe.pairs", T * k)
            scopes.count_equal("moe.dropped", slot, E * cap)
        elif scopes.recording():
            held = ids < Eh
            scopes.count_equal("moe.pairs", held, True)
            scopes.count_equal("moe.dropped", torch.where(held, slot, -1), Eh * cap)
    if cfg.n_shared_experts and "shared" in p:
        out = out + mlp_apply(p["shared"], x, "silu")
    return out, aux.to(torch.float32)
