"""Mixture-of-Experts FFN with capacity-based dispatch: the single-device path
of ``repro/models/moe.py`` (its ``mesh=None`` branch, ``:132-158`` and the
shared expert ``:249-251``).

* **Router** (``_router``): fp32 softmax over the experts, top-k, combine
  weights renormalised over the k, and the Switch load-balance loss.
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

The expert-parallel ``shard_map`` path (``:159-247``, both ``fsdp_mode``s)
runs only across devices and is not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import ParamSpec, mlp_apply, mlp_spec


def moe_spec(cfg: ModelConfig) -> Dict[str, object]:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    s: Dict[str, object] = {
        "router": ParamSpec((d, E), scale=0.02),
        "w_gate": ParamSpec((E, d, f)),
        "w_up": ParamSpec((E, d, f)),
        "w_down": ParamSpec((E, f, d)),
    }
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
    a dropped pair reads a zero row last)."""
    E, cap, d = ye.shape
    rows = (ye * weight[..., None].to(ye.dtype)).reshape(E * cap, d)
    rows = torch.cat([rows, rows.new_zeros(1, d)])
    slot = torch.sort(slot, dim=1).values
    out = torch.zeros((slot.shape[0], d), dtype=ye.dtype, device=ye.device)
    for j in range(slot.shape[1]):
        out = out + rows[slot[:, j]]
    return out


def _expert_ffn_local(
    x: torch.Tensor,            # (T, d)
    local_ids: torch.Tensor,    # (T, k) in [0, E_local]; E_local == "not mine"
    combine_w: torch.Tensor,    # (T, k)
    w_gate: torch.Tensor,       # (E_local, d, f)
    w_up: torch.Tensor,
    w_down: torch.Tensor,       # (E_local, f, d)
    capacity: int,
) -> torch.Tensor:
    """Capacity-dispatch expert computation. Returns (T, d)."""
    E_local = w_gate.shape[0]
    gather_tok, valid, weight, slot = _dispatch(local_ids, combine_w, E_local, capacity)
    xe = x[gather_tok.reshape(-1)].view(E_local, capacity, x.shape[1])
    xe = torch.where(valid[..., None], xe, torch.zeros((), dtype=x.dtype, device=x.device))
    ye = _expert_mats(xe, w_gate, w_up, w_down)
    return _combine(ye, weight, slot)


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN on x (B, S, d). Returns (out (B, S, d), aux_loss fp32 scalar).
    ``capacity_factor`` 0 means no drop (the capacity of E experts' worth)."""
    B, S, d = x.shape
    T = B * S
    k, E = cfg.n_experts_per_token, cfg.n_experts
    xf = x.reshape(T, d)
    logits32 = xf.to(torch.float32) @ p["router"].to(torch.float32)
    top_ids, combine, aux = _router(logits32, k)
    cf = capacity_factor if capacity_factor else float(E)
    cap = _capacity(T, k, E, cf)
    out = _expert_ffn_local(xf, top_ids, combine, p["w_gate"], p["w_up"], p["w_down"],
                            cap).reshape(B, S, d)
    if cfg.n_shared_experts and "shared" in p:
        out = out + mlp_apply(p["shared"], x, "silu")
    return out, aux.to(torch.float32)
