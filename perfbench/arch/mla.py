"""The DeepSeek-V3 decoder as Kimi-K2 publishes it: multi-head latent
attention (MLA), a leading dense layer, then MoE layers with a sigmoid
router (``noaux_tc``), a shared expert and, on this chip, a block of the
routed experts. The architecture module of every configuration whose
``arch`` is ``"mla"``; ``harness/common.py`` says what such a module gives.

A layer is pre-norm, ``x + attention(rms(x))`` then ``x + ffn(rms(x))``.
The attention, with H heads, n = ``qk_nope_head_dim``, r =
``qk_rope_head_dim``, c = ``v_head_dim``, Q = ``q_lora_rank`` and R =
``kv_lora_rank`` (``DeepseekV3Attention`` of the published
``modeling_deepseek.py``)::

    q           = rms(h W_qa) W_qb             (N, H, n + r)
    [lat, k_pe] = h W_kva                      (N, R + r)
    [k_nope, v] = rms(lat) W_kvb               (N, H, n + c)
    score       = (q_nope . k_nope + rope(q_pe) . rope(k_pe)) * scale
    out         = softmax(score) v W_o

scale = (n + r)^-0.5 * mscale^2, mscale = 0.1 * mscale_all_dim * ln(factor)
+ 1 under YaRN; RoPE at YaRN's frequencies (factor, beta_fast, beta_slow,
original context). Here it is computed in the expanded form, every key's
k_nope and v made from its latent. The dense layer is a SiLU-gated MLP of
``intermediate_size``. A MoE layer scores every one of the router's
``n_experts`` by sigmoid(h W_r), takes the top-k of score + bias, weights
them by their scores normalised over the k and times
``routed_scaling_factor``, and computes only the experts held here
(``experts_held`` from ``expert_offset``) behind the port's capacity,
counted over all ``n_experts``; the shared expert, a SiLU-gated MLP of
``moe_intermediate_size`` x ``n_shared_experts``, is added for every token.

Departures from the published model, shared with the port: RoPE is the
half-split rotation (the checkpoint's interleaved layout is a permutation
of W_qb's and W_kva's rope columns, which seeded weights make moot); every
RMSNorm is applied as (1 + scale); the cos/sin magnitude (mscale over
mscale_all_dim) is 1, as it is for Kimi-K2; the routed experts of other
chips add nothing (the chip's share, model-configs section 4).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from harness import common
from harness import flops as shared
from harness.model import Leaf

decoder = common.arch("decoder")
F32 = torch.float32

# published keys that must hold the value this module computes
REQUIRED = {"scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
            "topk_group": 1, "norm_topk_prob": True, "moe_layer_freq": 1,
            "num_nextn_predict_layers": 0, "attention_bias": False}


def describe(cfg_json: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration file -> the port's ModelConfig keyword arguments:
    the decoder's keys, the latent ranks and head widths, the leading dense
    layers, the router's scoring and scale, the experts held (the file's
    ``n_routed_experts``, with ``expert_parallel``'s ranks x that many
    routed over) and YaRN's parameters."""
    for key, want in REQUIRED.items():
        if cfg_json.get(key, want) != want:
            raise ValueError(f"{cfg_json['name']}: {key} {cfg_json[key]!r} is not described "
                             f"here (only {want!r})")
    md = decoder.describe(cfg_json)
    ep = cfg_json.get("expert_parallel", {"ranks": 1, "rank": 0})
    held = cfg_json["n_routed_experts"]
    n, r = cfg_json["qk_nope_head_dim"], cfg_json["qk_rope_head_dim"]
    md.update(q_lora_rank=cfg_json["q_lora_rank"], kv_lora_rank=cfg_json["kv_lora_rank"],
              qk_nope_head_dim=n, qk_rope_head_dim=r, v_head_dim=cfg_json["v_head_dim"],
              head_dim=n + r, n_dense_layers=cfg_json["first_k_dense_replace"],
              n_experts=ep["ranks"] * held, experts_held=held, expert_offset=ep["rank"] * held,
              n_shared_experts=cfg_json["n_shared_experts"], router_scoring="sigmoid",
              routed_scale=cfg_json["routed_scaling_factor"])
    rs = cfg_json.get("rope_scaling")
    if rs:
        if rs.get("type") != "yarn":
            raise ValueError(f"{md['name']}: rope_scaling {rs.get('type')!r} is not described")
        md.update(yarn_factor=rs["factor"],
                  yarn_original_max_pos=rs["original_max_position_embeddings"],
                  yarn_beta_fast=rs["beta_fast"], yarn_beta_slow=rs["beta_slow"],
                  yarn_mscale=rs["mscale"], yarn_mscale_all_dim=rs["mscale_all_dim"])
    return md


def layout(md: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameter tree (``transformer.model_spec`` with
    ``models/mla.py::mla_spec`` and ``moe.py::moe_spec``)."""
    d, H, V, L = md["d_model"], md["n_heads"], md["vocab_size"], md["n_layers"]
    Q, R = md["q_lora_rank"], md["kv_lora_rank"]
    n, r, c = md["qk_nope_head_dim"], md["qk_rope_head_dim"], md["v_head_dim"]
    norm = Leaf((d,), "norm")

    def attn():
        return {"wq_a": Leaf((d, Q), "matrix", d), "q_norm": Leaf((Q,), "norm"),
                "wq_b": Leaf((Q, H, n + r), "matrix", Q),
                "wkv_a": Leaf((d, R + r), "matrix", d), "kv_norm": Leaf((R,), "norm"),
                "wkv_b": Leaf((R, H, n + c), "matrix", R),
                "wo": Leaf((H, c, d), "matrix", H * c)}

    def mlp(f):
        return {"w_gate": Leaf((d, f), "matrix", d), "w_up": Leaf((d, f), "matrix", d),
                "w_down": Leaf((f, d), "matrix", f)}

    def moe():
        E, Eh, f = md["n_experts"], md["experts_held"], md["moe_d_ff"]
        return {"router": Leaf((d, E), "router"), "bias": Leaf((E,), "router_bias"),
                "w_gate": Leaf((Eh, d, f), "matrix", d), "w_up": Leaf((Eh, d, f), "matrix", d),
                "w_down": Leaf((Eh, f, d), "matrix", f),
                "shared": mlp(f * md["n_shared_experts"])}

    tree: Dict[str, Any] = {"embed": Leaf((V, d), "embed"), "final_norm": norm}
    if not md.get("tie_embeddings"):
        tree["head"] = Leaf((d, V), "matrix", d)
    tree["layers"] = [{"ln1": norm, "attn": attn(), "ln2": norm,
                       **({"mlp": mlp(md["d_ff"])} if i < md["n_dense_layers"]
                          else {"moe": moe()})} for i in range(L)]
    return tree


def softmax_scale(md: Dict[str, Any]) -> float:
    s = (md["qk_nope_head_dim"] + md["qk_rope_head_dim"]) ** -0.5
    if md.get("yarn_factor", 0) > 1 and md.get("yarn_mscale_all_dim"):
        s *= (0.1 * md["yarn_mscale_all_dim"] * math.log(md["yarn_factor"]) + 1.0) ** 2
    return s


def inv_freq(md: Dict[str, Any], r: int, device) -> torch.Tensor:
    """(r / 2,) rotary frequencies: theta^(-2i/r), and under YaRN each band
    i between ``low`` and ``high`` blended linearly toward that over
    ``factor``, where ``low`` / ``high`` are the bands that turn
    ``beta_fast`` / ``beta_slow`` times over the original context."""
    half = r // 2
    i = torch.arange(half, dtype=F32, device=device)
    base = 1.0 / (md["rope_theta"] ** (i / half))
    f = md.get("yarn_factor", 0)
    if not f:
        return base
    L0, theta = md["yarn_original_max_pos"], md["rope_theta"]

    def band(turns):
        return r * math.log(L0 / (turns * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(band(md["yarn_beta_fast"])), 0)
    high = min(math.ceil(band(md["yarn_beta_slow"])), r - 1)
    t = ((i - low) / (high - low if high > low else 0.001)).clamp(0.0, 1.0)
    return (1.0 - t) * base + t * base / f


class Reference(decoder.Reference):
    """One layer in plain PyTorch (``harness/reference.py`` says how a
    call is replayed)."""

    def layer(self, lp, x, pos, mask, Sp):
        x = x + self.attention(lp, x, pos, mask)
        h = self.rms(x, lp["ln2"])
        if "moe" in lp:
            return x + self.moe(lp["moe"], h, Sp) + self.mlp(lp["moe"]["shared"], h)
        return x + self.mlp(lp["mlp"], h)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (B, N, heads, r), pos (B, N): half-split rotation at the
        configuration's frequencies."""
        half = x.shape[-1] // 2
        ang = pos.to(F32)[..., None] * inv_freq(self.md, x.shape[-1], x.device)
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, lp, x, pos, mask) -> torch.Tensor:
        md = self.md
        B, N, d = x.shape
        H, Q, R = md["n_heads"], md["q_lora_rank"], md["kv_lora_rank"]
        n, r, c = md["qk_nope_head_dim"], md["qk_rope_head_dim"], md["v_head_dim"]
        a = lp["attn"]
        h = self.rms(x, lp["ln1"])
        wqa, wkva = self.weight(a["wq_a"], d), self.weight(a["wkv_a"], d)
        wqb, wkvb = self.weight(a["wq_b"], Q), self.weight(a["wkv_b"], R)
        wo = self.weight(a["wo"], H * c)
        scale = softmax_scale(md)
        out = torch.empty_like(x)
        rows = max(1, decoder.ATTN_BYTES // (H * N * N * 4))
        for b0 in range(0, B, rows):
            sl = slice(b0, b0 + rows)
            hb = h[sl]
            q = self.mm(self.rms(self.mm(hb, wqa), a["q_norm"]), wqb).view(-1, N, H, n + r)
            kv = self.mm(hb, wkva)
            k_pe = self.rope(kv[..., None, R:], pos[sl])[:, :, 0]                # (b, N, r)
            kvb = self.mm(self.rms(kv[..., :R], a["kv_norm"]), wkvb).view(-1, N, H, n + c)
            q_pe = self.rope(q[..., n:], pos[sl])
            s = (torch.einsum("bqhk,bshk->bhqs", q[..., :n], kvb[..., :n])
                 + torch.einsum("bqhk,bsk->bhqs", q_pe, k_pe)) * scale
            s = s.masked_fill(~mask[sl][:, None], float("-inf"))
            o = torch.einsum("bhqs,bshc->bqhc", torch.softmax(s, dim=-1), kvb[..., n:])
            out[sl] = self.mm(o.reshape(-1, N, H * c), wo)
        return out

    def moe(self, p, h, Sp: int) -> torch.Tensor:
        """The routed experts held here: sigmoid scores over all
        ``n_experts``, the top-k of score + bias, the capacity of all
        ``n_experts`` (``kept``), the held block's products."""
        md = self.md
        B, N, d = h.shape
        E, k = md["n_experts"], md["n_experts_per_token"]
        Eh, off = md["experts_held"], md["expert_offset"]
        f = p["w_gate"].shape[-1]
        hr = h.to(torch.bfloat16).to(F32) if self.precision == "fp32r" else h
        s = torch.sigmoid(self.mm(hr, self.weight(p["router"], d)))
        ids = torch.topk(s + p["bias"].to(F32), k, dim=-1).indices               # (B, N, k)
        w = torch.gather(s, -1, ids)
        w = w / w.sum(dim=-1, keepdim=True) * md["routed_scale"]
        kept = torch.empty_like(ids, dtype=torch.bool)
        kept[:, :Sp] = self.kept(ids[:, :Sp].reshape(1, B * Sp, k), E).view(B, Sp, k)
        if N > Sp:
            kept[:, Sp:] = self.kept(ids[:, Sp:].transpose(0, 1), E).transpose(0, 1)
        hf, idf = h.reshape(B * N, d), ids.reshape(B * N, k)
        keptf = kept.reshape(B * N, k)
        wf = (w * kept).reshape(B * N, k)
        out = torch.zeros_like(hf)
        for e in range(Eh):
            sel = (idf == off + e) & keptf
            rows = torch.nonzero(sel.any(dim=1))[:, 0]
            if rows.numel() == 0:
                continue
            xe = hf[rows]
            g = self.mm(xe, self.weight(p["w_gate"][e], d))
            u = self.mm(xe, self.weight(p["w_up"][e], d))
            y = self.mm(torch.nn.functional.silu(g) * u, self.weight(p["w_down"][e], f))
            out.index_add_(0, rows, y * (wf[rows] * sel[rows]).sum(dim=1, keepdim=True))
        return out.view(B, N, d)


class Flops(decoder.Flops):
    """MLA's counts (``harness/flops.py`` says what is counted). A token's
    weight products count MLA's five projections (the W_kvb expansion, or
    at decode its absorption into q and o, which apply the same weights), a
    dense layer's MLP, and a MoE layer's router, shared expert and the k x
    held / n_experts routed experts that fall on this chip on average. An
    attention pair counts QK at n + r and PV at c a head. The cache is R +
    r values a token a layer (1,152 bytes at Kimi-K2's widths)."""

    def attn_weights(self, md: Dict) -> int:
        d, H, Q, R = md["d_model"], md["n_heads"], md["q_lora_rank"], md["kv_lora_rank"]
        n, r, c = md["qk_nope_head_dim"], md["qk_rope_head_dim"], md["v_head_dim"]
        return d * Q + Q * H * (n + r) + d * (R + r) + R * H * (n + c) + H * c * d

    def shared_weights(self, md: Dict) -> int:
        return 3 * md["d_model"] * md["moe_d_ff"] * md["n_shared_experts"]

    def dense_weights(self, md: Dict) -> int:
        return 3 * md["d_model"] * md["d_ff"]

    def ffn_applied(self, md: Dict) -> float:
        """A MoE layer's FFN weights applied to one token: router, shared
        expert and the routed experts held here, on average."""
        held = md["n_experts_per_token"] * md["experts_held"] / md["n_experts"]
        return (held * self.expert_weights(md) + md["d_model"] * md["n_experts"]
                + self.shared_weights(md))

    def token_flops(self, md: Dict) -> float:
        L, nd = md["n_layers"], md["n_dense_layers"]
        return 2 * (L * self.attn_weights(md) + nd * self.dense_weights(md)
                    + (L - nd) * self.ffn_applied(md))

    def pair_flops(self, md: Dict) -> int:
        return md["n_heads"] * (2 * (md["qk_nope_head_dim"] + md["qk_rope_head_dim"])
                                + 2 * md["v_head_dim"])

    def expert_bytes_all(self, md: Dict) -> int:
        return ((md["n_layers"] - md["n_dense_layers"]) * md["experts_held"]
                * self.expert_weights(md) * shared.BYTES)

    def kv_bytes(self, md: Dict, keys: float) -> float:
        """The latent entries of ``keys`` valid keys in every layer."""
        return md["n_layers"] * keys * (md["kv_lora_rank"] + md["qk_rope_head_dim"]) * shared.BYTES

    def step_bytes(self, md: Dict, rows: int, keys: float,
                   experts_read: Optional[float] = None) -> float:
        """One decode step: every weight once (``experts_read`` of the held
        experts a MoE layer, else all held), norms, the output head,
        ``rows`` embedding rows and the latent entries of ``keys`` keys."""
        d, V, L, nd = md["d_model"], md["vocab_size"], md["n_layers"], md["n_dense_layers"]
        E = md["n_experts"]
        e = md["experts_held"] if experts_read is None else experts_read
        norms = 2 * d + md["q_lora_rank"] + md["kv_lora_rank"]
        moe = e * self.expert_weights(md) + self.shared_weights(md) + d * E + E
        head = 0 if md.get("tie_embeddings") else d * V
        weights = (L * (self.attn_weights(md) + norms) + nd * self.dense_weights(md)
                   + (L - nd) * moe + head + d + rows * d)
        return weights * shared.BYTES + self.kv_bytes(md, keys)

    def flash_least_s(self, md: Dict, lens, peaks: Dict[str, float]) -> float:
        """One layer's prefill flash call: the real queries' pairs at the
        bf16 peak, or q and k at n + r and v and o at c a head, of the real
        tokens, once at the memory rate."""
        tokens = sum(int(x) for x in lens)
        H, qk, c = md["n_heads"], md["qk_nope_head_dim"] + md["qk_rope_head_dim"], md["v_head_dim"]
        return self.least_s(self.pair_flops(md) * shared.causal_pairs(lens),
                            tokens * H * (2 * qk + 2 * c) * shared.BYTES, peaks)

    def decode_attn_bytes(self, md: Dict, rows: int, keys: float) -> float:
        """One layer's absorbed decode attention: the valid latent entries,
        and each row's absorbed q (R + r a head) and attended latent (R)."""
        R, r, H = md["kv_lora_rank"], md["qk_rope_head_dim"], md["n_heads"]
        return (keys * (R + r) + rows * H * (2 * R + r)) * shared.BYTES


flops = Flops()
