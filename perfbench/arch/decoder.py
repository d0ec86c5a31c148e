"""The GQA decoder with SiLU-gated FFNs, dense or MoE: Qwen2.5, Qwen3-MoE
and their kind. The architecture module of every configuration whose
``arch`` is ``"decoder"``; ``harness/common.py`` says what such a module
gives.

A layer is pre-norm: ``x + attention(rms(x))``, then ``x + ffn(rms(x))``.
The attention is grouped-query with RoPE (half-split) and, with
``qk_norm``, an RMSNorm of each head's q and k; the FFN is a SiLU-gated
MLP, or in the ``moe`` family a softmax top-k router over ``n_experts``
SiLU-gated experts behind the port's capacity dispatch, with the top-k
weights renormalised. Every layer is of the one kind.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from harness import flops as shared
from harness.model import Leaf
from harness.reference import Reference as Base

F32 = torch.float32
ATTN_BYTES = 1 << 30        # fp32 score bytes an attention chunk may hold

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


class Reference(Base):
    """One decoder layer in plain PyTorch (``harness/reference.py`` says
    how a call is replayed)."""

    def layer(self, lp, x, pos, mask, Sp):
        x = x + self.attention(lp, x, pos, mask)
        h = self.rms(x, lp["ln2"])
        return x + (self.moe(lp["moe"], h, Sp) if "moe" in lp else self.mlp(lp["mlp"], h))

    def attention(self, lp, x, pos, mask) -> torch.Tensor:
        md = self.md
        B, N, d = x.shape
        H, KV, hd = md["n_heads"], md["n_kv_heads"], md["head_dim"]
        G = H // KV
        a = lp["attn"]
        h = self.rms(x, lp["ln1"])
        wq, wk, wv = (self.weight(a[n], d) for n in ("wq", "wk", "wv"))
        wo = self.weight(a["wo"], H * hd)
        out = torch.empty_like(x)
        rows = max(1, ATTN_BYTES // (H * N * N * 4))
        for b0 in range(0, B, rows):
            sl = slice(b0, b0 + rows)
            hb = h[sl]
            q = self.mm(hb, wq).view(-1, N, H, hd)
            k = self.mm(hb, wk).view(-1, N, KV, hd)
            v = self.mm(hb, wv).view(-1, N, KV, hd)
            if md.get("qk_norm"):
                q, k = self.rms(q, a["q_norm"]), self.rms(k, a["k_norm"])
            q, k = self.rope(q, pos[sl]), self.rope(k, pos[sl])
            qg = q.view(-1, N, KV, G, hd)
            s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(hd)
            s = s.masked_fill(~mask[sl][:, None, None], float("-inf"))
            o = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, dim=-1), v)
            out[sl] = self.mm(o.reshape(-1, N, H * hd), wo)
        return out

    def mlp(self, p, h) -> torch.Tensor:
        d = h.shape[-1]
        f = p["w_gate"].shape[-1]
        g = self.mm(h, self.weight(p["w_gate"], d))
        u = self.mm(h, self.weight(p["w_up"], d))
        return self.mm(torch.nn.functional.silu(g) * u, self.weight(p["w_down"], f))

    def moe(self, p, h, Sp: int) -> torch.Tensor:
        md = self.md
        B, N, d = h.shape
        E, k = md["n_experts"], md["n_experts_per_token"]
        f = p["w_gate"].shape[-1]
        hr = h.to(torch.bfloat16).to(F32) if self.precision == "fp32r" else h
        probs = torch.softmax(self.mm(hr, self.weight(p["router"], d)), dim=-1)
        top_p, ids = torch.topk(probs, k, dim=-1)                       # (B, N, k)
        w = top_p / top_p.sum(dim=-1, keepdim=True)
        kept = torch.empty_like(ids, dtype=torch.bool)
        kept[:, :Sp] = self.kept(ids[:, :Sp].reshape(1, B * Sp, k), E).view(B, Sp, k)
        if N > Sp:
            kept[:, Sp:] = self.kept(ids[:, Sp:].transpose(0, 1), E).transpose(0, 1)
        hf, idf = h.reshape(B * N, d), ids.reshape(B * N, k)
        wf = (w * kept).reshape(B * N, k)
        sel_all = (idf[..., None] == torch.arange(E, device=h.device)) & kept.reshape(B * N, k, 1)
        out = torch.zeros_like(hf)
        for e in range(E):
            sel = sel_all[:, :, e]
            rows = torch.nonzero(sel.any(dim=1))[:, 0]
            if rows.numel() == 0:
                continue
            xe = hf[rows]
            g = self.mm(xe, self.weight(p["w_gate"][e], d))
            u = self.mm(xe, self.weight(p["w_up"][e], d))
            y = self.mm(torch.nn.functional.silu(g) * u, self.weight(p["w_down"][e], f))
            out.index_add_(0, rows, y * (wf[rows] * sel[rows]).sum(dim=1, keepdim=True))
        return out.view(B, N, d)


class Flops:
    """The decoder's counts (``harness/flops.py`` says what is counted). A
    decode step reads each weight once (a MoE layer only the experts its
    tokens routed to, where that count is given), the untied output head
    once, the embedding rows of its tokens and the K/V of the valid keys.
    A subclass changes a piece (the FFN, the attention) and the totals
    follow."""

    least_s = staticmethod(shared.least_s)

    def attn_weights(self, md: Dict) -> int:
        d, H, KV, hd = md["d_model"], md["n_heads"], md["n_kv_heads"], md["head_dim"]
        return d * (H + 2 * KV) * hd + H * hd * d

    def expert_weights(self, md: Dict) -> int:
        return 3 * md["d_model"] * md["moe_d_ff"]

    def ffn_applied(self, md: Dict) -> int:
        """FFN weights applied to one token in one layer."""
        if md["family"] == "moe":
            return (md["n_experts_per_token"] * self.expert_weights(md)
                    + md["d_model"] * md["n_experts"])
        return 3 * md["d_model"] * md["d_ff"]

    def ffn_resident(self, md: Dict, experts_read: Optional[float] = None) -> float:
        """FFN weights a decode step reads in one layer: every one, or in a
        MoE layer ``experts_read`` experts and the router."""
        if md["family"] == "moe":
            e = md["n_experts"] if experts_read is None else experts_read
            return e * self.expert_weights(md) + md["d_model"] * md["n_experts"]
        return 3 * md["d_model"] * md["d_ff"]

    def token_flops(self, md: Dict) -> int:
        """Weight-product FLOPs of one token through every layer (2 a weight)."""
        return 2 * md["n_layers"] * (self.attn_weights(md) + self.ffn_applied(md))

    def pair_flops(self, md: Dict) -> int:
        """Attention FLOPs of one (query, key) pair in one layer: QK and PV."""
        return 4 * md["n_heads"] * md["head_dim"]

    def prefill_flops(self, md: Dict, lens, hidden: int = 0, bins: int = 0) -> float:
        """A prefill of prompts of ``lens`` real tokens, one unembedded row
        each, and (``hidden``, ``bins``) the head on each."""
        lens = [int(n) for n in lens]
        return (self.token_flops(md) * sum(lens)
                + md["n_layers"] * self.pair_flops(md) * shared.causal_pairs(lens)
                + len(lens) * shared.unembed_flops(md)
                + (len(lens) * shared.head_flops(md, hidden, bins) if hidden else 0))

    def expert_bytes_all(self, md: Dict) -> int:
        """Bytes of every expert of every MoE layer (what capacity dispatch
        reads in a decode step)."""
        return md["n_layers"] * md["n_experts"] * self.expert_weights(md) * shared.BYTES

    def kv_bytes(self, md: Dict, keys: float) -> float:
        """K and V of ``keys`` valid keys (summed over rows) in every layer."""
        return md["n_layers"] * 2 * keys * md["n_kv_heads"] * md["head_dim"] * shared.BYTES

    def step_bytes(self, md: Dict, rows: int, keys: float,
                   experts_read: Optional[float] = None) -> float:
        """One decode step: layer weights once (``experts_read`` experts a
        MoE layer, averaged), norms, the output head, ``rows`` embedding rows
        and the K/V of ``keys`` valid keys."""
        d, V, L = md["d_model"], md["vocab_size"], md["n_layers"]
        layer = self.attn_weights(md) + self.ffn_resident(md, experts_read) + 2 * d
        head = 0 if md.get("tie_embeddings") else d * V
        return (L * layer + head + d + rows * d) * shared.BYTES + self.kv_bytes(md, keys)

    def step_flops(self, md: Dict, rows: int, keys: float) -> float:
        return (self.token_flops(md) * rows + md["n_layers"] * self.pair_flops(md) * keys
                + rows * shared.unembed_flops(md))

    def flash_least_s(self, md: Dict, lens, peaks: Dict[str, float]) -> float:
        """Least time of one layer's prefill flash call: the real queries'
        pairs over valid keys at the bf16 peak, or q, k, v and o of the real
        tokens once at the memory rate."""
        n = sum(int(x) for x in lens)
        H, KV, hd = md["n_heads"], md["n_kv_heads"], md["head_dim"]
        return self.least_s(self.pair_flops(md) * shared.causal_pairs(lens),
                            n * (2 * H + 2 * KV) * hd * shared.BYTES, peaks)

    def decode_attn_bytes(self, md: Dict, rows: int, keys: float) -> float:
        """One layer's decode-attention call: the valid K/V, q and o."""
        return ((2 * keys * md["n_kv_heads"] + 2 * rows * md["n_heads"]) * md["head_dim"]
                * shared.BYTES)


flops = Flops()
