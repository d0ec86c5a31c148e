"""Operations and bytes that the served calls need, from their shapes: the
yardstick of every roofline and ``mfu`` metric.

"Needed" counts what these inputs require, not what a design computes: the
weight products of real tokens (a MoE layer's attention, its router and its
k routed experts, not the capacity slots), the attention pairs of real
queries over their valid keys, the unembedding of the rows that are sampled,
and the head. A decode step reads each weight once (a MoE layer only the
experts its tokens routed to, where that count is given), the untied output
head once, the embedding rows of its tokens and the K/V of the valid keys.
Weights and K/V are bf16 (2 bytes).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

BYTES = 2


def attn_weights(md: Dict) -> int:
    d, H, KV, hd = md["d_model"], md["n_heads"], md["n_kv_heads"], md["head_dim"]
    return d * (H + 2 * KV) * hd + H * hd * d


def expert_weights(md: Dict) -> int:
    return 3 * md["d_model"] * md["moe_d_ff"]


def ffn_applied(md: Dict) -> int:
    """FFN weights applied to one token in one layer."""
    if md["family"] == "moe":
        return md["n_experts_per_token"] * expert_weights(md) + md["d_model"] * md["n_experts"]
    return 3 * md["d_model"] * md["d_ff"]


def ffn_resident(md: Dict, experts_read: Optional[float] = None) -> float:
    """FFN weights a decode step reads in one layer: every one, or in a MoE
    layer ``experts_read`` experts and the router."""
    if md["family"] == "moe":
        e = md["n_experts"] if experts_read is None else experts_read
        return e * expert_weights(md) + md["d_model"] * md["n_experts"]
    return 3 * md["d_model"] * md["d_ff"]


def token_flops(md: Dict) -> int:
    """Weight-product FLOPs of one token through every layer (2 a weight)."""
    return 2 * md["n_layers"] * (attn_weights(md) + ffn_applied(md))


def pair_flops(md: Dict) -> int:
    """Attention FLOPs of one (query, key) pair in one layer: QK and PV."""
    return 4 * md["n_heads"] * md["head_dim"]


def causal_pairs(lens: Iterable[int]) -> int:
    return sum(int(n) * (int(n) + 1) // 2 for n in lens)


def unembed_flops(md: Dict) -> int:
    return 2 * md["d_model"] * md["vocab_size"]


def head_flops(md: Dict, hidden: int, bins: int) -> int:
    return 2 * (md["d_model"] * hidden + hidden * bins)


def prefill_flops(md: Dict, lens, hidden: int = 0, bins: int = 0) -> float:
    """A prefill of prompts of ``lens`` real tokens, one unembedded row
    each, and (``hidden``, ``bins``) the head on each."""
    lens = [int(n) for n in lens]
    return (token_flops(md) * sum(lens) + md["n_layers"] * pair_flops(md) * causal_pairs(lens)
            + len(lens) * unembed_flops(md)
            + (len(lens) * head_flops(md, hidden, bins) if hidden else 0))


def expert_bytes_all(md: Dict) -> int:
    """Bytes of every expert of every MoE layer (what capacity dispatch reads
    in a decode step)."""
    return md["n_layers"] * md["n_experts"] * expert_weights(md) * BYTES


def kv_bytes(md: Dict, keys: float) -> float:
    """K and V of ``keys`` valid keys (summed over rows) in every layer."""
    return md["n_layers"] * 2 * keys * md["n_kv_heads"] * md["head_dim"] * BYTES


def step_bytes(md: Dict, rows: int, keys: float, experts_read: Optional[float] = None) -> float:
    """One decode step: layer weights once (``experts_read`` experts a MoE
    layer, averaged), norms, the output head, ``rows`` embedding rows and
    the K/V of ``keys`` valid keys."""
    d, V, L = md["d_model"], md["vocab_size"], md["n_layers"]
    layer = attn_weights(md) + ffn_resident(md, experts_read) + 2 * d
    head = 0 if md.get("tie_embeddings") else d * V
    return (L * layer + head + d + rows * d) * BYTES + kv_bytes(md, keys)


def step_flops(md: Dict, rows: int, keys: float) -> float:
    return (token_flops(md) * rows + md["n_layers"] * pair_flops(md) * keys
            + rows * unembed_flops(md))


def least_s(flops: float, nbytes: float, peaks: Dict[str, float]) -> float:
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def flash_least_s(md: Dict, lens, peaks: Dict[str, float]) -> float:
    """Least time of one layer's prefill flash call: the real queries' pairs
    over valid keys at the bf16 peak, or q, k, v and o of the real tokens
    once at the memory rate."""
    n = sum(int(x) for x in lens)
    H, KV, hd = md["n_heads"], md["n_kv_heads"], md["head_dim"]
    return least_s(pair_flops(md) * causal_pairs(lens), n * (2 * H + 2 * KV) * hd * BYTES, peaks)


def decode_attn_bytes(md: Dict, rows: int, keys: float) -> float:
    """One layer's decode-attention call: the valid K/V, q and o."""
    return (2 * keys * md["n_kv_heads"] + 2 * rows * md["n_heads"]) * md["head_dim"] * BYTES
