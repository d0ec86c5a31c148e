"""Operations and bytes that the served calls need, from their shapes: the
yardstick of every roofline and ``mfu`` metric. What every architecture
shares is here; each architecture's own counts are its module's ``flops``
(``perfbench/arch/<arch>.py``), which the metrics call through
``run.flops``.

"Needed" counts what these inputs require, not what a design computes: the
weight products of real tokens (a MoE layer's attention, its router and its
k routed experts, not the capacity slots), the attention pairs of real
queries over their valid keys, the unembedding of the rows that are sampled,
and the head. Weights and K/V are bf16 (2 bytes).
"""

from __future__ import annotations

from typing import Dict, Iterable

BYTES = 2


def causal_pairs(lens: Iterable[int]) -> int:
    return sum(int(n) * (int(n) + 1) // 2 for n in lens)


def unembed_flops(md: Dict) -> int:
    return 2 * md["d_model"] * md["vocab_size"]


def head_flops(md: Dict, hidden: int, bins: int) -> int:
    return 2 * (md["d_model"] * hidden + hidden * bins)


def least_s(flops: float, nbytes: float, peaks: Dict[str, float]) -> float:
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])
