"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2].

GQA kv=8, per-expert d_ff=2048, one shared expert (K2 paper table).

A GQA stand-in kept under the JAX package's name, and not the published
model: Kimi-K2-Instruct has multi-head latent attention, a sigmoid router
with a correction bias and a leading dense layer. The published model, as
its ``config.json`` gives it, is ``perfbench/configs/kimi-k2-instruct.json``
(served through ``models/mla.py`` and ``models/moe.py``'s sigmoid router).
"""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        moe_d_ff=2048,
        vocab_size=163840,
        n_experts=384,
        n_experts_per_token=8,
        n_shared_experts=1,
        citation="arXiv:2501.kimi2",
    )
