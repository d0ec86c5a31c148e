"""Qwen3-MoE 235B-A22B — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,
        moe_d_ff=1536,
        vocab_size=151936,
        n_experts=128,
        n_experts_per_token=8,
        qk_norm=True,
        citation="hf:Qwen/Qwen3-30B-A3B",
    )
