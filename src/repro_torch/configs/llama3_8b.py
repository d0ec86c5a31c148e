"""Llama-3-8B — one of the paper's served models (Section 3.1) [Meta AI 2024]."""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=5e5,
        citation="Meta AI 2024 (https://ai.meta.com/llama/)",
    )
