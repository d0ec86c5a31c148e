"""Qwen2.5-7B — one of the paper's served models (Section 3.1) [arXiv:2412.15115]."""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        rope_theta=1e6,
        citation="arXiv:2412.15115",
    )
