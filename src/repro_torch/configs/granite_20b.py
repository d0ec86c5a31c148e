"""Granite-20B (code) — llama-arch with MQA (kv=1) [arXiv:2405.04324]."""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        citation="arXiv:2405.04324",
    )
