"""Tiny decoder LM used for CPU end-to-end runs (real generation + hidden-state
harvesting for the ProD pipeline). Not part of the assigned pool."""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="tiny-lm",
        family="dense",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=384,
        vocab_size=512,
        tie_embeddings=True,
        predictor_bins=32,
        predictor_bin_max=256.0,
        citation="(internal tiny model)",
    )
