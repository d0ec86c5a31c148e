"""Gemma3-27B — 5:1 local:global attention pattern, 128k context
[hf:google/gemma-3-1b-pt]."""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab_size=262144,
        local_global_ratio=5,
        attn_window=1024,
        rope_theta=1e6,
        rope_theta_local=10000.0,
        qk_norm=True,
        tie_embeddings=True,
        act="gelu_gated",
        citation="hf:google/gemma-3-1b-pt",
    )
