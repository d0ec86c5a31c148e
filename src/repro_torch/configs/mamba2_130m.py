"""Mamba2-130M — SSD (state-space duality), attention-free [arXiv:2405.21060]."""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,       # attention-free; unused
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,  # d_inner = 2*d_model = 1536 -> 24 SSD heads
        tie_embeddings=True,
        citation="arXiv:2405.21060",
    )
