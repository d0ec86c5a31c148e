"""Zamba2-1.2B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

38 Mamba2 layers; a single weight-shared attention+MLP block is applied every
``attn_every`` SSM layers (Zamba2's shared-block design).
"""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        attn_every=6,
        attn_window=8192,  # shared attn block uses a KV ring at long context
        citation="arXiv:2411.15242",
    )
