"""Yi-34B — llama-arch dense GQA [arXiv:2403.04652]."""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5e6,
        citation="arXiv:2403.04652",
    )
