"""MiniCPM-2B [arXiv:2404.06395] — llama-like dense arch trained with the WSD
(warmup-stable-decay) schedule; the schedule lives in ``repro_torch.training.optim``."""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_ff=5760,
        vocab_size=122753,
        tie_embeddings=True,
        citation="arXiv:2404.06395",
    )
