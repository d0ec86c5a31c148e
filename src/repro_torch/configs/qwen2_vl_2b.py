"""Qwen2-VL-2B language backbone [arXiv:2409.12191].

M-RoPE (3 position streams: temporal/height/width) + dynamic resolution.
The ViT vision encoder + projector is a stub
(``models/frontend.py::vlm_embeds`` gives interleaved patch and text
embeddings with their M-RoPE position ids).
"""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        use_mrope=True,
        rope_theta=1e6,
        tie_embeddings=True,
        citation="arXiv:2409.12191",
    )
