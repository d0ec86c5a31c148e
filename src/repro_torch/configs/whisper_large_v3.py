"""Whisper-large-v3 transformer backbone [arXiv:2212.04356].

Encoder-decoder; the mel-spectrogram + conv feature extractor is a stub
(``models/frontend.py::audio_frame_embeds`` gives the encoder its frame
embeddings, (batch, encoder_seq, d_model)).
"""

from repro_torch.common.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        n_layers=32,
        n_encoder_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        encoder_seq=1500,
        act="gelu",
        norm_eps=1e-5,
        predictor_bin_max=448.0,  # whisper's decode budget
        citation="arXiv:2212.04356",
    )
