"""Configuration dataclasses (the port's own copy of ``repro.common.config``).

Only the fields and helpers this slice reads are kept; field names, defaults
and the ``head_dim`` derivation are the reference's, so a config built here
describes the same model as the one of the same name in ``repro.configs``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (values live in ``repro_torch.configs``)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    attn_window: int = 0             # 0 = full attention; >0 = sliding window
    local_global_ratio: int = 0
    rope_theta: float = 10000.0
    use_mrope: bool = False
    qk_norm: bool = False

    # --- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0               # d_state N
    ssm_heads: int = 0               # number of SSD heads (0 -> derived)
    ssm_head_dim: int = 64           # P
    ssm_chunk: int = 256             # kept to match the reference's config;
                                     # never read: the scan picks its own chunk
    ssm_conv_width: int = 4
    attn_every: int = 0              # hybrid: apply shared attn block every k ssm layers

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: str = "bfloat16"
    citation: str = ""

    predictor_bins: int = 64
    predictor_hidden: int = 512
    predictor_bin_max: float = 8192.0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) and self.family != "ssm":
            raise ValueError(f"{self.name}: n_heads={self.n_heads} not "
                             f"divisible by kv={self.n_kv_heads}")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def ssm_n_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return (2 * self.d_model) // self.ssm_head_dim  # mamba2 default d_inner=2*d

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """The AdamW fields of the reference's TrainConfig (the trainer's fields
    come with the trainer's slice)."""

    lr: float = 3e-4
    schedule: str = "cosine"          # only "constant" is ported so far
    warmup_steps: int = 100
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95


@dataclass(frozen=True)
class PredictorConfig:
    """ProD head + supervision protocol (paper §2.4 / A.2)."""

    n_bins: int = 64
    hidden: int = 512
    bin_max: float = 8192.0
    bin_spacing: str = "linear"       # linear | log
    decode: str = "median"            # median | argmax | mean
    lr: float = 1e-3
    epochs: int = 30
    batch_size: int = 256
    weight_decay: float = 0.0
