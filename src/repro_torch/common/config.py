"""Configuration dataclasses (the port's own copy of ``repro.common.config``).

Only the fields and helpers this slice reads are kept; field names, defaults
and the ``head_dim`` derivation are the reference's, so a config built here
describes the same model as the one of the same name in ``repro.configs``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


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
    rope_theta_local: float = 10000.0  # the rope base of "local" (windowed) layers
    use_mrope: bool = False
    qk_norm: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0        # kimi-k2 style always-on shared expert(s)
    moe_d_ff: int = 0                # per-expert hidden size (0 -> d_ff)
    router_aux_coef: float = 0.01

    # --- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0               # d_state N
    ssm_heads: int = 0               # number of SSD heads (0 -> derived)
    ssm_head_dim: int = 64           # P
    ssm_chunk: int = 256             # the training scan's chunk (models/ssm.py::
                                     # ssd_chunked); the prefill kernel picks its own
    ssm_conv_width: int = 4
    attn_every: int = 0              # hybrid: apply shared attn block every k ssm layers

    # --- enc-dec (Whisper) ---------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # frame positions of the stub audio frontend

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                # silu | gelu_gated (gated MLPs) | gelu (plain MLP)
    dtype: str = "bfloat16"
    citation: str = ""

    predictor_bins: int = 64
    predictor_hidden: int = 512
    predictor_bin_max: float = 8192.0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "moe" and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
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

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula: the hybrid's
        shared block counted once; a MoE layer's experts, shared experts and
        router; an encdec model's encoder layers and its decoder layers with
        self- and cross-attention. Like the reference's, it counts a
        ``gelu_gated`` MLP as two matrices though it holds three (Gemma3-27B:
        21.12 B here, 28.29 B in its leaves), leaves out the norms, and counts
        an untied embedding twice, so Whisper's one table, which its unembed
        reuses, counts twice (1.60 B here, 1.53 B in its leaves)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        ffn = lambda ff: (3 if self.act == "silu" else 2) * d * ff
        if self.family in ("dense", "vlm"):
            total = L * (attn + ffn(self.d_ff))
        elif self.family == "moe":
            experts = (self.n_experts + self.n_shared_experts) * ffn(self.moe_d_ff)
            total = L * (attn + experts + d * self.n_experts)
        elif self.family == "ssm":
            total = L * self._ssm_layer_params()
        elif self.family == "hybrid":
            total = L * self._ssm_layer_params() + attn + ffn(self.d_ff)
        elif self.family == "encdec":
            total = (self.n_encoder_layers * (attn + ffn(self.d_ff))
                     + L * (2 * attn + ffn(self.d_ff)))
        else:
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
        return int(total + emb)

    def active_param_count(self) -> int:
        """Parameters applied per token: a MoE layer's top-k and shared
        experts (gated, 3 matrices each) and its router; all of any other
        family."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        ffn = 3 * d * self.moe_d_ff
        layer = (self._attn_params() + (self.n_experts_per_token + self.n_shared_experts) * ffn
                 + d * self.n_experts)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(self.n_layers * layer + emb)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _ssm_layer_params(self) -> int:
        d = self.d_model
        d_inner = self.ssm_n_heads * self.ssm_head_dim
        n = self.ssm_state
        # in_proj (z, x, B, C, dt), conv, A, D, out_proj (one state group)
        return (d * (2 * d_inner + 2 * n + self.ssm_n_heads) + d_inner * self.ssm_conv_width
                + 2 * self.ssm_n_heads + d_inner * d)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: 2 layers, d_model<=256 (the
        reference's ``reduced``): 4 experts, top-2, of width 128 and at most
        one shared expert, SSM state<=16 in 4 heads of 32, a hybrid
        attending every layer, a window of at most 16, a local/global mix of
        one local layer and one full one, at most 32 encoder frames and 2
        encoder layers."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        while heads % kv:
            kv -= 1
        kw = dict(name=self.name + "-smoke", n_layers=2, d_model=d, n_heads=heads,
                  n_kv_heads=kv, head_dim=d // heads, d_ff=min(self.d_ff, 512) or self.d_ff,
                  vocab_size=min(self.vocab_size, 512),
                  encoder_seq=min(self.encoder_seq, 32))
        if self.family == "moe":
            kw.update(n_experts=4, n_experts_per_token=2, moe_d_ff=128,
                      n_shared_experts=min(self.n_shared_experts, 1))
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_heads=4, ssm_head_dim=32,
                      ssm_chunk=16)
        if self.family == "hybrid":
            kw.update(attn_every=1)
        if self.n_encoder_layers:
            kw.update(n_encoder_layers=2)
        if self.attn_window:
            kw.update(attn_window=min(self.attn_window, 16))
        if self.local_global_ratio:
            kw.update(local_global_ratio=min(self.local_global_ratio, 1))
        return self.with_overrides(**kw)


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)


def get_input_shape(name: str) -> InputShape:
    for s in INPUT_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown input shape {name!r}; options: {[s.name for s in INPUT_SHAPES]}")


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    schedule: str = "cosine"          # cosine | wsd | constant
    warmup_steps: int = 100
    decay_steps: int = 10_000
    stable_steps: int = 0             # WSD plateau
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0               # 0 = no gradient accumulation
    remat: str = "full"               # none | full
    seed: int = 0


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
