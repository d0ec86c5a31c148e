"""Architecture registry of the port: every config of ``repro.configs``
(its 10 assigned architectures, the paper's two served models and tiny-lm).
``ASSIGNED_ARCHS`` are the ten the dry-run sweeps (``launch/dryrun.py``).
"""

from __future__ import annotations

from typing import List

from repro_torch.common.config import ModelConfig
from repro_torch.configs import (gemma3_27b, granite_20b, kimi_k2_1t_a32b, llama3_8b,
                                 mamba2_130m, minicpm_2b, qwen2_vl_2b, qwen3_moe_235b_a22b,
                                 qwen25_7b, tiny_lm, whisper_large_v3, yi_34b, zamba2_1p2b)

_MAKERS = {
    "llama3-8b": llama3_8b.make_config,
    "qwen2.5-7b": qwen25_7b.make_config,
    "granite-20b": granite_20b.make_config,
    "minicpm-2b": minicpm_2b.make_config,
    "yi-34b": yi_34b.make_config,
    "gemma3-27b": gemma3_27b.make_config,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.make_config,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b.make_config,
    "tiny-lm": tiny_lm.make_config,
    "mamba2-130m": mamba2_130m.make_config,
    "zamba2-1.2b": zamba2_1p2b.make_config,
    "whisper-large-v3": whisper_large_v3.make_config,
    "qwen2-vl-2b": qwen2_vl_2b.make_config,
}

ASSIGNED_ARCHS: List[str] = [
    "whisper-large-v3",
    "qwen2-vl-2b",
    "minicpm-2b",
    "kimi-k2-1t-a32b",
    "qwen3-moe-235b-a22b",
    "yi-34b",
    "zamba2-1.2b",
    "gemma3-27b",
    "granite-20b",
    "mamba2-130m",
]


def list_archs() -> List[str]:
    return list(_MAKERS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MAKERS:
        raise KeyError(f"unknown arch {arch!r}; options: {sorted(_MAKERS)}")
    return _MAKERS[arch]()
