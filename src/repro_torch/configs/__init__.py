"""Architecture registry of the port: the configs this slice serves.

The other families of ``repro.configs`` wait for their slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import List

from repro_torch.common.config import ModelConfig
from repro_torch.configs import llama3_8b, mamba2_130m, tiny_lm, zamba2_1p2b

_MAKERS = {
    "llama3-8b": llama3_8b.make_config,
    "tiny-lm": tiny_lm.make_config,
    "mamba2-130m": mamba2_130m.make_config,
    "zamba2-1.2b": zamba2_1p2b.make_config,
}


def list_archs() -> List[str]:
    return list(_MAKERS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MAKERS:
        raise KeyError(f"unknown arch {arch!r}; ported so far: {sorted(_MAKERS)} "
                       f"(the rest are queued in ROADMAP.md)")
    return _MAKERS[arch]()
