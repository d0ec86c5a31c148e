"""Device resolution shared by every entry point of the port.

The port runs on the GPU. ``device=None`` means ``cuda``; a caller that wants
the CPU (the parity tests) says so explicitly. A missing GPU is an error,
never a silent fall-back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ('bfloat16', 'float32', 'float16') -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
