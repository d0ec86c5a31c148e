"""LM-training data pipeline: host-side NumPy batching with deterministic
epoch shuffling, batches placed on one device.

The port of ``repro.data.pipeline`` for a single process: the same seed
gives the same batches, bit for bit. The reference's ``sharding`` argument
(``jax.make_array_from_process_local_data`` over a mesh) becomes ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.data.tokenizer import make_corpus


@dataclass
class LMDataset:
    tokens: np.ndarray       # (n, seq) int32
    loss_mask: np.ndarray    # (n, seq) int32

    def __len__(self):
        return self.tokens.shape[0]


def make_lm_dataset(n: int, seq_len: int, seed: int = 0) -> LMDataset:
    rng = np.random.default_rng(seed)
    toks, masks, _, _ = make_corpus(rng, n, seq_len)
    return LMDataset(tokens=toks, loss_mask=masks)


def batch_iterator(ds: LMDataset, global_batch: int, seed: int = 0,
                   device: DeviceLike = None,
                   drop_last: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite epoch-shuffled iterator of int32 ``tokens`` and ``loss_mask``
    (B, seq) tensors on ``device``."""
    dev = resolve_device(device)
    n = len(ds)
    epoch = 0
    while True:
        perm = np.random.default_rng(seed + epoch).permutation(n)
        for s in range(0, n - global_batch + 1 if drop_last else n, global_batch):
            idx = perm[s:s + global_batch]
            yield {"tokens": torch.from_numpy(ds.tokens[idx]).to(dev),
                   "loss_mask": torch.from_numpy(ds.loss_mask[idx]).to(dev)}
        epoch += 1
