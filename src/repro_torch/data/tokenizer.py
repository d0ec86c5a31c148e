"""Toy tokenizer + synthetic corpus for the Track-B end-to-end demo (the
port's own copy of ``repro.data.tokenizer``; NumPy only).

A tiny "language" whose ground-truth generation-length law is heavy-tailed and
topic-conditioned: a prompt is [BOS, topic, style...] and the continuation
length is drawn from a topic-conditional lognormal+Pareto mixture, terminated
by EOS. A tiny LM trained on this corpus learns a stochastic EOS hazard, so
sampling it at temperature 0.8 genuinely reproduces the paper's Observation 1/2
phenomenology — real repeated generations with prompt-conditioned spread.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

PAD, BOS, EOS = 0, 1, 2
N_TOPICS = 8
TOPIC0 = 3                      # topic token ids: TOPIC0 .. TOPIC0+N_TOPICS-1
CONTENT0 = 3 + N_TOPICS         # content tokens start here
VOCAB = 512

# topic -> (median length, body sigma, tail weight, tail alpha)
TOPIC_LAWS = [
    (12, 0.25, 0.03, 2.5), (18, 0.30, 0.04, 2.2), (26, 0.35, 0.05, 2.0),
    (36, 0.30, 0.05, 2.0), (48, 0.40, 0.06, 1.9), (64, 0.35, 0.05, 2.1),
    (20, 0.55, 0.08, 1.8), (40, 0.60, 0.08, 1.8),
]


@dataclass(frozen=True)
class ToyTokenizer:
    vocab_size: int = VOCAB

    def prompt(self, rng: np.random.Generator, topic: int, n_style: int = 4) -> np.ndarray:
        style = rng.integers(CONTENT0, CONTENT0 + 64, size=n_style)
        return np.concatenate([[BOS, TOPIC0 + topic], style]).astype(np.int32)


def sample_continuation_length(rng: np.random.Generator, topic: int,
                               max_len: int = 240) -> int:
    m, sigma, w, alpha = TOPIC_LAWS[topic]
    if rng.random() < w:
        L = m * rng.random() ** (-1.0 / alpha)
    else:
        L = m * np.exp(sigma * rng.standard_normal())
    return int(np.clip(np.rint(L), 2, max_len))


def make_sequence(rng: np.random.Generator, topic: int, seq_len: int,
                  max_gen: int = 240) -> Tuple[np.ndarray, np.ndarray, int]:
    """One training sequence: prompt + content + EOS, padded to seq_len.

    Returns (tokens (seq_len,), loss_mask (seq_len,), true_length)."""
    tok = ToyTokenizer()
    prompt = tok.prompt(rng, topic)
    L = sample_continuation_length(rng, topic, max_gen)
    # content distribution is topic-specific so the LM can also learn topicality
    lo = CONTENT0 + 64 + topic * 48
    content = rng.integers(lo, lo + 48, size=L)
    seq = np.concatenate([prompt, content, [EOS]])[:seq_len]
    out = np.full(seq_len, PAD, np.int32)
    out[: len(seq)] = seq
    mask = np.zeros(seq_len, np.int32)
    mask[len(prompt): len(seq)] = 1      # train on continuation + EOS only
    return out, mask, L


def make_corpus(rng: np.random.Generator, n: int, seq_len: int):
    """(tokens (n, seq_len), mask (n, seq_len), topics (n,), lengths (n,))."""
    toks = np.zeros((n, seq_len), np.int32)
    masks = np.zeros((n, seq_len), np.int32)
    topics = rng.integers(0, N_TOPICS, size=n)
    lens = np.zeros(n, np.int64)
    for i in range(n):
        toks[i], masks[i], lens[i] = make_sequence(rng, int(topics[i]), seq_len)
    return toks, masks, topics, lens
