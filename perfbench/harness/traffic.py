"""The one traffic generator: it reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and the run's seed, and gives the inputs.

Every seed gets the same work in another order. Prompt lengths are the
stratified quantiles of the mix's law (``(i + 0.5) / n`` for i < n), so the
multiset of lengths is fixed by the mix; the seed draws the order, the token
ids and the sampling noise. An ``admit`` mix groups its lengths into batches
by the mix's own ``grouping_seed``, so that the batches, and their padding,
are the same for every run seed too.

Two kinds of mix:

* ``admit``: a closed loop of one client that sends a batch of ``batch``
  prompts, waits for its first tokens and length predictions, then sends the
  next; the batches of one cycle repeat in the seed's order.
* ``collect``: calls of ``prompts`` x ``repeats`` rows, each prompt tiled
  over ``repeats`` rows of one generation call (the paper's repeated
  sampling as an offline batch); the first ``greedy_repeats`` repeats of each
  prompt decode greedily, so the output check can judge their tokens.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Any, Dict, List, Tuple

import numpy as np

from harness.model import seed_of

PAD_ID = 0


def stratified_lengths(law: Dict[str, Any], n: int) -> np.ndarray:
    """n lengths at the stratified quantiles of ``law``, ascending."""
    if law["law"] != "lognormal":
        raise ValueError(f"unknown length law {law['law']!r}")
    nd = NormalDist()
    mu, sigma = math.log(law["median"]), law["sigma"]
    x = [math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(x), law["min"], law["max"]).astype(np.int64)


def _prompts(rng: np.random.Generator, lens: np.ndarray, width: int, vocab: int) -> np.ndarray:
    toks = rng.integers(0, vocab, size=(len(lens), width), dtype=np.int64)
    toks[np.arange(width)[None, :] >= lens[:, None]] = PAD_ID
    return toks


def admit_batches(mix: Dict[str, Any], vocab: int, seed: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One cycle of (tokens (B, S_pad) int64, lengths (B,)) batches, in the
    seed's order; S_pad is the batch's longest prompt rounded up to
    ``pad_multiple``."""
    B, nb = mix["batch"], mix["cycle_batches"]
    lens = stratified_lengths(mix["prompt_len"], B * nb)
    groups = np.random.default_rng(mix["grouping_seed"]).permutation(B * nb).reshape(nb, B)
    rng = np.random.default_rng(seed_of(seed, 3))
    out = []
    for g in rng.permutation(nb):
        bl = lens[groups[g]][rng.permutation(B)]
        m = mix["pad_multiple"]
        width = int(-(-bl.max() // m) * m)
        out.append((_prompts(rng, bl, width, vocab), bl))
    return out


def collect_call(mix: Dict[str, Any], vocab: int, seed: int, call: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Call ``call``'s rows: (tokens (P*r, pad_to) int64, lengths (P*r,)),
    prompt p on rows p*r .. p*r + r - 1."""
    P, r = mix["prompts"], mix["repeats"]
    rng = np.random.default_rng(seed_of(seed, 4, call))
    lens = stratified_lengths(mix["prompt_len"], P)[rng.permutation(P)]
    toks = _prompts(rng, lens, mix["pad_to"], vocab)
    return np.repeat(toks, r, axis=0), np.repeat(lens, r)


def greedy_rows(mix: Dict[str, Any]) -> np.ndarray:
    """The rows of a collect call that decode greedily."""
    P, r = mix["prompts"], mix["repeats"]
    j = np.arange(P * r) % r
    return np.nonzero(j < mix.get("greedy_repeats", 0))[0]


def row_temperatures(mix: Dict[str, Any]) -> np.ndarray:
    """(rows, 1) sampling temperatures: the mix's, and the greedy rows'
    ``greedy_temperature`` (so small that the sampled token is the argmax
    up to a gap of ~25 times it)."""
    t = np.full((mix["prompts"] * mix["repeats"], 1), mix["temperature"], np.float32)
    t[greedy_rows(mix)] = mix["greedy_temperature"]
    return t
