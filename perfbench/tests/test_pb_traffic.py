"""The traffic generator: deterministic per seed, the same work for every
seed in another order, and the stated laws."""

import math
from statistics import NormalDist

import numpy as np
import pytest

from harness import common, traffic


@pytest.fixture(params=["admit", "collect-p64-r8", "collect-p16-r8"])
def mix(request):
    return common.traffic(request.param)


def _draw(mix, seed):
    if mix["kind"] == "admit":
        return traffic.admit_batches(mix, 152064, seed)
    return [traffic.collect_call(mix, 152064, seed, c) for c in range(2)]


def test_same_seed_same_inputs(mix):
    a, b = _draw(mix, 2 ** 31 + 17), _draw(mix, 2 ** 31 + 17)
    for (ta, la), (tb, lb) in zip(a, b):
        assert np.array_equal(ta, tb) and np.array_equal(la, lb)


def test_seeds_differ_in_order_not_in_work(mix):
    a, b = _draw(mix, 1), _draw(mix, 4_000_000_000)
    assert any(not np.array_equal(ta, tb) for (ta, _), (tb, _) in zip(a, b))
    assert sorted(int(l.sum()) for _, l in a) == sorted(int(l.sum()) for _, l in b)
    assert sorted(t.shape for t, _ in a) == sorted(t.shape for t, _ in b)


def test_lengths_follow_the_law(mix):
    law = mix["prompt_len"]
    n = 4096
    lens = traffic.stratified_lengths(law, n)
    assert lens.min() >= law["min"] and lens.max() <= law["max"]
    assert np.all(np.diff(lens) >= 0)
    # the median and the quartiles of the lognormal, before clipping
    for p in (0.25, 0.5, 0.75):
        want = law["median"] * math.exp(law["sigma"] * NormalDist().inv_cdf(p))
        want = min(max(want, law["min"]), law["max"])
        assert abs(np.quantile(lens, p) - want) <= 1.0


def test_padding_and_rows(mix):
    for toks, lens in _draw(mix, 7):
        width = toks.shape[1]
        if mix["kind"] == "admit":
            assert toks.shape[0] == mix["batch"]
            assert width % mix["pad_multiple"] == 0
            assert width - mix["pad_multiple"] < lens.max() <= width
        else:
            assert toks.shape == (mix["prompts"] * mix["repeats"], mix["pad_to"])
            r = mix["repeats"]
            assert np.array_equal(toks[::r], toks[r - 1::r])      # a prompt's repeats
        pads = np.arange(width)[None, :] >= lens[:, None]
        assert np.all(toks[pads] == traffic.PAD_ID)


def test_greedy_rows():
    mix = common.traffic("collect-p16-r8")
    g = traffic.greedy_rows(mix)
    assert list(g) == list(range(0, 128, 8))
    t = traffic.row_temperatures(mix)
    assert t.shape == (128, 1) and np.all(t[g] == 1e-6) and np.sum(t == 0.8) == 112
