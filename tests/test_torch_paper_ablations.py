"""The port's twins of the paper's Tables 2-3 (``launch/bench_table23.py``),
Figure 2 (``launch/bench_fig2.py``) and the bins ablation
(``launch/bench_bins_ablation.py``) against the reference's
``benchmarks/bench_{table23,fig2,bins_ablation}.py``.

Constants, loop order and seed maps are checked with every fit stubbed out,
at the fast profile: each port fit gets the integer the reference makes its
key of, and Figure 2's subsamples are the reference's rows. Each
``validate`` is fed the same synthetic results in both packages, in cases
where its booleans flip. Then each ``run`` at a reduced size (one small
setting, the S³/EGTP sweep cut to two points, Figure 2's repeats cut to
1, 2 and 4; one trial, as the stubbed checks cover the trials; the bins
ablation at its own size), fed the reference's head inits and minibatch seeds, is held at
Table 1's tolerance (``tests/test_torch_baselines.py``: test MAE rtol 1e-3,
atol 2e-3 tokens). A std over trials is held within what the trials' own
tolerance allows it to move.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (carry_reference_inits, carry_reference_seeds,  # noqa: E402
                           cut_sweeps_to_two_points, jax, jnp, record_reference_fits)

from benchmarks import bench_bins_ablation as jbins_abl  # noqa: E402
from benchmarks import bench_fig2 as jfig2  # noqa: E402
from benchmarks import bench_table23 as jt23  # noqa: E402
from repro.data import make_scenario as jmake_scenario  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.data import make_scenario  # noqa: E402
from repro_torch.launch import bench_bins_ablation as bins_abl  # noqa: E402
from repro_torch.launch import bench_fig2 as fig2  # noqa: E402
from repro_torch.launch import bench_table23 as t23  # noqa: E402

MAE_RTOL, ATOL = 1e-3, 2e-3
SETTINGS = [(m, s) for m in ("qwen", "llama") for s in ("math", "coding", "longseq", "chat")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed)).tolist()


def test_constants_match_the_reference():
    assert t23.ABLATION_METHODS == jt23.ABLATION_METHODS
    assert fig2.REPEATS == jfig2.REPEATS


# --------------------------------------------------------------------------
# loop order and seed maps, every fit stubbed
# --------------------------------------------------------------------------

class _Result:
    test_mae = 1.0


def test_table23_fits_and_seeds_match_the_reference(monkeypatch):
    calls = {"ref": [], "port": []}

    def jrecord(key, data, method, pcfg, supervision, single_idx, eval_target):
        calls["ref"].append((np.asarray(key).tolist(), method, supervision, single_idx,
                             eval_target, pcfg.n_bins, pcfg.bin_max))
        return _Result()

    def record(seed, data, method, pcfg, supervision, single_idx, eval_target, device):
        calls["port"].append((_key(seed), method, supervision, single_idx, eval_target,
                              pcfg.n_bins, pcfg.bin_max))
        return _Result()

    monkeypatch.setattr(jt23, "run_method", jrecord)
    monkeypatch.setattr(t23, "run_method", record)
    jt23.run(fast=True, seed=0, n_trials=3, verbose=False)
    t23.run(fast=True, seed=0, n_trials=3, verbose=False, device="cpu")
    assert len(calls["port"]) == 8 * 5 * 2 * 3
    assert calls["port"] == calls["ref"]


def _stub_predictor(tensor):
    class Stub:
        def predict(self, phi, how=None):
            return tensor(np.zeros(len(phi), np.float32))
    return Stub()


def test_fig2_subsamples_and_seeds_match_the_reference(monkeypatch):
    """Every fit of the fast profile's four scenarios: its key, its rows of
    train phi (the subsample at repeat number k), its lengths, target kind
    and decode rule."""
    calls = {"ref": [], "port": []}

    def jrecord(key, phi, lens, kind, decode, pcfg):
        calls["ref"].append((np.asarray(key).tolist(), np.asarray(phi), np.asarray(lens),
                             kind, decode, pcfg.bin_max))
        return _stub_predictor(jnp.asarray), decode

    def record(seed, phi, lens, kind, decode, pcfg, device=None):
        calls["port"].append((_key(seed), np.asarray(phi), np.asarray(lens), kind, decode,
                              pcfg.bin_max))
        return _stub_predictor(torch.from_numpy), decode

    monkeypatch.setattr(jfig2, "_fit", jrecord)
    monkeypatch.setattr(fig2, "_fit", record)
    jfig2.run(fast=True, seed=0, verbose=False)
    fig2.run(fast=True, seed=0, verbose=False, device="cpu")
    # per scenario: 5 ProD-M and 4 ProD-D repeat numbers, 2 trials each, and
    # the 2 full-coverage TRAIL-last fits
    assert len(calls["port"]) == len(calls["ref"]) == 4 * (9 * 2 + 2)
    for got, want in zip(calls["port"], calls["ref"]):
        assert got[0] == want[0] and got[3:] == want[3:]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_bins_ablation_grids_and_seeds_match_the_reference(monkeypatch):
    calls = {"ref": [], "port": []}

    def jrecord(key, phi, tgt, pcfg, edges):
        calls["ref"].append((np.asarray(key).tolist(), pcfg.n_bins, pcfg.bin_spacing,
                             np.asarray(edges), np.asarray(tgt)))
        return _stub_predictor(jnp.asarray)

    def record(seed, phi, tgt, pcfg, edges, device=None):
        calls["port"].append((_key(seed), pcfg.n_bins, pcfg.bin_spacing,
                              edges.numpy(), tgt.numpy()))
        return _stub_predictor(torch.from_numpy)

    monkeypatch.setattr(jbins_abl, "train_predictor", jrecord)
    monkeypatch.setattr(bins_abl, "train_predictor", record)
    jbins_abl.run(fast=True, seed=3, verbose=False)
    bins_abl.run(fast=True, seed=3, verbose=False, device="cpu")
    assert len(calls["port"]) == len(calls["ref"]) == 2 * 2 * 3
    for got, want in zip(calls["port"], calls["ref"]):
        assert got[:3] == want[:3]
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
        np.testing.assert_array_equal(got[4], want[4])


# --------------------------------------------------------------------------
# validate on the same synthetic results
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(5))
def test_table23_validate_matches_the_reference(case):
    rng = np.random.default_rng(case)
    scale = np.array([160.0, 125.0, 80.0, 190.0, 78.0])   # the five methods, prod_m last
    if case:
        scale = rng.permutation(scale)
    noisier = 1.0 + (0.1 if case % 2 == 0 else -0.1)
    t23_rows = {"median": {}, "single": {}}
    for i, m in enumerate(t23.ABLATION_METHODS):
        for s in SETTINGS:
            v = float(scale[i] * rng.uniform(0.9, 1.1))
            t23_rows["median"].setdefault(m, {})[s] = (v, float(rng.uniform(0, 2)))
            t23_rows["single"].setdefault(m, {})[s] = (v * noisier * rng.uniform(0.98, 1.02), 1.0)
    t1_rows = {"prod_m": {s: float(80 * rng.uniform(0.8, 1.2)) for s in SETTINGS}}
    got, want = t23.validate(t23_rows, t1_rows), jt23.validate(t23_rows, t1_rows)
    assert got == want


@pytest.mark.parametrize("case", range(4))
def test_fig2_validate_matches_the_reference(case):
    rng = np.random.default_rng(case)
    out = {}
    for j, setting in enumerate([("qwen", "math"), ("qwen", "chat"), ("llama", "longseq")]):
        base = float(rng.uniform(50, 150))
        # the best ProD-D point around the 2% margin: below, at and above it
        best = base * (0.95, 1.02, 1.05, 1.019)[(case + j) % 4]
        out[setting] = {"prod_d": {k: (best * (1 + 0.1 * i), 1.0) for i, k in enumerate((2, 4, 8))},
                        "prod_m": {1: (base, 1.0)}, "trail_last_full": {1: (base, 0.5)}}
    got, want = fig2.validate(out), jfig2.validate(out)
    assert got == want and any(got.values())
    if case == 0:
        assert not all(got.values())


@pytest.mark.parametrize("case", range(4))
def test_bins_ablation_validate_matches_the_reference(case):
    rng = np.random.default_rng(case)
    out = {}
    for setting in (("qwen", "chat"), ("qwen", "math")):
        res = {(sp, K): float(rng.uniform(30, 60)) for sp in ("linear", "log")
               for K in (16, 64, 128)}
        if case % 2:
            res[("log", 16)] = 1.3 * max(res.values())      # a log grid that is not robust
        out[setting] = res
    got, want = bins_abl.validate(out), jbins_abl.validate(out)
    assert got == want
    assert all(isinstance(v, bool) == isinstance(want[k], bool) for k, v in got.items())


# --------------------------------------------------------------------------
# the runs at a reduced size, the reference's fits carried across
# --------------------------------------------------------------------------

def _small(real):
    return lambda model, scen, seed=0, **kw: real(model, scen, n_train=64, n_test=48, seed=seed)


def _held(got, want):
    """A (mean, std) pair over trials: the mean at Table 1's tolerance, the
    std within the largest move the trials' tolerance allows."""
    assert got[0] == pytest.approx(want[0], rel=MAE_RTOL, abs=ATOL)
    assert abs(got[1] - want[1]) <= MAE_RTOL * 1.1 * want[0] + ATOL


def _carry(monkeypatch, jrun, *modules):
    inits, seeds = record_reference_fits(monkeypatch)
    want = jrun()
    carry_reference_inits(monkeypatch, inits)
    pairs = carry_reference_seeds(monkeypatch, seeds, *modules)
    return want, pairs


def _one_to_one(pairs, n):
    assert len(pairs) == n
    assert len(set(pairs)) == len({p for p, _ in pairs}) == len({r for _, r in pairs})


def test_table23_run_follows_the_reference(monkeypatch):
    cut_sweeps_to_two_points(monkeypatch)
    setting = lambda mk: (lambda fast=True, seed=0: iter(
        [("qwen", "math", mk("qwen", "math", n_train=64, n_test=48, seed=1), 1)]))
    monkeypatch.setattr(jt23, "all_settings", setting(jmake_scenario))
    monkeypatch.setattr(t23, "all_settings", setting(make_scenario))
    want, pairs = _carry(monkeypatch, lambda: jt23.run(n_trials=1, verbose=False),
                         baselines)
    got = t23.run(n_trials=1, verbose=False, device="cpu")
    # per eval target: S³ 2 fits, TRAIL-mean, TRAIL-last 1, EGTP 2, ProD-M 1
    _one_to_one(pairs, 7 * 2)
    for ev in ("single", "median"):
        for m in t23.ABLATION_METHODS:
            _held(got[ev][m][("qwen", "math")], want[ev][m][("qwen", "math")])


def test_fig2_run_follows_the_reference(monkeypatch):
    for mod, real in ((jfig2, jmake_scenario), (fig2, make_scenario)):
        monkeypatch.setattr(mod, "make_scenario", _small(real))
        monkeypatch.setattr(mod, "REPEATS", (1, 2, 4))
    scen = (("qwen", "longseq"),)
    want, pairs = _carry(monkeypatch, lambda: jfig2.run(scen, n_trials=1, verbose=False), fig2)
    got = fig2.run(scen, n_trials=1, verbose=False, device="cpu")
    _one_to_one(pairs, 3 + 2 + 1)
    assert got.keys() == want.keys()
    for curve, points in want[scen[0]].items():
        assert got[scen[0]][curve].keys() == points.keys()
        for k, v in points.items():
            _held(got[scen[0]][curve][k], v)


def test_bins_ablation_run_follows_the_reference(monkeypatch):
    """At the fast profile's own size (800 train prompts): at 64, the 400
    full-batch steps overfit the head (soft-CE 0.53) and the training turns
    chaotic past ~100 steps, the reference's own weights moving by 5.5e-2 of
    their scale under one ulp on φ, so a log grid of 16 bins there is no
    test of the port."""
    scen = (("qwen", "chat"),)
    want, pairs = _carry(monkeypatch, lambda: jbins_abl.run(scen, verbose=False), bins_abl)
    got = bins_abl.run(scen, verbose=False, device="cpu")
    assert len(pairs) == 6 and len(set(pairs)) == 1        # one seed for every grid
    assert got[scen[0]].keys() == want[scen[0]].keys()
    for grid, v in want[scen[0]].items():
        assert got[scen[0]][grid] == pytest.approx(float(v), rel=MAE_RTOL, abs=ATOL), grid
