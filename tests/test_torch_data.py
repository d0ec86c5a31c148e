"""The port's length laws and Track-A scenarios against the reference's.

Both are NumPy from a seed, so the port must give the same arrays bit for
bit (``np.array_equal``, dtypes included): no tolerance.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import lengths as jlengths  # noqa: E402
from repro.data import scenarios as jscenarios  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch.data import lengths, make_scenario, scenarios, synthetic  # noqa: E402

SETTINGS = [(m, s) for m in ("qwen", "llama") for s in ("math", "coding", "longseq", "chat")]


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("model,scenario", SETTINGS)
def test_make_scenario_is_bit_identical(model, scenario):
    want = jsynthetic.make_scenario(model, scenario, n_train=64, n_test=32, seed=3)
    got = make_scenario(model, scenario, n_train=64, n_test=32, seed=3)
    assert (got.model, got.scenario, got.r) == (want.model, want.scenario, want.r)
    for field in ("len_train", "len_test", "latents_train", "latents_test",
                  "true_median_train", "true_median_test"):
        _same(getattr(got, field), getattr(want, field))
    for split in ("phi_train", "phi_test"):
        assert list(getattr(got, split)) == list(getattr(want, split))
        for view in getattr(want, split):
            _same(getattr(got, split)[view], getattr(want, split)[view])
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)


def test_scenario_tables_match():
    assert scenarios.MODELS == jscenarios.MODELS
    assert scenarios.SCENARIOS == jscenarios.SCENARIOS
    assert scenarios.VIEW_NOISE == jscenarios.VIEW_NOISE
    assert scenarios.PAPER_SPLITS == jscenarios.PAPER_SPLITS
    assert scenarios.ALL_SETTINGS == jscenarios.ALL_SETTINGS
    for model, scenario in SETTINGS:
        spec, jspec = scenarios.get_spec(model, scenario), jscenarios.get_spec(model, scenario)
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        for view in jscenarios.VIEW_NOISE:
            assert scenarios.feature_sigma(spec, view) == jscenarios.feature_sigma(jspec, view)


@pytest.mark.parametrize("model,scenario", [("qwen", "chat"), ("llama", "longseq")])
def test_length_laws_are_bit_identical(model, scenario):
    law = scenarios.get_spec(model, scenario).law
    jlaw = jscenarios.get_spec(model, scenario).law
    lat = lengths.sample_prompt_latents(np.random.default_rng(5), law, 300)
    _same(lat, jlengths.sample_prompt_latents(np.random.default_rng(5), jlaw, 300))
    _same(lengths.sample_lengths(np.random.default_rng(6), lat, 16, law),
          jlengths.sample_lengths(np.random.default_rng(6), lat, 16, jlaw))
    _same(lengths.true_conditional_median(lat), jlengths.true_conditional_median(lat))
    for q in (0.5, 0.9, 0.99):
        _same(lengths.law_quantile(lat, q), jlengths.law_quantile(lat, q))


def test_surrogate_linear_data_is_bit_identical():
    got = synthetic.surrogate_linear_data(50, 8, eps=0.5, r=4, seed=2)
    want = jsynthetic.surrogate_linear_data(50, 8, eps=0.5, r=4, seed=2)
    for a, b in zip(got, want):
        _same(a, b)
