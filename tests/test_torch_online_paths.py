"""The port's online path and the paper's remaining artifacts against the JAX
package: ``RealEngine.generate(..., collect_per_step=True)`` (teacher-forced
on the reference's sampled tokens), ``core/metrics.py``'s heavy-tail
diagnostics, ``core/theory.py`` and the twins of ``bench_theory``,
``bench_fig1`` and ``bench_online``.

Tolerances: per-step hidden states 1e-4 of their scale (fp32, as the model
tests: the prefill attention differs in summation order) and step_valid,
lengths and tokens identical; metrics rtol 1e-6 (fp32 means over the same
values); theory and ``bench_theory`` bit-identical (NumPy copies on the same
draws); ``bench_fig1``'s statistics rtol 1e-5 and its ``validate`` equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import close, jax, jnp, np_tree  # noqa: E402

from benchmarks import bench_fig1 as jbench_fig1  # noqa: E402
from benchmarks import bench_theory as jbench_theory  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import metrics, theory  # noqa: E402
from repro_torch.launch import bench_fig1, bench_online, bench_theory, serve  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serving.engine import RealEngine  # noqa: E402

MAX_NEW = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def generations():
    """The reference's generation with per-step states, and the port's fed
    the reference's sampled tokens. EOS (id 2) is made likelier, so rows end
    at different steps (lengths 1-12)."""
    jm = jbuild_model(jget_config("tiny-lm").with_overrides(dtype="float32"))
    jparams = jm.init(jax.random.PRNGKey(0))
    e = np.asarray(jparams["embed"]).copy()
    e[2] += 4.0 * e[2] / np.linalg.norm(e[2])
    jparams = dict(jparams, embed=jnp.asarray(e))
    cfg = get_config("tiny-lm").with_overrides(dtype="float32")
    eng = RealEngine(build_model(cfg), from_jax_params(np_tree(jparams), cfg, device="cpu"),
                     max_new=MAX_NEW)
    prompts, plens = serve.toy_prompts(6, seed=4)
    plens = plens - np.arange(6) % 2                  # ragged right padding
    jout = JRealEngine(jm, jparams, max_new=MAX_NEW).generate(
        prompts, plens, jax.random.PRNGKey(0), collect_per_step=True)
    forced = iter(torch.from_numpy(np.asarray(jout["tokens"][:, t], np.int64))
                  for t in range(MAX_NEW))
    eng._sample = lambda logits, gen: next(forced)
    out = eng.generate(prompts, plens, torch.Generator().manual_seed(0), collect_per_step=True)
    return jout, out, eng, (prompts, plens)


def test_collect_per_step_teacher_forced(generations):
    jout, out, _, _ = generations
    assert len(set(jout["lengths"].tolist())) > 2 and jout["lengths"].max() == MAX_NEW
    np.testing.assert_array_equal(out["tokens"], jout["tokens"])
    np.testing.assert_array_equal(out["lengths"], jout["lengths"])
    assert out["step_valid"].dtype == np.bool_ and out["step_hidden"].dtype == np.float32
    assert out["step_hidden"].shape == (6, MAX_NEW, 128)
    np.testing.assert_array_equal(out["step_valid"], jout["step_valid"])
    want = np.asarray(jout["step_hidden"])
    close(out["step_hidden"], want, rtol=1e-4, atol=1e-4 * max(float(np.abs(want).max()), 1.0))
    np.testing.assert_allclose(out["phi"], jout["phi"], rtol=1e-4,
                               atol=1e-4 * float(np.abs(jout["phi"]).max()))


def test_per_step_keys_are_none_without_the_flag(generations):
    _, _, eng, (prompts, plens) = generations
    eng = RealEngine(eng.model, eng.params, max_new=3)
    out = eng.generate(prompts, plens, torch.Generator().manual_seed(1))
    assert out["step_hidden"] is None and out["step_valid"] is None


def test_online_dataset_from_the_port_generation(generations):
    """The port's per-step states feed core/online.py's dataset builder as the
    reference's do: the same rows, remaining lengths and progress."""
    from repro.core import online as jonline
    from repro_torch.core import online

    jout, out, _, _ = generations
    mine = online.build_online_dataset(out["step_hidden"], out["step_valid"], out["lengths"])
    theirs = jonline.build_online_dataset(np.asarray(jout["step_hidden"]),
                                          jout["step_valid"], jout["lengths"])
    for a, b in zip(mine[1:], theirs[1:]):
        np.testing.assert_array_equal(a, b)
    close(mine[0], theirs[0], rtol=1e-4, atol=1e-4 * float(np.abs(theirs[0]).max()))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [16, 5, 2], ids=["even-r16", "odd-r5", "even-r2"])
def test_metrics_match_jnp(r):
    rng = np.random.default_rng(r)
    lens = np.rint(np.exp(rng.normal(4.0, 1.0, (40, r)))).astype(np.int64)
    lens[:3] = 7                                          # ties and a flat row
    lens[3, : r // 2] = 0                                 # median below 1
    t, j = torch.from_numpy(lens), jnp.asarray(lens)
    close(metrics.max_to_median(t), jmetrics.max_to_median(j), rtol=1e-6, atol=0)
    close(metrics.noise_ratio(t), jmetrics.noise_ratio(j), rtol=1e-6, atol=1e-7)
    close(metrics.median_mae_per_prompt(t), jmetrics.median_mae_per_prompt(j),
          rtol=1e-6, atol=1e-6)
    assert metrics.hill_tail_index(lens) == jmetrics.hill_tail_index(lens)
    assert metrics.hill_tail_index(np.ones(10)) == jmetrics.hill_tail_index(np.ones(10))
    pred = rng.normal(50, 10, 40).astype(np.float32)
    mine = metrics.summarize_run("m", torch.from_numpy(pred), t[:, 0])
    theirs = jmetrics.summarize_run("m", jnp.asarray(pred), j[:, 0])
    assert mine["method"] == theirs["method"]
    assert abs(mine["mae"] - theirs["mae"]) <= 1e-6 * theirs["mae"]


# ---------------------------------------------------------------------------
# theory and the benchmarks' twins
# ---------------------------------------------------------------------------


def test_theory_is_bit_identical():
    rng = np.random.default_rng(0)
    phi, labels = rng.standard_normal((50, 4)), rng.standard_normal(50)
    a, b = theory.ridge_fit(phi, labels, lam=0.5), jtheory.ridge_fit(phi, labels, lam=0.5)
    for f in ("theta", "vn", "vn_inv"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert np.array_equal(theory.vn_norm(a, phi[:7]), jtheory.vn_norm(b, phi[:7]))
    assert theory.failure_prob(2000, 32) == jtheory.failure_prob(2000, 32)
    assert theory.r_required(600, 0.1) == jtheory.r_required(600, 0.1)
    assert theory.theorem1_constants(1.0, 0.5, 600, 0.1) == jtheory.theorem1_constants(
        1.0, 0.5, 600, 0.1)
    beta = theory.theorem1_beta(600, 6, 1.0, 0.5, 0.1, 1.0, 1.0)
    assert beta == jtheory.theorem1_beta(600, 6, 1.0, 0.5, 0.1, 1.0, 1.0)
    assert np.array_equal(theory.theorem1_pointwise_bound(a, phi, beta),
                          jtheory.theorem1_pointwise_bound(b, phi, beta))
    sampler = lambda g, s: g.standard_t(2.0, size=s)
    assert theory.lemma3_moment(sampler, 8, 0.5, 2000) == jtheory.lemma3_moment(
        sampler, 8, 0.5, 2000)
    lens = rng.integers(1, 100, (20, 9))
    assert np.array_equal(theory.median_label_noise(lens, lens[:, 0]),
                          jtheory.median_label_noise(lens, lens[:, 0]))
    assert theory.empirical_coverage(a, phi, labels, beta) == jtheory.empirical_coverage(
        b, phi, labels, beta)


def test_bench_theory_twin_is_bit_identical():
    mine, theirs = bench_theory.run(verbose=False), jbench_theory.run(verbose=False)
    assert mine == theirs
    assert bench_theory.validate(mine) == jbench_theory.validate(theirs)
    assert all(bench_theory.validate(mine).values())


def test_bench_fig1_twin_matches():
    mine = bench_fig1.run(verbose=False, device="cpu")
    theirs = jbench_fig1.run(verbose=False)
    assert list(mine) == list(theirs)
    for key in theirs:
        for stat, want in theirs[key].items():
            assert mine[key][stat] == pytest.approx(want, rel=1e-5), (key, stat)
    assert bench_fig1.validate(mine) == pytest.approx(jbench_fig1.validate(theirs), rel=1e-5)
    a = bench_fig1.system_prompt_effect(verbose=False, device="cpu")
    b = jbench_fig1.system_prompt_effect(verbose=False)
    assert a["radius_reduction_pct"] == pytest.approx(b["radius_reduction_pct"], rel=1e-5)
    for k in ("with_system_prompt", "without_system_prompt"):
        assert a[k] == pytest.approx(b[k], rel=1e-5)


def test_bench_online_reduced_run_on_cpu(capsys):
    """The whole ProD-O pipeline at a reduced size: 10 train steps, 8 prompts,
    16 new tokens. The port's samples differ from the reference's draw for
    draw, so its numbers are not the reference's; the report's form is."""
    rep = bench_online.run(train_steps=10, n_prompts=8, max_new=16, seed=0, verbose=True,
                           device="cpu")
    assert set(rep) == {"online", "static", "count"}
    assert 1 <= len(rep["online"]) <= 4 and rep["online"].keys() == rep["static"].keys()
    assert all(np.isfinite(v) and v >= 0 for v in [*rep["online"].values(),
                                                   *rep["static"].values()])
    assert sum(rep["count"].values()) > 0
    checks = bench_online.validate(rep)
    assert set(checks) == {"online_error_shrinks_with_progress",
                           "online_beats_static_remaining", "online_avg_mae",
                           "static_avg_mae"}
    assert "t≥" in capsys.readouterr().out
