"""The slice as a whole, port against the JAX package on tiny-lm (fp32):
the same weights and prompts give the same φ; the same lengths matrix goes
through targets -> train_predictor (same head init, same integer seed) ->
median and quantile predictions. Tolerances: φ 1e-4 of its scale (see
test_torch_models.py); predictions rtol 1e-4 / atol 2e-3 in length units —
40 AdamW steps compound fp32 differences of order 1e-6 in the weights."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import close, jax, jnp, np_tree  # noqa: E402

from repro.common.config import PredictorConfig as JPredictorConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import bins as jbins  # noqa: E402
from repro.core import heads as jheads  # noqa: E402
from repro.core import predictor as jpredictor  # noqa: E402
from repro.core import targets as jtargets  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro_torch.common.config import PredictorConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import bins, targets  # noqa: E402
from repro_torch.core.predictor import train_predictor  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import from_jax_params, head_from_jax  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serving.engine import RealEngine  # noqa: E402

N = 16


@pytest.fixture(scope="module")
def engines():
    jcfg = jget_config("tiny-lm").with_overrides(dtype="float32")
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("tiny-lm").with_overrides(dtype="float32")
    params = from_jax_params(np_tree(jparams), cfg, device="cpu")
    return (JRealEngine(jm, jparams, max_new=3),
            RealEngine(build_model(cfg), params, max_new=3))


@pytest.fixture(scope="module")
def phis(engines):
    jeng, teng = engines
    prompts, plens = serve.toy_prompts(N, seed=0)
    plens = plens - np.arange(N) % 3          # ragged right padding
    jphi = jeng.generate(prompts, plens, jax.random.PRNGKey(0))["phi"]
    tphi = teng.generate(prompts, plens, torch.Generator().manual_seed(0))["phi"]
    return jphi, tphi


def test_same_weights_same_prompts_same_phi(phis):
    jphi, tphi = phis
    assert tphi.shape == (N, 128) and tphi.dtype == np.float32
    close(tphi, jphi, rtol=1e-4, atol=1e-4 * float(np.abs(jphi).max()))


@pytest.mark.parametrize("kind", ["dist", "median"], ids=["ProD-D", "ProD-M"])
def test_targets_train_predict_pipeline(phis, kind):
    """run_real's tail (repro/launch/serve.py:81-91), both packages, on one
    lengths matrix with an even r (the sample median averages two values)."""
    jphi, tphi = phis
    rng = np.random.default_rng(1)
    lens = np.rint(np.exp(rng.normal(3.0, 0.7, (N, 4)))).clip(1, 120).astype(np.int64)
    bin_max = float(lens.max() + 8)
    jpcfg = JPredictorConfig(n_bins=32, bin_max=bin_max, epochs=40)
    tpcfg = PredictorConfig(n_bins=32, bin_max=bin_max, epochs=40)
    je = jbins.make_edges(32, bin_max)
    te = bins.make_edges(32, bin_max, device="cpu")
    jtgt = jtargets.build_target(jnp.asarray(lens, jnp.float32), je, kind)
    ttgt = targets.build_target(torch.from_numpy(lens), te, kind)
    close(ttgt, jtgt, rtol=0, atol=1e-7)

    split = N // 2
    key = jax.random.PRNGKey(1)
    init = jheads.head_init(key, 128, 512, 32)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    jpred = jpredictor.train_predictor(key, jnp.asarray(jphi[:split]), jtgt[:split], jpcfg,
                                       je, init_params=init)
    tpred = train_predictor(seed, tphi[:split], ttgt[:split], tpcfg, te,
                            init_params=head_from_jax(np_tree(init), device="cpu"),
                            device="cpu")
    test_j, test_t = jnp.asarray(jphi[split:]), torch.from_numpy(tphi[split:])
    close(tpred.predict(test_t), jpred.predict(test_j), rtol=1e-4, atol=2e-3)
    _, tq = tpred.quantiles(test_t, [0.5, 0.9])
    _, jq = jpred.quantiles(test_j, [0.5, 0.9])
    close(tq, jq, rtol=1e-4, atol=2e-3)


def test_generate_is_deterministic_under_a_seeded_generator(engines):
    _, teng = engines
    prompts, plens = serve.toy_prompts(6, seed=3)
    runs = [teng.generate(prompts, plens, torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
    np.testing.assert_array_equal(runs[0]["lengths"], runs[1]["lengths"])
    assert not np.array_equal(runs[0]["tokens"], runs[2]["tokens"])
    for out in runs:
        assert out["lengths"].min() >= 1 and out["lengths"].max() <= teng.max_new


def test_eos_ends_a_row_and_sets_its_length(engines):
    """A row that samples EOS stops counting; it is padded with EOS while
    other rows decode, and the columns after the last row ends stay 0, as in
    the reference."""
    _, teng = engines
    params = dict(teng.params)
    embed = params["embed"].clone()
    embed[2] += 50.0 * embed[2] / embed[2].norm()      # make EOS (id 2) likely
    params["embed"] = embed
    eng = RealEngine(teng.model, params, max_new=20)
    prompts, plens = serve.toy_prompts(8, seed=4)
    out = eng.generate(prompts, plens, torch.Generator().manual_seed(0))
    assert out["lengths"].min() < 20
    for row, n in zip(out["tokens"], out["lengths"]):
        if n < 20:
            assert row[n - 1] == 2 and np.isin(row[n:], (0, 2)).all()


def test_repeated_sampling_and_launcher_on_cpu():
    out = serve.main(["--mode", "real", "--device", "cpu", "--n-requests", "6", "--r", "2",
                      "--max-new", "6"])
    assert np.isfinite(out["median"]).all() and out["median"].shape == (3,)
    assert out["quantiles"].shape == (3, 2)
    assert (out["quantiles"][:, 1] >= out["quantiles"][:, 0] - 1e-4).all()


@pytest.mark.parametrize("name,dtype", [("tiny-lm", "float32"), ("llama3-8b", "bfloat16"),
                                        ("zamba2-1.2b", "bfloat16"),
                                        ("mamba2-130m", "bfloat16")])
def test_launcher_serves_each_model_in_its_dtype(name, dtype):
    assert serve.serving_config(name).dtype == dtype
