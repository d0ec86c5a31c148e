"""The port's spans and counters (common/scopes.py): live only while
torch.profiler records, placed at the layer boundaries of a RealEngine call
on a tiny dense and a tiny MoE model, counting what the MoE dispatch sees,
and changing neither the outputs nor the ops that run.

CPU tests, plus one marked ``gpu`` that runs where a card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_trace.py
"""

import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.common import scopes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import bins  # noqa: E402
from repro_torch.core.heads import head_init  # noqa: E402
from repro_torch.core.predictor import LengthPredictor  # noqa: E402
from repro_torch.common.config import PredictorConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serving.engine import RealEngine  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = {"dense": "tiny-lm", "moe": "qwen3-moe-235b-a22b"}
MAX_NEW = 4
PREFIXES = ("engine.", "model.", "moe.", "head.")


def _engine(family, device="cpu", capacity_factor=1.25):
    cfg = get_config(ARCHS[family])
    cfg = (cfg.reduced() if family == "moe" else cfg).with_overrides(dtype="float32")
    model = build_model(cfg, capacity_factor=capacity_factor)
    # an EOS id no token takes: every call runs all MAX_NEW steps
    return RealEngine(model, model.init(0, device=device), max_new=MAX_NEW, eos_id=-1)


def _prompts(B=3, S=7, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 500, (B, S)), np.array([S, S - 2, S - 1][:B] + [S] * (B - 3))


def _generate(eng, prompts, plens):
    return eng.generate(prompts, plens, torch.Generator(device=eng.device).manual_seed(7))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events()]


def _spans(events):
    return [e for e in events if e.name.startswith(PREFIXES)]


@pytest.fixture(autouse=True)
def _fresh_counters():
    scopes.reset_counters()
    yield
    scopes.reset_counters()


def test_off_without_the_profiler():
    assert scopes.span("engine.step") is scopes.span("moe.router")
    assert isinstance(scopes.span("engine.step"), type(scopes.contextlib.nullcontext()))
    eng = _engine("moe")
    _generate(eng, *_prompts())
    assert scopes.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(scopes.span("engine.step"), torch.profiler.record_function)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_generate_spans_nest_at_the_layer_boundaries(family):
    eng = _engine(family)
    n_layers = eng.model.cfg.n_layers
    _, events = _profiled(lambda: _generate(eng, *_prompts()))
    spans = _spans(events)
    names = Counter(e.name for e in spans)
    moe_calls = n_layers * (MAX_NEW + 1) if family == "moe" else 0      # prefill + steps
    assert names == Counter({
        "model.prefill": 1, "engine.step": MAX_NEW, "engine.sample": MAX_NEW,
        "engine.finished_sync": MAX_NEW, "model.decode_step": MAX_NEW, "model.unembed": MAX_NEW + 1,
        **{f"moe.{s}": moe_calls for s in ("router", "dispatch", "experts", "combine")
           if moe_calls}})

    def parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIXES):
            p = p.cpu_parent
        return p.name if p is not None else None

    want = {"engine.step": None, "engine.sample": "engine.step",
            "engine.finished_sync": "engine.step", "model.decode_step": "engine.step",
            "model.prefill": None}
    for e in spans:
        if e.name in want:
            assert parent(e) == want[e.name], e.name
        elif e.name == "model.unembed":
            assert parent(e) in (None, "model.decode_step")
        else:
            assert parent(e) in ("model.prefill", "model.decode_step"), e.name
    by_step = Counter(parent(e) for e in spans if e.name.startswith("moe."))
    assert by_step.get("model.decode_step", 0) == 4 * n_layers * MAX_NEW * (family == "moe")


def test_moe_counters_equal_what_the_dispatch_sees(monkeypatch):
    # a capacity below the routed pairs, so that the prefill drops some
    eng = _engine("moe", capacity_factor=0.5)
    seen = []
    orig = moe._dispatch

    def rec(local_ids, combine_w, E_local, capacity):
        out = orig(local_ids, combine_w, E_local, capacity)
        seen.append((local_ids.numel(), int((out[3] == E_local * capacity).sum())))
        return out

    monkeypatch.setattr(moe, "_dispatch", rec)
    _profiled(lambda: _generate(eng, *_prompts(B=4, S=16)))
    c = scopes.counters()
    assert len(seen) == eng.model.cfg.n_layers * (MAX_NEW + 1)
    assert c == {"moe.pairs": sum(s[0] for s in seen), "moe.dropped": sum(s[1] for s in seen)}
    assert c["moe.dropped"] > 0
    assert scopes.counters() == c                 # reduced once, then kept as integers
    scopes.reset_counters()
    assert scopes.counters() == {}


def test_kept_tensors_are_bounded_without_a_read(monkeypatch):
    """Profiling many MoE calls without reading the counters holds at most
    ``_HELD_MAX`` bytes of kept tensors, lets them go at the first call after
    recording ends, and still counts every dropped pair."""
    eng = _engine("moe", capacity_factor=0.5)
    prompts, plens = _prompts(B=4, S=16)
    _profiled(lambda: _generate(eng, prompts, plens))
    want = scopes.counters()
    assert want["moe.dropped"] > 0
    scopes.reset_counters()
    monkeypatch.setattr(scopes, "_HELD_MAX", 3 * prompts.size * 2 * 8)   # three prefill slots
    held = []

    def calls():
        for _ in range(6):
            _generate(eng, prompts, plens)
            held.append(sum(t.numel() * t.element_size() for _, t, _ in scopes._PENDING))

    _profiled(calls)
    assert 0 < max(held) <= scopes._HELD_MAX and scopes._FOLDED
    scopes.count_equal("moe.dropped", torch.zeros(3, dtype=torch.long), 1)   # recording off
    assert scopes._PENDING == [] and scopes._held == 0
    got = scopes.counters()
    assert got == {k: 6 * v for k, v in want.items()}


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_outputs_bit_identical_with_recording_on(family):
    eng = _engine(family)
    prompts, plens = _prompts()
    d = eng.model.cfg.d_model
    pcfg = PredictorConfig(n_bins=16, hidden=32, bin_max=64.0)
    pred = LengthPredictor(params=head_init(3, d, 32, 16, device="cpu"),
                           edges=bins.make_edges(16, 64.0, "linear", device="cpu"), pcfg=pcfg)

    def run():
        out = _generate(eng, prompts, plens)
        probs, quants = pred.quantiles(torch.as_tensor(out["phi"]), (0.5, 0.9))
        return out, probs, quants

    off = run()
    on, events = _profiled(run)
    assert Counter(e.name for e in _spans(events))["head.quantiles"] == 1
    for k in ("lengths", "tokens", "phi"):
        assert np.array_equal(off[0][k], on[0][k]), k
    assert torch.equal(off[1], on[1]) and torch.equal(off[2], on[2])


def test_counting_adds_no_tensor_op(monkeypatch):
    eng = _engine("moe", capacity_factor=0.5)
    prompts, plens = _prompts(B=4, S=16)
    ops = lambda events: [e.name for e in events if not e.name.startswith(PREFIXES)]
    _, counted = _profiled(lambda: _generate(eng, prompts, plens))
    assert scopes.counters()["moe.dropped"] > 0
    monkeypatch.setattr(scopes, "count", lambda *a, **k: None)
    monkeypatch.setattr(scopes, "count_equal", lambda *a, **k: None)
    _, uncounted = _profiled(lambda: _generate(eng, prompts, plens))
    assert ops(counted) == ops(uncounted) and len(ops(counted)) > 100


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_device_profile_counts_no_span_as_a_kernel():
    """On the card the spans become device ranges of their own
    (user annotations); chip_smoke.py's profile counts only the kernels,
    copies and sets, as many as the chrome trace holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the GPU)")
    import json
    import tempfile
    from torch.autograd import DeviceType
    eng = _engine("moe", device="cuda")
    prompts, plens = _prompts()
    fn = lambda: _generate(eng, prompts, plens)
    got = _chip_smoke().device_profile(fn, "tiny moe generate")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    assert any(e.is_user_annotation and e.device_type == DeviceType.CUDA
               and e.key == "model.decode_step" for e in prof.key_averages())
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/t.json")
        with open(f"{tmp}/t.json") as f:
            cats = Counter(e.get("cat") for e in json.load(f)["traceEvents"] if e.get("ph") == "X")
    assert cats["gpu_user_annotation"] > 0
    assert got["launches"] == cats["kernel"] + cats["gpu_memcpy"] + cats["gpu_memset"]
    assert "head.levels" in {e.name for e in _profiled_cuda_head(eng)}


def _profiled_cuda_head(eng):
    d = eng.model.cfg.d_model
    pred = LengthPredictor(params=head_init(3, d, 32, 16, device="cuda"),
                           edges=bins.make_edges(16, 64.0, "linear", device="cuda"),
                           pcfg=PredictorConfig(n_bins=16, hidden=32, bin_max=64.0))
    phi = torch.zeros((2, d), device="cuda")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.quantiles(phi, (0.5, 0.9))
    return prof.events()
