"""The port's sharding rules (common/sharding.py) against the reference's
(repro/common/sharding.py): the reference's own resolve_spec cases, generated
(axes, shape, mesh) cases, and every parameter and cache leaf of the 13
configs on both production meshes, where each port leaf resolves to the
reference's spec of the stacked leaf it is a layer of (the reference's
leading ``layers`` axis maps to None). Also shard_shape / shard_tensor."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import flat_leaves, jax, port_layout  # noqa: E402

from repro.common import sharding as jsharding  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro_torch.common import sharding  # noqa: E402
from repro_torch.common.sharding import P  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models.layers import ParamSpec  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402


class FakeMesh:
    """Shape-only stand-in (the reference's tests/test_sharding_and_hlo.py)."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.coords = {a: 0 for a in axes}

    def axis_index(self, axis):
        return self.coords[axis]


POD = dict(data=16, model=16)
MULTIPOD = dict(pod=2, data=16, model=16)

# the reference's TestResolveSpec cases: (mesh, rules, axes, shape, spec)
CASES = [
    (POD, {"batch": "data", "heads": "model", "seq": None}, ("batch", "seq", "heads"),
     (256, 4096, 64), ("data", None, "model")),
    (POD, {"batch": "data", "kv": "model"}, ("batch", "kv"), (256, 8), ("data",)),
    (POD, {"batch": "data"}, ("batch",), (1,), ()),
    (POD, {"a": "model", "b": "model"}, ("a", "b"), (64, 64), ("model",)),
    (MULTIPOD, {"batch": ("pod", "data")}, ("batch",), (32,), (("pod", "data"),)),
    # P(("pod",)) is stored as P("pod"), in JAX's spec as in the port's
    (MULTIPOD, {"batch": ("pod", "data")}, ("batch",), (2,), ("pod",)),
]


@pytest.mark.parametrize("mesh,rules,axes,shape,want", CASES)
def test_reference_resolve_cases(mesh, rules, axes, shape, want):
    got = sharding.resolve_spec(axes, shape, FakeMesh(**mesh), rules)
    ref = jsharding.resolve_spec(axes, shape, FakeMesh(**mesh), rules)
    assert tuple(got) == want == tuple(ref)
    assert isinstance(got, tuple)


@pytest.mark.parametrize("mesh", [POD, MULTIPOD, dict(data=2, model=2), dict(data=1, model=4)],
                         ids=["pod", "multipod", "2x2", "1x4"])
def test_default_rules_are_the_references(mesh):
    m = FakeMesh(**mesh)
    for cp in (False, True):
        assert sharding.default_rules(m, context_parallel=cp) == \
            jsharding.default_rules(m, context_parallel=cp)


@pytest.mark.parametrize("seed", range(4))
def test_generated_cases_resolve_as_the_references(seed):
    rng = np.random.default_rng(seed)
    names = ["batch", "embed", "heads", "kv_heads", "ffn", "vocab", "experts", "embed_fsdp",
             "cache_seq", "ssm_heads", "layers", None]
    for _ in range(200):
        mesh = FakeMesh(**[POD, MULTIPOD, dict(data=4, model=2)][rng.integers(3)])
        rules = jsharding.default_rules(mesh, context_parallel=bool(rng.integers(2)))
        rank = int(rng.integers(1, 5))
        axes = tuple(names[i] for i in rng.integers(len(names), size=rank))
        shape = tuple(int(d) for d in rng.choice([1, 2, 3, 8, 16, 24, 32, 48, 512], size=rank))
        got = sharding.resolve_spec(axes, shape, mesh, rules)
        assert tuple(got) == tuple(jsharding.resolve_spec(axes, shape, mesh, rules)), \
            (axes, shape, mesh.shape)


def _stacked(port_spec, ref_spec, stacked):
    """The reference's spec of the stacked leaf, from the port's leaf's."""
    return (tuple(port_spec) and (None,) + tuple(port_spec)) if stacked else tuple(port_spec)


def _check(port_specs, ref_specs, cfg, mesh, rules):
    ref_flat = dict(flat_leaves(port_layout(ref_specs, cfg),
                                lambda x: isinstance(x, jlayers.ParamSpec)))
    port_flat = dict(flat_leaves(port_specs, lambda x: isinstance(x, ParamSpec)))
    assert list(port_flat) == list(ref_flat)
    for path, s in port_flat.items():
        r = ref_flat[path]
        stacked = len(r.shape) == len(s.shape) + 1
        assert r.axes == (("layers",) + s.axes if stacked else s.axes), path
        assert tuple(r.shape) == ((r.shape[0],) + s.shape if stacked else s.shape), path
        got = sharding.resolve_spec(s.axes, s.shape, mesh, rules)
        want = jsharding.resolve_spec(r.axes, r.shape, mesh, rules)
        assert _stacked(got, want, stacked) == tuple(want), (path, got, want)


@pytest.mark.parametrize("mesh", [POD, MULTIPOD], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", list_archs())
def test_every_param_leaf_resolves_as_the_references(arch, mesh):
    m = FakeMesh(**mesh)
    _check(build_model(get_config(arch)).spec(), jbuild_model(jget_config(arch)).spec(),
           get_config(arch), m, sharding.default_rules(m))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mesh", [POD, MULTIPOD], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", list_archs())
def test_every_cache_leaf_resolves_as_the_references(arch, mesh, kv_quant):
    m = FakeMesh(**mesh)
    cfg = get_config(arch)
    for batch, cache_len, cp in ((128, 32_768, False), (1, 524_288, True)):
        rules = sharding.default_rules(m, context_parallel=cp)
        _check(build_model(cfg).cache_specs(batch, cache_len, kv_quant),
               jbuild_model(jget_config(arch)).cache_specs(batch, cache_len, kv_quant),
               cfg, m, rules)


def test_model_axes_and_shapes_follow_the_specs():
    m = build_model(get_config("qwen3-moe-235b-a22b"))
    shapes, axes = m.param_shapes(), m.param_axes()
    assert axes["layers"][0]["moe"]["w_down"] == ("experts", "expert_ffn", "embed_fsdp")
    w = shapes["layers"][0]["moe"]["w_gate"]
    assert tuple(w.shape) == (128, 4096, 1536) and w.dtype == torch.bfloat16
    c = m.cache_shapes(8, 64, kv_quant=True)[0]
    assert [t.dtype for t in c] == [torch.int8, torch.int8, torch.float32, torch.float32]
    assert m.cache_axes(kv_quant=True)[0][2] == ("batch", "cache_seq", "cache_kv_heads")


def test_shard_shape_and_shard_tensor():
    mesh = FakeMesh(pod=2, data=2, model=4)
    spec = P(("pod", "data"), None, "model")
    assert sharding.shard_shape((8, 3, 16), spec, mesh) == (2, 3, 4)
    t = torch.arange(8 * 3 * 16).reshape(8, 3, 16)
    mesh.coords = {"pod": 1, "data": 0, "model": 3}
    # (pod, data) index 1 * 2 + 0 = 2 -> rows 4:6; model 3 -> cols 12:16
    assert torch.equal(sharding.shard_tensor(t, spec, mesh), t[4:6, :, 12:16])
    from repro_torch.common.pytree import tree_shapes, tree_zeros_like_spec
    stand_in = tree_shapes({"a": [t.float()]})
    z = tree_zeros_like_spec(stand_in)
    assert z["a"][0].shape == t.shape and not z["a"][0].any()
