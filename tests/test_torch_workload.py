"""The port's dry-run workload (launch/workload.py) against the reference's
(repro/launch/workload.py): per-shape configs and the head padding for every
arch, the input and head stand-ins (shapes, dtypes, logical axes) for every
arch x shape, the optimizer-state axes in the port's layout, the variants
(the reference's but those that set a knob the port does not read),
and the PartitionSpecs build_steps gives each argument on a mesh."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import flat_leaves, is_axes, jax, port_layout  # noqa: E402

from repro.common.config import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import ASSIGNED_ARCHS as JASSIGNED  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import workload as jworkload  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro_torch.common.config import INPUT_SHAPES, ModelConfig, get_input_shape  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_archs  # noqa: E402
from repro_torch.launch import workload  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

SHAPES = [s.name for s in INPUT_SHAPES]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _theirs(want, keys):
    """The reference config's values of ``keys``: a field the port has and
    the reference lacks is held to its default."""
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    return {k: getattr(want, k, defaults[k]) for k in keys}


def test_shapes_and_archs_are_the_references():
    assert [dataclasses.astuple(s) for s in INPUT_SHAPES] == \
        [dataclasses.astuple(s) for s in JSHAPES]
    assert ASSIGNED_ARCHS == JASSIGNED
    # the reference's variants but those that set a knob the port does not
    # read (causal_skip, seq_shard), each with the reference's settings
    unread = {"causal_skip", "seq_shard"}
    assert workload.VARIANTS == {k: v for k, v in jworkload.VARIANTS.items()
                                 if not unread & set(v)}
    assert set(jworkload.VARIANTS) - set(workload.VARIANTS) == \
        {"causal_skip", "seqpar", "train_opt", "train_tight"}
    with pytest.raises(KeyError):
        get_input_shape("nope")


@pytest.mark.parametrize("arch", list_archs())
def test_cfg_for_shape_and_padding(arch):
    for name in SHAPES:
        got = workload.cfg_for_shape(get_config(arch), get_input_shape(name))
        want = jworkload.cfg_for_shape(jget_config(arch), jworkload.InputShape(
            *dataclasses.astuple(get_input_shape(name))))
        assert _fields(got) == _theirs(want, _fields(got))
        padded = workload.tpu_shardable_cfg(got, 16)
        jpadded = jworkload.tpu_shardable_cfg(want, 16)
        assert _fields(padded) == _theirs(jpadded, _fields(padded))
    tcfg, jtcfg = (workload.train_cfg_for(get_config(arch)),
                   jworkload.train_cfg_for(jget_config(arch)))
    assert (tcfg.optimizer, tcfg.schedule, tcfg.stable_steps, tcfg.remat) == \
        (jtcfg.optimizer, jtcfg.schedule, jtcfg.stable_steps, jtcfg.remat)


def _same_stand_ins(specs, axes, jspecs, jaxes):
    assert list(specs) == list(jspecs) and axes == jaxes
    for k, t in specs.items():
        assert tuple(t.shape) == tuple(jspecs[k].shape), k
        assert str(t.dtype).replace("torch.", "") == str(jspecs[k].dtype), k


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape", SHAPES)
def test_input_and_head_stand_ins(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s = get_input_shape(shape)
    _same_stand_ins(*workload.input_specs(cfg, s),
                    *jworkload.input_specs(jcfg, jworkload.InputShape(*dataclasses.astuple(s))))
    _same_stand_ins(*workload.head_specs(cfg), *jworkload.head_specs(jcfg))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["yi-34b", "zamba2-1.2b", "gemma3-27b", "kimi-k2-1t-a32b",
                                  "whisper-large-v3"])
def test_opt_state_axes_in_the_ports_layout(arch, optimizer):
    cfg = get_config(arch)
    got = workload.opt_state_axes(build_model(cfg).param_axes(), optimizer, cfg)
    want = jworkload.opt_state_axes(jbuild_model(jget_config(arch)).param_axes(), optimizer)
    if optimizer == "adamw":
        for key in ("m", "v"):
            ref = dict(flat_leaves(port_layout(want[key], cfg), is_axes))
            assert list(got[key]) == list(ref)
            for path, ax in got[key].items():
                assert ref[path] in (ax, ("layers",) + ax), path
        return
    ref = dict(flat_leaves(port_layout(want, cfg), lambda x: isinstance(x, dict) and (
        "v" in x or "vr" in x)))
    for first, st in got.items():
        assert st == ref[first], first


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_build_steps_specs_on_the_production_mesh(kind):
    """The PartitionSpecs build_steps resolves for the full-size Qwen3-MoE on
    a shape-only pod mesh: expert weights over (model, data), the embedding
    over model, the Adafactor statistics ZeRO-sharded, the batch over data."""
    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 16}

    cfg = get_config("qwen3-moe-235b-a22b")
    built = workload.build_steps(cfg, get_input_shape(kind), mesh=FakeMesh())
    assert len(built["arg_specs"]) == len(built["arg_axes"]) == len(built["arg_pspecs"])
    pspecs = built["arg_pspecs"][0]["params"] if kind == "train_4k" else built["arg_pspecs"][0]
    assert tuple(pspecs["layers"][0]["moe"]["w_gate"]) == ("model", "data")
    assert tuple(pspecs["embed"]) == ("model",)
    if kind == "train_4k":
        # Adafactor (235 B parameters): the stacked leaf's row statistics
        vr = built["arg_pspecs"][0]["opt_state"]["layers/0/moe/w_gate"]["vr"]
        assert tuple(vr) == (None, "model", "data")
    batch = built["arg_pspecs"][-1] if kind != "decode_32k" and kind != "long_500k" \
        else built["arg_pspecs"][2]
    assert tuple(batch["tokens"])[:1] == (("data",) if kind != "long_500k" else ())
