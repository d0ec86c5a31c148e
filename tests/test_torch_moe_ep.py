"""The expert-parallel branch of the port's moe_apply against the reference's
shard_map on 4 host devices.

The reference runs in a subprocess with 4 forced host devices (as
tests/test_perf_variants.py does); the port runs in 4 gloo processes
(tests/_torch_moe_ep_worker.py) on the same numpy inputs: the reduced
Qwen3-MoE at d=64, moe_d_ff=32 and 16 experts (so that the default capacity
can overflow: an expert overflows only where E > 2.5 k), fp32, its tokens
pushed toward expert 0 so that the default capacity drops pairs. Meshes (2, 2)
in both FSDP modes and (1, 4); capacities no-drop (factor 0, slack 1) and
the defaults (1.25, 2.0). Outputs within 1e-5, aux losses within the 1e-6 of
tests/test_torch_moe.py (one ulp apart: the token mean sums in another
order); at no drop each EP output also matches the port's single-device
path, its aux exactly.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = Path(__file__).resolve().parent.parent
D, F, E, B, S = 64, 32, 16, 8, 16
TAGS = [f"{m}_{mode}_{cap}" for m, mode in (("2x2", "gather"), ("2x2", "partial"),
                                           ("1x4", "gather"))
        for cap in ("nodrop", "default")]

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.models.moe import moe_apply
    data = np.load(sys.argv[1])
    cfg = get_config("qwen3-moe-235b-a22b").reduced().with_overrides(
        dtype="float32", d_model=int(data["d"]), moe_d_ff=int(data["f"]),
        n_experts=int(data["E"]))
    p = {k: jnp.asarray(data[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(data["x"])
    out = {}
    for shape, mode in (((2, 2), "gather"), ((2, 2), "partial"), ((1, 4), "gather")):
        mesh = jax.make_mesh(shape, ("data", "model"))
        for cap, (cf, slack) in (("nodrop", (0.0, 1.0)), ("default", (1.25, 2.0))):
            with mesh:
                f = jax.jit(lambda p, x: moe_apply(p, x, cfg, mesh=mesh, capacity_factor=cf,
                                                   cap_slack=slack, fsdp_mode=mode))
                y, aux = f(p, x)
            tag = f"{shape[0]}x{shape[1]}_{mode}_{cap}"
            out["out_" + tag], out["aux_" + tag] = np.asarray(y), np.asarray(aux)
    np.savez(sys.argv[2], **out)
""")


def _inputs(path):
    rng = np.random.default_rng(0)
    router = (rng.standard_normal((D, E)) * 0.02).astype(np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    # most tokens lean toward expert 0, which the default capacity overflows
    x += 12.0 * router[:, 0] / np.linalg.norm(router[:, 0])
    np.savez(path, d=D, f=F, E=E, router=router, x=x.astype(np.float32),
             w_gate=(rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
             w_up=(rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
             w_down=(rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs, ref_out, port_out = tmp / "in.npz", tmp / "ref.npz", tmp / "port.npz"
    _inputs(inputs)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(inputs), str(ref_out)],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = _free_port()
    ranks = [subprocess.Popen([sys.executable, str(REPO / "tests" / "_torch_moe_ep_worker.py"),
                               str(r), str(port), str(inputs), str(port_out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    for proc in ranks + [ref]:
        log, _ = proc.communicate(timeout=110)
        assert proc.returncode == 0, log[-3000:]
    return dict(np.load(ref_out)), dict(np.load(port_out))


@pytest.mark.parametrize("tag", TAGS)
def test_ep_matches_reference_shard_map(outputs, tag):
    ref, port = outputs
    np.testing.assert_allclose(port["out_" + tag], ref["out_" + tag], rtol=0, atol=1e-5)
    # the router is replicated and the port's own (tests/test_torch_moe.py
    # holds it at 1e-6): its mean over the tokens sums in another order
    np.testing.assert_allclose(port["aux_" + tag], ref["aux_" + tag], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tag", [t for t in TAGS if t.endswith("nodrop")])
def test_ep_without_drops_matches_single_device(outputs, tag):
    _, port = outputs
    np.testing.assert_allclose(port["out_" + tag], port["out_single"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port["aux_" + tag], port["aux_single"])


@pytest.mark.parametrize("mesh_mode", ["2x2_gather", "2x2_partial", "1x4_gather"])
def test_default_capacity_drops_pairs(outputs, mesh_mode):
    """The default capacity overflows here, so the same pairs must drop in
    both packages (the parity above) and the output moves off the no-drop one."""
    _, port = outputs
    gap = np.abs(port[f"out_{mesh_mode}_default"] - port[f"out_{mesh_mode}_nodrop"]).max()
    assert gap > 1e-3, gap
