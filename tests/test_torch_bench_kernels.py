"""The kernel bench on the port (``launch/bench_kernels.py``) against the
reference's ``benchmarks/bench_kernels.py``, on the CPU: its rows, its plain
outputs at the reference's four shapes against the reference's
``ops.*(impl="xla")`` on the same numpy inputs, at ``tests/test_kernels.py``'s
tolerances, and its bound against arithmetic by hand."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import CPU, close, jax, jnp  # noqa: E402,F401  (skips without JAX)

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.launch import bench_kernels as bk  # noqa: E402

# the reference's row names, in its order
ROWS = re.findall(r'rows\["(\w+)"\] = ', (Path(__file__).resolve().parents[1] / "benchmarks"
                                          / "bench_kernels.py").read_text())


@pytest.fixture(scope="module")
def cases():
    return {c.row: c for c in bk.cases(CPU)}


def test_run_on_the_cpu_gives_the_reference_rows():
    assert len(ROWS) == 4
    rows = bk.run(device="cpu", iters=1, verbose=False)
    assert list(rows) == ROWS
    assert all(isinstance(us, float) and us > 0 for us in rows.values())


def test_inputs_are_the_reference_shapes_and_scales():
    inp = bk.inputs()
    assert [a.shape for a in inp["flash_attention_512"]] == [(2, 512, 8, 64), (2, 512, 2, 64),
                                                             (2, 512, 2, 64)]
    q, k, v, lens = inp["decode_attention_4k"]
    assert (q.shape, k.shape, lens.dtype) == ((8, 8, 64), (8, 4096, 2, 64), np.int32)
    assert (lens == 4096).all()
    x, dt, a, Bm, Cm = inp["ssd_scan_512"]
    assert (x.shape, dt.shape, Bm.shape) == ((2, 512, 8, 32), (2, 512, 8), (2, 512, 32))
    assert (dt > 0).all() and np.array_equal(a, (-0.5 * dt).astype(np.float32))
    phi, w1, b1, w2, b2, edges = inp["prod_head_128x1024"]
    assert (phi.shape, w1.shape, w2.shape) == ((128, 1024), (1024, 512), (512, 64))
    assert 0.04 < w1.std() < 0.06 and not b1.any() and not b2.any()
    np.testing.assert_array_equal(edges, np.linspace(0, 8192.0, 65).astype(np.float32))
    # one seed, the same arrays
    assert all(np.array_equal(u, w) for r in ROWS
               for u, w in zip(inp[r], bk.inputs()[r]))


@pytest.mark.parametrize("row", ROWS)
def test_plain_outputs_match_the_reference(row, cases):
    """What ``measure`` holds each kernel against, at the reference's shape,
    is the reference's XLA path on the same inputs."""
    c = cases[row]
    got = c.plain()
    inp = [jnp.asarray(a) for a in bk.inputs()[row]]
    if row == "flash_attention_512":
        close(got, jops.flash_attention(*inp, impl="xla"), 2e-5, 2e-5)
    elif row == "decode_attention_4k":
        close(got, jops.decode_attention(*inp, impl="xla"), 2e-5, 2e-5)
    elif row == "ssd_scan_512":
        y, h = jops.ssd_scan(*inp, impl="xla")
        close(got[0], y, 2e-4, 2e-4)
        close(got[1], h, 2e-4, 2e-4)
    else:
        probs, median = jops.prod_head(*inp, impl="xla")
        close(got[0], probs, 1e-5, 1e-6)
        close(got[1][:, 0], median, 1e-4, 1e-3)
    # the call the bench times is the plain version on the CPU
    assert all(torch.equal(a, b) for a, b in zip(bk._outputs(got), bk._outputs(c.call())))


def test_bound_matches_arithmetic_by_hand(cases):
    # decode: K and V of 8 x 4,096 keys x 2 heads x 64 fp32, q and the output
    # 8 x 8 x 64 each, 8 lengths; 4 FLOPs per (query head, key, channel)
    d = cases["decode_attention_4k"]
    nbytes = 2 * 8 * 4096 * 2 * 64 * 4 + 2 * 8 * 8 * 64 * 4 + 8 * 4
    assert (d.nbytes, d.flops) == (nbytes, 4 * 8 * 8 * 4096 * 64)
    assert bk.bound(d.nbytes, d.flops, bk.FP32_FLOPS) == (nbytes / 3.35e12 * 1e3, "bytes")
    # causal flash: 2 x 8 heads x 512 * 513 / 2 (query, key) pairs x 64 x 4 FLOPs
    f = cases["flash_attention_512"]
    flops = 2 * 8 * (512 * 513 // 2) * 64 * 4
    assert f.flops == flops
    assert bk.bound(f.nbytes, f.flops, bk.FP32_FLOPS) == (flops / 67e12 * 1e3, "operations")
