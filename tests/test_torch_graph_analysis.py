"""The port's graph analyzer (launch/graph_analysis.py), the counterpart of
the reference's HLO analyzer: its FLOP and ring-model collective arithmetic
on the reference's HLO_SAMPLE program, traced as a loop of 10 matmuls with an
all-reduce each and one all-gather, under a fake process group; a
``fusedkernel_`` scope lowering bytes and keeping FLOPs; and its FLOPs on a
traced tiny prefill against torch's FlopCounterMode on the same call."""

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.common.scopes import scope  # noqa: E402
from repro_torch.launch import graph_analysis as G  # noqa: E402


@pytest.fixture(scope="module")
def mesh16():
    from repro_torch.launch.dryrun import _MESHES, open_fake_group
    from repro_torch.launch.mesh import Mesh

    open_fake_group(16)
    yield Mesh((16,), ("data",))
    dist.destroy_process_group()
    _MESHES.clear()


def _sample(mesh, kernel_scope=False):
    def f(a, w):
        x = mesh.all_gather(a, 0, ("data",))[:8, :128]          # f32[128, 256] gathered
        for _ in range(10):
            with scope("fusedkernel_flash_attention") if kernel_scope else scope("plain"):
                x = x @ w
            x = mesh.all_reduce(x, ("data",))
        return x
    return G.trace(f, torch.zeros(8, 256), torch.zeros(128, 128))


def test_flops_and_ring_bytes_of_the_reference_sample(mesh16):
    st = G.analyze(_sample(mesh16))
    assert st.flops == pytest.approx(10 * 2 * 8 * 128 * 128)
    assert st.coll_bytes["all-reduce"] == pytest.approx(10 * 2 * 8 * 128 * 4)
    assert st.coll_bytes["all-gather"] == pytest.approx(128 * 256 * 4)
    assert st.coll_counts["all-reduce"] == 10 and st.coll_counts["all-gather"] == 1
    assert st.as_dict()["total_bytes"] == st.total_coll_bytes
    assert st.expert_parallel.flops == 0


def test_kernel_scope_lowers_bytes_and_keeps_flops(mesh16):
    st0 = G.analyze(_sample(mesh16))
    st1 = G.analyze(_sample(mesh16, kernel_scope=True))
    assert st1.hbm_bytes < st0.hbm_bytes
    assert st1.flops == st0.flops


def test_expert_parallel_scope_is_kept_apart():
    def f(a, b):
        with scope("expert_parallel"):
            c = a @ b
        return c @ b
    st = G.analyze(G.trace(f, torch.zeros(4, 8), torch.zeros(8, 8)))
    assert st.expert_parallel.flops == 2 * 4 * 8 * 8
    assert st.flops == 2 * st.expert_parallel.flops
    assert st.expert_parallel.hbm_bytes == (32 + 64 + 32) * 4


def test_flops_equal_flop_counter_mode_on_a_tiny_prefill():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("tiny-lm").with_overrides(dtype="float32", n_layers=2)
    m = build_model(cfg)
    params = m.init(seed=0, device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(0))
    step = lambda p, t: m.prefill(p, t)[:2]
    with FlopCounterMode(display=False) as fc:
        step(params, tokens)
    assert G.analyze(G.trace(step, params, tokens)).flops == fc.get_total_flops() > 0
