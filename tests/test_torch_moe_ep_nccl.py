"""The expert-parallel MoE over NCCL, one rank per card, and Qwen3-MoE served
through a (1, 4) mesh (marked ``gpu``; skips where fewer than 4 CUDA devices
are visible).

Four workers (``chip_smoke.py --phase ep RANK PORT DIR nccl``, the workers of
``chip_smoke.py``'s ``ep`` phase with the backend as their argument) each
take card RANK: ``torch.cuda.set_device`` before ``init_process_group("nccl",
device_id=...)``, and ``launch/mesh.py``'s ``Mesh`` on ``"cuda"``; a failure
of NCCL fails the test, nothing falls back to gloo. They run the ``ep``
phase's three cases at Qwen3-MoE-235B-A22B's published widths (d=4096, 128
experts top-8 of width 1,536, bf16, T = 4 x 128), forward and backward,
with its checks (``chip_smoke.ep_phase``), then serve the model at 12 of 94
layers through ``RealEngine`` on ``build_model(cfg, mesh=(1, 4) mesh)``: the
sampled tokens the same on every rank at every step, flash, decode and the
head launched on each, one all-reduce over ``model`` per MoE layer a decode
step, rank 0's MoE layers and prefill logits against the single-device path
(``chip_smoke.mesh_serve_report``). Imports neither JAX nor the JAX package.
On a host with four GPUs:

    PYTHONPATH=src python -m pytest -q -s --noconftest -m gpu -p no:cacheprovider \
        tests/test_torch_moe_ep_nccl.py
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.gpu
def test_ep_and_mesh_serve_over_nccl():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 4:
        pytest.skip(f"needs 4 CUDA devices, {n} visible")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from repro_torch.kernels import _build

    _build.build_all()                # the workers load what is built here
    chip_smoke.ep_phase(chip_smoke.kernel_wrappers(), backend="nccl")
