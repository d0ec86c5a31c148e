"""The port's boundary: it imports neither JAX nor the JAX package, it
imports cleanly where JAX cannot be imported, and its entry points refuse to
run quietly on the CPU when no GPU is there and the CPU was not asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_package_imports_with_jax_and_reference_blocked():
    modules = sorted(".".join(p.relative_to(REPO / "src").with_suffix("").parts)
                     for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": str(REPO / "src"),
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    from repro_torch.common.config import PredictorConfig
    from repro_torch.configs import get_config
    from repro_torch.core.bins import make_edges
    from repro_torch.core.heads import head_init
    from repro_torch.core.predictor import train_predictor
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build_model

    model = build_model(get_config("tiny-lm"))
    calls = [lambda: model.init(seed=0),
             lambda: model.init_cache(1, 4),
             lambda: make_edges(8, 64.0),
             lambda: head_init(0, 8, 4, 3),
             lambda: train_predictor(0, np.zeros((4, 8), np.float32),
                                     np.full((4, 3), 1 / 3, np.float32),
                                     PredictorConfig(n_bins=3, hidden=4)),
             lambda: serve.main(["--n-requests", "2"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert make_edges(8, 64.0, device="cpu").device.type == "cpu"


def test_kernel_wrappers_take_only_cuda_tensors():
    """A CUDA kernel wrapper raises on a CPU tensor, before building or
    counting anything."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.prod_head import prod_head_cuda

    before = (prod_head_cuda.launches, flash_attention_cuda.launches,
              decode_attention_cuda.launches)
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        prod_head_cuda(torch.zeros(2, 8), torch.zeros(8, 32), torch.zeros(32),
                       torch.zeros(32, 4), torch.zeros(4), torch.zeros(5), torch.ones(1))
    assert (prod_head_cuda.launches, flash_attention_cuda.launches,
            decode_attention_cuda.launches) == before
