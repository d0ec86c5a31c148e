"""The control on the card at each cell's own size: the reference in float8
(the head in TF32) put in the program's place fails the cell's limits on
three seeds, where the program passes them. Several minutes a cell; run on
the card with

    python -m pytest -q -m gpu -p no:cacheprovider perfbench/tests/test_pb_control_gpu.py
"""

import json
import subprocess
import sys

import pytest

import conftest
from harness import check, common

SEEDS = "3100000001,3100000002,3100000003"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in common.benchmark()["workloads"]])
def test_control_fails_at_cell_size(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell,
                          "--limits-readings", SEEDS, "--control", SEEDS],
                         cwd=conftest.ROOT, capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 3
    lim = common.limits(cell)
    for line in lines:
        assert check.judge(line["program"], lim)[0] is True, line
        assert check.judge(line["control"], lim)[0] is False, line
