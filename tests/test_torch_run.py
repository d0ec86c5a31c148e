"""The port's benchmark runner (``launch/run.py``) against the reference's
``benchmarks/run.py``, on the CPU: the theory entry prints the reference's
CSV rows, names and values; the kernel rows keep the reference's names; the
roofline entry emits the reference's two rows over the dry-run's results."""

import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax  # noqa: E402,F401  (skips without JAX)

from benchmarks import run as jrun  # noqa: E402
from repro_torch.launch import run  # noqa: E402


def _csv(text, prefix):
    return [line for line in text.splitlines() if line.startswith(prefix)]


def test_theory_rows_are_the_references(monkeypatch, capsys):
    rows = run.main(["--only", "theory", "--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["run.py", "--only", "theory"])
    jrun.main()
    want = capsys.readouterr().out
    assert _csv(got, "theory_") == _csv(want, "theory_")
    assert len(rows) == 5 and [f"{n},{v},{d}" for n, v, d in rows] == _csv(want, "theory_")
    assert got.splitlines()[0] == want.splitlines()[0] == "== Theorem 1 / Lemma 3 =="


def test_kernel_rows_keep_the_reference_names(monkeypatch):
    """The bench's rows pass through under their names (the bench itself is
    held to the reference's in tests/test_torch_bench_kernels.py)."""
    from repro_torch.launch import bench_kernels

    names = [c.row for c in bench_kernels.cases("cpu")]
    monkeypatch.setattr(bench_kernels, "run", lambda device: {n: 1.0 for n in names})
    rows = run.main(["--only", "kernels", "--device", "cpu"])
    assert rows == [(n, "1.0", "us_per_call (plain/cpu)") for n in names]


def test_roofline_exits_naming_the_unported_item(tmp_path, capsys):
    """The name is from before the dry-run was ported, when this entry was
    refused; it now emits the reference's two rows (benchmarks/run.py's
    roofline entry), here over a directory with no results in it (the
    counts over real ones: tests/test_torch_dryrun.py)."""
    rows = run.main(["--only", "roofline", "--device", "cpu", "--dryrun-dir", str(tmp_path)])
    assert rows == [("roofline_pod_combos_ok", "0/0", "traced on 16x16"),
                    ("roofline_multipod_combos_ok", "0/0", "2x16x16")]
    assert "== Roofline (from dry-run artifacts) ==" in capsys.readouterr().out


def test_unknown_entry_is_refused():
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "nope", "--device", "cpu"])
    assert e.value.code == 2
