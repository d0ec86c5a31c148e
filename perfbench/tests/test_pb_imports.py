"""What the benchmark's sources may import and read: no JAX and no JAX
package of this repository (``repro``, compared by whole top-level name),
nothing of the port in the reference, and none of the JAX package's
benchmark outputs."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def test_no_jax_nor_the_jax_package():
    for p in _sources():
        bad = set(_imports(p)) & FORBIDDEN
        assert not bad, f"{p} imports {bad}"


def test_whole_names_are_compared():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert any(n == "repro_torch" for p in _sources() for n in _imports(p))


def test_reference_imports_nothing_of_the_port():
    ref = BENCH / "harness" / "reference.py"
    assert set(_imports(ref)) <= {"__future__", "math", "contextlib", "dataclasses",
                                  "typing", "torch"}


def test_no_read_of_the_jax_package_benchmarks():
    for p in _sources():
        text = p.read_text()
        assert "BENCH_serving" not in text and "benchmarks/" not in text, p
