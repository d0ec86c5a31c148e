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


# what the plain reference may import: the standard library's pieces, torch,
# and the harness's modules that themselves import nothing of the port
PLAIN = {"__future__", "math", "contextlib", "dataclasses", "typing", "types", "torch"}
HARNESS_FOR_REFERENCE = {"reference", "model", "flops", "common"}
STDLIB = {"importlib", "json", "os", "pathlib", "subprocess", "sys"}


def _harness_modules(path: Path):
    """The harness modules a source imports (``from harness import x``,
    ``from harness.x import ...``, ``import harness.x``)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            parts = node.module.split(".")
            if parts[0] == "harness":
                yield from ([parts[1]] if len(parts) > 1 else [a.name for a in node.names])
        elif isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if parts[0] == "harness":
                    yield parts[1] if len(parts) > 1 else "harness"


def _reference_sources():
    return [BENCH / "harness" / "reference.py"] + sorted((BENCH / "arch").glob("*.py"))


def test_reference_imports_nothing_of_the_port():
    """The base reference and every architecture's module (its reference
    and its counts) import torch, the standard library's pieces and the
    harness's plain modules (``common`` to load another architecture by
    name), which in turn import nothing of the port."""
    assert len(_reference_sources()) >= 2
    for p in _reference_sources():
        assert set(_imports(p)) <= PLAIN | {"harness"}, p
        assert set(_harness_modules(p)) <= HARNESS_FOR_REFERENCE, p
    for name in HARNESS_FOR_REFERENCE:
        p = BENCH / "harness" / f"{name}.py"
        assert set(_imports(p)) <= PLAIN | STDLIB | {"numpy", "harness"}, p
        assert set(_harness_modules(p)) <= HARNESS_FOR_REFERENCE, p


def test_no_read_of_the_jax_package_benchmarks():
    for p in _sources():
        text = p.read_text()
        assert "BENCH_serving" not in text and "benchmarks/" not in text, p
