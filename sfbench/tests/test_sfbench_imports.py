"""Nothing under sfbench/ imports JAX or the JAX package, compared by
whole top-level names (`staticfusion_tpu_torch` is not
`staticfusion_tpu`); the reference imports nothing of the port either."""

import ast
import sys
from pathlib import Path

from sfbench import harness

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _imports(path) & set(harness.FORBIDDEN)
        assert not bad, f"{path}: imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = _imports(path)
        assert "staticfusion_tpu_torch" not in names, path
        other = names - set(sys.stdlib_module_names)
        assert other <= {"numpy", "torch", "sfbench"}, (path, other)


def test_the_check_compares_whole_names():
    assert harness.forbidden_modules(
        ["staticfusion_tpu_torch", "staticfusion_tpu_torch.pipeline",
         "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "staticfusion_tpu.config", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "staticfusion_tpu"]
