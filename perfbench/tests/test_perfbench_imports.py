"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``photon_tpu_torch`` is not ``photon_tpu``), and the
reference imports nothing of the port."""

import ast
import pathlib

import pytest

from perfbench import spec

FILES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not _imports(path) & set(spec.FORBIDDEN_MODULES)


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").rglob("*.py"):
        assert not _imports(path) & {"photon_tpu_torch", "photon_tpu", "jax", "flax"}, path


def test_top_level_names_compare_whole():
    assert spec.forbidden_modules({"photon_tpu_torch": 1, "photon_tpu_torch.serve": 1,
                                   "jaxtyping": 1}) == []
    assert spec.forbidden_modules({"jax.numpy": 1, "photon_tpu.ops": 1, "flax": 1}) == [
        "flax", "jax.numpy", "photon_tpu.ops"]
