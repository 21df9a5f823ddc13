"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; names are compared whole by
their first part (``vaudio_torch`` is not ``vaudio``)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vaudio"}


def _imports(path: Path):
    """The top-level name of every module a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax(path):
    assert not FORBIDDEN & set(_imports(path))


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert "vaudio_torch" not in names and "vbench" not in names, path


def test_scan_sees_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import vaudio.x\nfrom jax import numpy\n"
                 "import vaudio_torch\n")
    assert set(_imports(f)) == {"vaudio", "jax", "vaudio_torch"}
