"""Nothing in ``portbench/`` imports JAX, the JAX package or its bench
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference and the frozen copies import nothing of the
program."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "meatmodeler_tpu", "bench"}
FILES = sorted(ROOT.rglob("*.py"))


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                roots.add(node.args[0].value.split(".")[0])
    return roots


def test_the_check_compares_whole_names(tmp_path):
    port, jax_package = tmp_path / "port.py", tmp_path / "jax_package.py"
    port.write_text("import meatmodeler_tpu_torch.ops\nfrom meatmodeler_tpu_torch import pipeline\n")
    jax_package.write_text("from meatmodeler_tpu.ops import clahe\n")
    assert not imported_roots(port) & FORBIDDEN
    assert imported_roots(jax_package) & FORBIDDEN == {"meatmodeler_tpu"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in ("reference", "frozen")],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_and_frozen_stand_alone(path):
    assert "meatmodeler_tpu_torch" not in imported_roots(path)
    assert "meatmodeler_tpu_torch" not in path.read_text()
