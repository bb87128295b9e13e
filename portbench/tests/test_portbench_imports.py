"""No module under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(HERE.rglob("*.py"))
NEVER = {"jax", "jaxlib", "flax", "frad_python_tpu"}


def top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(str(arg.value).partition(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_names(path) & NEVER


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "frad_python_tpu_torch" not in top_names(path)
    assert not top_names(path) & {"portbench"}


def test_whole_names_compared():
    assert "frad_python_tpu" not in {"frad_python_tpu_torch"}
    assert top_names(HERE / "drivers" / "__init__.py") & {"numpy"}
