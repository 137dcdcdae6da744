"""What the benchmark's modules import, by top-level module name (the part
before the first dot, compared whole: ``zlibes_tpu_torch`` is the port,
``zlibes_tpu`` its JAX original)."""
import ast

import pytest

from benchlib import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "zlibes_tpu"}
PY = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_imports(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", PY, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = top_imports(path)
    assert "zlibes_tpu_torch" not in tops and not tops & FORBIDDEN
    assert tops <= {"__future__", "zlib", "numpy", "torch"}, tops


def test_only_the_codec_binding_imports_the_port():
    users = {p.relative_to(BENCH).as_posix() for p in PY
             if "zlibes_tpu_torch" in top_imports(p)
             and p.parent.name != "tests"}
    assert users <= {"harness/codec.py", "harness/cell.py",
                     "harness/substitutes.py"}, users


def test_the_top_level_check_compares_whole_names():
    from harness.cell import forbidden_modules
    import sys

    sys.modules.setdefault("zlibes_tpu_torch_lookalike_probe", sys)
    try:
        assert "zlibes_tpu" not in forbidden_modules()
    finally:
        del sys.modules["zlibes_tpu_torch_lookalike_probe"]
