"""What the benchmark imports: nothing under perfbench/ imports JAX or
the JAX package, and the reference imports nothing of the program. Top-
level module names are compared whole: jepsen_tpu_torch, the program,
begins with jepsen_tpu, the JAX package."""

import ast

import pytest
from harness import cell

FORBIDDEN = {"jax", "jaxlib", "flax", "jepsen_tpu"}
SOURCES = sorted(cell.PERFBENCH.rglob("*.py"))


def top_level_imports(path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(cell.PERFBENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (cell.PERFBENCH / "reference").rglob("*.py"):
        tops = top_level_imports(path)
        assert not {t for t in tops if t.startswith("jepsen")}, path
        assert tops <= {"__future__", "zlib"}, (path, tops)


def test_the_names_are_compared_whole():
    import sys

    sys.path.insert(0, str(cell.PERFBENCH))
    import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    probes = ("jepsen_tpu_torch_probe", "jepsen_tpu.probe")
    try:
        for p in probes:
            sys.modules[p] = object()
        assert run.forbidden_modules() == ["jepsen_tpu.probe"]
    finally:
        for p in probes:
            sys.modules.pop(p, None)
