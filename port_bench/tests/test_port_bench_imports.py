"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (hibayes_tpu_torch is not hibayes_tpu), and the plain
reference imports nothing of the program."""

import ast
import sys

import pytest

from port_bench import harness

FILES = sorted(harness.BENCH.rglob("*.py"))


def top_level_imports(path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "hibayes_tpu_torch" not in top_level_imports(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hibayes_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hibayes_tpu.engine", object())
    assert harness.forbidden_modules() == ["hibayes_tpu"]
