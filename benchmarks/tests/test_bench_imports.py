"""No module under benchmarks/ imports JAX or the JAX package, and the
reference imports nothing of the program (whole top-level names)."""

import ast
import os

import pytest

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "hhsuite_tpu"}


def _py_files(top):
    for d, _sub, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_py_files(tiny.BENCH)),
                         ids=lambda p: os.path.relpath(p, tiny.BENCH))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    top = os.path.join(tiny.BENCH, "reference")
    for path in _py_files(top):
        assert "hhsuite_tpu_torch" not in set(_imports(path)), path
        assert "hhsuite_tpu_torch" not in open(path).read(), path


def test_whole_name_rule():
    from harness.runner import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "hhsuite_tpu_torch".split(".")[0] not in FORBIDDEN
