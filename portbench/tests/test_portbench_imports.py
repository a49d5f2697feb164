"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port.  Names are compared whole by their
top-level part: the port's name begins with the JAX package's."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "dmlc_core_tpu"}


def _modules():
    for root, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(_modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    bad = sorted(set(_imports(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [p for p in _modules()
                                  if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_no_port(path):
    assert "dmlc_core_tpu_torch" not in set(_imports(path))


def test_names_compared_whole():
    assert "dmlc_core_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax_extras" not in FORBIDDEN
