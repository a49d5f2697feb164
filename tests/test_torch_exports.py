"""The port's packages export the JAX package's names, and its host-side
packages import no torch.

- For the top level and every subpackage, each public name that the JAX
  ``__init__`` binds (by import from the package, definition, assignment
  or ``__all__``) resolves on the port's matching package, so code written
  against ``dmlc_core_tpu`` runs on the port by renaming the package.  The names
  are read from the JAX ``__init__``'s source, so the JAX package is not
  imported for them.
- In a fresh interpreter, importing the port's top level, ``data``,
  ``io``, ``utils``, ``config``, ``json_io`` and ``serializer`` leaves
  ``torch`` and ``jax`` out of ``sys.modules``: a spawned parse worker
  imports these and must start cheap, as the JAX package's do.
"""

import ast
import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUBPACKAGES = ["", "bridge", "collective", "models", "ops", "data",
               "parallel", "utils", "io", "fault", "telemetry", "serve",
               "train", "tracker"]

TORCH_FREE = ["dmlc_core_tpu_torch", "dmlc_core_tpu_torch.data",
              "dmlc_core_tpu_torch.io", "dmlc_core_tpu_torch.utils",
              "dmlc_core_tpu_torch.config", "dmlc_core_tpu_torch.json_io",
              "dmlc_core_tpu_torch.serializer"]


def _bound_names(sub):
    """Public names the JAX package's ``__init__`` binds."""
    path = os.path.join(REPO, "dmlc_core_tpu", sub, "__init__.py")
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = set()
    for node in tree.body:
        if (isinstance(node, ast.ImportFrom)
                and (node.module or "").startswith("dmlc_core_tpu")):
            names.update(alias.asname or alias.name for alias in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
            if any(isinstance(t, ast.Name) and t.id == "__all__"
                   for t in targets):
                value = node.value
                if isinstance(value, ast.BinOp):   # list(...) + [...]
                    value = value.right
                if isinstance(value, (ast.List, ast.Tuple)):
                    names.update(e.value for e in value.elts
                                 if isinstance(e, ast.Constant))
    # the lazy PEP 562 names of ``parallel`` sit in a tuple constant
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Tuple)
                and all(isinstance(e, ast.Constant)
                        for e in node.value.elts)):
            names.update(e.value for e in node.value.elts)
    return sorted(n for n in names if not n.startswith("_"))


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_every_jax_export_resolves_on_the_port(sub):
    names = _bound_names(sub)
    assert names, sub
    port = importlib.import_module(
        "dmlc_core_tpu_torch" + (f".{sub}" if sub else ""))
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_the_names_the_reference_users_import():
    from dmlc_core_tpu_torch import CHECK, JSONReader, Parameter, Registry
    from dmlc_core_tpu_torch.collective import ring_allreduce
    from dmlc_core_tpu_torch.data import create_parser
    from dmlc_core_tpu_torch.models import GBDT
    from dmlc_core_tpu_torch.ops import grad_histogram
    from dmlc_core_tpu_torch.parallel import fleet_ingest, make_mesh
    from dmlc_core_tpu_torch.utils import split_string
    from dmlc_core_tpu_torch.models.gbdt import GBDT as GBDT_
    assert GBDT is GBDT_
    assert all(callable(f) for f in (CHECK, JSONReader, Parameter, Registry,
                                      ring_allreduce, create_parser,
                                      grad_histogram, make_mesh,
                                      split_string))
    assert fleet_ingest.__name__ == "dmlc_core_tpu_torch.parallel.fleet_ingest"


def test_parallel_exports_stay_lazy():
    code = ("import sys, dmlc_core_tpu_torch.parallel as p; "
            "assert 'dmlc_core_tpu_torch.parallel.mesh' not in sys.modules; "
            "assert 'torch' not in sys.modules; p.make_mesh; "
            "assert 'dmlc_core_tpu_torch.parallel.mesh' in sys.modules; "
            "print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


@pytest.mark.parametrize("module", TORCH_FREE)
def test_host_packages_import_no_torch_nor_jax(module):
    code = (f"import sys, {module}; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", f"{module} loads {proc.stdout}"
