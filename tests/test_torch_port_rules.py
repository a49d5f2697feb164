"""Rules of the PyTorch port: what it imports, where it runs, what it builds.

Whether a card is present is decided inside each test, never at import.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
from dmlc_core_tpu_torch.ops import _build, hist_cuda
from dmlc_core_tpu_torch.ops.histogram import apply_bins, grad_histogram

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dmlc_core_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _port_files():
    out = [SMOKE]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "dmlc_core_tpu"), \
            f"{os.path.relpath(path, REPO)} imports {name}"


def _package_files():
    return [p for p in _port_files() if p != SMOKE]


def _imports_tests(path):
    return any(name.split(".")[0] == "tests"
               for name in _imported_roots(path))


@pytest.mark.parametrize("path", _package_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_package_imports_no_tests(path):
    """The port's package never imports the repository's ``tests`` (the
    mock object store is for the tests and ``chip_smoke.py`` only)."""
    assert not _imports_tests(path), \
        f"{os.path.relpath(path, REPO)} imports tests"


def test_port_tests_rule_catches_a_tests_import(tmp_path):
    for code, caught in (("from tests.mock_s3 import MockS3", True),
                         ("import tests.mock_s3", True),
                         ("import testsuite", False),
                         ("from dmlc_core_tpu_torch.io import s3_filesys",
                          False)):
        path = tmp_path / "m.py"
        path.write_text(code + "\n")
        assert _imports_tests(str(path)) == caught, code


def _names_repo_native(node):
    """Whether an AST node names the repository's ``native/`` directory: a
    path string through it, or ``os.path.join(..., "native")`` not under
    the port's own ``csrc/`` or ``build/``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if any(c.isspace() for c in node.value):
            return False                # prose, not a path
        parts = node.value.split("/")
        return "native" in parts[:-1] and not {"csrc", "build"} & set(parts)
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"):
        args = node.args
        for i, arg in enumerate(args):
            if isinstance(arg, ast.Constant) and arg.value == "native":
                prev = args[i - 1] if i else None
                if not (isinstance(prev, ast.Constant)
                        and prev.value in ("csrc", "build")):
                    return True
    return False


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_never_loads_or_builds_the_jax_native_library(path):
    """The port builds its own native library from its own copies of the
    sources: it neither opens ``native/libdmlc_tpu_native.so`` nor runs
    ``make`` on the repository's ``native/``."""
    text = open(path, encoding="utf-8").read()
    rel = os.path.relpath(path, REPO)
    assert "libdmlc_tpu_native" not in text, rel
    for node in ast.walk(ast.parse(text, path)):
        assert not (isinstance(node, ast.Constant) and node.value == "make"), \
            f"{rel} runs make"
        assert not _names_repo_native(node), \
            f"{rel} names the repository's native/: {ast.unparse(node)}"


def test_port_rule_catches_the_jax_native_build():
    """The rule above fails on the JAX package's own build and load."""
    with open(os.path.join(REPO, "dmlc_core_tpu", "native_bridge.py"),
              encoding="utf-8") as f:
        jax_bridge = ast.parse(f.read())
    assert any(_names_repo_native(n) for n in ast.walk(jax_bridge))
    assert any(isinstance(n, ast.Constant) and n.value == "make"
               for n in ast.walk(jax_bridge))
    for code, names in (('os.path.join(_PKG, "csrc", "native")', False),
                        ('os.path.join(ROOT, "build", "native")', False),
                        ('os.path.join(ROOT, "native", "Makefile")', True),
                        ('"native/libx.so"', True)):
        assert any(_names_repo_native(n)
                   for n in ast.walk(ast.parse(code))) == names, code


HIST_METHODS = ("pallas", "pallas_fused", "onehot", "scatter")


def _hist_layering_leaks(tree, methods=HIST_METHODS + ("auto",),
                         imports=True):
    """What in a module's AST takes a histogram decision that belongs to
    ``ops/histogram.py``: a comparison with a ``hist_method`` name and,
    with ``imports``, an import of ``ops.hist_cuda``, of ``bin_onehot`` or
    of ``resolve_hist_method``."""
    def strings(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value
        elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                yield from strings(e)

    leaks = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and imports:
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and imports:
            names = [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Compare):
            operands = [node.left] + node.comparators
            if set(methods) & {v for o in operands for v in strings(o)}:
                leaks.append(ast.unparse(node))
            continue
        else:
            continue
        leaks += [n for n in names
                  if n.endswith(("ops.hist_cuda", ".bin_onehot",
                                 ".resolve_hist_method"))
                  or ".ops.hist_cuda." in n]
    return leaks


def test_model_layer_leaves_the_histogram_path_to_the_op_layer():
    """``models/gbdt.py`` takes its histogram plan and leaf sums from
    ``ops/histogram.py``: it imports nothing from ``ops.hist_cuda``,
    neither ``bin_onehot`` nor ``resolve_hist_method``, and compares no
    method name."""
    path = os.path.join(PKG, "models", "gbdt.py")
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    assert _hist_layering_leaks(tree) == []


def test_only_the_op_layer_branches_on_a_hist_method():
    """No module of the port but ``ops/histogram.py`` compares a
    ``hist_method`` name (``"auto"`` names other things too)."""
    leaks = {}
    for path in _package_files():
        if path == os.path.join(PKG, "ops", "histogram.py"):
            continue
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        found = _hist_layering_leaks(tree, HIST_METHODS, imports=False)
        if found:
            leaks[os.path.relpath(path, REPO)] = found
    assert leaks == {}


def test_histogram_layering_rule_catches_a_leak():
    for code, caught in (
            ("from dmlc_core_tpu_torch.ops import hist_cuda", True),
            ("import dmlc_core_tpu_torch.ops.hist_cuda", True),
            ("from dmlc_core_tpu_torch.ops.hist_cuda import segment_sum",
             True),
            ("from dmlc_core_tpu_torch.ops.histogram import bin_onehot",
             True),
            ("from dmlc_core_tpu_torch.ops.histogram import "
             "resolve_hist_method", True),
            ('if method in ("onehot", "pallas"): pass', True),
            ('x = plan.method == "scatter"', True),
            ('x = method != "auto"', True),
            ("from dmlc_core_tpu_torch.ops.histogram import hist_plan",
             False),
            ('x = objective == "logistic"', False),
            ('methods = ["pallas", "scatter"]', False)):
        assert bool(_hist_layering_leaks(ast.parse(code))) == caught, code


# what a spawned parse worker imports (``data.parse_proc`` rebuilds the
# parsers by module path) and the host-side packages around it
WORKER_MODULES = ("dmlc_core_tpu_torch", "dmlc_core_tpu_torch.data",
                  "dmlc_core_tpu_torch.io", "dmlc_core_tpu_torch.utils",
                  "dmlc_core_tpu_torch.config", "dmlc_core_tpu_torch.json_io",
                  "dmlc_core_tpu_torch.serializer",
                  "dmlc_core_tpu_torch.data.parse_proc",
                  "dmlc_core_tpu_torch.data.libsvm_parser",
                  "dmlc_core_tpu_torch.data.libfm_parser",
                  "dmlc_core_tpu_torch.data.csv_parser",
                  "dmlc_core_tpu_torch.data.arrow_ingest",
                  "dmlc_core_tpu_torch.interop")


def test_parse_worker_modules_import_no_torch_nor_jax():
    """Spawned parse workers stay cheap: in a fresh interpreter, the modules
    they import load neither ``torch`` nor ``jax``.  A later re-export that
    pulled torch into ``dmlc_core_tpu_torch.data`` fails here."""
    code = ("import importlib, sys\n"
            f"for m in {WORKER_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "    bad = [r for r in ('torch', 'jax') if r in sys.modules]\n"
            "    assert not bad, (m, bad)\n"
            "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_entry_points_need_a_card_unless_cpu_is_asked():
    x = np.zeros((4, 2), np.float32)
    bounds = np.zeros((2, 3), np.float32)
    if torch.cuda.is_available():
        assert GBDT(GBDTParam(), 2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GBDT(GBDTParam(), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grad_histogram(np.zeros((4, 2), np.int32), np.zeros(4, np.int32),
                       np.zeros(4, np.float32), np.zeros(4, np.float32), 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        apply_bins(x, bounds)
    assert GBDT(GBDTParam(), 2, device="cpu").device.type == "cpu"
    assert not hist_cuda.kernels_available()


def test_kernel_sources_and_build_script_present():
    src = open(_build.SOURCE, encoding="utf-8").read()
    for sym in ("dmlc_hist_matmul", "dmlc_grad_hist_fused",
                "hist_matmul_kernel", "grad_hist_fused_kernel",
                "__float2bfloat16_rn"):
        assert sym in src
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build.LIBRARY.startswith(os.path.join(REPO, "build"))
    gitignore = open(os.path.join(REPO, ".gitignore"),
                     encoding="utf-8").read().split()
    assert "build/" in gitignore


def test_cpu_tensors_take_plain_versions_without_counting():
    rng = np.random.RandomState(0)
    bins = torch.from_numpy(rng.randint(0, 8, (50, 3)).astype(np.uint8))
    node = torch.from_numpy(rng.randint(-1, 3, 50).astype(np.int32))
    g = torch.from_numpy(rng.randn(50).astype(np.float32))
    h = torch.from_numpy(rng.rand(50).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 50).astype(np.float32)).bfloat16()
    hist_cuda.reset_launches()
    want = hist_cuda.grad_hist_ref(bins, node, g, h, 3, 8)
    rows, offsets = hist_cuda.row_partition(node, 3)
    for fn in (hist_cuda.grad_hist_cuda, hist_cuda.grad_hist_fused_cuda):
        for a, b in zip(fn(bins, node, g, h, 3, 8), want):
            assert torch.equal(a, b)
        for a, b in zip(fn(bins, node, g, h, 3, 8, rows=rows,
                           offsets=offsets), want):
            assert torch.equal(a, b)
    assert torch.equal(hist_cuda.hist_matmul_cuda(w, bins, 8),
                       hist_cuda.hist_matmul_ref(w, bins, 8))
    assert hist_cuda.LAUNCHES == {"hist_matmul_cuda": 0,
                                  "grad_hist_fused_cuda": 0,
                                  "grad_hist_sharded_cuda": 0,
                                  "row_partition": 0}


def test_wrappers_reject_bad_inputs():
    bins = torch.zeros((10, 2), dtype=torch.int64)
    node = torch.zeros(10, dtype=torch.int32)
    g = torch.zeros(10)
    with pytest.raises(RuntimeError, match="uint8 or int32"):
        hist_cuda.grad_hist_fused_cuda(bins, node, g, g, 1, 4)
    bins = bins.to(torch.int32)
    with pytest.raises(RuntimeError, match="node_ids"):
        hist_cuda.grad_hist_cuda(bins, node.long(), g, g, 1, 4)
    with pytest.raises(RuntimeError, match="grad"):
        hist_cuda.grad_hist_fused_cuda(bins, node, g[:5], g, 1, 4)
    with pytest.raises(RuntimeError, match="bf16"):
        hist_cuda.hist_matmul_cuda(torch.zeros(16, 10), bins, 4)
    with pytest.raises(RuntimeError, match="contiguous"):
        hist_cuda.hist_matmul_cuda(torch.zeros(16, 10).bfloat16(),
                                   bins.t().contiguous().t(), 4)


def test_listed_mode_rejects_bad_inputs():
    bins = torch.zeros((10, 2), dtype=torch.int32)
    node = torch.zeros(10, dtype=torch.int32)
    g = torch.zeros(10)
    rows, offsets = hist_cuda.row_partition(node, 2)
    with pytest.raises(RuntimeError, match="rows"):
        hist_cuda.grad_hist_fused_cuda(bins, node, g, g, 2, 4,
                                       rows=rows.long(), offsets=offsets)
    with pytest.raises(RuntimeError, match="offsets"):
        hist_cuda.grad_hist_fused_cuda(bins, node, g, g, 3, 4, rows=rows,
                                       offsets=offsets)
    with pytest.raises(RuntimeError, match="offsets"):
        hist_cuda.grad_hist_cuda(bins, node, g, g, 2, 4, rows=rows)
    with pytest.raises(RuntimeError, match="int32"):
        hist_cuda.row_partition(node.long(), 2)
    with pytest.raises(RuntimeError, match="num_nodes"):
        hist_cuda.row_partition(node, 65535)


def test_row_chunking_depends_on_shapes_only():
    n_chunks, rows = hist_cuda._chunks(2_000_000, 28)
    assert rows % hist_cuda.TILE == 0
    assert n_chunks * rows >= 2_000_000 > (n_chunks - 1) * rows
    assert hist_cuda._chunks(100, 28) == (1, hist_cuda.TILE)
    # the shared-memory plans stay inside one block's limit
    assert hist_cuda.hist_matmul_plan(64, 2_000_000, 28, 256, 1).smem \
        <= hist_cuda._SMEM_BYTES
    assert hist_cuda.grad_hist_fused_plan(32, 2_000_000, 28, 256, 1).smem \
        <= hist_cuda._SMEM_BYTES


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """``chip_smoke.py`` exits non-zero and prints no result line when no
    card is present, and when it is run with nothing else of the repo."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: chip_smoke.py would run for real")
    script = SMOKE
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        with open(SMOKE, encoding="utf-8") as src, \
                open(script, "w", encoding="utf-8") as dst:
            dst.write(src.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """On the card: both kernels agree with their plain versions and are
    bitwise repeatable (run with ``pytest -m cuda`` on a GPU machine)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert hist_cuda.kernels_available()
    rng = np.random.RandomState(1)
    B, F, nb = 5000, 5, 256
    dev = torch.device("cuda")
    bins = torch.from_numpy(rng.randint(0, nb, (B, F)).astype(np.uint8))
    node = torch.from_numpy(rng.randint(-1, 40, B).astype(np.int32))
    g = torch.from_numpy(rng.randn(B).astype(np.float32))
    h = torch.from_numpy(rng.rand(B).astype(np.float32))
    want = hist_cuda.grad_hist_ref(bins, node, g, h, 40, nb)
    args = [t.to(dev) for t in (bins, node, g, h)] + [40, nb]
    for fn in (hist_cuda.grad_hist_cuda, hist_cuda.grad_hist_fused_cuda):
        first = fn(*args)
        again = fn(*args)
        for a, b, c in zip(first, again, want):
            assert torch.equal(a, b)
            torch.testing.assert_close(a.cpu(), c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_nccl_refuses_more_local_ranks_than_cards(monkeypatch, backend):
    """NCCL (the default on the card) with two local ranks on one card
    raises before any process group exists; it never switches to gloo."""
    from dmlc_core_tpu_torch.collective import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    chosen = []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    for key in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    args = {"DMLC_NUM_WORKER": 2, "DMLC_TASK_ID": 1,
            "DMLC_COORDINATOR_URI": "127.0.0.1",
            "DMLC_COORDINATOR_PORT": 9}
    if backend is not None:
        args["backend"] = backend
    with pytest.raises(RuntimeError, match="Duplicate GPU detected"):
        api.init(args)
    assert not api.is_initialized()
    assert chosen == []
    assert not torch.distributed.is_initialized()
