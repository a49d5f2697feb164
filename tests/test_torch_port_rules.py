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
    for fn in (hist_cuda.grad_hist_cuda, hist_cuda.grad_hist_fused_cuda):
        for a, b in zip(fn(bins, node, g, h, 3, 8), want):
            assert torch.equal(a, b)
    assert torch.equal(hist_cuda.hist_matmul_cuda(w, bins, 8),
                       hist_cuda.hist_matmul_ref(w, bins, 8))
    assert hist_cuda.LAUNCHES == {"hist_matmul_cuda": 0,
                                  "grad_hist_fused_cuda": 0,
                                  "grad_hist_sharded_cuda": 0}


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
