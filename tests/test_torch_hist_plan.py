"""The launch plans of K1 (``hist_cuda.hist_matmul_plan``) and K3
(``hist_cuda.grad_hist_fused_plan``), both kernels on ragged shapes, and
the kernel build's staleness rule.

The plans are pure Python and mirror ``matmul_plan`` and
``launch_grad_hist_fused`` in ``csrc/hist.cu``; these tests hold the
assumptions the kernels make of them.  The kernel tests
compare with the plain version (rtol 1e-4, atol 1e-3: f32 sums in another
order) and need a card; the CPU path is held against the Pallas kernel in
interpret mode (rtol/atol 1e-5: the same bf16 inputs, f32 sums).
"""

import os

import numpy as np
import pytest
import torch

from dmlc_core_tpu.ops import hist_pallas
from dmlc_core_tpu_torch.ops import _build
from dmlc_core_tpu_torch.ops import hist_cuda

GRID_LIMIT = 65535
SMEM_LIMIT = 232448


def _units_of(plan, group):
    """The (feature, first bin) units of one CTA of the plan."""
    lo = group * hist_cuda._WARPS
    hi = min(plan.units, lo + plan.warps)
    return [(u // plan.slices, (u % plan.slices) * hist_cuda._SLICE)
            for u in range(lo, hi)]


@pytest.mark.parametrize("num_rows", [1, 700, 2_000_000])
@pytest.mark.parametrize("num_feature", [1, 14, 28])
@pytest.mark.parametrize("num_bins", [2, 16, 255, 256, 1024])
@pytest.mark.parametrize("m", [16, 48, 64, 256])
def test_hist_matmul_plan(m, num_bins, num_feature, num_rows):
    for bin_bytes in (1, 4):
        plan = hist_cuda.hist_matmul_plan(m, num_rows, num_feature, num_bins,
                                          bin_bytes)
        # a function of the shapes alone
        assert plan == hist_cuda.hist_matmul_plan(m, num_rows, num_feature,
                                                  num_bins, bin_bytes)
        # row chunks of whole tiles and k-steps cover every row once
        rpc = plan.rows_per_chunk
        assert rpc % hist_cuda.TILE == 0 and rpc % hist_cuda._K_STEP == 0
        assert plan.n_chunks * rpc >= num_rows > (plan.n_chunks - 1) * rpc
        # at most the target CTA count, unless one chunk is already more
        ctas = plan.groups * plan.m_blocks * plan.n_chunks
        assert plan.n_chunks == 1 or ctas <= hist_cuda._TARGET_CTAS
        # m-blocks cover the weight rows
        assert plan.m_blocks * hist_cuda._M_BLOCK >= m
        assert (plan.m_blocks - 1) * hist_cuda._M_BLOCK < m
        # the warps' units cover every (feature, bin) once, and a CTA stages
        # no more feature columns than its bins rows hold
        seen = np.zeros((num_feature, num_bins), np.int32)
        for g in range(plan.groups):
            units = _units_of(plan, g)
            assert 1 <= len(units) <= plan.warps
            feats = {f for f, _ in units}
            assert max(feats) - min(feats) + 1 <= plan.span
            for f, b0 in units:
                seen[f, b0:b0 + hist_cuda._SLICE] += 1
        assert (seen == 1).all()
        assert plan.bins_pitch % 16 == 0
        assert plan.bins_pitch >= 15 + plan.span * bin_bytes
        assert plan.smem <= SMEM_LIMIT
        assert all(1 <= d <= GRID_LIMIT for d in plan.grid)
        assert plan.grid == (plan.groups, plan.n_chunks, plan.m_blocks)


@pytest.mark.parametrize("bin_bytes", [1, 4])
def test_hist_matmul_plan_window(bin_bytes):
    """Columns 14..27 of 28: every staged column lies in the window."""
    f_offset, f_count, ld = 14, 14, 28
    plan = hist_cuda.hist_matmul_plan(64, 1_000_003, f_count, 255, bin_bytes)
    assert plan.n_chunks * plan.rows_per_chunk >= 1_000_003
    for g in range(plan.groups):
        feats = [f for f, _ in _units_of(plan, g)]
        assert 0 <= min(feats) and f_offset + max(feats) < ld


def test_k1_chunking_rounds_down_k3_keeps_its_own():
    """K1 stays within the CTA target; K3 has its own plan, which rounds
    down over its m-blocks too (one at 32 nodes, eight at 256)."""
    plan = hist_cuda.hist_matmul_plan(64, 2_000_000, 28, 256, 1)
    assert plan.groups == 14 and plan.n_chunks == 75
    k3 = hist_cuda.grad_hist_fused_plan(32, 2_000_000, 28, 256, 1)
    assert (k3.groups, k3.m_blocks, k3.m_tiles, k3.n_chunks) == (14, 1, 4, 75)
    deep = hist_cuda.grad_hist_fused_plan(256, 2_000_000, 28, 256, 1)
    assert (deep.m_blocks, deep.m_tiles, deep.n_chunks) == (8, 4, 9)
    assert hist_cuda.grad_hist_fused_plan(1, 2_000_000, 28, 256,
                                          1).m_tiles == 1


def _epilogue_writes(plan, num_nodes):
    """K3's epilogue as a map: A row ``r`` of m-tile ``t`` of m-block ``z``
    holds ``s = r >= 8`` (G, then H) of node ``32 z + 8 t + r % 8``, and is
    written when that node lies below ``num_nodes``.  Returns the count of
    writes of each (s, node)."""
    writes = {}
    for z in range(plan.m_blocks):
        for t in range(plan.m_tiles):
            for r in range(16):
                node = (z * hist_cuda._NODE_M_BLOCK + t * hist_cuda._NODE_TILE
                        + r % 8)
                if node < num_nodes:
                    key = (int(r >= 8), node)
                    writes[key] = writes.get(key, 0) + 1
    return writes


@pytest.mark.parametrize("num_bins", [2, 255, 256, 1024])
@pytest.mark.parametrize("num_feature", [1, 14, 28])
@pytest.mark.parametrize("num_rows", [1, 700, 2_000_000])
@pytest.mark.parametrize("num_nodes", [1, 5, 8, 13, 16, 32, 37, 256, 1000])
def test_grad_hist_fused_plan(num_nodes, num_rows, num_feature, num_bins):
    for bin_bytes in (1, 4):
        plan = hist_cuda.grad_hist_fused_plan(num_nodes, num_rows,
                                              num_feature, num_bins,
                                              bin_bytes)
        # a function of the shapes alone
        assert plan == hist_cuda.grad_hist_fused_plan(
            num_nodes, num_rows, num_feature, num_bins, bin_bytes)
        # row chunks of whole tiles cover every row once
        rpc = plan.rows_per_chunk
        assert rpc % hist_cuda.TILE == 0 and rpc % hist_cuda._K_STEP == 0
        assert plan.n_chunks * rpc >= num_rows > (plan.n_chunks - 1) * rpc
        ctas = plan.groups * plan.m_blocks * plan.n_chunks
        assert plan.n_chunks == 1 or ctas <= hist_cuda._TARGET_CTAS
        # m-blocks of 32 nodes cover the nodes, and one m-block's m-tiles
        # cover its nodes: n <= 8 takes one m-tile
        assert plan.m_blocks * hist_cuda._NODE_M_BLOCK >= num_nodes
        assert (plan.m_blocks - 1) * hist_cuda._NODE_M_BLOCK < num_nodes
        assert plan.m_tiles * hist_cuda._NODE_TILE >= min(num_nodes, 32)
        assert plan.m_tiles == 1 or num_nodes > 8
        # the epilogue writes every (s, node < num_nodes) exactly once
        writes = _epilogue_writes(plan, num_nodes)
        assert sorted(writes) == [(s, n) for s in (0, 1)
                                  for n in range(num_nodes)]
        assert set(writes.values()) == {1}
        # K1's units: every (feature, bin) once, within the staged span
        seen = np.zeros((num_feature, num_bins), np.int32)
        for g in range(plan.groups):
            units = _units_of(plan, g)
            assert 1 <= len(units) <= plan.warps
            feats = {f for f, _ in units}
            assert max(feats) - min(feats) + 1 <= plan.span
            for f, b0 in units:
                seen[f, b0:b0 + hist_cuda._SLICE] += 1
        assert (seen == 1).all()
        # one thread per row of a tile packs it, with a register and a
        # pattern row for each of the CTA's columns
        assert plan.threads == hist_cuda.TILE
        assert plan.span <= hist_cuda._WARPS
        assert plan.smem <= SMEM_LIMIT
        assert all(1 <= d <= GRID_LIMIT for d in plan.grid)
        assert plan.grid == (plan.groups, plan.n_chunks, plan.m_blocks)


def test_hist_matmul_cpu_window_matches_pallas(monkeypatch):
    """The wrapper's CPU path on a column window with ragged rows and
    weight rows, against the Pallas kernel on a copy of the window."""
    import jax.numpy as jnp

    monkeypatch.setattr(hist_pallas, "_INTERPRET", True)
    rng = np.random.RandomState(48)
    m, b, f_all, nbins = 48, 701, 6, 16
    w = rng.randn(m, b).astype(np.float32)
    bins = rng.randint(0, nbins, (b, f_all)).astype(np.int32)
    want = hist_pallas.hist_matmul_pallas(
        jnp.asarray(w).astype(jnp.bfloat16), bins[:, 3:].copy(), nbins)
    got = hist_cuda.hist_matmul_cuda(torch.from_numpy(w).to(torch.bfloat16),
                                     torch.from_numpy(bins), nbins, 3, 3)
    assert got.shape == (m, 3 * nbins)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- the kernel on the card ---------------------------------------------------
CARD_CASES = [
    # m, num_rows, columns, num_bins, dtype, (lo, hi) of the bins, f_offset,
    # f_count, offset of w and bins in their allocations (elements)
    (48, 1_000_003, 28, 255, torch.uint8, (0, 256), 0, None, 0, 0),
    (48, 100_003, 28, 255, torch.int32, (-3, 260), 14, 14, 0, 0),
    (3, 700, 1, 2, torch.int32, (-1, 4), 0, None, 0, 0),
    (16, 5000, 14, 1024, torch.int32, (-5, 1100), 0, None, 0, 0),
    (256, 70_001, 28, 256, torch.uint8, (0, 256), 0, None, 0, 0),
    (20, 1000, 5, 16, torch.uint8, (0, 18), 2, 3, 4, 3),
    (80, 3001, 7, 100, torch.int32, (0, 101), 1, 5, 8, 1),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_hist_matmul_cuda_ragged(card, case):
    m, rows, cols, nbins, dtype, (lo, hi), f_off, f_cnt, w_off, b_off = case
    gen = torch.Generator().manual_seed(rows)
    w = torch.randn(m * rows + w_off, generator=gen).to(torch.bfloat16)
    bins = torch.randint(lo, hi, (rows * cols + b_off,), generator=gen)
    w = w.to(card)[w_off:].view(m, rows)
    bins = bins.to(dtype).to(card)[b_off:].view(rows, cols)
    count = cols - f_off if f_cnt is None else f_cnt
    before = hist_cuda.LAUNCHES["hist_matmul_cuda"]
    got = hist_cuda.hist_matmul_cuda(w, bins, nbins, f_off, f_cnt)
    again = hist_cuda.hist_matmul_cuda(w, bins, nbins, f_off, f_cnt)
    assert hist_cuda.LAUNCHES["hist_matmul_cuda"] == before + 2
    want = hist_cuda.hist_matmul_ref(
        w, bins[:, f_off:f_off + count].contiguous(), nbins)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


FUSED_CARD_CASES = [
    # num_nodes, num_rows, columns, num_bins, dtype, (lo, hi) of the bins,
    # f_offset, f_count, offset of the tensors in their allocations
    # (elements); node ids are drawn from [-2, num_nodes + 3)
    (1, 1_000_003, 28, 256, torch.uint8, (0, 256), 0, None, 0),
    (5, 1_000_003, 28, 255, torch.int32, (-3, 260), 14, 14, 3),
    (13, 1_000_003, 28, 255, torch.uint8, (0, 256), 2, 3, 1),
    (37, 1_000_003, 28, 255, torch.int32, (-3, 260), 14, 14, 0),
    (256, 1_000_003, 28, 255, torch.uint8, (0, 256), 0, None, 5),
    (3, 700, 1, 2, torch.int32, (-1, 4), 0, None, 0),
    (40, 5000, 14, 1024, torch.int32, (-5, 1100), 0, None, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CARD_CASES)
def test_grad_hist_fused_cuda_ragged(card, case):
    n, rows, cols, nbins, dtype, (lo, hi), f_off, f_cnt, off = case
    gen = torch.Generator().manual_seed(rows + n)
    bins = torch.randint(lo, hi, (rows * cols + off,), generator=gen)
    node = torch.randint(-2, n + 3, (rows + off,), generator=gen)
    g = torch.randn(rows + off, generator=gen)
    h = torch.rand(rows + off, generator=gen)
    bins = bins.to(dtype).to(card)[off:].view(rows, cols)
    node, g, h = (t.to(card)[off:] for t in (node.to(torch.int32), g, h))
    count = cols - f_off if f_cnt is None else f_cnt
    before = hist_cuda.LAUNCHES["grad_hist_fused_cuda"]
    got = hist_cuda.grad_hist_fused_cuda(bins, node, g, h, n, nbins, f_off,
                                         f_cnt)
    again = hist_cuda.grad_hist_fused_cuda(bins, node, g, h, n, nbins, f_off,
                                           f_cnt)
    assert hist_cuda.LAUNCHES["grad_hist_fused_cuda"] == before + 2
    want = hist_cuda.grad_hist_fused_ref(
        bins[:, f_off:f_off + count].contiguous(), node, g, h, n, nbins)
    for a, b, c in zip(got, again, want):
        assert a.shape == (n, count, nbins)
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-3)


# -- the build ----------------------------------------------------------------
def test_build_compiles_every_source_and_tracks_headers(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cuh"):
        (csrc / name).write_text("// source\n")
    lib = tmp_path / "lib.so"
    assert [os.path.basename(p) for p in _build.sources(str(csrc))] == [
        "a.cu", "b.cu"]
    assert _build.stale(str(lib), str(csrc))          # not built yet
    lib.write_text("")
    os.utime(lib, (2_000_000_000, 2_000_000_000))
    assert not _build.stale(str(lib), str(csrc))
    # an edited header alone makes the library stale
    os.utime(csrc / "c.cuh", (2_000_000_100, 2_000_000_100))
    assert _build.stale(str(lib), str(csrc))
    assert _build.sources() == [_build.SOURCE]
