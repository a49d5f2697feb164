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

import functools
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
    down over its node blocks too (one block of 64 columns at 32 nodes,
    eight at 256 nodes; four units a consumer warpgroup at 1 node)."""
    plan = hist_cuda.hist_matmul_plan(64, 2_000_000, 28, 256, 1)
    assert plan.groups == 14 and plan.n_chunks == 75
    k3 = hist_cuda.grad_hist_fused_plan(32, 2_000_000, 28, 256, 1)
    assert (k3.groups, k3.m_blocks, k3.cols, k3.n_chunks) == (28, 1, 64, 37)
    assert (k3.consumers, k3.threads, k3.stage_rows) == (4, 640, 512)
    assert k3.bins_bulk and k3.slab_pitch == 28
    mid = hist_cuda.grad_hist_fused_plan(16, 2_000_000, 28, 256, 1)
    assert (mid.groups, mid.units_per_wg, mid.cols, mid.n_chunks) == (
        14, 2, 32, 75)
    deep = hist_cuda.grad_hist_fused_plan(256, 2_000_000, 28, 256, 1)
    assert (deep.m_blocks, deep.cols, deep.n_chunks) == (8, 64, 4)
    root = hist_cuda.grad_hist_fused_plan(1, 2_000_000, 28, 256, 1)
    assert (root.cols, root.units_per_wg, root.groups, root.stage_rows) == (
        8, 4, 7, 512)


def _epilogue_map(plan, group, block, num_nodes, num_bins):
    """K3's epilogue as a map over (consumer warpgroup, its unit, thread,
    accumulator) of the CTA (group, any chunk, block): accumulator ``e`` of
    unit ``k`` in warp ``w``, lane (``g``, ``t``) of warpgroup ``v`` holds
    bin ``16 w + g + 8 ((e >> 1) & 1)`` of unit ``consumers * units_per_wg
    * group + units_per_wg * v + k``'s slice and column ``8 (e >> 2) + 2 t
    + (e & 1)``: ``s = e & 1`` (G, then H) of node ``4 (e >> 2) + t`` of the
    block.  Returns (s, node, feature, bin, written), each [consumers *
    units_per_wg, 128, cols / 2]."""
    per_wg = plan.units_per_wg
    v = np.arange(plan.consumers)[:, None, None, None]
    k = np.arange(per_wg)[None, :, None, None]
    thread = np.arange(128)[None, None, :, None]
    e = np.arange(plan.cols // 2)[None, None, None, :]
    warp, lane = thread // 32, thread % 32
    g, t = lane // 4, lane % 4
    unit = (group * plan.consumers + v) * per_wg + k
    feature = unit // plan.slices
    b = (unit % plan.slices) * hist_cuda._SLICE + 16 * warp + g \
        + 8 * ((e >> 1) & 1)
    node = block * plan.node_block + 4 * (e >> 2) + t
    s = e & 1
    written = (unit < plan.units) & (node < num_nodes) & (b < num_bins)
    shape = (plan.consumers * per_wg, 128, plan.cols // 2)
    return tuple(np.broadcast_to(a, (plan.consumers, per_wg) + shape[1:])
                 .reshape(shape) for a in (s, node, feature, b, written))


@functools.lru_cache(maxsize=None)
def _epilogue_misses(num_nodes, num_feature, num_bins):
    """How many (s, node, feature, bin) of the output K3's epilogue writes
    other than exactly once over all CTAs of a launch (row chunks write
    partials alike), from :func:`_epilogue_map`, one feature at a time.
    The map's ``written`` is the kernel's guard, so nothing out of range
    is written."""
    plan = hist_cuda.grad_hist_fused_plan(num_nodes, 1, num_feature,
                                          num_bins, 1)
    misses = 0
    for f in range(num_feature):
        flat = []
        # the groups whose units hold a slice of feature f
        per_cta = plan.consumers * plan.units_per_wg
        for grp in range(f * plan.slices // per_cta,
                         ((f + 1) * plan.slices - 1) // per_cta + 1):
            for z in range(plan.m_blocks):
                s, node, feat, b, w = _epilogue_map(plan, grp, z, num_nodes,
                                                    num_bins)
                mine = w & (feat == f)
                flat.append(((s * num_nodes + node) * num_bins + b)[mine])
        counts = np.bincount(np.concatenate(flat),
                             minlength=2 * num_nodes * num_bins)
        misses += int((counts != 1).sum())
    return misses


@pytest.mark.parametrize("num_bins", [2, 255, 256, 1024])
@pytest.mark.parametrize("num_feature", [1, 14, 28])
@pytest.mark.parametrize("num_rows", [1, 700, 2_000_000])
@pytest.mark.parametrize("num_nodes", [1, 5, 8, 13, 16, 32, 37, 64, 128, 129,
                                       256, 1000])
def test_grad_hist_fused_plan(num_nodes, num_rows, num_feature, num_bins):
    for bin_bytes in (1, 4):
        plan = hist_cuda.grad_hist_fused_plan(num_nodes, num_rows,
                                              num_feature, num_bins,
                                              bin_bytes)
        # a function of the shapes alone
        assert plan == hist_cuda.grad_hist_fused_plan(
            num_nodes, num_rows, num_feature, num_bins, bin_bytes)
        # row chunks of whole tiles cover every row (a chunk's last stage
        # may be short)
        rpc = plan.rows_per_chunk
        assert rpc % hist_cuda.TILE == 0
        assert plan.n_chunks * rpc >= num_rows > (plan.n_chunks - 1) * rpc
        ctas = plan.groups * plan.m_blocks * plan.n_chunks
        assert plan.n_chunks == 1 or ctas <= hist_cuda._TARGET_CTAS
        # wgmma's N: G and H of each node of a block, a power of two in
        # [8, 64], no wider than twice the nodes (or 8)
        assert plan.cols == 2 * plan.node_block
        assert plan.cols in (8, 16, 32, 64)
        assert plan.cols >= 2 * min(num_nodes, 32)
        assert plan.cols == 8 or plan.cols < 4 * num_nodes
        # node blocks cover the nodes
        assert plan.m_blocks * plan.node_block >= num_nodes
        assert (plan.m_blocks - 1) * plan.node_block < num_nodes
        # four consumer warpgroups of 1 to 4 units (at most 32 accumulators
        # a thread) and a producer warpgroup; a stage is whole tiles, and
        # its B at most 64 KB
        assert plan.consumers == 4
        assert plan.units_per_wg == {8: 4, 16: 4, 32: 2}.get(plan.cols, 1)
        assert plan.units_per_wg * plan.cols // 2 <= 32
        assert plan.threads == 128 * (plan.consumers + 1)
        assert plan.stage_rows % hist_cuda.TILE == 0
        assert plan.stage_rows * plan.cols * 2 <= 65536
        # the units: every (feature, bin) once, within the span a CTA reads
        seen = np.zeros((num_feature, num_bins), np.int32)
        per_cta = plan.consumers * plan.units_per_wg
        for grp in range(plan.groups):
            lo = grp * per_cta
            units = [(u // plan.slices, (u % plan.slices) * hist_cuda._SLICE)
                     for u in range(lo, min(plan.units, lo + per_cta))]
            assert units
            feats = {f for f, _ in units}
            assert max(feats) - min(feats) + 1 <= plan.span
            for f, b0 in units:
                seen[f, b0:b0 + hist_cuda._SLICE] += 1
        assert (seen == 1).all()
        # the bins slab: whole rows by bulk copy when aligned and a stage
        # fits, else 16-byte granules over the span; shared memory fits
        # a block on every path, for windows of wider rows too
        assert plan.bins_bulk == (plan.stage_rows * num_feature * bin_bytes
                                  <= hist_cuda._K3_BULK_SLAB)
        for ld, aligned in ((num_feature, True), (num_feature, False),
                            (3 * num_feature + 5, True),
                            (40_000, True)):
            other = hist_cuda.grad_hist_fused_plan(
                num_nodes, num_rows, num_feature, num_bins, bin_bytes, ld,
                aligned)
            assert other.smem <= SMEM_LIMIT
            if other.bins_bulk:
                assert aligned and other.slab_pitch == ld * bin_bytes
            else:
                assert other.slab_pitch % 16 == 0
                assert other.slab_pitch >= 15 + other.span * bin_bytes
        assert all(1 <= d <= GRID_LIMIT for d in plan.grid)
        assert plan.grid == (plan.groups, plan.n_chunks, plan.m_blocks)
    # the epilogue writes every (G|H, node, feature, bin) exactly once
    assert _epilogue_misses(num_nodes, num_feature, num_bins) == 0


# -- K3's listed mode: the row partition and the chunks ----------------------
def _level_ids(num_rows, num_nodes, seed, share=0.35):
    """A level's ids below the root: a ``share`` of the rows in built nodes
    [0, num_nodes) (some nodes left empty), the rest -1 or past the end."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, num_nodes, num_rows)
    if num_nodes > 2:
        ids[ids == num_nodes // 2] = num_nodes - 1       # an empty node
    out = rng.rand(num_rows) >= share
    ids[out] = rng.choice([-1, num_nodes, -7], out.sum())
    return ids.astype(np.int32)


PARTITION_CASES = {
    # name: ids
    "ids of -1 and past the end": _level_ids(700, 5, 1),
    "empty nodes": np.array([4, 4, -1, 0, 4, 0, 9, 4], np.int32),
    "every row in one node": np.zeros(1000, np.int32),
    "no row in any node": np.full(300, -1, np.int32),
    "one row": np.array([0], np.int32),
    "rows not a multiple of the tile": _level_ids(3 * 256 + 17, 64, 2),
    "many nodes": _level_ids(20_000, 13_000, 3, share=0.9),
}


@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_row_partition_is_stable_and_grouped(case):
    ids = PARTITION_CASES[case]
    n = max(1, int(ids.max()))     # the largest id lies past the nodes
    rows, offsets = hist_cuda.row_partition(torch.from_numpy(ids), n)
    assert rows.dtype == offsets.dtype == torch.int32
    assert rows.shape == ids.shape and offsets.shape == (n + 1,)
    rows, offsets = rows.numpy(), offsets.numpy()
    assert offsets[0] == 0 and (np.diff(offsets) >= 0).all()
    for k in range(n):
        # node k's rows, in row order, at [offsets[k], offsets[k + 1])
        np.testing.assert_array_equal(rows[offsets[k]:offsets[k + 1]],
                                      np.flatnonzero(ids == k))
    assert offsets[n] == ((ids >= 0) & (ids < n)).sum()
    assert set(hist_cuda.LAUNCHES.values()) == {0}   # no kernel on the CPU


def _partition_model(ids, num_nodes):
    """hist.cu's row_partition step by step on the host: per-part counts,
    the exclusive scan in (id, part) order, then each part's rows placed
    in order at its cursors.  Returns (rows, offsets, parts)."""
    B = len(ids)
    parts, per = hist_cuda.row_partition_plan(B, num_nodes)
    counts = np.zeros((num_nodes, parts), np.int64)
    inside = (ids >= 0) & (ids < num_nodes)
    for p in range(parts):
        seg = ids[p * per:(p + 1) * per]
        seg = seg[(seg >= 0) & (seg < num_nodes)]
        counts[:, p] = np.bincount(seg, minlength=num_nodes)
    flat = np.append(counts.reshape(-1), 0)
    starts = np.cumsum(flat) - flat                  # exclusive, in place
    offsets = starts[np.arange(num_nodes + 1) * parts]
    cursor = starts[:-1].reshape(num_nodes, parts).copy()
    rows = np.full(B, -1, np.int64)
    for r in np.flatnonzero(inside):
        k, p = ids[r], r // per
        rows[cursor[k, p]] = r
        cursor[k, p] += 1
    return rows, offsets, parts


@pytest.mark.parametrize("num_rows,num_nodes", [
    (1, 1), (700, 5), (5000, 1), (300_001, 64), (70_000, 3000)])
def test_row_partition_plan_model_is_the_plain_partition(num_rows,
                                                         num_nodes):
    """The kernel's three steps over the plan's parts give the plain
    version's list and offsets: the list does not depend on the parts."""
    ids = _level_ids(num_rows, num_nodes, num_rows + num_nodes)
    parts, per = hist_cuda.row_partition_plan(num_rows, num_nodes)
    assert per % hist_cuda.TILE == 0 and per >= hist_cuda._PART_ROWS
    assert parts * per >= num_rows > (parts - 1) * per
    assert parts <= hist_cuda._PART_MAX
    assert parts == 1 or num_nodes * parts <= hist_cuda._PART_COUNTS
    rows, offsets, _ = _partition_model(ids, num_nodes)
    want_rows, want_off = hist_cuda.row_partition_ref(
        torch.from_numpy(ids), num_nodes)
    np.testing.assert_array_equal(offsets, want_off.numpy())
    total = offsets[-1]
    np.testing.assert_array_equal(rows[:total], want_rows.numpy()[:total])
    assert (rows[total:] == -1).all()                # never written


def test_row_partition_plan_bounds_its_counts():
    # 10M rows at 64 nodes: 1,002 warps of 9,984 rows
    assert hist_cuda.row_partition_plan(10_000_000, 64) == (1002, 9984)
    # a wide level: fewer parts, so the (node, part) counts stay bounded
    parts, per = hist_cuda.row_partition_plan(10_000_000, 65534)
    assert parts * 65534 <= hist_cuda._PART_COUNTS and parts * per >= 1e7


@pytest.mark.parametrize("n_chunks", [1, 3, 37, 150])
@pytest.mark.parametrize("lo,hi", [(0, 0), (5, 5), (0, 1), (7, 200),
                                   (0, 256), (3, 260), (100, 100_003),
                                   (0, 3_300_000)])
def test_listed_chunks_cover_the_range_once(lo, hi, n_chunks):
    """A listed launch's chunks of one node block: in order, whole tiles
    but the last that holds rows, empty past the range, and together the
    block's positions [lo, hi) exactly once (from the offsets alone)."""
    spans = [hist_cuda.listed_chunk(lo, hi, n_chunks, c)
             for c in range(n_chunks)]
    seen = np.zeros(hi - lo, np.int32)
    for c, (b, e) in enumerate(spans):
        assert lo <= b <= e <= hi
        seen[b - lo:e - lo] += 1
        if e < hi:
            assert (e - b) % hist_cuda.TILE == 0
        if c and spans[c - 1][1] < hi:
            assert b == spans[c - 1][1]
    assert (seen == 1).all()
    per = spans[0][1] - spans[0][0]
    assert per == 0 or per < hi - lo + hist_cuda.TILE


@pytest.mark.parametrize("num_nodes", [1, 2, 8, 16, 32, 64, 129])
@pytest.mark.parametrize("num_feature,bin_bytes", [(28, 1), (28, 4),
                                                   (2000, 1), (67, 1)])
def test_listed_plan_keeps_the_grid_and_writes_every_output_once(
        num_nodes, num_feature, bin_bytes):
    """The listed plan is the dense plan's grid and chunk count (so the
    same partials, summed in chunk order), with the bins as granules and a
    byte more a staged row within shared memory; whatever rows the
    offsets give a chunk (none, less than a tile, ragged), its CTAs write
    every (G|H, node, feature, bin) of its partial exactly once."""
    B = 10_000_000 if num_feature < 100 else 400_000
    dense = hist_cuda.grad_hist_fused_plan(num_nodes, B, num_feature, 256,
                                           bin_bytes)
    listed = hist_cuda.grad_hist_fused_plan(num_nodes, B, num_feature, 256,
                                            bin_bytes, listed=True)
    same = ("n_chunks", "cols", "node_block", "m_blocks", "units_per_wg",
            "groups", "span", "stage_rows", "threads", "grid")
    assert all(getattr(listed, k) == getattr(dense, k) for k in same)
    assert not listed.bins_bulk
    assert listed.slab_pitch % 16 == 0
    assert listed.slab_pitch >= 15 + listed.span * bin_bytes
    assert listed.smem <= SMEM_LIMIT
    # a level's offsets with empty nodes: each block's chunks cover its
    # positions once, and the epilogue, which runs for empty chunks too,
    # writes each output element once a chunk
    ids = _level_ids(5000, num_nodes, num_nodes)
    _, offsets = hist_cuda.row_partition_ref(torch.from_numpy(ids),
                                             num_nodes)
    offsets = offsets.numpy()
    for z in range(listed.m_blocks):
        lo = offsets[z * listed.node_block]
        hi = offsets[min((z + 1) * listed.node_block, num_nodes)]
        got = sorted(hist_cuda.listed_chunk(lo, hi, listed.n_chunks, c)
                     for c in range(listed.n_chunks))
        assert sum(e - b for b, e in got) == hi - lo
    assert _epilogue_misses(num_nodes, min(num_feature, 67), 256) == 0


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
    # four full 32-node blocks (64 columns each), and one node past them
    (128, 100_003, 28, 255, torch.uint8, (0, 256), 0, None, 0),
    (129, 100_003, 28, 256, torch.int32, (-3, 260), 14, 14, 3),
    # the dryrun's K4 shapes: 16 bins, 4 nodes, a window of 4 of 8 columns
    (4, 64, 8, 16, torch.int32, (0, 16), 4, 4, 0),
    (4, 70_001, 8, 16, torch.int32, (-1, 17), 4, 4, 1),
    # rows too wide for a bulk stage (80 int32 columns): granules, aligned
    (33, 20_001, 80, 64, torch.int32, (-1, 65), 8, 40, 0),
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


LISTED_CARD_CASES = [
    # built nodes, num_rows, columns, num_bins, dtype, (lo, hi) of the
    # bins, offset of the tensors in their allocations (elements: 0 keeps
    # uint8 rows of 28 bytes 16-byte aligned at the start, 3 does not)
    (1, 1_000_003, 28, 256, torch.uint8, (0, 256), 0),
    (8, 1_000_003, 28, 256, torch.uint8, (0, 256), 3),
    (32, 1_000_003, 28, 255, torch.int32, (-3, 260), 0),
    (64, 1_000_003, 28, 256, torch.uint8, (0, 256), 0),
    (64, 400_001, 2000, 256, torch.uint8, (0, 256), 1),
    (129, 100_003, 28, 256, torch.int32, (-3, 260), 3),
]


def _card_level(card, n, rows, cols, dtype, lo, hi, off):
    """A level's tensors on the card: ~35% of the rows in the n built
    nodes (one left empty), the rest -1 or past them."""
    gen = torch.Generator().manual_seed(rows + n)
    bins = torch.randint(lo, hi, (rows * cols + off,), generator=gen)
    ids = torch.from_numpy(_level_ids(rows + off, n, n))
    g = torch.randn(rows + off, generator=gen)
    h = torch.rand(rows + off, generator=gen)
    bins = bins.to(dtype).to(card)[off:].view(rows, cols)
    ids, g, h = (t.to(card)[off:] for t in (ids, g, h))
    return bins, ids, g, h


@pytest.mark.cuda
@pytest.mark.parametrize("case", LISTED_CARD_CASES)
def test_listed_k3_matches_dense_k3_on_the_card(card, case):
    """K3's listed mode on one level against the dense launch (f32 sums in
    another order) and the plain version; the partition is the plain
    one's list exactly; both bitwise over two launches; one partition and
    one K3 launch counted each."""
    n, rows, cols, nbins, dtype, (lo, hi), off = case
    bins, ids, g, h = _card_level(card, n, rows, cols, dtype, lo, hi, off)
    before = dict(hist_cuda.LAUNCHES)
    part = hist_cuda.row_partition(ids, n)
    part2 = hist_cuda.row_partition(ids, n)
    want_rows, want_off = hist_cuda.row_partition_ref(ids.cpu(), n)
    total = int(want_off[n])
    for r, o in (part, part2):
        assert torch.equal(o.cpu(), want_off)
        assert torch.equal(r[:total].cpu(), want_rows[:total])
    listed = hist_cuda.grad_hist_fused_cuda(bins, ids, g, h, n, nbins,
                                            rows=part[0], offsets=part[1])
    again = hist_cuda.grad_hist_fused_cuda(bins, ids, g, h, n, nbins,
                                           rows=part2[0], offsets=part2[1])
    dense = hist_cuda.grad_hist_fused_cuda(bins, ids, g, h, n, nbins)
    assert hist_cuda.LAUNCHES["row_partition"] == before["row_partition"] + 2
    assert (hist_cuda.LAUNCHES["grad_hist_fused_cuda"]
            == before["grad_hist_fused_cuda"] + 3)
    want = hist_cuda.grad_hist_fused_ref(bins, ids, g, h, n, nbins)
    for a, b, d, c in zip(listed, again, dense, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, d, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_row_partition_on_the_card_is_the_plain_one(card, case):
    ids = torch.from_numpy(PARTITION_CASES[case])
    n = max(1, int(ids.max()))
    rows, offsets = hist_cuda.row_partition(ids.to(card), n)
    want_rows, want_off = hist_cuda.row_partition_ref(ids, n)
    total = int(want_off[n])
    assert torch.equal(offsets.cpu(), want_off)
    assert torch.equal(rows[:total].cpu(), want_rows[:total])


def _higgs_fit(card, **param):
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam

    rng = np.random.RandomState(5)
    x = rng.randn(300_000, 28).astype(np.float32)
    y = (x[:, :3].sum(1) + 0.5 * np.sin(3 * x[:, 3])
         + 0.3 * rng.randn(len(x)) > 0).astype(np.float32)
    model = GBDT(GBDTParam(num_boost_round=4, max_depth=7, num_bins=256,
                           **param), 28)
    model.make_bins(x[:50_000])
    bins = model.bin_features(x).to(card).to(torch.uint8)
    return model.fit_binned(bins, torch.from_numpy(y).to(card))


@pytest.mark.cuda
def test_listed_fit_on_the_card(card, monkeypatch):
    """A higgs-shaped fit: bitwise from call to call and between ``auto``
    and ``pallas_fused``, one partition a level below the root, and the
    trees of the dense launch (every row read at every level) within f32
    rounding: the first tree's splits the same, leaves within 1e-5."""
    from dmlc_core_tpu_torch.models import gbdt

    hist_cuda.reset_launches()
    (ens, margin) = _higgs_fit(card)
    assert hist_cuda.LAUNCHES["row_partition"] == 4 * 6
    (ens2, margin2) = _higgs_fit(card)
    (fused, fmargin) = _higgs_fit(card, hist_method="pallas_fused")
    for a, b, c in zip(ens, ens2, fused):
        if a is not None:
            assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(margin, margin2) and torch.equal(margin, fmargin)
    plan = gbdt.hist_plan
    monkeypatch.setattr(gbdt, "hist_plan", lambda *a, **k: plan(
        *a, **k)._replace(lists_rows=False))
    hist_cuda.reset_launches()
    (dense, dmargin) = _higgs_fit(card)
    assert hist_cuda.LAUNCHES["row_partition"] == 0
    split_feat, split_bin, leaf = ens[0], ens[1], ens[2]
    assert torch.equal(split_feat[0], dense[0][0])
    assert torch.equal(split_bin[0], dense[1][0])
    torch.testing.assert_close(leaf[0], dense[2][0], rtol=0, atol=1e-5)
    same = (split_feat == dense[0]).float().mean().item()
    assert same >= 0.95
    torch.testing.assert_close(margin, dmargin, rtol=0, atol=1e-3)


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
    assert _build.sources() == [
        _build.SOURCE, os.path.join(_build.CSRC, "predict.cu")]
