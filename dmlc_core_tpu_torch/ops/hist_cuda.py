"""Gradient-histogram kernels for the H100: wrappers, plain versions, counts.

Counterpart of ``dmlc_core_tpu/ops/hist_pallas.py``.  The kernels live in
``csrc/hist.cu`` (CUDA C++ for ``sm_90a``, built and bound by
:mod:`._build`):

- :func:`hist_matmul_cuda` replaces ``hist_matmul_pallas`` (K1):
  ``out[m, f*nbins + b] = sum_i w[m, i] * [bins[i, f] == b]``;
- :func:`grad_hist_cuda` replaces ``grad_hist_pallas`` (K2), which builds
  the bf16 weight matrix ``W = [nodehot*g ; nodehot*h]`` in XLA and runs
  K1 over it: on the card it launches K3's kernel over every node in one
  launch, so no W is built (the TPU built W outside the kernel only where
  Mosaic could not lower the fused build; the card has no such limit);
- :func:`grad_hist_fused_cuda` replaces ``grad_hist_pallas_fused`` (K3):
  the same (G, H) as a product transposed onto Hopper's ``wgmma``: the
  bin one-hot is A, built in registers, and the node-masked g/h rows are
  B, built once a stage in shared memory for every feature, so no W
  matrix is materialised.  Its listed mode reads only the rows of the
  nodes it builds: :func:`row_partition` groups a level's rows by node id
  on the card (a stable counting partition, no read by the host), and
  each node block's CTAs walk their own range of that list;
- :func:`grad_hist_sharded_cuda` replaces ``grad_hist_pallas_sharded``
  (K4): on a rank at mesh coordinate ``(d, m)``, K3's kernel over the rank's
  window of ``F/mp`` feature columns (read in place: the kernels take a
  row stride and a column offset), then the sum over the rank's row-axes
  group (``data`` on a flat mesh, ``("dcn_data", "ici_data")`` on the
  hybrid one) and the concatenation over its ``model`` group.

All three CUDA paths can read a column window ``[f_offset, f_offset +
f_count)`` of a wider ``[B, F]`` bins array; outputs cover the window.

K4's bound at ``chip_smoke.py``'s shape (2,000,000 rows over a 2 x 2
data x model mesh, 28 features, 256 bins, 32 nodes): each rank's kernel
must read its 1,000,000 x 14 uint8 window (14 MB; the 32-byte sectors it
touches hold the whole 28-byte rows, 28 MB) and 12 B of node/g/h per row
(12 MB), and write 2 x 32 x 14 x 256 f32 (0.92 MB): about 8 us at
3.35 TB/s.  The data all-reduce then moves 0.92 MB per rank and the model
all-gather hands each rank 1.84 MB.

Numerics are the TPU kernels': g and h rounded to bf16 (nearest even),
sums in f32, rows whose node id lies outside ``[0, num_nodes)`` dropped.
K1 runs the TPU's formulation, W times a one-hot built in registers, on
``mma.sync``; K3 runs it transposed on ``wgmma``, one-hot times the g/h
rows, so no W exists.  The notes in ``hist.cu`` give each kernel's
bounds; ``tools/k3_variants.py`` times K3 beside copies with a part
removed.  Every sum is free of atomics, so outputs are bitwise identical
from launch to launch.

Beside each kernel sits its plain PyTorch version (``*_ref``): bf16
rounding, then f32 sums over flat ids (:func:`segment_sum`, which is
atomics-free on the card too).  A wrapper takes the plain version only for
tensors that lie on the CPU; for a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES[name]`` counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dmlc_core_tpu_torch.collective.mesh_collectives import MeshCollective
from dmlc_core_tpu_torch.parallel.mesh import ambient_mesh
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["hist_matmul_cuda", "grad_hist_cuda", "grad_hist_fused_cuda",
           "grad_hist_sharded_cuda", "hist_matmul_ref", "grad_hist_ref",
           "grad_hist_fused_ref", "grad_hist_sharded_ref", "scatter_sums",
           "segment_sum", "node_weights", "hist_node_block",
           "hist_matmul_plan", "grad_hist_fused_plan", "sharded_hist_plan",
           "row_partition", "row_partition_ref", "row_partition_plan",
           "listed_chunk", "kernels_available", "reset_launches",
           "LAUNCHES", "TILE"]

# kernel launches per wrapper since the last reset_launches()
# ("row_partition": one a partition, its three kernels together)
LAUNCHES: Dict[str, int] = {"hist_matmul_cuda": 0, "grad_hist_fused_cuda": 0,
                            "grad_hist_sharded_cuda": 0, "row_partition": 0}

TILE = 256               # rows a CTA stages per step (kTile in hist.cu)
_SMEM_BYTES = 232448     # dynamic shared memory one block may use on sm_90
_TARGET_CTAS = 1056      # CTAs per launch the row chunking aims at
# K1 (the constants of hist.cu's matmul_plan)
_M_BLOCK = 64            # weight rows per CTA: 4 mma m-tiles of 16
_SLICE = 64              # bins per warp: 8 mma n-tiles of 8
_WARPS = 8               # (feature, bin slice) units per CTA
_K_STEP = 16             # data rows per mma (m16n8k16)
_W_PITCH = TILE + 8      # bf16 per staged W row
# K3 (hist.cu's K3Shape and k3_layout): K1's 64-bin slices as units
_K3_MAX_COLS = 64        # wgmma's largest N here: 2 x 32 nodes per CTA
_K3_CONSUMERS = 4        # consumer warpgroups per CTA
_K3_RAW_STAGES = 2       # stages of raw rows in flight
_K3_B_STAGES = 2         # stages of built B and one-hot patterns
_K3_BULK_SLAB = 32768    # most bins bytes a stage copies as whole rows
# the row partition (hist.cu's row_partition): a warp a part of the rows
_PART_ROWS = 1024        # fewest rows a part
_PART_MAX = 1024         # most parts
_PART_COUNTS = 1 << 22   # most (node, part) counts

# the reference's per-sweep budget of its K2's [2*n_pad, F*nbins] f32
# accumulator (hist_pallas._ACC_BYTES_LIMIT); the port's kernels need none,
# but its dispatch gates take the reference's decisions with it
_ACC_BYTES_LIMIT = 8 * 1024 * 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _pad_nodes(num_nodes: int) -> int:
    """Node slots of K2's weight matrix (the TPU's multiple of 8)."""
    return -(-max(8, num_nodes) // 8) * 8


def _acc_fits(num_nodes: int, num_feature: int, num_bins: int) -> bool:
    """Whether the reference K2's ``[2*n_pad, F*nbins]`` f32 accumulator
    fits its budget."""
    return 2 * _pad_nodes(num_nodes) * num_feature * num_bins * 4 \
        <= _ACC_BYTES_LIMIT


def hist_node_block(num_nodes: int, num_feature: int, num_bins: int) -> int:
    """Nodes per sweep of the reference's K2 (``hist_pallas.
    hist_node_block``): all of them when the ``[2*n_pad, F*nbins]`` f32
    accumulator fits ``_ACC_BYTES_LIMIT``, else the largest power of two
    (at least 8) that does.  The port sweeps no node blocks (K3's kernel
    covers any node count in one launch); the dispatch gates use this to
    choose as the reference does."""
    if _acc_fits(num_nodes, num_feature, num_bins):
        return num_nodes
    block = 1 << (num_nodes - 1).bit_length()
    while block > 8 and 2 * block * num_feature * num_bins * 4 \
            > _ACC_BYTES_LIMIT:
        block //= 2
    return block


# -- plain PyTorch versions -------------------------------------------------
def _bf16(x):
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def segment_sum(values, ids, num_segments: int):
    """``jax.ops.segment_sum``: ``out[s]`` is the f32 sum of the rows
    ``values[i]`` ([N] or [N, K]) with ``ids[i] == s``; ids outside
    ``[0, num_segments)`` add nothing.

    On the CPU each column is an ``index_add_``, which adds the rows
    serially in row order.  On the card ``index_add_`` adds with float
    atomics, in an order that changes from run to run, so there a stable
    sort of the ids puts each segment's rows together in row order and
    ``torch.segment_reduce`` sums each segment alone, in a fixed order: the
    same bits every call, without a process-wide switch."""
    values = values.to(torch.float32)
    ids = ids.to(torch.int64)
    # out-of-range ids go to a spill segment past the end
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    cols = values.t() if values.dim() == 2 else values[None]   # [K, N]
    if values.device.type == "cpu":
        sums = [torch.zeros(num_segments + 1).index_add_(0, ids, v)
                for v in cols]
    else:
        _check_cuda(values)
        sums = _sorted_sums(cols, ids, num_segments + 1)
    out = torch.stack(sums, dim=1)[:num_segments]
    return out.reshape((num_segments,) + tuple(values.shape[1:]))


def _sorted_sums(cols, ids, num_segments: int):
    """:func:`segment_sum`'s form for the card, on ids all in
    ``[0, num_segments)``: per row of ``cols`` [K, N], the f32 sum of each
    segment, each segment's values added alone in a fixed order."""
    ids, order = torch.sort(ids, stable=True)
    starts = torch.searchsorted(ids, torch.arange(
        num_segments + 1, dtype=torch.int64, device=ids.device))
    # unsafe: the lengths sum to N by construction; checking them would
    # wait for the card
    return [torch.segment_reduce(v[order], "sum", lengths=starts.diff(),
                                 unsafe=True, initial=0.0)
            for v in cols]


def scatter_sums(bins, node_ids, grad, hess, num_nodes: int, num_bins: int):
    """Exact f32 (G, H) by :func:`segment_sum` over the flat ids
    ``node*F*nbins + f*nbins + bin``; out-of-range nodes and bins drop.  The
    ``"scatter"`` method and the kernels' plain versions share it."""
    B, F = bins.shape
    nseg = num_nodes * F * num_bins
    node = node_ids.to(torch.int64)
    b = bins.to(torch.int64)
    ids = (node[:, None] * (F * num_bins)
           + torch.arange(F, device=bins.device)[None, :] * num_bins + b)
    keep = (((node >= 0) & (node < num_nodes))[:, None]
            & (b >= 0) & (b < num_bins))
    flat = torch.where(keep, ids, -1).reshape(-1)
    gh = torch.stack([grad, hess], dim=1).to(torch.float32)    # [B, 2]
    sums = segment_sum(gh[:, None, :].expand(B, F, 2).reshape(B * F, 2),
                       flat, nseg)
    return (sums[:, 0].reshape(num_nodes, F, num_bins),
            sums[:, 1].reshape(num_nodes, F, num_bins))


def hist_matmul_ref(w, bins, num_bins: int):
    """Plain version of K1: f32 ``index_add_`` of the columns of ``w``
    ([M, B] bf16) into ``[M, F*nbins]``, one feature at a time."""
    M, B = w.shape
    F = bins.shape[1]
    wt = w.to(torch.float32).t().contiguous()              # [B, M]
    b = bins.to(torch.int64)
    out_t = torch.zeros(F * num_bins + 1, M, dtype=torch.float32,
                        device=w.device)
    for f in range(F):
        col = b[:, f]
        ids = torch.where((col >= 0) & (col < num_bins), col + f * num_bins,
                          F * num_bins)
        out_t.index_add_(0, ids, wt)
    return out_t[:-1].t().contiguous()


def grad_hist_ref(bins, node_ids, grad, hess, num_nodes: int,
                  num_bins: int):
    """Plain version of K2 and K3: g and h rounded to bf16, then exact f32
    scatter sums.  Returns (G, H), each [num_nodes, F, num_bins]."""
    return scatter_sums(bins, node_ids, _bf16(grad), _bf16(hess), num_nodes,
                        num_bins)


def _columns(bins, f_offset: int, f_count: int):
    """The plain versions' column window: a copy of the columns."""
    if f_offset == 0 and f_count == bins.shape[1]:
        return bins
    return bins[:, f_offset:f_offset + f_count].contiguous()


# K2 and K3 compute the same function; the fused kernel's plain version is
# the same code
grad_hist_fused_ref = grad_hist_ref


# -- checks and launch plans ------------------------------------------------
def _check_bins(bins, num_bins: int) -> None:
    CHECK(bins.dim() == 2, f"bins must be [B, F], got {tuple(bins.shape)}")
    CHECK(bins.dtype in (torch.uint8, torch.int32),
          f"bins must be uint8 or int32, got {bins.dtype}")
    CHECK(bins.is_contiguous(), "bins must be contiguous")
    CHECK(2 <= num_bins <= 1024, f"num_bins must be in [2, 1024], got "
                                 f"{num_bins}")
    CHECK(bins.shape[1] <= 65535, "at most 65535 features per launch")


def _check_rows(name: str, t, dtype, B: int, device) -> None:
    CHECK(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    CHECK(t.shape == (B,), f"{name} must be [{B}], got {tuple(t.shape)}")
    CHECK(t.is_contiguous(), f"{name} must be contiguous")
    CHECK(t.device == device, f"{name} is on {t.device}, bins on {device}")


def _window(bins, f_offset: int, f_count: Optional[int]) -> int:
    """Width of the column window ``[f_offset, f_offset + f_count)`` of
    ``bins`` (every column from ``f_offset`` on when ``f_count`` is None)."""
    F = bins.shape[1]
    if f_count is None:
        f_count = F - f_offset
    CHECK(f_offset >= 0 and f_count >= 1 and f_offset + f_count <= F,
          f"column window [{f_offset}, {f_offset + f_count}) lies outside "
          f"{F} features")
    return f_count


def _check_cuda(t) -> None:
    CHECK(t.device.type == "cuda",
          f"the CUDA histogram kernels take CPU or CUDA tensors, got "
          f"{t.device}")


def _chunks(num_rows: int, ctas_per_chunk: int,
            round_down: bool = False) -> Tuple[int, int]:
    """(n_chunks, rows_per_chunk): row chunks of whole tiles, sized from
    the shapes alone so the summation order never depends on the card.
    ``round_down`` keeps a launch within ``_TARGET_CTAS`` (8 waves of one
    CTA on each of the H100's 132 SMs, or 4 of two), where rounding up
    would start a ninth wave for a few CTAs."""
    tiles = -(-num_rows // TILE)
    want = (_TARGET_CTAS // ctas_per_chunk if round_down
            else -(-_TARGET_CTAS // ctas_per_chunk))
    n_chunks = max(1, min(tiles, want))
    rows_per_chunk = -(-tiles // n_chunks) * TILE
    return -(-num_rows // rows_per_chunk), rows_per_chunk


class MatmulPlan(NamedTuple):
    """K1's launch: row chunks, warps, CTAs and shared memory."""
    n_chunks: int
    rows_per_chunk: int
    slices: int          # 64-bin slices per feature
    units: int           # (feature, slice) pairs, one warp each
    warps: int           # warps per CTA
    groups: int          # CTAs per (row chunk, m-block)
    m_blocks: int        # 64-row blocks of W
    span: int            # most feature columns one CTA stages
    bins_pitch: int      # bytes per staged bins row
    smem: int            # dynamic shared memory per CTA
    grid: Tuple[int, int, int]   # (groups, n_chunks, m_blocks)


def _unit_plan(num_feature: int, num_bins: int, per_cta: int = _WARPS):
    """(slices, units, warps, groups, span): the (feature, 64-bin slice)
    units K1 gives its warps and K3 its consumer warpgroups, ``per_cta``
    to a CTA, and the most feature columns one CTA's units touch."""
    slices = -(-num_bins // _SLICE)
    units = num_feature * slices
    warps = min(units, per_cta)
    groups = -(-units // per_cta)
    # `warps` consecutive units starting anywhere in a feature touch at
    # most this many features
    span = min(num_feature, (warps + slices - 2) // slices + 1)
    return slices, units, warps, groups, span


def hist_matmul_plan(m: int, num_rows: int, num_feature: int,
                     num_bins: int, bin_bytes: int) -> MatmulPlan:
    """K1's launch plan, from the shapes alone; ``hist.cu``'s
    ``matmul_plan`` computes the same.  A warp owns one (feature, 64-bin
    slice) unit of one 64-row block of W; a CTA of up to 8 warps stages a
    two-stage ring of W tiles ``[64][TILE + 8]`` bf16 and of bins rows
    holding the 16-byte granules over its features' columns."""
    slices, units, warps, groups, span = _unit_plan(num_feature, num_bins)
    # a row's columns start anywhere in a 16-byte granule: up to 15 B ahead
    bins_pitch = 16 * ((15 + span * bin_bytes + 15) // 16)
    smem = 2 * (_M_BLOCK * _W_PITCH * 2 + TILE * bins_pitch)
    m_blocks = -(-m // _M_BLOCK)
    n_chunks, rows_per_chunk = _chunks(num_rows, groups * m_blocks,
                                       round_down=True)
    return MatmulPlan(n_chunks, rows_per_chunk, slices, units, warps, groups,
                      m_blocks, span, bins_pitch, smem,
                      (groups, n_chunks, m_blocks))


class FusedPlan(NamedTuple):
    """K3's launch: row chunks, node blocks, warpgroups, stages, shared
    memory."""
    n_chunks: int
    rows_per_chunk: int
    cols: int            # wgmma's N: the G and H columns of a node block
    node_block: int      # nodes per CTA (cols / 2)
    m_blocks: int        # node blocks (grid z)
    slices: int          # 64-bin slices per feature
    units: int           # (feature, 64-bin slice) pairs
    consumers: int       # consumer warpgroups per CTA
    units_per_wg: int    # units a consumer warpgroup owns
    groups: int          # CTAs per (row chunk, node block)
    span: int            # most feature columns one CTA reads
    stage_rows: int      # rows a stage holds
    bins_bulk: bool      # bins as whole rows by one bulk copy a stage
    slab_pitch: int      # bytes per staged bins row
    smem: int            # dynamic shared memory per CTA
    threads: int         # per CTA: the consumers and one producer warpgroup
    grid: Tuple[int, int, int]   # (groups, n_chunks, m_blocks)


def grad_hist_fused_plan(num_nodes: int, num_rows: int, num_feature: int,
                         num_bins: int, bin_bytes: int,
                         ld_bins: Optional[int] = None,
                         aligned: bool = True,
                         listed: bool = False) -> FusedPlan:
    """K3's launch plan, from the shapes alone; ``hist.cu``'s ``launch_k3``
    computes the same.  A node block holds ``cols / 2`` nodes (twice the
    nodes as a power of two, 8 to 64 columns: G and H of each); a CTA's 4
    consumer warpgroups each own ``units_per_wg`` (feature, 64-bin slice)
    units (4 up to 16 columns, 2 at 32, 1 at 64), and its producer
    warpgroup stages ``stage_rows`` = 512 rows at a time.  The bins come as
    whole rows of ``ld_bins`` columns (``num_feature`` by default) by bulk
    copy when the array is 16-byte ``aligned`` and a stage of them fits
    ``_K3_BULK_SLAB``, else as the 16-byte granules over the CTA's span.
    The ``listed`` mode reads rows through a row list: granules, a byte
    more a staged row (its shift in its first granule), and the same grid,
    whose chunks are cut from the list's offsets (:func:`listed_chunk`)."""
    cols = 8
    while cols < 2 * num_nodes and cols < _K3_MAX_COLS:
        cols *= 2
    units_per_wg = 4 if cols <= 16 else 2 if cols <= 32 else 1
    slices, units, _, groups, span = _unit_plan(
        num_feature, num_bins, _K3_CONSUMERS * units_per_wg)
    node_block = cols // 2
    m_blocks = -(-num_nodes // node_block)
    rows = 2 * TILE
    ld = (num_feature if ld_bins is None else ld_bins) * bin_bytes
    bulk = aligned and not listed and rows * ld <= _K3_BULK_SLAB
    # granules: a row's columns start anywhere in a 16-byte granule
    slab_pitch = ld if bulk else 16 * ((15 + span * bin_bytes + 15) // 16)
    # 1024 bytes to align the B stages, then B and the patterns, the raw
    # rows, and an 8-byte mbarrier a stage of each ring (built: full and
    # empty)
    smem = (1024 + _K3_B_STAGES * (rows * cols * 2 + span * rows * 2)
            + _K3_RAW_STAGES * (rows * (13 if listed else 12)
                                + rows * slab_pitch)
            + 8 * (_K3_RAW_STAGES + 2 * _K3_B_STAGES))
    n_chunks, rows_per_chunk = _chunks(num_rows, groups * m_blocks,
                                       round_down=True)
    return FusedPlan(n_chunks, rows_per_chunk, cols, node_block, m_blocks,
                     slices, units, _K3_CONSUMERS, units_per_wg, groups,
                     span, rows, bulk, slab_pitch, smem,
                     128 * (_K3_CONSUMERS + 1),
                     (groups, n_chunks, m_blocks))


def listed_chunk(lo: int, hi: int, n_chunks: int,
                 chunk: int) -> Tuple[int, int]:
    """The positions ``[begin, end)`` of the row list that chunk ``chunk``
    of a listed K3 launch reads, for a node block whose rows lie at
    ``[lo, hi)``; ``hist.cu``'s ``grad_hist_fused_kernel`` computes the
    same from the offsets: ``ceil((hi - lo) / n_chunks)`` positions a
    chunk, rounded up to whole tiles, the last chunks short or empty."""
    per = -(-(hi - lo) // n_chunks)
    per = -(-per // TILE) * TILE
    begin = min(hi, lo + chunk * per)
    return begin, min(hi, begin + per)


def row_partition_plan(num_rows: int, num_nodes: int) -> Tuple[int, int]:
    """(parts, rows_per_part) of :func:`row_partition`: a warp a part of
    whole tiles, at least ``_PART_ROWS`` rows, at most ``_PART_MAX`` parts
    and ``_PART_COUNTS`` (node, part) counts.  The list it makes does not
    depend on the plan."""
    most = max(1, min(_PART_MAX, _PART_COUNTS // num_nodes))
    per = max(_PART_ROWS, -(-num_rows // most))
    per = -(-per // TILE) * TILE
    return max(1, -(-num_rows // per)), per


def row_partition_ref(node_ids, num_nodes: int):
    """Plain version of :func:`row_partition`: a stable sort of the ids,
    with every id outside ``[0, num_nodes)`` last."""
    ids = node_ids.to(torch.int64)
    key = torch.where((ids >= 0) & (ids < num_nodes), ids, num_nodes)
    rows = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = torch.bincount(key, minlength=num_nodes + 1)[:num_nodes]
    offsets = torch.zeros(num_nodes + 1, dtype=torch.int64,
                          device=ids.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return rows, offsets.to(torch.int32)


def _library():
    from dmlc_core_tpu_torch.ops._build import load_library

    lib = load_library()
    CHECK(lib.dmlc_hist_tile() == TILE,
          f"hist.cu stages {lib.dmlc_hist_tile()} rows, wrapper {TILE}")
    return lib


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.dmlc_hist_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({msg})")


# -- wrappers ---------------------------------------------------------------
def hist_matmul_cuda(w, bins, num_bins: int, f_offset: int = 0,
                     f_count: Optional[int] = None):
    """K1 on the card: ``[M, F*num_bins]`` f32 from ``w`` [M, B] bf16 and
    the ``F = f_count`` columns from ``f_offset`` of ``bins`` [B, F_all]
    uint8/int32 (all of them by default).  CPU tensors take
    :func:`hist_matmul_ref` on a copy of the window."""
    _check_bins(bins, num_bins)
    CHECK(w.dim() == 2 and w.dtype == torch.bfloat16 and w.is_contiguous(),
          f"w must be a contiguous [M, B] bf16 matrix, got "
          f"{tuple(w.shape)} {w.dtype}")
    M, B = w.shape
    F = _window(bins, f_offset, f_count)
    CHECK(bins.shape[0] == B, f"w has {B} rows, bins {bins.shape[0]}")
    CHECK(w.device == bins.device, f"w on {w.device}, bins on {bins.device}")
    if w.device.type == "cpu":
        return hist_matmul_ref(w, _columns(bins, f_offset, F), num_bins)
    _check_cuda(w)
    out = torch.empty(M, F * num_bins, dtype=torch.float32, device=w.device)
    if B == 0 or M == 0:
        return out.zero_()
    CHECK(B < 2**31 - 8, f"at most 2**31 - 8 rows per launch, got {B}")
    plan = hist_matmul_plan(M, B, F, num_bins, bins.element_size())
    # the kernel copies W rows in 16-byte pieces: rows of a multiple of 8
    # bf16 from a 16-byte-aligned start, else a row-padded copy
    if B % 8:
        w = torch.nn.functional.pad(w, (0, -B % 8))
    elif w.data_ptr() % 16:
        w = w.clone()
    partial = out if plan.n_chunks == 1 else torch.empty(
        plan.n_chunks * M * F * num_bins, dtype=torch.float32,
        device=w.device)
    lib = _library()
    with torch.cuda.device(w.device):
        rc = lib.dmlc_hist_matmul(
            w.data_ptr(), bins.data_ptr(), int(bins.dtype == torch.uint8),
            B, F, bins.shape[1], f_offset, M, num_bins, w.shape[1],
            plan.rows_per_chunk, plan.n_chunks,
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "hist_matmul_cuda")
    LAUNCHES["hist_matmul_cuda"] += 1
    return out


def node_weights(node_ids, grad, hess, num_nodes: int):
    """The reference K2's weight matrix ``[nodehot*g ; nodehot*h]`` in
    bf16, [2*n_pad, B]; rows of nodes outside ``[0, num_nodes)`` stay zero.
    No histogram path of the port builds it: it is the W that K1's checks
    and tools hand :func:`hist_matmul_cuda`."""
    n_pad = _pad_nodes(num_nodes)
    iota = torch.arange(n_pad, dtype=torch.int32, device=node_ids.device)
    nodehot = node_ids[None, :] == iota[:, None]           # [n_pad, B]
    return torch.cat([torch.where(nodehot, grad[None, :], 0.0),
                      torch.where(nodehot, hess[None, :], 0.0)]
                     ).to(torch.bfloat16)


def _check_grad_args(bins, node_ids, grad, hess, num_nodes: int,
                     num_bins: int) -> None:
    _check_bins(bins, num_bins)
    CHECK(num_nodes >= 1, f"num_nodes must be >= 1, got {num_nodes}")
    for name, t, dt in (("node_ids", node_ids, torch.int32),
                        ("grad", grad, torch.float32),
                        ("hess", hess, torch.float32)):
        _check_rows(name, t, dt, bins.shape[0], bins.device)


def grad_hist_cuda(bins, node_ids, grad, hess, num_nodes: int,
                   num_bins: int, f_offset: int = 0,
                   f_count: Optional[int] = None, rows=None, offsets=None):
    """K2: (G, H), each [num_nodes, F, num_bins] f32 over the ``F =
    f_count`` columns from ``f_offset`` (all by default).

    K2 and K3 compute one function.  The reference's K2 builds W in XLA
    and sweeps node blocks for deep levels; on the card the fastest kernel
    for the function is K3's, which needs no W, so a CUDA tensor takes
    :func:`grad_hist_fused_cuda`'s kernel over every node in one launch
    (counted under ``LAUNCHES["grad_hist_fused_cuda"]``) and K2 and K3
    give the same bits, the listed mode (``rows``, ``offsets``) included.
    CPU tensors take :func:`grad_hist_ref` on a copy of the window."""
    return grad_hist_fused_cuda(bins, node_ids, grad, hess, num_nodes,
                                num_bins, f_offset, f_count, rows=rows,
                                offsets=offsets)


def grad_hist_fused_cuda(bins, node_ids, grad, hess, num_nodes: int,
                         num_bins: int, f_offset: int = 0,
                         f_count: Optional[int] = None, rows=None,
                         offsets=None):
    """K3: (G, H), each [num_nodes, F, num_bins] f32 over the ``F =
    f_count`` columns from ``f_offset`` (all by default), on Hopper's
    ``wgmma``, transposed: per (feature, 64-bin slice) unit and node block,
    the bin one-hot (A, built in registers) times the node-masked g/h rows
    (B, g and h rounded to bf16, built once a stage in shared memory for
    every unit of the CTA), up to 32 nodes per CTA
    (:func:`grad_hist_fused_plan`; ``tools/k3_variants.py`` times its
    parts).  It allocates only ``out`` and the row chunks' partials; no W
    exists.  Rows whose node lies outside ``[0, num_nodes)`` add nothing,
    nor do bins outside ``[0, num_bins)``.

    With ``rows`` and ``offsets``, :func:`row_partition` of ``node_ids``,
    it runs listed: each node block reads only its nodes' rows, through the
    list, and no other row is read (the same sums, added in another
    order).  CPU tensors take :func:`grad_hist_fused_ref` on a copy of the
    window, of the listed rows in the listed mode: with the list grouped
    stably, every (node, feature, bin) adds its rows in row order, so the
    result is bitwise the dense call's."""
    _check_grad_args(bins, node_ids, grad, hess, num_nodes, num_bins)
    B = bins.shape[0]
    F = _window(bins, f_offset, f_count)
    listed = rows is not None
    if listed:
        _check_rows("rows", rows, torch.int32, B, bins.device)
        CHECK(offsets is not None and offsets.dtype == torch.int32
              and offsets.shape == (num_nodes + 1,)
              and offsets.device == bins.device,
              f"offsets must be [{num_nodes + 1}] int32 on {bins.device}")
    if bins.device.type == "cpu":
        cols = _columns(bins, f_offset, F)
        if listed:
            keep = rows[:int(offsets[num_nodes])].to(torch.int64)
            return grad_hist_fused_ref(cols[keep], node_ids[keep],
                                       grad[keep], hess[keep], num_nodes,
                                       num_bins)
        return grad_hist_fused_ref(cols, node_ids, grad, hess, num_nodes,
                                   num_bins)
    _check_cuda(bins)
    CHECK(num_nodes < 65535, f"at most 65534 nodes per launch, got "
                             f"{num_nodes}")
    out = torch.empty(2, num_nodes, F, num_bins, dtype=torch.float32,
                      device=bins.device)
    if B == 0:
        out.zero_()
        return out[0], out[1]
    CHECK(not listed or B < 2**31,
          f"at most 2**31 - 1 rows in a listed launch, got {B}")
    plan = grad_hist_fused_plan(num_nodes, B, F, num_bins,
                                bins.element_size(), bins.shape[1],
                                bins.data_ptr() % 16 == 0, listed)
    partial = out if plan.n_chunks == 1 else torch.empty(
        plan.n_chunks * out.numel(), dtype=torch.float32, device=bins.device)
    lib = _library()
    with torch.cuda.device(bins.device):
        rc = lib.dmlc_grad_hist_fused(
            bins.data_ptr(), int(bins.dtype == torch.uint8),
            node_ids.data_ptr(), grad.data_ptr(), hess.data_ptr(),
            rows.data_ptr() if listed else None,
            offsets.data_ptr() if listed else None,
            B, F, bins.shape[1], f_offset, num_nodes, num_bins,
            plan.rows_per_chunk, plan.n_chunks, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "grad_hist_fused_cuda")
    LAUNCHES["grad_hist_fused_cuda"] += 1
    return out[0], out[1]


def row_partition(node_ids, num_nodes: int):
    """The rows of ``node_ids`` [B] int32 grouped by node id, stable:
    ``(rows, offsets)``, ``rows`` [B] int32 holding node n's rows in row
    order at positions ``[offsets[n], offsets[n + 1])`` of ``offsets``
    [num_nodes + 1] int32; rows whose id lies outside ``[0, num_nodes)``
    are left out (positions from ``offsets[num_nodes]`` on are not
    written).  K3's listed mode reads a level through it.

    On the card a counting partition in ``hist.cu`` (per-warp counts, one
    ordered scan, a stable scatter; :func:`row_partition_plan`), launched
    on the current stream with no read by the host: the listed count stays
    on the card.  Its one buffer holds the list, the counts and the
    offsets.  CPU tensors take :func:`row_partition_ref`; both give the
    same list, the only stable grouping."""
    CHECK(node_ids.dim() == 1 and node_ids.dtype == torch.int32
          and node_ids.is_contiguous(),
          f"node_ids must be a contiguous [B] int32 vector, got "
          f"{tuple(node_ids.shape)} {node_ids.dtype}")
    CHECK(1 <= num_nodes < 65535, f"num_nodes must be in [1, 65534], got "
                                  f"{num_nodes}")
    if node_ids.device.type == "cpu":
        return row_partition_ref(node_ids, num_nodes)
    _check_cuda(node_ids)
    B = node_ids.shape[0]
    CHECK(B < 2**31, f"at most 2**31 - 1 rows, got {B}")
    parts, per = row_partition_plan(B, num_nodes)
    n = num_nodes * parts + 1
    buf = torch.empty(B + n + num_nodes + 1, dtype=torch.int32,
                      device=node_ids.device)
    rows, counts, offsets = buf[:B], buf[B:B + n], buf[B + n:]
    if B == 0:
        offsets.zero_()
        return rows, offsets
    lib = _library()
    with torch.cuda.device(node_ids.device):
        rc = lib.dmlc_row_partition(
            node_ids.data_ptr(), B, num_nodes, parts, per, rows.data_ptr(),
            counts.data_ptr(), offsets.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "row_partition")
    LAUNCHES["row_partition"] += 1
    return rows, offsets


# -- K4: the model-sharded histogram ------------------------------------------
def sharded_hist_plan(model_axis: Optional[str], num_feature: int,
                      num_nodes: int, num_bins: int, mesh=None):
    """The mesh to run :func:`grad_hist_sharded_cuda` over, or None, where
    callers take ``"onehot"`` on all features instead.

    The reference's gate (``hist_pallas.sharded_hist_plan``): an ambient
    (or given) mesh carrying ``model_axis``, features dividing evenly
    across it, and a per-shard ``F/mp`` slice that holds at least an
    8-node accumulator block (the reference sweeps node blocks inside each
    shard; the port's kernel needs no blocks).  The reference also checks
    that the global batch divides across the data axis; here rows arrive
    already sharded, one part per rank, so there is nothing to divide.
    ``num_nodes`` does not change the answer (node blocks cover any
    count); it is kept for the reference's signature."""
    if model_axis is None:
        return None
    if mesh is None:
        mesh = ambient_mesh()
    if mesh is None:
        return None
    mp = mesh.shape.get(model_axis)
    if (mp is None or num_feature % mp != 0
            or not _acc_fits(8, num_feature // mp, num_bins)):
        return None
    return mesh


def _shard_window(bins, mesh, model_axis: str) -> Tuple[int, int]:
    f_count = bins.shape[1] // mesh.shape[model_axis]
    return mesh.coord(model_axis) * f_count, f_count


def _shard_collectives(G, H, mesh, model_axis: str):
    """Steps 2 and 3 of K4: the sum over the group of the mesh's row axes
    (the reference's ``psum`` over its ``data_axis``), then the model
    group's windows concatenated on the feature axis in model-coordinate
    order (what GSPMD does before the split scan)."""
    gh = torch.stack([G, H])                         # [2, n, F/mp, nbins]
    if mesh.row_axes:
        gh = MeshCollective(mesh, mesh.row_axes).psum(gh)
    gh = MeshCollective(mesh, model_axis).allgather(gh, dim=2)
    return gh[0], gh[1]


def grad_hist_sharded_ref(bins, node_ids, grad, hess, num_nodes: int,
                          num_bins: int, mesh, model_axis: str):
    """Plain version of K4: the rank's window as a copy,
    :func:`grad_hist_ref`, then the same collectives."""
    f_offset, f_count = _shard_window(bins, mesh, model_axis)
    G, H = grad_hist_ref(_columns(bins, f_offset, f_count), node_ids, grad,
                         hess, num_nodes, num_bins)
    return _shard_collectives(G, H, mesh, model_axis)


def grad_hist_sharded_cuda(bins, node_ids, grad, hess, num_nodes: int,
                           num_bins: int, mesh, model_axis: str):
    """K4: (G, H), each [num_nodes, F, num_bins] f32, identical on every
    rank of ``mesh``.

    ``bins`` [B_local, F] are this rank's rows, all F columns; ranks that
    share a data coordinate hold the same rows.  The rank runs K3's kernel
    (the reference's K2 or K3: one function, one kernel on the card) on its
    window of ``F/mp`` columns in place, sums the result over the group of
    the mesh's row axes (``Mesh.row_axes``, where the reference takes a
    ``data_axis``) and gathers the windows of its ``model_axis`` group.
    CPU tensors take :func:`grad_hist_sharded_ref`.
    Every rank of the mesh must make the call (a rank with no rows joins
    with zeros)."""
    _check_grad_args(bins, node_ids, grad, hess, num_nodes, num_bins)
    CHECK(sharded_hist_plan(model_axis, bins.shape[1], num_nodes, num_bins,
                            mesh) is not None,
          f"no sharded plan for {bins.shape[1]} features over "
          f"{model_axis!r} of mesh {mesh.shape} at {num_bins} bins")
    if bins.device.type == "cpu":
        return grad_hist_sharded_ref(bins, node_ids, grad, hess, num_nodes,
                                     num_bins, mesh, model_axis)
    _check_cuda(bins)
    f_offset, f_count = _shard_window(bins, mesh, model_axis)
    G, H = grad_hist_fused_cuda(bins, node_ids, grad, hess, num_nodes,
                                num_bins, f_offset, f_count)
    LAUNCHES["grad_hist_sharded_cuda"] += 1
    return _shard_collectives(G, H, mesh, model_axis)


def _probe_cases(device):
    """The probe's small cases, one per wrapper (K1, K2, K3) on the whole
    array and on the window of column 1 alone: ``(label, wrapper call on
    tensors on device, plain call on CPU tensors)``; K1's calls return a
    tensor, K2's and K3's (G, H).  K1 takes the W the reference's K2 would
    build."""
    gen = torch.Generator().manual_seed(0)
    B, F, nbins, n = 1000, 3, 256, 5
    bins = torch.randint(0, nbins, (B, F), generator=gen).to(torch.uint8)
    node = torch.randint(-1, n, (B,), generator=gen).to(torch.int32)
    g = torch.randn(B, generator=gen)
    h = torch.rand(B, generator=gen)
    w = node_weights(node, g, h, n)
    d_bins, d_node, d_g, d_h, d_w = (t.to(device)
                                     for t in (bins, node, g, h, w))
    cases = []
    for window in ((0, F), (1, 1)):
        cols = _columns(bins, *window)
        cases.append((
            f"hist_matmul_cuda columns {window}",
            functools.partial(hist_matmul_cuda, d_w, d_bins, nbins, *window),
            functools.partial(hist_matmul_ref, w, cols, nbins)))
        for fn in (grad_hist_cuda, grad_hist_fused_cuda):
            cases.append((
                f"{fn.__name__} columns {window}",
                functools.partial(fn, d_bins, d_node, d_g, d_h, n, nbins,
                                  *window),
                functools.partial(grad_hist_ref, cols, node, g, h, n,
                                  nbins)))
    return cases


@functools.lru_cache(maxsize=None)
def kernels_available() -> bool:
    """Build the kernel library and hold one small case of each wrapper
    (:func:`_probe_cases`: K1, K2, K3, each also on a column window)
    against its plain version, as the reference's probes check its
    kernels.  False without a card; raises when the build or the check
    fails on one (there is no downgrade to another formulation)."""
    if not torch.cuda.is_available():
        return False
    for label, kernel, plain in _probe_cases(torch.device("cuda")):
        got, want = kernel(), plain()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        for a, b in zip(got, want):
            if not torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-5):
                raise RuntimeError(
                    f"{label} disagrees with its plain version on the probe "
                    f"case (max abs err "
                    f"{(a.cpu() - b).abs().max().item():.3g})")
    return True
