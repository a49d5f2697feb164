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
  the same (G, H) with the weight rows ``[nodehot*g ; nodehot*h]`` built
  in registers inside the kernel, so no W matrix is materialised;
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
K1 and K3 run the TPU's formulation, W times a one-hot built in
registers, on the tensor cores (``mma.sync``); K3 builds W's fragments
from node/g/h in registers too, so no W exists.  The note in
``hist.cu`` gives each kernel's bounds.  Every sum is free of atomics, so
outputs are bitwise identical from launch to launch.

Beside each kernel sits its plain PyTorch version (``*_ref``): bf16
rounding, then f32 sums over flat ids (:func:`segment_sum`, which is
atomics-free on the card too).  A wrapper takes the plain version only for
tensors that lie on the CPU; for a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES[name]`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import functools
import time
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
           "kernels_available", "reset_launches", "LAUNCHES",
           "STAGE_SECONDS", "TILE"]

# kernel launches per wrapper since the last reset_launches()
LAUNCHES: Dict[str, int] = {"hist_matmul_cuda": 0, "grad_hist_fused_cuda": 0,
                            "grad_hist_sharded_cuda": 0}

# seconds grad_hist_sharded_cuda spends in each stage ("kernel",
# "all_reduce", "all_gather"), summed while this is a dict; None, the
# default, times nothing.  Timing synchronises the card around each stage.
STAGE_SECONDS: Optional[Dict[str, float]] = None

TILE = 256               # rows a CTA stages per step (kTile in hist.cu)
_SMEM_BYTES = 232448     # dynamic shared memory one block may use on sm_90
_TARGET_CTAS = 1056      # CTAs per launch the row chunking aims at
# K1 (the constants of hist.cu's matmul_plan)
_M_BLOCK = 64            # weight rows per CTA: 4 mma m-tiles of 16
_SLICE = 64              # bins per warp: 8 mma n-tiles of 8
_WARPS = 8               # (feature, bin slice) units per CTA
_K_STEP = 16             # data rows per mma (m16n8k16)
_W_PITCH = TILE + 8      # bf16 per staged W row
# K3 (K1's units and warps, and these)
_NODE_TILE = 8           # nodes per mma m-tile: their G rows, then H rows
_NODE_M_BLOCK = 32       # nodes per CTA (grid z): 4 m-tiles
# two stages of packed rows: per row pair {node, g, h} in 16 bytes, per row
# and column of the CTA (at most _WARPS) a 2-byte one-hot pattern
_FUSED_SMEM = 2 * (TILE // 2 * 16 + _WARPS * TILE * 2)

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


def _unit_plan(num_feature: int, num_bins: int):
    """(slices, units, warps, groups, span): the (feature, 64-bin slice)
    units K1 and K3 give their warps, 8 to a CTA, and the most feature
    columns one CTA's units touch."""
    slices = -(-num_bins // _SLICE)
    units = num_feature * slices
    warps = min(units, _WARPS)
    groups = -(-units // _WARPS)
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
    """K3's launch: row chunks, warps, CTAs, node blocks, shared memory."""
    n_chunks: int
    rows_per_chunk: int
    slices: int          # 64-bin slices per feature
    units: int           # (feature, slice) pairs, one warp each
    warps: int           # warps that compute per CTA (all 8 pack rows)
    groups: int          # CTAs per (row chunk, m-block)
    m_blocks: int        # 32-node blocks (grid z)
    m_tiles: int         # 8-node m-tiles a warp computes (kernel template)
    span: int            # most feature columns one CTA packs
    smem: int            # dynamic shared memory per CTA
    threads: int         # per CTA: one per row of a packed tile
    grid: Tuple[int, int, int]   # (groups, n_chunks, m_blocks)


def grad_hist_fused_plan(num_nodes: int, num_rows: int, num_feature: int,
                         num_bins: int, bin_bytes: int) -> FusedPlan:
    """K3's launch plan, from the shapes alone; ``hist.cu``'s
    ``launch_grad_hist_fused`` computes the same.  K1's units, warps and
    CTA groups; each CTA covers one m-block of 32 nodes as ``m_tiles``
    m-tiles of 8 (A rows 0-7 the nodes' G rows, 8-15 their H rows).  Its
    256 threads pack each tile once, a row each, into one of two stages
    (``bin_bytes`` does not change the plan)."""
    slices, units, warps, groups, span = _unit_plan(num_feature, num_bins)
    m_blocks = -(-num_nodes // _NODE_M_BLOCK)
    m_tiles = -(-min(num_nodes, _NODE_M_BLOCK) // _NODE_TILE)
    n_chunks, rows_per_chunk = _chunks(num_rows, groups * m_blocks,
                                       round_down=True)
    return FusedPlan(n_chunks, rows_per_chunk, slices, units, warps, groups,
                     m_blocks, m_tiles, span, _FUSED_SMEM, _WARPS * 32,
                     (groups, n_chunks, m_blocks))


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
                   f_count: Optional[int] = None):
    """K2: (G, H), each [num_nodes, F, num_bins] f32 over the ``F =
    f_count`` columns from ``f_offset`` (all by default).

    K2 and K3 compute one function.  The reference's K2 builds W in XLA
    and sweeps node blocks for deep levels; on the card the fastest kernel
    for the function is K3's, which builds W's fragments in registers, so
    a CUDA tensor takes :func:`grad_hist_fused_cuda`'s kernel over every
    node in one launch (counted under ``LAUNCHES["grad_hist_fused_cuda"]``)
    and K2 and K3 give the same bits.  CPU tensors take
    :func:`grad_hist_ref` on a copy of the window."""
    return grad_hist_fused_cuda(bins, node_ids, grad, hess, num_nodes,
                                num_bins, f_offset, f_count)


def grad_hist_fused_cuda(bins, node_ids, grad, hess, num_nodes: int,
                         num_bins: int, f_offset: int = 0,
                         f_count: Optional[int] = None):
    """K3: (G, H), each [num_nodes, F, num_bins] f32 over the ``F =
    f_count`` columns from ``f_offset`` (all by default), on the tensor
    cores: the kernel builds the weight fragments ``[nodehot*g ;
    nodehot*h]`` (g and h rounded to bf16) in registers from node/g/h, 8
    nodes per m-tile and 32 per CTA (:func:`grad_hist_fused_plan`), and
    multiplies them with the bin one-hot, also built in registers.  It
    allocates only ``out`` and the row chunks' partials; no W exists.  Rows
    whose node lies outside ``[0, num_nodes)`` add nothing, nor do bins
    outside ``[0, num_bins)``.  CPU tensors take :func:`grad_hist_fused_ref`
    on a copy of the window."""
    _check_grad_args(bins, node_ids, grad, hess, num_nodes, num_bins)
    B = bins.shape[0]
    F = _window(bins, f_offset, f_count)
    if bins.device.type == "cpu":
        return grad_hist_fused_ref(_columns(bins, f_offset, F), node_ids,
                                   grad, hess, num_nodes, num_bins)
    _check_cuda(bins)
    # the kernel packs node ids local to a 32-node block in 16 bits
    CHECK(num_nodes < 65535, f"at most 65534 nodes per launch, got "
                             f"{num_nodes}")
    out = torch.empty(2, num_nodes, F, num_bins, dtype=torch.float32,
                      device=bins.device)
    if B == 0:
        out.zero_()
        return out[0], out[1]
    plan = grad_hist_fused_plan(num_nodes, B, F, num_bins,
                                bins.element_size())
    partial = out if plan.n_chunks == 1 else torch.empty(
        plan.n_chunks * out.numel(), dtype=torch.float32, device=bins.device)
    lib = _library()
    with torch.cuda.device(bins.device):
        rc = lib.dmlc_grad_hist_fused(
            bins.data_ptr(), int(bins.dtype == torch.uint8),
            node_ids.data_ptr(), grad.data_ptr(), hess.data_ptr(),
            B, F, bins.shape[1], f_offset, num_nodes, num_bins,
            plan.rows_per_chunk, plan.n_chunks, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "grad_hist_fused_cuda")
    LAUNCHES["grad_hist_fused_cuda"] += 1
    return out[0], out[1]


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


@contextlib.contextmanager
def _stage(name: str):
    if STAGE_SECONDS is None:
        yield
        return
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    start = time.perf_counter()
    yield
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    STAGE_SECONDS[name] = (STAGE_SECONDS.get(name, 0.0)
                           + time.perf_counter() - start)


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
        with _stage("all_reduce"):
            gh = MeshCollective(mesh, mesh.row_axes).psum(gh)
    with _stage("all_gather"):
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
    with _stage("kernel"):
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
