"""Gradient-histogram kernels for the H100: wrappers, plain versions, counts.

Counterpart of ``dmlc_core_tpu/ops/hist_pallas.py``.  The kernels live in
``csrc/hist.cu`` (CUDA C++ for ``sm_90a``, built and bound by
:mod:`._build`):

- :func:`hist_matmul_cuda` replaces ``hist_matmul_pallas`` (K1):
  ``out[m, f*nbins + b] = sum_i w[m, i] * [bins[i, f] == b]``;
- :func:`grad_hist_cuda` replaces ``grad_hist_pallas`` (K2): builds the
  bf16 weight matrix ``W = [nodehot*g ; nodehot*h]`` with PyTorch, launches
  K1's kernel and splits (G, H), sweeping node blocks for deep levels;
- :func:`grad_hist_fused_cuda` replaces ``grad_hist_pallas_fused`` (K3):
  the same (G, H) with the node one-hot built inside the kernel.

Numerics are the TPU kernels': g and h rounded to bf16 (nearest even),
sums in f32, rows whose node id lies outside ``[0, num_nodes)`` dropped.
Each kernel is bound by bytes on the H100 (see the note in ``hist.cu``);
its design keeps every sum free of atomics, so outputs are bitwise
identical from launch to launch.

Beside each kernel sits its plain PyTorch version (``*_ref``): bf16
rounding, then f32 ``index_add_`` over flat ids.  A wrapper takes the plain
version only for tensors that lie on the CPU; for a CUDA tensor it launches
the kernel or raises.  ``LAUNCHES[name]`` counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["hist_matmul_cuda", "grad_hist_cuda", "grad_hist_fused_cuda",
           "hist_matmul_ref", "grad_hist_ref", "grad_hist_fused_ref",
           "scatter_sums", "node_weights", "hist_node_block",
           "kernels_available",
           "reset_launches", "LAUNCHES", "TILE"]

# kernel launches per wrapper since the last reset_launches()
LAUNCHES: Dict[str, int] = {"hist_matmul_cuda": 0, "grad_hist_fused_cuda": 0}

TILE = 256               # rows a CTA stages per step (kTile in hist.cu)
_SMEM_BYTES = 232448     # dynamic shared memory one block may use on sm_90
_TARGET_CTAS = 1056      # CTAs per launch the row chunking aims at
_M_BLOCK = 64            # K1: weight rows per CTA
_NODE_BLOCK = 32         # K3: nodes per CTA (G and H rows: 2x)

# per-sweep budget of grad_hist_cuda's [2*n_pad, F*nbins] f32 output; deeper
# levels sweep node blocks, which also bounds the bf16 W it materialises
_ACC_BYTES_LIMIT = 8 * 1024 * 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _pad_nodes(num_nodes: int) -> int:
    """Node slots of K2's weight matrix (the TPU's multiple of 8)."""
    return -(-max(8, num_nodes) // 8) * 8


def hist_node_block(num_nodes: int, num_feature: int, num_bins: int) -> int:
    """Nodes per :func:`grad_hist_cuda` sweep: all of them when the
    ``[2*n_pad, F*nbins]`` f32 output fits ``_ACC_BYTES_LIMIT``, else the
    largest power of two (at least 8) that does."""
    if 2 * _pad_nodes(num_nodes) * num_feature * num_bins * 4 \
            <= _ACC_BYTES_LIMIT:
        return num_nodes
    block = 1 << (num_nodes - 1).bit_length()
    while block > 8 and 2 * block * num_feature * num_bins * 4 \
            > _ACC_BYTES_LIMIT:
        block //= 2
    return block


def _split_gh(out, n_pad: int, num_nodes: int, num_feature: int,
              num_bins: int):
    """[2*n_pad, F*nbins] -> (G, H) trimmed to num_nodes."""
    out = out.reshape(2, n_pad, num_feature, num_bins)
    return out[0, :num_nodes], out[1, :num_nodes]


# -- plain PyTorch versions -------------------------------------------------
def _bf16(x):
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def scatter_sums(bins, node_ids, grad, hess, num_nodes: int, num_bins: int):
    """Exact f32 (G, H) by ``index_add_`` over the flat ids
    ``node*F*nbins + f*nbins + bin``; out-of-range nodes and bins drop into
    a spill slot.  The ``"scatter"`` method and the kernels' plain versions
    share it."""
    B, F = bins.shape
    dev = bins.device
    nseg = num_nodes * F * num_bins
    node = node_ids.to(torch.int64)
    b = bins.to(torch.int64)
    ids = (node[:, None] * (F * num_bins)
           + torch.arange(F, device=dev)[None, :] * num_bins + b)
    keep = (((node >= 0) & (node < num_nodes))[:, None]
            & (b >= 0) & (b < num_bins))
    flat = torch.where(keep, ids, nseg).reshape(-1)
    out = []
    for v in (grad, hess):
        src = v.to(torch.float32)[:, None].expand(B, F).reshape(-1)
        acc = torch.zeros(nseg + 1, dtype=torch.float32, device=dev)
        acc.index_add_(0, flat, src)
        out.append(acc[:nseg].reshape(num_nodes, F, num_bins))
    return out[0], out[1]


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


def _check_cuda(t) -> None:
    CHECK(t.device.type == "cuda",
          f"the CUDA histogram kernels take CPU or CUDA tensors, got "
          f"{t.device}")


def _chunks(num_rows: int, ctas_per_chunk: int) -> Tuple[int, int]:
    """(n_chunks, rows_per_chunk): row chunks of whole tiles, sized from
    the shapes alone so the summation order never depends on the card."""
    tiles = -(-num_rows // TILE)
    n_chunks = max(1, min(tiles, -(-_TARGET_CTAS // ctas_per_chunk)))
    rows_per_chunk = -(-tiles // n_chunks) * TILE
    return -(-num_rows // rows_per_chunk), rows_per_chunk


def _matmul_smem(m_block: int, num_bins: int) -> int:
    return m_block * (num_bins + 1) * 4 + TILE * 4 + TILE * (m_block + 2) * 2


def _fused_smem(node_block: int, num_bins: int) -> int:
    return 2 * node_block * num_bins * 4 + TILE * 16


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
def hist_matmul_cuda(w, bins, num_bins: int):
    """K1 on the card: ``[M, F*num_bins]`` f32 from ``w`` [M, B] bf16 and
    ``bins`` [B, F] uint8/int32.  CPU tensors take :func:`hist_matmul_ref`."""
    _check_bins(bins, num_bins)
    CHECK(w.dim() == 2 and w.dtype == torch.bfloat16 and w.is_contiguous(),
          f"w must be a contiguous [M, B] bf16 matrix, got "
          f"{tuple(w.shape)} {w.dtype}")
    M, B = w.shape
    F = bins.shape[1]
    CHECK(bins.shape[0] == B, f"w has {B} rows, bins {bins.shape[0]}")
    CHECK(w.device == bins.device, f"w on {w.device}, bins on {bins.device}")
    if w.device.type == "cpu":
        return hist_matmul_ref(w, bins, num_bins)
    _check_cuda(w)
    out = torch.empty(M, F * num_bins, dtype=torch.float32, device=w.device)
    if B == 0 or M == 0:
        return out.zero_()
    m_block = min(M, _M_BLOCK)
    while _matmul_smem(m_block, num_bins) > _SMEM_BYTES:
        m_block -= 1
    n_chunks, rows_per_chunk = _chunks(B, F * -(-M // m_block))
    partial = out if n_chunks == 1 else torch.empty(
        n_chunks * M * F * num_bins, dtype=torch.float32, device=w.device)
    lib = _library()
    with torch.cuda.device(w.device):
        rc = lib.dmlc_hist_matmul(
            w.data_ptr(), bins.data_ptr(), int(bins.dtype == torch.uint8),
            B, F, M, num_bins, m_block, rows_per_chunk, n_chunks,
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "hist_matmul_cuda")
    LAUNCHES["hist_matmul_cuda"] += 1
    return out


def node_weights(node_ids, grad, hess, num_nodes: int):
    """K2's weight matrix ``[nodehot*g ; nodehot*h]`` in bf16,
    [2*n_pad, B]; rows of nodes outside ``[0, num_nodes)`` stay zero."""
    n_pad = _pad_nodes(num_nodes)
    iota = torch.arange(n_pad, dtype=torch.int32, device=node_ids.device)
    nodehot = node_ids[None, :] == iota[:, None]           # [n_pad, B]
    return torch.cat([torch.where(nodehot, grad[None, :], 0.0),
                      torch.where(nodehot, hess[None, :], 0.0)]
                     ).to(torch.bfloat16)


def _grad_hist_block(bins, node_ids, grad, hess, num_nodes: int,
                     num_bins: int):
    if bins.device.type == "cpu":
        return grad_hist_ref(bins, node_ids, grad, hess, num_nodes, num_bins)
    n_pad = _pad_nodes(num_nodes)
    w = node_weights(node_ids, grad, hess, num_nodes)
    out = hist_matmul_cuda(w, bins, num_bins)
    return _split_gh(out, n_pad, num_nodes, bins.shape[1], num_bins)


def grad_hist_cuda(bins, node_ids, grad, hess, num_nodes: int,
                   num_bins: int):
    """K2: (G, H), each [num_nodes, F, num_bins] f32, through K1's kernel.

    Levels whose output exceeds ``_ACC_BYTES_LIMIT`` run in node blocks:
    shifting node ids by the block base makes the kernel's own
    out-of-range drop do the partitioning."""
    _check_bins(bins, num_bins)
    CHECK(num_nodes >= 1, f"num_nodes must be >= 1, got {num_nodes}")
    B, F = bins.shape
    for name, t, dt in (("node_ids", node_ids, torch.int32),
                        ("grad", grad, torch.float32),
                        ("hess", hess, torch.float32)):
        _check_rows(name, t, dt, B, bins.device)
    block = hist_node_block(num_nodes, F, num_bins)
    if block < num_nodes:
        parts = [_grad_hist_block(bins, node_ids - b0, grad, hess,
                                  min(block, num_nodes - b0), num_bins)
                 for b0 in range(0, num_nodes, block)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    return _grad_hist_block(bins, node_ids, grad, hess, num_nodes, num_bins)


def grad_hist_fused_cuda(bins, node_ids, grad, hess, num_nodes: int,
                         num_bins: int):
    """K3: (G, H), each [num_nodes, F, num_bins] f32, with the node
    one-hot built in the kernel.  CPU tensors take
    :func:`grad_hist_fused_ref`."""
    _check_bins(bins, num_bins)
    CHECK(num_nodes >= 1, f"num_nodes must be >= 1, got {num_nodes}")
    B, F = bins.shape
    for name, t, dt in (("node_ids", node_ids, torch.int32),
                        ("grad", grad, torch.float32),
                        ("hess", hess, torch.float32)):
        _check_rows(name, t, dt, B, bins.device)
    if bins.device.type == "cpu":
        return grad_hist_fused_ref(bins, node_ids, grad, hess, num_nodes,
                                   num_bins)
    _check_cuda(bins)
    out = torch.empty(2, num_nodes, F, num_bins, dtype=torch.float32,
                      device=bins.device)
    if B == 0:
        out.zero_()
        return out[0], out[1]
    node_block = min(num_nodes, _NODE_BLOCK)
    while _fused_smem(node_block, num_bins) > _SMEM_BYTES:
        node_block -= 1
    n_chunks, rows_per_chunk = _chunks(B, F * -(-num_nodes // node_block))
    partial = out if n_chunks == 1 else torch.empty(
        n_chunks * out.numel(), dtype=torch.float32, device=bins.device)
    lib = _library()
    with torch.cuda.device(bins.device):
        rc = lib.dmlc_grad_hist_fused(
            bins.data_ptr(), int(bins.dtype == torch.uint8),
            node_ids.data_ptr(), grad.data_ptr(), hess.data_ptr(),
            B, F, num_nodes, num_bins, node_block, rows_per_chunk, n_chunks,
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "grad_hist_fused_cuda")
    LAUNCHES["grad_hist_fused_cuda"] += 1
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def kernels_available() -> bool:
    """Build the kernel library and hold one small case of each kernel
    against its plain version.  False without a card; raises when the
    build or the check fails on one (there is no downgrade to another
    formulation)."""
    if not torch.cuda.is_available():
        return False
    gen = torch.Generator().manual_seed(0)
    B, F, nbins, n = 1000, 3, 256, 5
    bins = torch.randint(0, nbins, (B, F), generator=gen).to(torch.uint8)
    node = torch.randint(-1, n, (B,), generator=gen).to(torch.int32)
    g = torch.randn(B, generator=gen)
    h = torch.rand(B, generator=gen)
    want = grad_hist_ref(bins, node, g, h, n, nbins)
    dev = torch.device("cuda")
    args = [t.to(dev) for t in (bins, node, g, h)]
    for fn in (grad_hist_cuda, grad_hist_fused_cuda):
        got = fn(*args, n, nbins)
        for a, b in zip(got, want):
            if not torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-5):
                raise RuntimeError(
                    f"{fn.__name__} disagrees with its plain version on the "
                    f"probe case (max abs err "
                    f"{(a.cpu() - b).abs().max().item():.3g})")
    return True
