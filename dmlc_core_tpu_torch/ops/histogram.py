"""Quantile binning and gradient histograms (the hist-GBDT core).

Counterpart of ``dmlc_core_tpu/ops/histogram.py``.  The quantile functions
are a numpy copy of the reference's; the device half runs on tensors:

- :func:`apply_bins` is ``torch.searchsorted(right=True)`` per feature plus
  the NaN -> ``missing_bin`` override, bitwise equal to the reference;
- :func:`grad_histogram` offers the reference's methods:
  ``"scatter"`` (exact f32 ``index_add_`` over flat ids), ``"onehot"`` (a
  bf16 one-hot times the bf16 node-weight matrix, summed in f32 by
  ``torch.matmul``), and ``"pallas"`` / ``"pallas_fused"``, which keep the
  reference's names so its parameters load unchanged and here mean the
  hand-written CUDA kernels of :mod:`.hist_cuda` (K2 and K3).

Under an ambient mesh (``with mesh:``) each rank holds its own rows.
``grad_histogram(model_axis=...)`` then takes K4 where the reference's
``sharded_hist_plan`` gives a plan, and every other method sums its
histogram over the mesh's ``data`` group; :func:`distributed_quantile_
boundaries` gives every rank the same bin edges.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from dmlc_core_tpu_torch.collective.mesh_collectives import MeshCollective
from dmlc_core_tpu_torch.ops import hist_cuda
from dmlc_core_tpu_torch.parallel.mesh import ambient_mesh
from dmlc_core_tpu_torch.utils.device import resolve_device
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["quantile_boundaries", "apply_bins", "grad_histogram",
           "bin_onehot", "resolve_hist_method", "local_quantile_summary",
           "merged_quantile_boundaries", "distributed_quantile_boundaries",
           "data_allreduce", "as_tensor"]

METHODS = ("pallas", "pallas_fused", "onehot", "scatter")


def as_tensor(x, device: torch.device, dtype=None):
    """``x`` (numpy array, tensor or sequence) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    x = np.asarray(x)
    if not x.flags.writeable:       # torch does not wrap read-only memory
        x = x.copy()
    return torch.as_tensor(x, dtype=dtype, device=device)


def resolve_hist_method(method: str, *tensors) -> str:
    """Resolve ``"auto"``: the CUDA kernel (``"pallas"``) for tensors on the
    card, the exact scatter for tensors on the CPU.  On a card the kernels
    are built and checked first, and a failure raises."""
    if method != "auto":
        CHECK(method in METHODS, f"unknown hist method {method!r}")
        return method
    on_cuda = any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
                  for t in tensors)
    if not on_cuda:
        return "scatter"
    hist_cuda.kernels_available()
    return "pallas"


def bin_onehot(bins, num_bins: int, dtype=torch.bfloat16):
    """One-hot encode binned features: [B, F] int -> [B, F*num_bins]."""
    bins = bins.to(torch.int64)                 # narrow dtypes must not wrap
    B, F = bins.shape
    iota = torch.arange(num_bins, device=bins.device)
    return (bins[:, :, None] == iota).to(dtype).reshape(B, F * num_bins)


def _strictly_increasing(bounds: np.ndarray) -> np.ndarray:
    """Make per-feature boundaries strictly increasing (magnitude-relative
    nudge) so searchsorted is stable on repeated quantiles."""
    eps = np.float32(1e-6)
    scale = np.maximum(np.abs(bounds), np.float32(1.0))
    return np.maximum.accumulate(
        bounds + eps * scale * np.arange(bounds.shape[1], dtype=np.float32),
        axis=1)


def quantile_boundaries(sample: np.ndarray, num_bins: int) -> np.ndarray:
    """Per-feature quantile split points [F, num_bins-1] from a host
    sample; value v lands in bin ``searchsorted(boundaries[f], v)``."""
    sample = np.asarray(sample, dtype=np.float32)
    qs = np.linspace(0, 1, num_bins + 1)[1:-1]
    return _strictly_increasing(_nan_aware_quantile(sample, qs))


def _nan_aware_quantile(sample: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Per-feature quantiles [F, len(qs)] ignoring NaNs; all-NaN features
    get zero boundaries."""
    if np.isnan(sample).any():
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="All-NaN slice")
            out = np.nanquantile(sample, qs, axis=0).T.astype(np.float32)
        return np.nan_to_num(out, nan=0.0)
    return np.quantile(sample, qs, axis=0).T.astype(np.float32)


def local_quantile_summary(sample: np.ndarray, num_points: int):
    """Fixed-size mergeable quantile summary of one data shard:
    ``(points [F, num_points] float32, finite counts [F] float32)``."""
    sample = np.asarray(sample, dtype=np.float32)
    n, F = sample.shape
    if n == 0:
        return (np.zeros((F, num_points), np.float32),
                np.zeros((F,), np.float32))
    qs = np.linspace(0, 1, num_points)
    points = _nan_aware_quantile(sample, qs)
    counts = np.sum(np.isfinite(sample), axis=0).astype(np.float32)
    return points, counts


def merged_quantile_boundaries(points: np.ndarray, counts,
                               num_bins: int) -> np.ndarray:
    """Merge per-shard summaries ([W, F, K] points, [W, F] or [W] counts)
    into boundaries [F, num_bins-1] by pooled weighted quantiles
    (inverted-CDF rule); features with zero total mass get zeros."""
    points = np.asarray(points, dtype=np.float32)
    CHECK(points.ndim == 3, f"points must be [W, F, K], got {points.shape}")
    W, F, K = points.shape
    counts = np.asarray(counts, dtype=np.float64)
    if counts.ndim == 1:
        counts = np.broadcast_to(counts[:, None], (W, F))
    CHECK(counts.shape == (W, F),
          f"counts must be [W]={W} or [W, F]={(W, F)}, got {counts.shape}")
    CHECK(counts.sum() > 0, "merged_quantile_boundaries: all shards empty")
    pooled = np.swapaxes(points, 0, 1).reshape(F, W * K)
    mass = np.repeat(counts.T, K, axis=1) / K            # [F, W*K]
    order = np.argsort(pooled, axis=1, kind="stable")
    v_sorted = np.take_along_axis(pooled, order, axis=1)
    cum = np.cumsum(np.take_along_axis(mass, order, axis=1), axis=1)
    total = counts.sum(axis=0)                           # [F]
    out = np.empty((F, num_bins - 1), np.float32)
    for j in range(num_bins - 1):
        target = total * (j + 1) / num_bins              # [F]
        idx = np.minimum((cum < target[:, None]).sum(axis=1), W * K - 1)
        out[:, j] = v_sorted[np.arange(F), idx]
    out[total == 0] = 0.0
    return _strictly_increasing(out)


def distributed_quantile_boundaries(sample: np.ndarray, num_bins: int,
                                    comm=None,
                                    num_points: Optional[int] = None,
                                    count: Optional[int] = None
                                    ) -> np.ndarray:
    """Quantile bin boundaries consistent across data-parallel workers.

    Each worker summarises its local ``sample``
    (:func:`local_quantile_summary`), allgathers the fixed-size summaries
    through ``comm`` (any object with a rabit-shaped ``allgather``, e.g.
    :mod:`dmlc_core_tpu_torch.collective`) and merges them
    deterministically, so all ranks return identical boundaries.  With
    ``comm=None`` this is :func:`quantile_boundaries`.

    ``num_points`` is the summary resolution (default ``8 * num_bins``, at
    least 64).  ``count`` is the shard's true row count when ``sample`` is
    a subsample of it, so imbalanced shards merge with their real mass.
    """
    if comm is None:
        return quantile_boundaries(sample, num_bins)
    K = num_points or max(64, 8 * num_bins)
    points, fc = local_quantile_summary(sample, K)       # fc: [F] finite
    n = np.asarray(sample).shape[0]
    if count is not None:
        CHECK(count >= 0, f"count must be non-negative, got {count}")
        CHECK(n > 0 or count == 0,
              f"count={count} with an empty sample contributes unsampled "
              f"mass; pass the shard's rows (or a subsample) too")
        if n > 0:
            # scale the finite mass from the subsample up to the shard's
            # true size (missingness rates are assumed to survive sampling)
            fc = fc * (count / n)
    all_points = comm.allgather(points.astype(np.float32))   # [W, F, K]
    all_counts = comm.allgather(fc.astype(np.float32))       # [W, F]
    return merged_quantile_boundaries(all_points, all_counts, num_bins)


def apply_bins(x, boundaries, missing_bin: Optional[int] = None,
               device=None):
    """Bin dense features: x [B, F] float -> bins [B, F] int32.

    ``searchsorted(side="right")`` per feature in float32; NaN compares
    false against every edge and lands in the last bin, unless
    ``missing_bin`` is set, which NaNs then take.  Runs on ``device``
    (``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)
    x = as_tensor(x, dev, torch.float32)
    bounds = as_tensor(boundaries, dev, torch.float32).contiguous()
    CHECK(x.dim() == 2 and bounds.dim() == 2
          and x.shape[1] == bounds.shape[0],
          f"x [B, F] and boundaries [F, nb-1] disagree: {tuple(x.shape)} "
          f"vs {tuple(bounds.shape)}")
    ids = torch.searchsorted(bounds, x.t().contiguous(), right=True)
    ids = ids.t().to(torch.int32)
    if missing_bin is not None:
        ids = torch.where(torch.isnan(x), missing_bin, ids)
    return ids.contiguous()


def _kernel_bins(bins):
    """uint8 bins reach the kernels as they are; other dtypes widen to
    int32 on the device."""
    if bins.dtype in (torch.uint8, torch.int32):
        return bins.contiguous()
    return bins.to(torch.int32).contiguous()


def data_allreduce(*tensors):
    """The tensors (of one shape) summed over the ambient mesh's ``data``
    group when that axis spans more than one rank, as one collective (the
    reference gets these sums from GSPMD); else the tensors unchanged."""
    mesh = ambient_mesh()
    if mesh is None or mesh.shape.get(hist_cuda.DATA_AXIS, 1) == 1:
        return tensors
    return tuple(MeshCollective(mesh, hist_cuda.DATA_AXIS).psum(
        torch.stack(tensors)))


def grad_histogram(bins, node_ids, grad, hess, num_nodes: int, num_bins: int,
                   model_axis: Optional[str] = None, method: str = "scatter",
                   onehot=None, device=None):
    """Per-(node, feature, bin) gradient/hessian sums.

    Args:
      bins: [B, F] binned features (uint8, int32 or any integer dtype).
      node_ids: [B] tree node of each row; ids outside ``[0, num_nodes)``
        contribute nothing.
      grad/hess: [B] float32 (padding rows carry 0 weight).
      model_axis: optional mesh axis to shard the feature axis over.  Under
        an ambient mesh with that axis, ``"pallas"``/``"pallas_fused"`` run
        K4 (each rank on its ``F/mp`` columns) where
        :func:`.hist_cuda.sharded_hist_plan` gives a plan, else
        ``"onehot"`` on all features, as the reference does.
      method: ``"scatter"`` (exact f32), ``"onehot"``, ``"pallas"`` (K2),
        ``"pallas_fused"`` (K3) or ``"auto"``.
      onehot: optional precomputed :func:`bin_onehot` for ``"onehot"``.
      device: where to run; ``cuda`` unless ``device="cpu"``.

    Under an ambient mesh ``bins`` are this rank's rows and the result is
    the histogram of every rank's rows, identical on every rank.

    Returns (G, H): each [num_nodes, F, num_bins] float32.
    """
    dev = resolve_device(device)
    bins = _kernel_bins(as_tensor(bins, dev))
    node_ids = as_tensor(node_ids, dev, torch.int32).contiguous()
    grad = as_tensor(grad, dev, torch.float32).contiguous()
    hess = as_tensor(hess, dev, torch.float32).contiguous()
    B, F = bins.shape
    method = resolve_hist_method(method, bins)
    if method in ("pallas", "pallas_fused") and model_axis is not None:
        mesh = hist_cuda.sharded_hist_plan(model_axis, F, num_nodes,
                                           num_bins)
        if mesh is None:
            method = "onehot"
        else:
            mp = mesh.shape[model_axis]
            # blocked sweeps have no fused variant in the reference
            fused = (method == "pallas_fused" and hist_cuda.hist_node_block(
                num_nodes, F // mp, num_bins) >= num_nodes)
            return hist_cuda.grad_hist_sharded_cuda(
                bins, node_ids, grad, hess, num_nodes, num_bins, mesh,
                model_axis, fused=fused)
    return data_allreduce(*_local_histogram(
        bins, node_ids, grad, hess, num_nodes, num_bins, method, onehot))


def _local_histogram(bins, node_ids, grad, hess, num_nodes: int,
                     num_bins: int, method: str, onehot):
    """(G, H) of this rank's rows by ``method``, over all F features."""
    B, F = bins.shape
    dev = bins.device
    if method == "pallas":
        return hist_cuda.grad_hist_cuda(bins, node_ids, grad, hess,
                                        num_nodes, num_bins)
    if method == "pallas_fused":
        return hist_cuda.grad_hist_fused_cuda(bins, node_ids, grad, hess,
                                              num_nodes, num_bins)
    if method == "onehot":
        if onehot is None:
            onehot = bin_onehot(bins, num_bins)
        dt = onehot.dtype
        nodehot = (node_ids[:, None] == torch.arange(
            num_nodes, dtype=torch.int32, device=dev)).to(dt)
        # [B, 2n]: per-row node one-hot weighted by g (first n) and h
        w = torch.cat([nodehot * grad[:, None].to(dt),
                       nodehot * hess[:, None].to(dt)], dim=1)
        # bf16 x bf16 products are exact in f32; the sums stay f32
        gh = torch.matmul(w.to(torch.float32).t(),
                          onehot.to(torch.float32))      # [2n, F*nbins]
        gh = gh.reshape(2, num_nodes, F, num_bins)
        return gh[0], gh[1]
    return hist_cuda.scatter_sums(bins, node_ids, grad, hess, num_nodes,
                                  num_bins)
