"""Host-side quantile binning to the narrow wire dtype.

Counterpart of ``dmlc_core_tpu/bridge/binning.py``: :func:`fit_binner`
streams quantile edges over any row source with the same mergeable
per-chunk summaries as the distributed sketch; :class:`HostBinner` applies
them with numpy ``searchsorted(side="right")`` exactly as
:func:`..ops.histogram.apply_bins` does on the device, so the uint8 ids
shipped to the card are byte-identical to the JAX package's and to
on-device binning; :func:`binned_batches` fuses binning into the dense
batch pipeline, so the device feed ships ``n*F`` wire bytes instead of
``4*n*F`` float32 bytes.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from dmlc_core_tpu_torch.bridge.batching import (DenseBatch, block_to_dense,
                                                 dense_batches)
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.ops.histogram import (local_quantile_summary,
                                               merged_quantile_boundaries)
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["HostBinner", "BinnedBatch", "fit_binner",
           "fit_binner_from_summaries", "default_summary_points",
           "binned_batches", "wire_dtype"]


def default_summary_points(num_bins: int) -> int:
    """Per-chunk summary resolution K for ``num_bins`` target bins: the
    one formula :func:`fit_binner` and every external summary producer
    (the fleet-ingest workers) share, so their summaries merge into the
    same edges."""
    return max(64, 8 * num_bins)


def wire_dtype(num_bins: int) -> np.dtype:
    """The narrowest unsigned dtype that holds ``num_bins`` bin ids."""
    CHECK(num_bins >= 2, f"num_bins must be >= 2, got {num_bins}")
    if num_bins <= 256:
        return np.dtype(np.uint8)
    if num_bins <= 65536:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


class BinnedBatch(NamedTuple):
    """A :class:`~.batching.DenseBatch` whose features are pre-binned ids
    in the wire dtype: what the device feed ships.  Same padding/masking
    contract: padding rows carry ``weight == 0`` and the true row count
    rides in ``num_rows``."""

    bins: torch.Tensor     # [B, F] wire dtype (uint8 for <=256 bins)
    label: torch.Tensor    # [B] float32
    weight: torch.Tensor   # [B] float32 (0.0 marks padding)
    num_rows: Optional[int] = None


class HostBinner:
    """Apply fixed quantile edges on the host; emit wire-dtype bin ids.

    ``boundaries`` is ``[F, eff_bins - 1]`` float32, where ``eff_bins =
    num_bins - 1`` when ``handle_missing`` reserves the last id for NaNs,
    else ``num_bins``.
    """

    def __init__(self, boundaries: np.ndarray, num_bins: int,
                 handle_missing: bool = False):
        boundaries = np.asarray(boundaries, dtype=np.float32)
        CHECK(boundaries.ndim == 2,
              f"boundaries must be [F, bins-1], got {boundaries.shape}")
        eff = num_bins - 1 if handle_missing else num_bins
        CHECK(boundaries.shape[1] == eff - 1,
              f"boundaries have {boundaries.shape[1] + 1} bins; expected "
              f"{eff} (num_bins={num_bins}, handle_missing={handle_missing})")
        self.boundaries = boundaries
        self.num_bins = num_bins
        self.handle_missing = handle_missing
        self.dtype = wire_dtype(num_bins)

    @property
    def num_feature(self) -> int:
        return self.boundaries.shape[0]

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Bin ``x [B, F]`` float -> ``[B, F]`` wire-dtype ids.  NaNs take
        the reserved missing id under ``handle_missing``, else land in the
        last bin (NaN compares false against every edge)."""
        x = np.asarray(x)
        CHECK(x.ndim == 2 and x.shape[1] == self.num_feature,
              f"x must be [B, {self.num_feature}], got {x.shape}")
        x32 = np.ascontiguousarray(x, dtype=np.float32)
        out = np.empty(x32.shape, dtype=self.dtype)
        for f in range(self.num_feature):
            out[:, f] = np.searchsorted(self.boundaries[f], x32[:, f],
                                        side="right")
        if self.handle_missing:
            out[np.isnan(x32)] = self.num_bins - 1
        return out

    def transform_batch(self, batch: DenseBatch) -> BinnedBatch:
        """Bin one dense batch into the wire format (labels/weights/count
        pass through untouched)."""
        return BinnedBatch(torch.from_numpy(self.transform(batch.x.numpy())),
                           batch.label, batch.weight, num_rows=batch.num_rows)

    def wire_nbytes(self, n_rows: int) -> int:
        """Bytes one ``[n_rows, F]`` binned feed ships (features only)."""
        return n_rows * self.num_feature * self.dtype.itemsize


def _dense_chunks(source: Any, num_feature: Optional[int],
                  handle_missing: bool) -> Iterator[np.ndarray]:
    """Normalize any supported row source into ``[n, F]`` float chunks.

    RowBlock sources densify chunk-by-chunk (absent features become NaN
    under ``handle_missing``, else 0.0, matching ``block_to_dense``);
    arrays and tensors stream through untouched.
    """
    fill = np.nan if handle_missing else 0.0

    def one(item):
        if isinstance(item, RowBlock):
            CHECK(num_feature is not None,
                  "RowBlock sources need num_feature= to densify")
            return block_to_dense(item, num_feature,
                                  fill_value=fill).x.numpy()
        arr = np.asarray(item)
        CHECK(arr.ndim == 2, f"chunks must be [n, F], got {arr.shape}")
        return arr

    if isinstance(source, (np.ndarray, torch.Tensor, RowBlock)):
        yield one(source)
        return
    for item in source:
        chunk = one(item)
        if chunk.shape[0]:
            yield chunk


def fit_binner(source: Any, num_bins: int,
               num_feature: Optional[int] = None,
               handle_missing: bool = False, comm=None,
               num_points: Optional[int] = None) -> HostBinner:
    """Stream quantile bin edges over ``source``; return a ready binner.

    ``source`` may be a ``[n, F]`` array, an iterable of arrays, or a
    parser / RowBlock iterable (``num_feature`` required to densify).
    Each chunk contributes a fixed-size mergeable summary
    (:func:`~..ops.histogram.local_quantile_summary`) and the deterministic
    weighted merge produces the edges in one pass: memory is
    O(chunks x F x num_points), not O(rows).

    ``comm`` (rabit-shaped allgather, e.g. :mod:`..collective`) makes edges
    consistent across data-parallel workers: the local stream is
    re-summarised to one fixed block per rank and merged globally, so every
    rank returns identical boundaries.

    ``handle_missing`` reserves the last bin id for NaN: edges then cover
    ``num_bins - 1`` real bins.
    """
    K = num_points or default_summary_points(num_bins)
    all_points, all_counts = [], []
    n_feat = None
    for chunk in _dense_chunks(source, num_feature, handle_missing):
        if n_feat is None:
            n_feat = chunk.shape[1]
        CHECK(chunk.shape[1] == n_feat,
              f"chunk feature dim {chunk.shape[1]} != {n_feat}")
        pts, cnt = local_quantile_summary(chunk, K)
        all_points.append(pts)
        all_counts.append(cnt)
    CHECK(all_points, "fit_binner: empty source (no rows to summarise)")
    return fit_binner_from_summaries(
        np.stack(all_points), np.stack(all_counts), num_bins,
        handle_missing=handle_missing, comm=comm, num_points=K)


def fit_binner_from_summaries(points: np.ndarray, counts: np.ndarray,
                              num_bins: int, *,
                              handle_missing: bool = False, comm=None,
                              num_points: Optional[int] = None) -> HostBinner:
    """The allgather-merge tail of :func:`fit_binner`, callable on
    pre-accumulated ``local_quantile_summary`` stacks.

    ``points [C, F, K]`` / ``counts [C, F]`` are this rank's per-chunk
    summaries (K is :func:`default_summary_points` of ``num_bins`` unless
    ``num_points`` overrides it; every rank must use the same K).  With
    ``comm`` the local stack is re-summarised to one fixed ``[F, K]``
    block (weighted quantiles of the pooled points), allgathered and
    merged globally, so every rank returns the same boundaries.  The
    fleet-ingest workers (:mod:`..parallel.fleet_ingest`) fit their binner
    through this path.
    """
    eff_bins = num_bins - 1 if handle_missing else num_bins
    K = num_points or default_summary_points(num_bins)
    points = np.asarray(points, dtype=np.float32)
    counts = np.asarray(counts, dtype=np.float32)
    if comm is not None:
        local = merged_quantile_boundaries(points, counts, K + 1)  # [F, K]
        local_mass = counts.sum(axis=0).astype(np.float32)
        points = comm.allgather(local.astype(np.float32))    # [W, F, K]
        counts = comm.allgather(local_mass)                  # [W, F]
    boundaries = merged_quantile_boundaries(points, counts, eff_bins)
    return HostBinner(boundaries, num_bins, handle_missing=handle_missing)


def binned_batches(parser, binner: HostBinner, batch_size: int,
                   drop_remainder: bool = False) -> Iterable[BinnedBatch]:
    """Fixed-size :class:`BinnedBatch` stream from a parser: the dense
    batch pipeline with host binning fused in.

    Under ``binner.handle_missing`` absent features densify to NaN and
    bin to the reserved missing id (padding rows stay zero-binned with
    ``weight == 0``, exactly like the float pipeline's contract).
    """
    fill = np.nan if binner.handle_missing else 0.0
    for batch in dense_batches(parser, batch_size, binner.num_feature,
                               drop_remainder=drop_remainder,
                               fill_value=fill):
        yield binner.transform_batch(batch)
