"""Ragged CSR RowBlocks -> fixed-shape batches of CPU tensors.

Counterpart of ``dmlc_core_tpu/bridge/batching.py``.  RowBlock is ragged;
the device feed and the kernels want fixed shapes.  Two layouts:

- :class:`DenseBatch` — densified ``[batch, num_feature]`` features; right for
  low-dimensional dense data (csv/HIGGS);
- :class:`SparseBatch` — flat COO-ish ``(value[N], index[N], row_id[N])`` with
  the nonzero count padded up to a *bucket* (power-of-two style) so the number
  of distinct compiled shapes stays logarithmic; padding rows carry
  ``row_id == batch_size`` and are dropped by ``segment_sum`` with
  ``num_segments = batch_size + 1``.

Fields are CPU ``torch`` tensors made with ``torch.from_numpy`` (zero-copy
over the numpy arrays the JAX package builds, same dtypes, same padding
and ``num_rows`` contract), ready to be pinned and copied to the card.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from dmlc_core_tpu_torch.data.parser import Parser
from dmlc_core_tpu_torch.data.row_block import RowBlock, concat_blocks
from dmlc_core_tpu_torch.utils.logging import CHECK, CHECK_LE

__all__ = [
    "DenseBatch",
    "SparseBatch",
    "block_to_dense",
    "block_to_sparse",
    "dense_batches",
    "sparse_batches",
    "bucket_size",
]


class DenseBatch(NamedTuple):
    x: torch.Tensor        # [B, F] float32
    label: torch.Tensor    # [B] float32
    weight: torch.Tensor   # [B] float32 (1.0 where absent; 0.0 marks padding)
    # real (unpadded) row count; None from hand-built batches.  Consumers
    # must slice with this, NOT weight.sum(): explicit libsvm row weights
    # make the weight sum diverge from the row count
    num_rows: Optional[int] = None


class SparseBatch(NamedTuple):
    value: torch.Tensor    # [N] float32
    index: torch.Tensor    # [N] int32 feature ids (0 on padding)
    row_id: torch.Tensor   # [N] int32 in [0, B]; B marks padding
    label: torch.Tensor    # [B] float32
    weight: torch.Tensor   # [B] float32 (0.0 marks padding rows)
    field: Optional[torch.Tensor] = None  # [N] int32 (libfm)
    num_rows: Optional[int] = None      # real row count (see DenseBatch)


def bucket_size(n: int, minimum: int = 256) -> int:
    """Round up to the bucket ladder: 1.5x-spaced powers-of-two-ish sizes so
    recompiles are O(log nnz) (static-shape discipline).

    From ``minimum=1`` the ladder runs 1, 2, 3, 4, 6, 8, 12, 16, ...
    """
    b = minimum
    while b < n:
        # b=1 must step to 2 (1*3//2 would stick at 1 forever)
        b = b * 3 // 2 if (b & (b - 1)) == 0 and b > 1 else 1 << (b.bit_length())
    return b


def block_to_dense(block: RowBlock, num_feature: int,
                   batch_size: Optional[int] = None,
                   fill_value: float = 0.0) -> DenseBatch:
    """Densify a RowBlock into [B, num_feature] (B padded to batch_size).

    ``fill_value`` seeds features absent from a row: 0.0 by default
    (classic densification), ``np.nan`` for sparsity-aware GBDT training
    (GBDTParam.handle_missing) where absent means missing, not zero —
    XGBoost's sparse-libsvm semantics.  Padding rows are zeroed either way
    (they carry weight 0 and NaN would poison binning).
    """
    n = block.size
    b = batch_size or n
    CHECK_LE(n, b, "block larger than batch_size")
    x = np.full((b, num_feature), np.float32(fill_value), dtype=np.float32)
    if fill_value != 0.0:          # True for NaN too (NaN != 0.0)
        x[n:] = 0.0
    nnz = block.num_nonzero
    if nnz:
        rows = np.repeat(np.arange(n), np.diff(block.offset - block.offset[0]))
        idx = np.asarray(block.index, dtype=np.int64)
        CHECK(int(idx.max()) < num_feature, "feature index exceeds num_feature")
        vals = (block.value if block.value is not None
                else np.ones(nnz, dtype=np.float32))
        x[rows, idx] = vals
    label = np.zeros(b, dtype=np.float32)
    label[:n] = block.label
    weight = np.zeros(b, dtype=np.float32)
    weight[:n] = block.weight if block.weight is not None else 1.0
    return DenseBatch(*map(torch.from_numpy, (x, label, weight)), num_rows=n)


def block_to_sparse(block: RowBlock, nnz_bucket: Optional[int] = None,
                    batch_size: Optional[int] = None) -> SparseBatch:
    """Flatten a RowBlock into padded flat-COO (segment-sum ready)."""
    n = block.size
    b = batch_size or n
    CHECK_LE(n, b, "block larger than batch_size")
    nnz = block.num_nonzero
    cap = nnz_bucket or bucket_size(max(nnz, 1))
    CHECK_LE(nnz, cap, "nnz exceeds bucket")
    value = np.zeros(cap, dtype=np.float32)
    value[:nnz] = (block.value if block.value is not None
                   else np.ones(nnz, dtype=np.float32))
    index = np.zeros(cap, dtype=np.int32)
    index[:nnz] = block.index
    row_id = np.full(cap, b, dtype=np.int32)
    row_id[:nnz] = np.repeat(np.arange(n, dtype=np.int32),
                             np.diff(block.offset - block.offset[0]))
    label = np.zeros(b, dtype=np.float32)
    label[:n] = block.label
    weight = np.zeros(b, dtype=np.float32)
    weight[:n] = block.weight if block.weight is not None else 1.0
    field = None
    if block.field is not None:
        field = np.zeros(cap, dtype=np.int32)
        field[:nnz] = block.field
    return SparseBatch(*map(torch.from_numpy, (value, index, row_id, label,
                                               weight)),
                       None if field is None else torch.from_numpy(field),
                       num_rows=n)


class _Rebatcher:
    """Slice a stream of variable-size RowBlocks into fixed-size batches.

    Final-partial-batch contract: with ``drop_remainder=False`` (the
    default) the leftover ``0 < r < batch_size`` rows are emitted as one
    short block — the downstream ``block_to_dense`` / ``block_to_sparse``
    pad it back up to ``batch_size`` with **masked** rows (``weight == 0``,
    ``label == 0``, ``num_rows == r``), so consumers see only static
    shapes and slice/weight the padding away; an empty parser yields no
    batches at all (never an all-padding one).  With
    ``drop_remainder=True`` the short tail is dropped (equal step counts
    across data-parallel workers matter more than the last rows).
    """

    def __init__(self, parser: Parser, batch_size: int, drop_remainder: bool):
        self._parser = parser
        self._batch = batch_size
        self._drop = drop_remainder

    def __iter__(self) -> Iterator[RowBlock]:
        pending: list = []
        pending_rows = 0
        for block in self._parser:
            pending.append(block)
            pending_rows += block.size
            while pending_rows >= self._batch:
                merged = pending[0] if len(pending) == 1 else concat_blocks(pending)
                out = merged.slice(0, self._batch)
                rest = merged.slice(self._batch, merged.size)
                yield out
                pending = [rest] if rest.size else []
                pending_rows = rest.size
        if pending_rows and not self._drop:
            merged = pending[0] if len(pending) == 1 else concat_blocks(pending)
            yield merged


def dense_batches(parser: Parser, batch_size: int, num_feature: int,
                  drop_remainder: bool = False,
                  fill_value: float = 0.0) -> Iterator[DenseBatch]:
    """Fixed-size dense batches from a parser.

    Every yielded batch is exactly ``[batch_size, num_feature]``; the
    final partial batch (``drop_remainder=False``) arrives zero-padded
    with the mask in ``weight`` (0.0 on padding rows — explicit row
    weights are preserved on real rows) and the true row count in
    ``num_rows`` (see :class:`_Rebatcher` for the full contract).

    ``fill_value=np.nan`` marks absent features as missing for
    sparsity-aware GBDT training (see :func:`block_to_dense`).
    """
    for block in _Rebatcher(parser, batch_size, drop_remainder):
        yield block_to_dense(block, num_feature, batch_size,
                             fill_value=fill_value)


def sparse_batches(parser: Parser, batch_size: int,
                   nnz_bucket: Optional[int] = None,
                   drop_remainder: bool = False) -> Iterator[SparseBatch]:
    """Fixed-size flat-COO batches; nnz padded to a bucket ladder.

    The final partial batch (``drop_remainder=False``) keeps the static
    ``[batch_size]`` row axis: padding rows carry ``weight == 0`` and
    padding nnz slots carry ``row_id == batch_size`` (the segment-sum
    drop segment), with the true row count in ``num_rows``.
    """
    for block in _Rebatcher(parser, batch_size, drop_remainder):
        cap = nnz_bucket or bucket_size(block.num_nonzero or 1)
        yield block_to_sparse(block, cap, batch_size)
