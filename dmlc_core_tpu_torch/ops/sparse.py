"""Sparse segment ops for flat-COO batches (the RowBlock SDot analog).

Counterpart of ``dmlc_core_tpu/ops/sparse.py``: a gather plus a segment
sum over the flat nonzero stream of a
:class:`~dmlc_core_tpu_torch.bridge.batching.SparseBatch`.  The sums go
through :func:`~dmlc_core_tpu_torch.ops.hist_cuda.segment_sum`:
``index_add_`` on the CPU, and on the card a stable sort and
``segment_reduce``, because ``index_add_`` adds with float atomics there
and would make the sparse step give other bits from run to run.
"""

from __future__ import annotations

import torch

from dmlc_core_tpu_torch.ops.hist_cuda import segment_sum

__all__ = ["segment_matvec", "sparse_logit", "segment_transpose_matvec"]


def segment_matvec(w: torch.Tensor, value: torch.Tensor, index: torch.Tensor,
                   row_id: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Per-row sparse dot: out[b] = sum_{nnz in row b} w[index] * value.

    Padding entries carry ``row_id == batch_size`` and land in the dropped
    extra segment.
    """
    contrib = w[index.long()] * value
    return segment_sum(contrib, row_id, batch_size + 1)[:batch_size]


def segment_transpose_matvec(r: torch.Tensor, value: torch.Tensor,
                             index: torch.Tensor, row_id: torch.Tensor,
                             num_feature: int) -> torch.Tensor:
    """Transpose product: out[f] = sum_{nnz with index==f} r[row] * value.

    ``r`` must have a trailing 0 sentinel slot (r[batch_size] == 0) so
    padding rows contribute nothing: pass a [B+1] tensor.
    """
    contrib = r[row_id.long()] * value
    return segment_sum(contrib, index, num_feature)


def sparse_logit(w: torch.Tensor, b: torch.Tensor, batch,
                 num_feature: int) -> torch.Tensor:
    """Margin for a SparseBatch under a linear model: Xw + b."""
    bsz = batch.label.shape[0]
    return segment_matvec(w, batch.value, batch.index, batch.row_id,
                          bsz) + b
