"""Histogram ops and the hand-written CUDA histogram kernels.

Counterpart of ``dmlc_core_tpu/ops``, with the same exports: quantile
edges, binning and the gradient histogram (:mod:`.histogram`), the sparse
ops (:mod:`.sparse`); the kernels' wrappers are :mod:`.hist_cuda`.
"""

from dmlc_core_tpu_torch.ops.histogram import (  # noqa: F401
    quantile_boundaries,
    apply_bins,
    grad_histogram,
)
from dmlc_core_tpu_torch.ops.sparse import segment_matvec, sparse_logit  # noqa: F401
