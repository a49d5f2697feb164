"""Host-side data bridge of the PyTorch port.

Counterpart of ``dmlc_core_tpu/bridge``: RowBlocks to dense, sparse and
binned batches (:mod:`.batching`, :mod:`.binning`), the pinned device feed
and the mesh batch loader (:mod:`.loader`), and checkpoints
(:mod:`.checkpoint`), with the same exports.
"""

from dmlc_core_tpu_torch.bridge.batching import (  # noqa: F401
    DenseBatch,
    SparseBatch,
    dense_batches,
    sparse_batches,
    block_to_dense,
    block_to_sparse,
)
from dmlc_core_tpu_torch.bridge.binning import (  # noqa: F401
    BinnedBatch,
    HostBinner,
    binned_batches,
    fit_binner,
)
from dmlc_core_tpu_torch.bridge.loader import (MeshBatchLoader,  # noqa: F401
                                               DeviceFeedLoader)
from dmlc_core_tpu_torch.bridge.checkpoint import (save_checkpoint,  # noqa: F401
                                                   load_checkpoint,
                                                   AsyncCheckpointer,
                                                   CheckpointManager)
