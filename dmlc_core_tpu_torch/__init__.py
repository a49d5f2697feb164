"""PyTorch / CUDA port of ``dmlc_core_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout, so each module's counterpart
sits at the same relative path:

- :mod:`.ops.histogram` — quantile edges, ``apply_bins`` and
  ``grad_histogram`` (the scatter, one-hot and kernel formulations);
- :mod:`.ops.hist_cuda` — wrappers of the hand-written Hopper histogram
  kernels in ``csrc/hist.cu``, their plain PyTorch versions and launch
  counters;
- :mod:`.io`, :mod:`.data` — local and remote files through byte-range
  InputSplits into the threaded libsvm/libfm/CSV parsers (threads, worker
  processes or the native engine) and RowBlocks, and Parquet/Arrow files
  mapped onto RowBlocks;
- :mod:`.bridge.batching`, :mod:`.bridge.binning` — dense, sparse and
  binned batches (host binning to the uint8 wire, streamed bin edges);
- :mod:`.bridge.loader` — the pinned, double-buffered device feed;
- :mod:`.examples.train_gbdt` — the ``train_gbdt`` entry point;
- :mod:`.models.gbdt` — hist-GBDT training and scoring;
- :mod:`.convert` — carries a JAX-trained ensemble across as tensors;
- :mod:`.config`, :mod:`.json_io`, :mod:`.serializer`, :mod:`.interop`
  and :mod:`.utils` — the substrate: key=value configs, the
  schema-directed JSON reader/writer, typed binary serialization onto
  streams, dlpack exchange, logging, concurrency and small helpers.

It imports ``torch`` and numpy only, never ``jax`` nor ``dmlc_core_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of running on the CPU.

The top level re-exports the JAX package's names (``Parameter``,
``Registry``, ``CHECK``, the ``JSON*`` names).  As the JAX top level
imports no jax, this one imports no torch, and neither do :mod:`.data`,
:mod:`.io`, :mod:`.utils`, :mod:`.config`, :mod:`.json_io` and
:mod:`.serializer`: a spawned parse worker starts cheap.
"""

__version__ = "0.1.0"

from dmlc_core_tpu_torch.utils.logging import Error, CHECK, CHECK_EQ, LOG  # noqa: F401,E402
from dmlc_core_tpu_torch.param import Parameter, ParamError, field, get_env  # noqa: F401,E402
from dmlc_core_tpu_torch.registry import Registry  # noqa: F401,E402
from dmlc_core_tpu_torch.json_io import (  # noqa: F401,E402
    JSONReader, JSONWriter, JSONObjectReadHelper, JSONError, register_any_type)
