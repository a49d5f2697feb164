"""PyTorch / CUDA port of ``dmlc_core_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout, so each module's counterpart
sits at the same relative path:

- :mod:`.ops.histogram` — quantile edges, ``apply_bins`` and
  ``grad_histogram`` (the scatter, one-hot and kernel formulations);
- :mod:`.ops.hist_cuda` — wrappers of the hand-written Hopper histogram
  kernels in ``csrc/hist.cu``, their plain PyTorch versions and launch
  counters;
- :mod:`.io`, :mod:`.data` — local files through byte-range InputSplits
  into the threaded libsvm/CSV parsers and RowBlocks;
- :mod:`.bridge.batching`, :mod:`.bridge.binning` — dense, sparse and
  binned batches (host binning to the uint8 wire, streamed bin edges);
- :mod:`.bridge.loader` — the pinned, double-buffered device feed;
- :mod:`.examples.train_gbdt` — the ``train_gbdt`` entry point;
- :mod:`.models.gbdt` — hist-GBDT training and scoring;
- :mod:`.convert` — carries a JAX-trained ensemble across as tensors.

It imports ``torch`` and numpy only, never ``jax`` nor ``dmlc_core_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of running on the CPU.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
