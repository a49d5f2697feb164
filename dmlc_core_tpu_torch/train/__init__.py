"""Continuous training ring of the PyTorch port: crash-tolerant trainer.

Counterpart of ``dmlc_core_tpu/train/__init__.py``.
``python -m dmlc_core_tpu_torch.train`` runs :class:`~.daemon.TrainerDaemon`
on the card against a spool directory (:class:`~.source.DirectorySource`)
or the shard-lease fleet (:class:`~.source.FleetSource`), publishing
manifest-first checkpoints the serving watcher hot-swaps live.
"""

from dmlc_core_tpu_torch.train.daemon import (CURSOR_KEY, ROUND_KEY,
                                              TrainerDaemon)
from dmlc_core_tpu_torch.train.source import (Batch, DirectorySource,
                                              DONE_SENTINEL, FleetSource)

__all__ = ["TrainerDaemon", "DirectorySource", "FleetSource", "Batch",
           "DONE_SENTINEL", "CURSOR_KEY", "ROUND_KEY"]
