"""Batch sources for the continuous trainer.

Counterpart of ``dmlc_core_tpu/train/source.py``, on the port's parser and
densifier.  A source turns "where training data comes from" into one
cursor-addressed call: ``next_batch(cursor)`` returns the next dense host
batch after ``cursor`` or ``None`` when nothing new has landed yet.  The
cursor is the source's own resume token: the daemon persists it inside
every published checkpoint (the ``train_cursor`` leaf rides the same
atomic blob as the trees), so a crashed trainer restarts exactly where its
last *published* state left off and retrains only the rounds lost with it.

:class:`DirectorySource`
    single-host spool: a directory of text data files (libsvm/CSV, what
    the port's :func:`~dmlc_core_tpu_torch.data.factory.create_parser`
    speaks), consumed once each in name order.  New files appearing later
    are picked up on the next poll; a ``_DONE`` sentinel marks the spool
    finished so batch jobs can drain and exit.  A file that fails to
    parse is returned as a *poison* batch (``error`` set): the daemon
    quarantines and counts it, the cursor advances, training continues.

:class:`FleetSource`
    the fleet-ingest path: drives :func:`~dmlc_core_tpu_torch.parallel.
    fleet_ingest.run_worker` against a ``ShardLeaseCoordinator`` (of
    either package) on a background thread, ferrying each densified unit
    into a bounded queue.  Lease bookkeeping stays coordinator-side
    (exactly-once *coverage*); the training feed itself is at-least-once:
    a unit whose commit is rejected was already handed to the boosting
    loop.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from dmlc_core_tpu_torch.utils.logging import CHECK, log_warning

__all__ = ["Batch", "DirectorySource", "FleetSource", "DONE_SENTINEL"]

# an empty file of this name in a spool directory = no more data is coming
DONE_SENTINEL = "_DONE"


class Batch(NamedTuple):
    """One dense host batch, or a poison marker when ``error`` is set."""

    x: Optional[np.ndarray]        # [n, F] float32 (None on poison)
    label: Optional[np.ndarray]    # [n] float32 (None on poison)
    origin: str                    # file / unit the rows came from
    cursor: int                    # source position AFTER this batch
    error: Optional[str] = None    # parse failure → poison, not fatal


class DirectorySource:
    """Spool-directory source: files consumed once each, in name order.

    ``cursor`` counts consumed files over the name-sorted listing — files
    must land with monotonically increasing names (timestamps, sequence
    numbers) and never be renamed, the usual spool contract.  ``nan_fill``
    densifies absent libsvm features as NaN instead of 0.0 (the
    sparsity-aware ``handle_missing`` training mode).
    """

    def __init__(self, directory: str, num_feature: int, *,
                 nan_fill: bool = False):
        CHECK(num_feature >= 1, "num_feature must be >= 1")
        self.directory = directory
        self.num_feature = num_feature
        self.nan_fill = nan_fill

    def _files(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(n for n in names
                      if not n.startswith((".", "_")))

    def next_batch(self, cursor: int) -> Optional[Batch]:
        files = self._files()
        if cursor >= len(files):
            return None
        name = files[cursor]
        path = os.path.join(self.directory, name)
        try:
            x, label = self._parse(path)
        except Exception as exc:  # noqa: BLE001 — poison, not fatal
            return Batch(None, None, path, cursor + 1, error=repr(exc))
        return Batch(x, label, path, cursor + 1)

    def exhausted(self, cursor: int) -> bool:
        """True when every spooled file is consumed AND the ``_DONE``
        sentinel says no more are coming (batch-job drain)."""
        if not os.path.exists(os.path.join(self.directory, DONE_SENTINEL)):
            return False
        return cursor >= len(self._files())

    def _parse(self, path: str):
        from dmlc_core_tpu_torch.bridge.batching import block_to_dense
        from dmlc_core_tpu_torch.data.factory import create_parser

        fill = np.nan if self.nan_fill else 0.0
        xs: List[np.ndarray] = []
        ys: List[np.ndarray] = []
        parser = create_parser(path, threaded=False)
        try:
            for block in parser:
                if not block.size:
                    continue
                dense = block_to_dense(block, self.num_feature,
                                       fill_value=fill)
                xs.append(np.ascontiguousarray(
                    dense.x[:block.size].numpy(), dtype=np.float32))
                ys.append(np.asarray(dense.label[:block.size].numpy(),
                                     dtype=np.float32))
        finally:
            if hasattr(parser, "close"):
                parser.close()
        CHECK(bool(xs), f"{path!r} parsed to zero rows")
        return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)


class FleetSource:
    """Trainer feed over the shard-lease fleet (one worker's view).

    Runs :func:`~dmlc_core_tpu_torch.parallel.fleet_ingest.run_worker` on a
    background thread with a processor that densifies each leased unit
    and ferries it here through a bounded queue; ``next_batch`` drains the
    queue.  The coordinator's ledger keeps unit *coverage* exactly-once;
    the feed is at-least-once (a rejected commit's rows were already
    yielded).  The cursor counts delivered units — it resumes the queue
    position after a trainer restart within one coordinator epoch, but a
    restarted epoch re-leases every unit (the coordinator owns coverage,
    not this adapter).
    """

    def __init__(self, worker_id: str, num_feature: int, *,
                 host: Optional[str] = None, port: Optional[int] = None,
                 nan_fill: bool = False, max_queued: int = 8):
        self.worker_id = worker_id
        self.num_feature = num_feature
        self.nan_fill = nan_fill
        self._queue: "queue.Queue[Batch]" = queue.Queue(maxsize=max_queued)
        self._done = threading.Event()
        self._delivered = 0
        self._host = host
        self._port = port
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FleetSource":
        CHECK(self._thread is None, "FleetSource already started")
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name=f"train-fleet-{self.worker_id}")
        self._thread.start()
        return self

    def _pump(self) -> None:
        from dmlc_core_tpu_torch.parallel.fleet_ingest import run_worker

        try:
            run_worker(self.worker_id, self._host, self._port,
                       processor=self._process_unit)
        except Exception as exc:  # noqa: BLE001 — surfaced as exhaustion
            log_warning(f"train: fleet source worker {self.worker_id!r} "
                        f"failed: {exc!r}")
        finally:
            self._done.set()

    def _process_unit(self, spec: Dict[str, Any],
                      accum: Any = None) -> Dict[str, Any]:
        from dmlc_core_tpu_torch.bridge.batching import block_to_dense
        from dmlc_core_tpu_torch.data.factory import create_parser

        fill = np.nan if self.nan_fill else 0.0
        parser = create_parser(spec["uri"], int(spec.get("part", 0)),
                               int(spec.get("nparts", 1)),
                               type=spec.get("format", "auto"),
                               threaded=False)
        xs: List[np.ndarray] = []
        ys: List[np.ndarray] = []
        rows = 0
        try:
            for block in parser:
                if not block.size:
                    continue
                rows += block.size
                dense = block_to_dense(block, self.num_feature,
                                       fill_value=fill)
                xs.append(np.ascontiguousarray(
                    dense.x[:block.size].numpy(), dtype=np.float32))
                ys.append(np.asarray(dense.label[:block.size].numpy(),
                                     dtype=np.float32))
                if accum is not None:
                    accum.add(xs[-1])
        finally:
            if hasattr(parser, "close"):
                parser.close()
        if xs:
            self._delivered += 1
            origin = f"{spec.get('uri')}#{spec.get('part', 0)}"
            self._queue.put(Batch(np.concatenate(xs, axis=0),
                                  np.concatenate(ys, axis=0),
                                  origin, self._delivered))
        return {"rows": rows, "batches": 1 if xs else 0}

    def next_batch(self, cursor: int) -> Optional[Batch]:
        try:
            return self._queue.get(timeout=0.05)
        except queue.Empty:
            return None

    def exhausted(self, cursor: int) -> bool:
        return self._done.is_set() and self._queue.empty()
