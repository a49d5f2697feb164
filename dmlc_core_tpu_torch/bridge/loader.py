"""Double-buffered device feed: host batches -> the card, overlapped.

Counterpart of ``dmlc_core_tpu/bridge/loader.py`` (``DeviceFeedLoader``,
``MeshBatchLoader`` and the transfer accounting they share), in PyTorch's
idiom.

:class:`MeshBatchLoader` stages a parser's dense or sparse batches on a
prefetch thread and places each on the rank's device; with one process
per rank, a rank yields its own share of one global batch: ``global_batch_size
/ P`` rows, where P is the number of row shards of the mesh (the product
of its row axes; ``world`` on a ``data`` mesh over all ranks, the JAX
loader's per-process share), so ranks that differ only along a ``model``
axis stage the same rows.

:class:`DeviceFeedLoader`: on ``cuda`` each host batch is copied into one
of a ring of ``prefetch + 1`` pinned host buffers (allocated once per batch
layout and reused), then onto the card with a ``non_blocking`` copy on a
side stream, with an event recorded after it.  The loader keeps
``prefetch`` such copies in flight ahead of the consumer, so the copy of
batch k+1 overlaps compute on batch k.  At hand-off the consumer's stream
waits on the batch's event (``wait_event``: no host sync) and the device
tensors ``record_stream`` the consumer's stream, so the caching allocator
never hands their memory to another tensor while the consumer's work is
queued.  A pinned buffer is refilled only after the copy that last read it
has completed.

Every transfer is accounted: ``loader.transfer`` spans plus the
``dmlc_transfer_bytes_total`` / ``dmlc_transfer_seconds_total{phase=
dispatch|wait}`` counters, names as in the JAX package.  Feed it
:func:`~.binning.binned_batches` and the wire carries uint8 bin ids
instead of float32 features.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.bridge.batching import dense_batches, sparse_batches
from dmlc_core_tpu_torch.io.threadediter import ThreadedIter
from dmlc_core_tpu_torch.telemetry import clock
from dmlc_core_tpu_torch.utils.device import resolve_device
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["MeshBatchLoader", "DeviceFeedLoader", "batch_nbytes"]


def _leaves(batch: Any) -> List[torch.Tensor]:
    """The tensors of a batch (a tensor, or a tuple/NamedTuple/list/dict
    of them), in order; ``None`` fields and host ints are not leaves."""
    if isinstance(batch, torch.Tensor):
        return [batch]
    if isinstance(batch, dict):
        batch = list(batch.values())
    if isinstance(batch, (tuple, list)):
        return [t for item in batch for t in _leaves(item)]
    return []


def _rebuild(batch: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """``batch`` with its leaves replaced, in order, from ``leaves``."""
    if isinstance(batch, torch.Tensor):
        return next(leaves)
    if isinstance(batch, dict):
        return {k: _rebuild(v, leaves) for k, v in batch.items()}
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_rebuild(v, leaves) for v in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(_rebuild(v, leaves) for v in batch)
    return batch


def _as_tensors(batch: Any) -> Any:
    """numpy leaves become CPU tensors (zero-copy); the rest as it is."""
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch)
    if isinstance(batch, dict):
        return {k: _as_tensors(v) for k, v in batch.items()}
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_as_tensors(v) for v in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(_as_tensors(v) for v in batch)
    return batch


def batch_nbytes(batch: Any) -> int:
    """Total tensor bytes of a host batch (what a transfer of it ships)."""
    return sum(t.numel() * t.element_size() for t in _leaves(batch))


def _record_transfer(path: str, nbytes: int, seconds: float,
                     phase: str) -> None:
    """One transfer accounting row: bytes move once (dispatch), seconds
    split by phase so dispatch cost and non-overlapped wait stay separate
    series."""
    if phase == "dispatch":
        telemetry.count("dmlc_transfer_bytes_total", nbytes, path=path)
    telemetry.count("dmlc_transfer_seconds_total", seconds, path=path,
                    phase=phase)


def _accounted_place(inner: Callable[[Any], Any],
                     path: str) -> Callable[[Any], Any]:
    """Wrap a placement fn with the transfer accounting: ``loader.transfer``
    span + byte/latency counters.  Zero-cost when telemetry is disabled."""

    def place(host_batch):
        if not telemetry.enabled():
            return inner(host_batch)
        nbytes = batch_nbytes(host_batch)
        start = clock.monotonic()
        with telemetry.span("loader.transfer", path=path, nbytes=nbytes):
            placed = inner(host_batch)
        _record_transfer(path, nbytes, clock.monotonic() - start,
                         "dispatch")
        return placed

    return place


class MeshBatchLoader:
    """Iterate device-placed batches of a parser, one process per rank.

    Args:
      parser: host-side Parser (already sharded per process through
        ``part_index``/``num_parts`` at creation).
      mesh: the job's :class:`~..parallel.mesh.Mesh`; each rank places
        its own rows on its device.
      form: "dense" or "sparse".
      global_batch_size: rows per global step; this process stages
        ``global_batch_size / P`` rows, P the mesh's row shards.
      num_feature: required for the dense form.
      nnz_bucket: fixed nonzero bucket for the sparse form (else the
        power-of-two ladder of :func:`~.batching.bucket_size`).
      prefetch: host batches staged ahead on the producer thread.
      device: where batches land; ``cuda`` unless the caller passes
        ``device="cpu"``.
    """

    def __init__(self, parser: Any, mesh: Any, form: str = "dense",
                 global_batch_size: int = 1024,
                 num_feature: Optional[int] = None,
                 nnz_bucket: Optional[int] = None, prefetch: int = 2,
                 drop_remainder: bool = True, device: Any = None):
        rows = mesh.row_axes
        nproc = mesh.axis_size(rows) if rows else 1
        CHECK(global_batch_size % nproc == 0,
              "global_batch_size must divide evenly across processes")
        self._device = resolve_device(device)
        self._local_rows = global_batch_size // nproc
        if form == "dense":
            CHECK(num_feature is not None, "dense form requires num_feature")
            factory = lambda: dense_batches(  # noqa: E731
                parser, self._local_rows, num_feature, drop_remainder)
        elif form == "sparse":
            factory = lambda: sparse_batches(  # noqa: E731
                parser, self._local_rows, nnz_bucket, drop_remainder)
        else:
            raise ValueError(f"unknown batch form {form!r}")
        self._parser = parser
        self._host_iter = ThreadedIter(_EpochProducer(parser, factory),
                                       max_capacity=prefetch, name="loader")

    def _place(self, host_batch: Any) -> Any:
        dev = self._device
        return _rebuild(host_batch, iter([t.to(dev) for t in
                                          _leaves(host_batch)]))

    def _host_batches(self) -> Iterator[Any]:
        while True:
            host_batch = self._host_iter.next()
            if host_batch is None:
                return
            yield host_batch

    def __iter__(self) -> Iterator[Any]:
        place = _accounted_place(self._place, "mesh_shard")
        for host_batch in self._host_batches():
            yield place(host_batch)

    def before_first(self) -> None:
        self._host_iter.before_first()

    def bytes_read(self) -> int:
        return self._parser.bytes_read()

    def close(self) -> None:
        self._host_iter.destroy()
        if hasattr(self._parser, "close"):
            self._parser.close()


class _EpochProducer:
    """ThreadedIter producer over a restartable batch-iterator factory."""

    def __init__(self, parser: Any, factory: Callable[[], Any]):
        self._parser = parser
        self._factory = factory
        self._it = None

    def before_first(self) -> None:
        self._parser.before_first()
        self._it = None

    def next(self, reuse):
        if self._it is None:
            self._it = iter(self._factory())
        try:
            return next(self._it)
        except StopIteration:
            self._it = None
            return None
        except BaseException:
            # a mid-epoch failure leaves the iterator spent: a later next()
            # would read as a clean (truncated) epoch end, so drop it and
            # let the next pull restart the factory
            self._it = None
            raise


class _Slot:
    __slots__ = ("buffers", "event")

    def __init__(self, buffers: List[torch.Tensor]):
        self.buffers = buffers
        self.event: Optional[torch.cuda.Event] = None


class _PinnedPlacer:
    """Host batch -> (device batch, copy-done event) through a ring of
    ``depth`` pinned buffers per batch layout, copied on a side stream."""

    def __init__(self, device: torch.device, depth: int):
        self._device = device
        self._depth = depth
        self._stream = torch.cuda.Stream(device)
        self._rings: Dict[tuple, List[_Slot]] = {}
        self._turns: Dict[tuple, int] = {}

    def __call__(self, host_batch: Any
                 ) -> Tuple[Any, Optional[torch.cuda.Event]]:
        leaves = _leaves(host_batch)
        key = tuple((tuple(t.shape), t.dtype) for t in leaves)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [
                _Slot([torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       for t in leaves]) for _ in range(self._depth)]
            self._turns[key] = 0
        slot = ring[self._turns[key] % self._depth]
        self._turns[key] += 1
        if slot.event is not None:
            # the copy that last read this buffer must be done before the
            # host overwrites it
            slot.event.synchronize()
        for buf, t in zip(slot.buffers, leaves):
            buf.copy_(t)
        with torch.cuda.stream(self._stream):
            out = [torch.empty(t.shape, dtype=t.dtype, device=self._device)
                   for t in leaves]
            for dst, buf in zip(out, slot.buffers):
                dst.copy_(buf, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        return _rebuild(host_batch, iter(out)), slot.event


class DeviceFeedLoader:
    """Double-buffered async device feed over any restartable batch source.

    ``source`` is either a zero-arg factory returning one epoch's iterator
    of host batches (e.g. ``lambda: binned_batches(parser, binner, bs)``),
    or an object with ``before_first()`` + iteration.  Each ``__iter__``
    starts a fresh epoch; ``before_first()`` is the explicit restart for
    source objects that need it.  A host batch is a CPU tensor or numpy
    array, or a tuple/NamedTuple/list/dict of them (``None`` fields and
    ints such as ``num_rows`` pass through).

    ``device=None`` means ``cuda``; without a card the loader raises
    unless the caller passes ``device="cpu"``, where placement is the
    synchronous ``.to("cpu")``.

    Determinism contract (tested): the batch sequence is byte-identical
    to placing the same host batches synchronously with ``.to(device)``
    (buffering reorders *time*, never data), including across a full
    ``before_first()`` epoch restart.
    """

    def __init__(self, source: Any, device: Any = None, prefetch: int = 2):
        CHECK(prefetch >= 1, "prefetch must be >= 1")
        self._source = source
        self._prefetch = prefetch
        self._device = resolve_device(device)
        self._pinned: Optional[_PinnedPlacer] = None

    def _epoch(self) -> Iterator[Any]:
        if callable(self._source):
            return iter(self._source())
        if hasattr(self._source, "before_first"):
            self._source.before_first()
        return iter(self._source)

    def _placer(self) -> Callable[[Any], Any]:
        if self._device.type != "cuda":
            dev = self._device

            def inner(host_batch):
                placed = [t.to(dev) for t in _leaves(host_batch)]
                return _rebuild(host_batch, iter(placed)), None
        else:
            if self._pinned is None:
                self._pinned = _PinnedPlacer(self._device,
                                             self._prefetch + 1)
            inner = self._pinned
        return _accounted_place(inner, "device_feed")

    def __iter__(self) -> Iterator[Any]:
        place = self._placer()
        host = (_as_tensors(b) for b in self._epoch())
        pending: deque = deque()
        while True:
            while len(pending) < self._prefetch:
                try:
                    host_batch = next(host)
                except StopIteration:
                    break
                pending.append(place(host_batch))
            if not pending:
                return
            batch, event = pending.popleft()
            if event is not None:
                self._hand_off(batch, event)
            yield batch

    def _hand_off(self, batch: Any, event: torch.cuda.Event) -> None:
        """Order the consumer's stream after the batch's copy; with
        telemetry on, first time the host's wait for it (the transfer
        residue compute did not hide)."""
        if telemetry.enabled():
            start = clock.monotonic()
            with telemetry.span("loader.transfer.wait", path="device_feed"):
                event.synchronize()
            _record_transfer("device_feed", 0, clock.monotonic() - start,
                             "wait")
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(event)
        for t in _leaves(batch):
            t.record_stream(consumer)

    def before_first(self) -> None:
        """Restart the underlying source (factory sources restart per
        ``__iter__`` anyway; this forwards to object sources)."""
        if not callable(self._source) and hasattr(self._source,
                                                  "before_first"):
            self._source.before_first()
