"""Double-buffered device feed: host batches -> the card, overlapped.

Counterpart of ``dmlc_core_tpu/bridge/loader.py`` (``DeviceFeedLoader``
and the transfer accounting it shares; ``MeshBatchLoader`` is not ported
yet), in PyTorch's idiom.  On ``cuda`` each host batch is copied into one
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
from dmlc_core_tpu_torch.telemetry import clock
from dmlc_core_tpu_torch.utils.device import resolve_device
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["DeviceFeedLoader", "batch_nbytes"]


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
