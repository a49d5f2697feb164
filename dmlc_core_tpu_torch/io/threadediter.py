"""Threaded producer/consumer iterator — the universal pipeline primitive.

Capability parity with the reference's ``dmlc::ThreadedIter<DType>``
(include/dmlc/threadediter.h:45-394): a single producer thread fills a bounded
queue; the consumer pulls with :meth:`next` and hands buffers back with
:meth:`recycle` so the producer can reuse them (free-cell recycling,
threadediter.h:359-394); :meth:`before_first` restarts the epoch
(kBeforeFirst signal, threadediter.h:167-190) and :meth:`destroy` tears the
thread down (kDestroy).

Producer protocol (reference Producer subclass, threadediter.h:87-134)::

    class MyProducer:
        def before_first(self):   # reset to the beginning (optional)
        def next(self, reuse):    # return next item, reusing `reuse` (may be
                                  # None) as scratch; return None at the end

Exceptions raised by the producer are captured and re-raised on the consumer
side at the next :meth:`next` call, matching the reference's exception-ferrying
(threadediter.h:300-356).

Counterpart of ``dmlc_core_tpu/io/threadediter.py`` (a copy).  This is the
host-side prefetch idiom; the device-facing form of the same pattern
(pinned, double-buffered copies onto the card) lives in
:mod:`dmlc_core_tpu_torch.bridge.loader`.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable, Generic, Iterator, Optional, TypeVar

from dmlc_core_tpu_torch import fault, telemetry

logger = logging.getLogger("dmlc_core_tpu_torch.io")

T = TypeVar("T")

__all__ = ["ThreadedIter", "IteratorProducer"]

_END = object()


class IteratorProducer:
    """Adapts a factory of plain Python iterables to the producer protocol."""

    def __init__(self, factory: Callable[[], Any]):
        self._factory = factory
        self._it: Optional[Iterator] = None

    def before_first(self) -> None:
        self._it = None

    def next(self, reuse: Any) -> Any:
        if self._it is None:
            self._it = iter(self._factory())
        try:
            return next(self._it)
        except StopIteration:
            return None


class ThreadedIter(Generic[T]):
    """Single-producer bounded-queue prefetch iterator.

    Capacity is bounded by item count (``max_capacity``) and, when a
    ``cost_fn`` is given, by total queued cost (``max_bytes``): the producer
    blocks while ``sum(cost_fn(item))`` of queued items is at or over the
    bound.  At least one item is always admitted, so a single over-budget
    item flows instead of deadlocking.  The bound is checked *before*
    producing — the queue can overshoot by at most one item.

    Observability: :meth:`qsize` reports current queue occupancy (and
    :meth:`qbytes` the queued cost); ``producer_stalls`` /
    ``consumer_stalls`` count wait *episodes* (a producer blocked on a full
    queue / a consumer blocked on an empty one — each stall names the side
    that is the bottleneck); the optional ``on_producer_stall`` /
    ``on_consumer_stall`` hooks fire once per episode (called under the
    iterator lock: keep them cheap and never call back into the iterator).
    With telemetry enabled the same signals feed the
    ``dmlc_threadediter_*`` metric families, labeled by ``name``.
    """

    def __init__(self, producer: Any = None, max_capacity: int = 8,
                 name: str = "threadediter",
                 max_bytes: Optional[int] = None,
                 cost_fn: Optional[Callable[[Any], int]] = None):
        self._cap = max(1, int(max_capacity))
        self._name = name
        self._max_bytes = int(max_bytes) if max_bytes else None
        self._cost_fn = cost_fn
        self._queue_bytes = 0             # summed cost of queued items
        self._cond = threading.Condition()
        self._queue: deque = deque()      # (generation, item-or-_END, cost)
        self._free: deque = deque()       # recycled buffers
        self._gen = 0                     # current consumer generation
        self._destroyed = False
        self._error: Optional[BaseException] = None
        self._producer = None
        self._thread: Optional[threading.Thread] = None
        self.producer_stalls = 0
        self.consumer_stalls = 0
        self.on_producer_stall: Optional[Callable[[], None]] = None
        self.on_consumer_stall: Optional[Callable[[], None]] = None
        if producer is not None:
            self.init(producer)

    @classmethod
    def from_factory(cls, factory: Callable[[], Any], max_capacity: int = 8,
                     name: str = "threadediter") -> "ThreadedIter":
        """ThreadedIter over ``iter(factory())`` per epoch."""
        return cls(IteratorProducer(factory), max_capacity=max_capacity,
                   name=name)

    # -- observability --------------------------------------------------------
    def qsize(self) -> int:
        """Real items of the current generation queued right now (end-of-
        epoch/error sentinels and stale-generation leftovers excluded)."""
        with self._cond:
            return self._qsize_locked()

    def qbytes(self) -> int:
        """Summed ``cost_fn`` cost of queued items (0 without a cost_fn)."""
        with self._cond:
            return self._queue_bytes

    def _qsize_locked(self) -> int:
        return sum(1 for gen, item, _ in self._queue
                   if gen == self._gen and item is not _END)

    def _full_locked(self) -> bool:
        if len(self._queue) >= self._cap:
            return True
        return (self._max_bytes is not None and len(self._queue) > 0
                and self._queue_bytes >= self._max_bytes)

    def _note_depth_locked(self) -> None:
        try:
            if telemetry.enabled():
                telemetry.gauge_set("dmlc_threadediter_queue_depth",
                                    self._qsize_locked(), name=self._name)
                if self._cost_fn is not None:
                    telemetry.gauge_set("dmlc_threadediter_queue_bytes",
                                        self._queue_bytes, name=self._name)
        except Exception:
            # observability must never kill the producer thread (a dead
            # producer with no _error/_END posted hangs next() forever)
            logger.exception("queue-depth telemetry failed")

    def _note_producer_stall_locked(self) -> None:
        self.producer_stalls += 1
        # counter first: a raising user hook must not desync the exported
        # count from the attribute just incremented
        try:
            telemetry.count("dmlc_threadediter_producer_stalls_total",
                            name=self._name)
        except Exception:
            logger.exception("producer-stall telemetry failed")
        try:
            if self.on_producer_stall is not None:
                self.on_producer_stall()
        except Exception:
            logger.exception("producer-stall hook failed")

    def _note_consumer_stall_locked(self) -> None:
        self.consumer_stalls += 1
        try:
            telemetry.count("dmlc_threadediter_consumer_stalls_total",
                            name=self._name)
        except Exception:
            logger.exception("consumer-stall telemetry failed")
        try:
            if self.on_consumer_stall is not None:
                self.on_consumer_stall()
        except Exception:
            logger.exception("consumer-stall hook failed")

    def init(self, producer: Any) -> None:
        assert self._thread is None, "ThreadedIter already initialized"
        self._producer = producer
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dmlc-threadediter")
        self._thread.start()

    # -- producer thread ------------------------------------------------------
    def _run(self) -> None:
        cur_gen = 0
        need_reset = False
        while True:
            epoch_ok = True
            if need_reset:
                try:
                    self._producer.before_first()
                except BaseException as exc:  # noqa: BLE001 - ferried to consumer
                    self._post_error(cur_gen, exc)
                    epoch_ok = False
            if epoch_ok:
                finished = self._produce_epoch(cur_gen)
                if finished is None:
                    return  # destroyed
            # epoch over (EOF, error, or reset): wait for the next
            # generation.  An error ends the epoch but NOT the thread —
            # exiting here would make every post-error before_first()
            # restart hang the consumer forever (no producer left)
            with self._cond:
                while not self._destroyed and self._gen == cur_gen:
                    self._cond.wait()
                if self._destroyed:
                    return
                cur_gen = self._gen
            need_reset = True

    def _produce_epoch(self, cur_gen: int) -> Optional[bool]:
        """Produce items for ``cur_gen`` until EOF/reset. None means destroyed."""
        while True:
            with self._cond:
                if (self._full_locked() and not self._destroyed
                        and self._gen == cur_gen):
                    # queue full: the consumer is the bottleneck right now
                    self._note_producer_stall_locked()
                while (self._full_locked() and not self._destroyed
                       and self._gen == cur_gen):
                    self._cond.wait()
                if self._destroyed:
                    return None
                if self._gen != cur_gen:
                    return True  # reset requested mid-epoch
                reuse = self._free.popleft() if self._free else None
            try:
                if fault.enabled():
                    # injected producer faults ride the normal ferrying path:
                    # the consumer sees them at next(), the thread survives
                    fault.inject("threadediter.produce", name=self._name)
                with telemetry.span("threadediter.produce", name=self._name):
                    item = self._producer.next(reuse)
            except BaseException as exc:  # noqa: BLE001
                if reuse is not None:
                    # the buffer was never handed to the consumer; without
                    # this, every failed epoch shrinks the recycle pool
                    with self._cond:
                        self._free.append(reuse)
                self._post_error(cur_gen, exc)
                return True  # epoch over; stay alive for a restart
            cost = 0
            if item is not None and self._cost_fn is not None:
                try:
                    cost = max(0, int(self._cost_fn(item)))
                except Exception:
                    logger.exception("cost hook failed; item costed as 0")
            with self._cond:
                if self._destroyed:
                    return None
                if self._gen != cur_gen:
                    # reset raced the produce: the consumer will never see
                    # this item — re-pool its buffer (and reuse too, when
                    # the producer ignored it and allocated fresh)
                    if item is not None and item is not reuse:
                        self._free.append(item)
                    if reuse is not None:
                        self._free.append(reuse)
                    return True
                self._queue.append((cur_gen, _END if item is None else item,
                                    cost))
                self._queue_bytes += cost
                self._note_depth_locked()
                self._cond.notify_all()
                if item is None:
                    # EOF probe: the popped reuse buffer was never consumed
                    if reuse is not None:
                        self._free.append(reuse)
                    return True

    def _post_error(self, gen: int, exc: BaseException) -> None:
        with self._cond:
            if gen != self._gen:
                # the consumer already abandoned this epoch via
                # before_first(); surfacing its error into the NEXT epoch
                # would make an otherwise-successful restart raise at EOF
                return
            self._error = exc
            self._queue.append((gen, _END, 0))
            self._cond.notify_all()

    # -- consumer side ---------------------------------------------------------
    def next(self) -> Optional[T]:
        """Next item, or None at end of the current epoch (reference Next)."""
        with self._cond:
            stalled = False
            while True:
                if self._destroyed:
                    return None
                # drop items from stale generations, recycling their buffers
                while self._queue and self._queue[0][0] != self._gen:
                    _, item, cost = self._queue.popleft()
                    self._queue_bytes -= cost
                    if item is not _END:
                        self._free.append(item)
                    self._cond.notify_all()
                if self._queue:
                    gen, item, cost = self._queue[0]
                    if item is _END:
                        if self._error is not None:
                            err, self._error = self._error, None
                            # leave _END queued: the epoch stays "ended"
                            # after the raise (next call returns None
                            # instead of waiting on an epoch that will
                            # never produce again)
                            raise err
                        return None  # leave _END queued: epoch stays "ended"
                    self._queue.popleft()
                    self._queue_bytes -= cost
                    self._note_depth_locked()
                    self._cond.notify_all()
                    return item
                if not stalled:
                    # empty queue: the producer is the bottleneck right now
                    stalled = True
                    self._note_consumer_stall_locked()
                self._cond.wait()

    def recycle(self, item: T) -> None:
        """Return a consumed buffer for producer reuse (reference Recycle)."""
        with self._cond:
            self._free.append(item)
            self._cond.notify_all()

    def before_first(self) -> None:
        """Restart from the beginning (reference BeforeFirst signal protocol).

        Discards the current epoch wholesale: queued items AND a pending
        error both belong to the epoch being abandoned (the producer posts
        late errors generation-checked, so none can leak in afterwards)."""
        with self._cond:
            self._gen += 1
            self._error = None
            # drop everything already queued
            while self._queue:
                _, item, _ = self._queue.popleft()
                if item is not _END:
                    self._free.append(item)
            self._queue_bytes = 0
            self._note_depth_locked()
            self._cond.notify_all()

    def destroy(self) -> None:
        with self._cond:
            if self._destroyed:
                return
            self._destroyed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass

    def __iter__(self) -> Iterator[T]:
        while True:
            item = self.next()
            if item is None:
                return
            yield item
