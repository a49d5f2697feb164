"""Threading primitives (reference include/dmlc/concurrency.h, thread_local.h,
memory.h).

Counterpart of ``dmlc_core_tpu/utils/concurrency.py`` (a copy; it imports no
torch).

Python-side parity notes:
- :class:`ConcurrentBlockingQueue` — bounded FIFO/priority queue with the
  reference's SignalForKill semantics (concurrency.h:62-122);
- :class:`ThreadLocalStore` — per-thread singleton registry
  (thread_local.h:34-79);
- :class:`BufferPool` — fixed-size buffer recycling (memory.h:21-76); in the
  rebuild the hot path recycles via ThreadedIter, but the pool is exposed for
  host-staging buffers (e.g. pinned batch arrays reused across steps);
- a Spinlock (concurrency.h:23-49) is deliberately *not* provided: under the
  GIL a spinlock is strictly worse than threading.Lock, and the C++ native
  core uses std::mutex.
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")

__all__ = ["ConcurrentBlockingQueue", "ThreadLocalStore", "BufferPool"]


class ConcurrentBlockingQueue(Generic[T]):
    """Bounded blocking queue, FIFO or priority ordering."""

    def __init__(self, max_size: int = 0, priority: bool = False):
        self._max = max_size
        self._priority = priority
        self._fifo: deque = deque()
        self._heap: List = []
        self._count = 0
        self._killed = False
        self._cond = threading.Condition()

    def push(self, value: T, priority: int = 0) -> None:
        with self._cond:
            while (self._max and self._size() >= self._max
                   and not self._killed):
                self._cond.wait()
            if self._killed:
                return
            if self._priority:
                self._count += 1
                heapq.heappush(self._heap, (-priority, self._count, value))
            else:
                self._fifo.append(value)
            self._cond.notify_all()

    def pop(self) -> Optional[T]:
        """Blocking pop; None after signal_for_kill (reference Pop returning
        false on kill)."""
        with self._cond:
            while self._size() == 0 and not self._killed:
                self._cond.wait()
            if self._size() == 0:
                return None
            if self._priority:
                value = heapq.heappop(self._heap)[2]
            else:
                value = self._fifo.popleft()
            self._cond.notify_all()
            return value

    def signal_for_kill(self) -> None:
        with self._cond:
            self._killed = True
            self._cond.notify_all()

    def size(self) -> int:
        with self._cond:
            return self._size()

    def _size(self) -> int:
        return len(self._heap) if self._priority else len(self._fifo)


class ThreadLocalStore:
    """Per-thread singletons keyed by factory (reference ThreadLocalStore)."""

    _local = threading.local()

    @classmethod
    def get(cls, factory: Callable[[], Any]) -> Any:
        store: Dict = getattr(cls._local, "store", None)
        if store is None:
            store = {}
            cls._local.store = store
        key = factory
        if key not in store:
            store[key] = factory()
        return store[key]


class BufferPool:
    """Recycle fixed-size bytearray/numpy buffers (reference MemoryPool)."""

    def __init__(self, nbytes: int, max_cached: int = 16):
        self._nbytes = nbytes
        self._max = max_cached
        self._free: List[bytearray] = []
        self._lock = threading.Lock()

    def alloc(self) -> bytearray:
        with self._lock:
            if self._free:
                return self._free.pop()
        return bytearray(self._nbytes)

    def free(self, buf: bytearray) -> None:
        if len(buf) != self._nbytes:
            return
        with self._lock:
            if len(self._free) < self._max:
                self._free.append(buf)
