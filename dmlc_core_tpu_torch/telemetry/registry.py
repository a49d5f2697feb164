"""Thread-safe process-wide metrics registry: counters, gauges, histograms.

The shape is Prometheus' data model cut down to what the pipeline needs:

- a **family** is a named metric of one kind (``counter``/``gauge``/
  ``histogram``) with optional help text;
- each distinct label set under a family is one **child** holding the actual
  value; the no-label child is keyed by the empty tuple;
- histograms use **fixed upper-bound buckets** chosen at registration
  (defaults suit request latencies in seconds) — observation is a bisect
  plus two adds, no allocation.

Everything mutating takes the child's own lock, so N writer threads produce
exact final counts (the GIL does not make ``+=`` on an attribute atomic).
Family creation takes the registry lock once; hot-path increments never do.

This module has no idea whether telemetry is enabled — the near-zero-overhead
disabled path lives in :mod:`dmlc_core_tpu_torch.telemetry` (the module-level flag
is checked before any registry call or allocation happens).

Counterpart of ``dmlc_core_tpu/telemetry/registry.py`` (a copy).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily", "MetricRegistry",
           "DEFAULT_BUCKETS"]

# request/op latencies in seconds; the +Inf bucket is implicit
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing float."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time float that can move both ways."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts + sum + count.

    ``buckets`` are inclusive upper bounds in ascending order; one extra
    +Inf bucket is always appended, so every observation lands somewhere.
    """

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(nxt <= prev
                             for nxt, prev in zip(bounds[1:], bounds)):
            raise ValueError(f"buckets must be ascending and non-empty: {bounds}")
        self._lock = threading.Lock()
        self.buckets = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # upper bounds are inclusive (Prometheus le semantics): the index of
        # the first bound >= v
        idx = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    @property
    def bucket_counts(self) -> List[int]:
        """Per-bucket (non-cumulative) counts; last entry is the +Inf bucket."""
        with self._lock:
            return list(self._counts)

    def cumulative(self) -> List[int]:
        """Cumulative counts per upper bound, Prometheus ``le`` style."""
        out, running = [], 0
        for c in self.bucket_counts:
            running += c
            out.append(running)
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric with children per label set."""

    __slots__ = ("name", "kind", "help", "buckets", "_children", "_lock")

    def __init__(self, name: str, kind: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None):
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
        self._children: Dict[LabelKey, object] = {}
        self._lock = threading.Lock()

    def child(self, labels: Dict[str, object]):
        key = _label_key(labels)
        got = self._children.get(key)
        if got is None:
            with self._lock:
                got = self._children.get(key)
                if got is None:
                    got = (Histogram(self.buckets) if self.kind == "histogram"
                           else _KINDS[self.kind]())
                    self._children[key] = got
        return got

    def samples(self) -> List[Tuple[LabelKey, object]]:
        with self._lock:
            return sorted(self._children.items())


class MetricRegistry:
    """Process-wide family store.  All lookups are by (name, kind)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _family(self, name: str, kind: str, help: str = "",
                buckets: Optional[Iterable[float]] = None) -> MetricFamily:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = MetricFamily(name, kind, help, buckets)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, not {kind}")
        if (kind == "histogram" and buckets is not None
                and tuple(float(b) for b in buckets) != fam.buckets):
            # same rigor as the kind clash: observations silently landing in
            # bounds the caller never asked for would be invisible until
            # someone reads the exported le= labels
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{fam.buckets}, not {tuple(buckets)}")
        return fam

    def counter(self, name: str, help: str = "", /, **labels) -> Counter:
        return self._family(name, "counter", help).child(labels)

    def gauge(self, name: str, help: str = "", /, **labels) -> Gauge:
        return self._family(name, "gauge", help).child(labels)

    def histogram(self, name: str, help: str = "", /, *,
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._family(name, "histogram", help, buckets).child(labels)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def reset(self) -> None:
        with self._lock:
            self._families.clear()
