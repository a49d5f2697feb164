"""The one monotonic clock for host-side metering.

Every hand-rolled ``time.perf_counter()`` idiom in utils/ (timer.get_time,
profiler.ThroughputMeter, profiler.device_timer) now routes through here, so
"what clock does telemetry use" has exactly one answer: ``perf_counter``,
monotonic, sub-microsecond resolution, meaningless across processes.

Span timestamps additionally need a per-process epoch so multiple ranks'
traces can be laid side by side in Perfetto: :func:`trace_time_us` is
microseconds since an arbitrary-but-fixed process start.  Wall-clock
(``time.time``) is only used to stamp exported snapshots, never to measure
— with one deliberate exception: :func:`wall_epoch` records, once at
import, the wall-clock time corresponding to trace timestamp 0.  The
cross-process trace assembler (``telemetry trace``) uses it to shift each
process' monotonic timestamps onto one shared axis; NTP-grade skew (ms)
is fine for eyeballing a merged timeline, and no *measurement* ever reads
the wall clock.

Counterpart of ``dmlc_core_tpu/telemetry/clock.py`` (a copy).
"""

from __future__ import annotations

import time

__all__ = ["monotonic", "elapsed", "trace_time_us", "to_trace_us",
           "wall_epoch"]

_PROCESS_EPOCH = time.perf_counter()
# captured back-to-back with _PROCESS_EPOCH: the wall time of trace ts 0
_WALL_EPOCH = time.time()


def monotonic() -> float:
    """Seconds on the process-wide monotonic clock."""
    return time.perf_counter()


def elapsed(start: float) -> float:
    """Seconds since ``start`` (a previous :func:`monotonic` reading)."""
    return time.perf_counter() - start


def trace_time_us() -> float:
    """Microseconds since process start — the Chrome-trace ``ts`` domain."""
    return (time.perf_counter() - _PROCESS_EPOCH) * 1e6


def to_trace_us(t: float) -> float:
    """Convert a :func:`monotonic` reading into the ``ts`` domain (for spans
    whose begin time was captured before the span was named)."""
    return (t - _PROCESS_EPOCH) * 1e6


def wall_epoch() -> float:
    """``time.time()`` at trace timestamp 0 — the per-process anchor the
    trace assembler uses to align processes on one time axis."""
    return _WALL_EPOCH
