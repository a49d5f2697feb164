"""Metrics + span tracing for the port's IO, parser and device-feed paths.

Counterpart of ``dmlc_core_tpu/telemetry/__init__.py``: a process-wide
metrics registry (counters / gauges / fixed-bucket histograms with labels),
a span tracer exporting Chrome-trace JSON and JSONL, and Prometheus-text /
JSON-snapshot exporters with an atexit flush.  Span and counter names are
the JAX package's, letter for letter, so one trace reader serves both.
``python -m dmlc_core_tpu_torch.telemetry report|trace DIR`` aggregates
the snapshots and assembles the span files of such a directory.

Usage (instrumentation sites)::

    from dmlc_core_tpu_torch import telemetry

    telemetry.count("dmlc_parser_rows_total", n, format="libsvm")
    with telemetry.span("parser.parse_chunk", nbytes=len(chunk)):
        ...

**Disabled is the default and costs (almost) nothing**: every helper checks
the module-level ``_enabled`` flag before touching the registry, allocating,
or reading a clock; :func:`span` returns a shared no-op context manager.
Enable explicitly via :func:`enable`, or by environment:

- ``DMLC_TELEMETRY=1``     — enable collection;
- ``DMLC_TELEMETRY_DIR=d`` — enable collection AND flush every export form
  into ``d`` at interpreter exit (rank/pid-keyed filenames), and arm the
  flight recorder's abnormal-exit dumps (:mod:`.flight`).

Spans carry distributed trace identity when a trace context is active
(:mod:`.tracecontext`); :mod:`.traceview` merges the per-process span files
and crash dumps into one Perfetto trace with per-trace critical paths.

**Profiler bridge**: while a ``torch.profiler`` capture is recording,
every :func:`span` also opens a ``torch.profiler.record_function`` of the
same name, whether collection is on or off, so the span appears in the
profiler's Chrome trace as a ``user_annotation`` on the profiler's clock,
on the thread that ran it, where the device's kernels can be laid against
it (:mod:`.clock` converts between the two clocks).  The check is the
profiler module's own flag, looked up in ``sys.modules`` (telemetry imports
nothing heavier than the standard library): with collection off and no
profiler recording, :func:`span` is two flag checks and returns the shared
no-op, reading no clock and entering no ``record_function`` (which costs
microseconds even with no profiler running).
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
from typing import Any, Dict, Iterable, Optional

from dmlc_core_tpu_torch.telemetry import clock  # noqa: F401  (re-export)
from dmlc_core_tpu_torch.telemetry import flight  # noqa: F401  (re-export)
from dmlc_core_tpu_torch.telemetry import tracecontext  # noqa: F401  (re-export)
from dmlc_core_tpu_torch.telemetry.registry import (DEFAULT_BUCKETS, Counter, Gauge,
                                              Histogram, MetricRegistry)
from dmlc_core_tpu_torch.telemetry.spans import Span, SpanTracer

__all__ = [
    "enabled", "active", "enable", "disable", "reset",
    "count", "gauge_set", "gauge_add", "observe", "span", "record_span",
    "event",
    "get_registry", "get_tracer",
    "snapshot", "prometheus_text", "flush",
    "Counter", "Gauge", "Histogram", "MetricRegistry", "SpanTracer", "Span",
    "DEFAULT_BUCKETS", "clock", "flight", "tracecontext",
]

_enabled = False
_flush_dir: Optional[str] = None
_registry = MetricRegistry()
_tracer = SpanTracer()
_lock = threading.Lock()
_atexit_registered = False


class _NullSpan:
    """Shared no-op span: the whole disabled-mode cost of ``with span(...)``."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **attrs: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` capture is recording (torch's own flag;
    False where torch's profiler module was never imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


class _AnnotatedSpan:
    """``inner`` (a tracer span or the no-op) inside a profiler
    ``record_function`` of the same name; ``with`` yields ``inner``."""

    __slots__ = ("_inner", "_annotation")

    def __init__(self, name: str, inner: Any):
        self._inner = inner
        self._annotation = sys.modules[
            "torch.autograd.profiler"].record_function(name)

    def __enter__(self) -> Any:
        self._annotation.__enter__()
        return self._inner.__enter__()

    def __exit__(self, *exc: Any) -> None:
        try:
            self._inner.__exit__(*exc)
        finally:
            self._annotation.__exit__(*exc)


# -- switch ------------------------------------------------------------------

def enabled() -> bool:
    return _enabled


def active() -> bool:
    """Whether a :func:`span` records anything: collection is on, or a
    ``torch.profiler`` capture is recording.  Sites that compute span
    attributes check it first, so that both off costs one branch."""
    return _enabled or _profiling()


def enable(flush_dir: Optional[str] = None) -> None:
    """Turn collection on; with ``flush_dir``, also flush at interpreter exit
    and arm the flight recorder's abnormal-exit dumps into the same dir."""
    global _enabled, _flush_dir, _atexit_registered
    with _lock:
        _enabled = True
        if flush_dir:
            _flush_dir = flush_dir
            if not _atexit_registered:
                atexit.register(_atexit_flush)
                _atexit_registered = True
            flight.install(flush_dir)


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False


def reset() -> None:
    """Drop all collected state (metrics + spans).  Collection stays as-is."""
    _registry.reset()
    _tracer.reset()


def _atexit_flush() -> None:
    if _enabled and _flush_dir:
        try:
            flush(_flush_dir)
        except Exception:
            pass  # nothing at interpreter exit may turn into a traceback


# -- hot-path helpers (flag checked before anything else) --------------------

def count(name: str, n: float = 1, /, **labels: Any) -> None:
    """Increment counter ``name`` (no-op when disabled)."""
    if not _enabled:
        return
    _registry.counter(name, **labels).inc(n)


def gauge_set(name: str, value: float, /, **labels: Any) -> None:
    if not _enabled:
        return
    _registry.gauge(name, **labels).set(value)


def gauge_add(name: str, delta: float, /, **labels: Any) -> None:
    if not _enabled:
        return
    _registry.gauge(name, **labels).inc(delta)


def observe(name: str, value: float, /, *,
            buckets: Optional[Iterable[float]] = None, **labels: Any) -> None:
    """Record ``value`` into histogram ``name`` (no-op when disabled)."""
    if not _enabled:
        return
    _registry.histogram(name, buckets=buckets, **labels).observe(value)


def span(name: str, /, **attrs: Any):
    """Context manager tracing one span (shared no-op when disabled), also a
    profiler annotation while ``torch.profiler`` records."""
    if not _enabled:
        return _AnnotatedSpan(name, _NULL_SPAN) if _profiling() \
            else _NULL_SPAN
    inner = _tracer.span(name, **attrs)
    return _AnnotatedSpan(name, inner) if _profiling() else inner


def record_span(name: str, start: float, end: float, /, *,
                trace=None, **attrs: Any) -> None:
    """Record a span bracketed by two :func:`clock.monotonic` readings.

    ``trace`` optionally pins explicit ``(trace_id, span_id, parent_id)``
    identity (cross-thread attribution); without it, the recording thread's
    active trace context applies as usual."""
    if not _enabled:
        return
    _tracer.record_complete(name, start, end, trace=trace, **attrs)


def event(name: str, /, *, trace=None, **attrs: Any) -> None:
    """Record an instant event on the current span/context (no-op when
    disabled) — how point-in-time facts like fault-site fires land *on*
    the span that was running when they happened."""
    if not _enabled:
        return
    _tracer.record_instant(name, trace=trace, **attrs)


# -- access / export ---------------------------------------------------------

def get_registry() -> MetricRegistry:
    return _registry


def get_tracer() -> SpanTracer:
    return _tracer


def snapshot() -> Dict[str, Any]:
    from dmlc_core_tpu_torch.telemetry import export

    return export.json_snapshot(_registry, _tracer)


def prometheus_text() -> str:
    from dmlc_core_tpu_torch.telemetry import export

    return export.prometheus_text(_registry)


def flush(dirpath: Optional[str] = None) -> Dict[str, str]:
    """Write snapshot/prom/trace/events into ``dirpath`` (or the env dir)."""
    from dmlc_core_tpu_torch.telemetry import export

    target = dirpath or _flush_dir or os.environ.get("DMLC_TELEMETRY_DIR")
    if not target:
        raise ValueError("no telemetry directory: pass dirpath or set "
                         "DMLC_TELEMETRY_DIR")
    return export.flush(target, _registry, _tracer)


# -- env-driven bring-up -----------------------------------------------------

def _init_from_env() -> None:
    env_dir = os.environ.get("DMLC_TELEMETRY_DIR", "").strip()
    flag = os.environ.get("DMLC_TELEMETRY", "").strip().lower()
    if env_dir:
        enable(env_dir)
    elif flag not in ("", "0", "false", "off"):
        enable()


_init_from_env()
