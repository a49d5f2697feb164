"""Span tracer: begin/end events per thread, Chrome-trace + JSONL export.

Spans are *complete* events (Chrome trace ``"ph": "X"``): one record per
span carrying its start timestamp and duration, appended at span end — no
begin/end pairing pass is needed at export time and a crashed span simply
never appears.  Timestamps are microseconds on the process-monotonic clock
(:func:`dmlc_core_tpu_torch.telemetry.clock.trace_time_us`), so traces from
several ranks laid side by side in Perfetto share a plausible-if-not-
synchronized time axis.

**Trace identity** (:mod:`.tracecontext`): when a trace context is active
on the recording thread (an HTTP ``traceparent`` continued by the server,
a ``DMLC_TRACEPARENT`` process root, an enclosing span), every recorded
event additionally carries ``trace_id`` / ``span_id`` / ``parent_id`` —
the keys the cross-process assembler (``telemetry trace``) joins on.  A
context-managed :class:`Span` also *installs itself* as the active context
for its dynamic extent, so nested spans parent automatically.  With no
active context, events record exactly as before: untraced, never dropped
for it.

Every recorded event is also fed to the flight recorder's bounded ring
(:mod:`.flight`) — including events the main buffer drops — so a crashed
or SIGTERMed process still leaves its last N spans behind.

The buffer is bounded (``max_events``, default 200k): past the cap new
spans are counted as dropped rather than grown without limit — a telemetry
subsystem that OOMs the pipeline it observes would be worse than none.
Drops are exported as ``dmlc_telemetry_spans_dropped_total`` so an
assembled-but-incomplete trace is attributable to them.

The enabled/disabled fast path lives in the package ``__init__``; this
module always records when called.

Counterpart of ``dmlc_core_tpu/telemetry/spans.py`` (a copy).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

from dmlc_core_tpu_torch.telemetry import clock, flight, tracecontext

__all__ = ["SpanTracer", "Span"]

# (trace_id, span_id, parent_id-or-None) as carried on one event
TraceIds = Tuple[str, str, Optional[str]]


class Span:
    """Context manager recording one complete event on exit."""

    __slots__ = ("_tracer", "_name", "_attrs", "_start", "_trace", "_token")

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._start = 0.0
        self._trace: Optional[TraceIds] = None
        self._token: Optional[tracecontext.TraceContext] = None

    def __enter__(self) -> "Span":
        self._start = clock.trace_time_us()
        ctx = tracecontext.current()
        if ctx is not None:
            span_id = tracecontext.new_span_id()
            self._trace = (ctx.trace_id, span_id, ctx.span_id)
            # children opened inside this span's extent parent to it
            self._token = tracecontext._push(
                tracecontext.TraceContext(ctx.trace_id, span_id))
        return self

    @property
    def trace_id(self) -> Optional[str]:
        return self._trace[0] if self._trace else None

    @property
    def span_id(self) -> Optional[str]:
        return self._trace[1] if self._trace else None

    def set(self, **attrs: Any) -> None:
        """Attach attributes discovered mid-span (e.g. bytes handled)."""
        if self._attrs is None:
            self._attrs = {}
        self._attrs.update(attrs)

    def __exit__(self, exc_type, exc, tb) -> None:
        end = clock.trace_time_us()
        if self._trace is not None:
            tracecontext._pop(self._token)
        if exc_type is not None:
            self.set(error=exc_type.__name__)
        self._tracer.record(self._name, self._start, end - self._start,
                            self._attrs, trace=self._trace)


class SpanTracer:
    """Process-wide span sink with per-thread identity."""

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._thread_meta: Dict[int, str] = {}
        self._max = max_events
        self.dropped = 0

    def span(self, name: str, /, **attrs: Any) -> Span:
        return Span(self, name, attrs or None)

    def record(self, name: str, start_us: float, dur_us: float,
               attrs: Optional[Dict[str, Any]] = None, *,
               trace: Optional[TraceIds] = None, ph: str = "X") -> None:
        """Append one complete event (``ph: X``; ``ph: i`` for instants).

        ``trace`` pins explicit trace identity; when omitted, the recording
        thread's active context (if any) supplies it — the event becomes a
        child of the current span/context.
        """
        tid = threading.get_ident()
        event: Dict[str, Any] = {
            "name": name, "ph": ph, "ts": round(start_us, 3),
            "pid": os.getpid(), "tid": tid,
        }
        if ph == "X":
            event["dur"] = round(max(dur_us, 0.0), 3)
        else:
            event["s"] = "t"  # instant events scope to their thread
        if trace is None:
            ctx = tracecontext.current()
            if ctx is not None:
                trace = (ctx.trace_id, tracecontext.new_span_id(),
                         ctx.span_id)
        if trace is not None:
            event["trace_id"], event["span_id"] = trace[0], trace[1]
            if trace[2]:
                event["parent_id"] = trace[2]
        if attrs:
            event["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        overflow = False
        with self._lock:
            if len(self._events) >= self._max:
                self.dropped += 1
                overflow = True
            else:
                if tid not in self._thread_meta:
                    self._thread_meta[tid] = threading.current_thread().name
                self._events.append(event)
        # the flight ring keeps the most recent tail even past overflow:
        # that tail is exactly what a crash dump needs
        flight.note_event(event)
        if overflow:
            try:  # lazy: the package imports this module at its own load
                from dmlc_core_tpu_torch import telemetry

                telemetry.count("dmlc_telemetry_spans_dropped_total")
            except Exception:
                pass

    def record_complete(self, name: str, start: float, end: float,
                        /, *, trace: Optional[TraceIds] = None,
                        **attrs: Any) -> None:
        """Record a span bracketed by explicit :func:`clock.monotonic`
        readings — for phases whose begin predates knowing their name
        (e.g. tracker rendezvous: connect time is only attributable once
        the rank is assigned).  ``trace`` optionally pins identity for
        cross-thread attribution (e.g. the batcher crediting a request's
        queue wait to the request's own trace)."""
        self.record(name, clock.to_trace_us(start),
                    (end - start) * 1e6, attrs or None, trace=trace)

    def record_instant(self, name: str, /, *,
                       trace: Optional[TraceIds] = None,
                       **attrs: Any) -> None:
        """Record an instant event (``ph: i``) at now — fault fires and
        other point-in-time marks that belong *on* the enclosing span."""
        self.record(name, clock.trace_time_us(), 0.0, attrs or None,
                    trace=trace, ph="i")

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict[str, Any]:
        """chrome://tracing / Perfetto loadable JSON object."""
        with self._lock:
            events = list(self._events)
            meta = [{"name": "thread_name", "ph": "M", "pid": os.getpid(),
                     "tid": tid, "args": {"name": tname}}
                    for tid, tname in sorted(self._thread_meta.items())]
        # the per-process wall anchor the cross-process assembler aligns on
        meta.append({"name": "clock_sync", "ph": "M", "pid": os.getpid(),
                     "tid": 0, "args": {"wall_epoch_s": clock.wall_epoch()}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def jsonl(self) -> Iterator[str]:
        """One JSON object per line — the appendable event-log form."""
        for event in self.events():
            yield json.dumps(event, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._thread_meta.clear()
            self.dropped = 0


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
