"""Trace context: the identity that makes spans joinable across processes.

A **trace** is one causal story — a scored request from the loadgen client
through the HTTP handler, the micro-batcher and predict; a probe run from
``bench.py`` down into its re-exec'd children; a rendezvous from the
tracker's accept loop into every worker.  Each story gets one ``trace_id``;
every span recorded while a :class:`TraceContext` is active carries that id
plus its own ``span_id`` and its parent's, so the offline assembler
(``python -m dmlc_core_tpu_torch.telemetry trace``) can stitch per-process span
files back into one tree however many processes the story crossed.

Propagation forms (all carry the same W3C ``traceparent`` string,
``00-<32 hex trace_id>-<16 hex span_id>-01``):

- **HTTP header** ``traceparent`` — the serving path
  (client attaches, ``serve/server.py`` continues);
- **environment** ``DMLC_TRACEPARENT`` — a parent process roots every span
  of a child it launches (``bench.py`` children, tracker-launched workers
  via ``DMLC_TRACKER_TRACEPARENT``); read once at import into the
  *process root* context, which applies to every thread;
- **explicit argument** — same-process boundaries that cross threads or
  executors (``data/parse_proc.py`` ships it to pool workers next to the
  parse spec).

In-process the active context is **thread-local**: ``with activate(ctx):``
installs it, every ``telemetry.span(...)`` opened inside becomes a child
and re-installs itself for its own dynamic extent, so nesting is automatic.
A thread with no activated context falls back to the process root (or no
context at all — spans then record exactly as they did before tracing
existed: untraced, but never lost).

Cost discipline: this module is consulted only when telemetry is enabled
and a span is actually recorded — one thread-local read.  Disabled
telemetry never touches it.

Counterpart of ``dmlc_core_tpu/telemetry/tracecontext.py`` (a copy).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

__all__ = [
    "TraceContext", "new_trace_id", "new_span_id",
    "format_traceparent", "from_traceparent",
    "current", "activate", "set_process_root", "get_process_root",
    "current_traceparent", "child_env",
    "TRACEPARENT_ENV", "TRACKER_TRACEPARENT_ENV",
]

TRACEPARENT_ENV = "DMLC_TRACEPARENT"
# the tracker's own env contract (tracker/rendezvous.py worker_envs): kept
# distinct from DMLC_TRACEPARENT so a job-level trace (bench) and a
# tracker-level one can coexist; DMLC_TRACEPARENT wins when both are set
TRACKER_TRACEPARENT_ENV = "DMLC_TRACKER_TRACEPARENT"

_VERSION = "00"
_FLAGS_SAMPLED = "01"
_HEX = set("0123456789abcdef")


class TraceContext:
    """One point in a trace: the trace and the span new children parent to.

    ``span_id`` may be ``None`` for a *fresh root*: the first span opened
    under it becomes the trace's root span (no parent) — this is how a
    client starts a story without inventing a parent span nobody recorded.
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)


def new_trace_id() -> str:
    """Fresh 32-hex (128-bit) trace id."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """Fresh 16-hex (64-bit) span id."""
    return os.urandom(8).hex()


def new_root() -> TraceContext:
    """A fresh root context (new trace, no parent span yet)."""
    return TraceContext(new_trace_id(), None)


def format_traceparent(ctx: TraceContext) -> str:
    """W3C ``traceparent`` for ``ctx`` (requires a concrete ``span_id`` —
    the wire format has no way to say "trace but no span yet")."""
    if not ctx.span_id:
        raise ValueError("cannot encode a traceparent without a span_id "
                         "(open a span first, or generate one explicitly)")
    return f"{_VERSION}-{ctx.trace_id}-{ctx.span_id}-{_FLAGS_SAMPLED}"


def _hexfield(s: str, n: int) -> bool:
    return len(s) == n and set(s) <= _HEX and set(s) != {"0"}


def from_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Decode a ``traceparent``; ``None`` on anything malformed.

    Lenient by design (the W3C rule: an invalid header is *ignored*, the
    receiver starts its own trace) — a hostile or buggy client must not be
    able to 500 the scoring path with a weird header.  Future versions
    (``version != 00``) are accepted as long as the two id fields parse;
    version ``ff`` is explicitly invalid per spec.
    """
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or set(version) - _HEX or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        # the spec: version 00 has exactly four fields; extra fields are
        # only tolerated from FUTURE versions (forward compatibility)
        return None
    if not _hexfield(trace_id, 32) or not _hexfield(span_id, 16):
        return None
    return TraceContext(trace_id, span_id)


# -- the active context -------------------------------------------------------

_tls = threading.local()
_process_root: Optional[TraceContext] = None


def current() -> Optional[TraceContext]:
    """The context spans opened on this thread join (thread-local first,
    then the process root, else None)."""
    ctx = getattr(_tls, "ctx", None)
    return ctx if ctx is not None else _process_root


class _Activation:
    """``with activate(ctx):`` — install (or, for None, change nothing)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._prev: Optional[TraceContext] = None

    def __enter__(self) -> Optional[TraceContext]:
        if self._ctx is not None:
            self._prev = getattr(_tls, "ctx", None)
            _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc: Any) -> None:
        if self._ctx is not None:
            _tls.ctx = self._prev


def activate(ctx: Optional[TraceContext]) -> _Activation:
    """Context manager installing ``ctx`` as this thread's active context.

    ``activate(None)`` is a transparent no-op, so call sites can write
    ``with activate(from_traceparent(header)):`` without branching.
    """
    return _Activation(ctx)


def _push(ctx: TraceContext) -> Optional[TraceContext]:
    """Install ``ctx`` (a span making itself current); returns the token
    :func:`_pop` restores.  Internal — spans.py only."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def _pop(token: Optional[TraceContext]) -> None:
    _tls.ctx = token


def set_process_root(ctx: Optional[TraceContext]) -> None:
    """Install the process-wide fallback context (None clears it).

    This is what env propagation sets: every thread with no explicitly
    activated context parents its spans here, so a whole child process'
    telemetry joins the launcher's trace.
    """
    global _process_root
    _process_root = ctx


def get_process_root() -> Optional[TraceContext]:
    return _process_root


def current_traceparent() -> Optional[str]:
    """The active context as a traceparent string (None when there is no
    context or it has no span yet)."""
    ctx = current()
    if ctx is None or not ctx.span_id:
        return None
    return format_traceparent(ctx)


def child_env(environ: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Env-var propagation: ``environ`` (or a fresh dict) with
    ``DMLC_TRACEPARENT`` set from the active context when there is one."""
    env: Dict[str, str] = dict(environ) if environ is not None else {}
    tp = current_traceparent()
    if tp:
        env[TRACEPARENT_ENV] = tp
    return env


# -- env-driven bring-up ------------------------------------------------------

def _init_from_env() -> None:
    header = (os.environ.get(TRACEPARENT_ENV, "").strip()
              or os.environ.get(TRACKER_TRACEPARENT_ENV, "").strip())
    ctx = from_traceparent(header)
    if ctx is not None:
        set_process_root(ctx)


_init_from_env()
