"""Event-driven scoring transport: a selectors-based non-blocking front end.

Counterpart of ``dmlc_core_tpu/serve/eventloop.py`` (a copy).  The loop
threads never touch a device tensor: a batch's scores reach the host on
the batcher thread (:func:`~.model_runtime.to_host`, a pinned copy and
its event), and the future the loop reads holds numpy arrays only.

The threaded transport (:mod:`.server`) burns one handler thread per
connection; at 10k keep-alive clients that is 10k stacks pinned on
sockets that are idle 99% of the time.  This module replaces the
*transport* only — a small number of event-loop threads (default 1,
``DMLC_SERVE_EVLOOP_THREADS``) multiplex every connection through
:mod:`selectors`, while scoring still flows through the exact same
MicroBatcher/admission/registry stack.  The batcher already decouples
transport from predict (``submit`` returns a future), so the event loop
never blocks on a model: it parses a request incrementally, submits it,
and writes the response when the future's completion callback pokes the
loop awake through a pipe.

Contract parity with the threaded transport is byte-for-byte: the same
structured error envelope (400/404/408/413/503/504), the same keep-alive
close discipline (any response sent before the request body was read
closes the connection — an unread body would be parsed as the next
request line), the same W3C ``traceparent`` continuation into the
``serve.request`` span, the same ``/healthz`` / ``/metrics`` / ``/stats``
bodies, the same in-flight odometer that graceful drain waits on.

What the event loop adds over the threaded transport:

- **slowloris + stalled-body defense** — a per-request assembly deadline
  (``DMLC_SERVE_HEADER_S``, first byte to full body) answers a
  byte-at-a-time client with a structured 408 and closes, instead of
  pinning a thread for the socket timeout;
- **connection observability** — ``dmlc_serve_connections{state=...}``
  gauges, open/close lifecycle counters, and ``serve.accept`` /
  ``serve.read`` / ``serve.write`` spans (read/write parented to the
  request's ``serve.request`` span when the request is traced);
- **c10k** — one loop thread holds >=10,000 keep-alive connections
  (:func:`~.loadgen.run_churn` drives it); ``TCP_NODELAY`` is set on
  every accepted socket so small JSON responses never sit out a Nagle /
  delayed-ACK round trip (a flat +40ms tail on the threaded transport's
  default-config cousins).

Threading model (the races/deadlock passes lean on this shape):

- ``serve_forever`` spawns every loop thread from one
  ``Thread(target=self._run_loop)`` site and then just waits on a stop
  event;
- per-connection state (:class:`_Conn`) is constructed and mutated only
  on its owning loop thread — thread-confined, no locks;
- the shared connection table ``self._conns`` is the one cross-thread
  structure: every *write* (register on accept, pop on close, clear on
  ``server_close``) holds ``self._lock``; completion/inbox handoff
  deques take the same lock, and nothing under the lock calls into the
  batcher, admission, or telemetry.
"""

from __future__ import annotations

import functools
import json
import os
import selectors
import socket
import threading
import time
from collections import deque
from http.client import responses as _REASON
from itertools import count as _serial
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.serve import server as server_mod
from dmlc_core_tpu_torch.serve.errors import (BadRequest, ClientTimeout,
                                        RequestTimeout, ServeError)
from dmlc_core_tpu_torch.serve.server import (healthz_payload, parse_instances,
                                        route_slot)
from dmlc_core_tpu_torch.telemetry import clock, tracecontext
from dmlc_core_tpu_torch.utils.logging import log_debug, log_warning

__all__ = ["EventLoopServer"]

# request head (request line + headers) cap: same order as http.server's
# 64KiB line limit — a head that large is hostile, not a scoring client
_HEAD_CAP = 64 * 1024
_MAX_HEADERS = 128
# while a request is in flight we keep reading (to see EOF/RST early) but
# a client that pipelines megabytes ahead gets its READ interest dropped
# until the in-flight response drains — TCP backpressure, not RAM
_PIPELINE_CAP = 1 << 20
_RECV_CHUNK = 65536
# accepted sockets per accept-readiness wake: bounds time-per-loop-tick
# so a connect storm cannot starve in-flight connections
_ACCEPT_BURST = 512

_SERVER_LINE = b"Server: dmlc-serve/0.1\r\n"


def _fenv(raw: Optional[str], default: float) -> float:
    try:
        return float(raw) if raw not in (None, "") else default
    except ValueError:
        return default


_date_cache: Tuple[int, bytes] = (0, b"")


def _http_date(now: float) -> bytes:
    """``Date:`` header bytes, cached per wall-clock second (formatting a
    GMT date 10k times a second is measurable; reusing a 1s-stale string
    is not).  Benign if two loops race the cache: both write the same
    value for the same second."""
    global _date_cache
    sec = int(now)
    cached_sec, cached = _date_cache
    if sec != cached_sec:
        cached = time.strftime("Date: %a, %d %b %Y %H:%M:%S GMT\r\n",
                               time.gmtime(sec)).encode("latin-1")
        _date_cache = (sec, cached)
    return cached


def _head_bytes(status: int, length: int,
                headers: Optional[Dict[str, str]],
                content_type: str) -> bytes:
    # NB: no "Connection: close" is ever announced, even on paths that
    # close — the threaded transport (BaseHTTPRequestHandler) closes
    # silently too, and the keep-alive contract tests pin that exact
    # behavior (the client discovers the close on its next request)
    parts = [f"HTTP/1.1 {status} {_REASON.get(status, '')}\r\n"
             .encode("latin-1"),
             _SERVER_LINE, _http_date(time.time()),
             f"Content-Type: {content_type}\r\n".encode("latin-1"),
             f"Content-Length: {length}\r\n".encode("latin-1")]
    for k, v in (headers or {}).items():
        if k.lower() not in ("content-type", "content-length"):
            parts.append(f"{k}: {v}\r\n".encode("latin-1"))
    parts.append(b"\r\n")
    return b"".join(parts)


class _Conn:
    """One client connection: buffers + incremental parse state.

    Constructed and mutated only on its owning event-loop thread
    (thread-confined — no locks guard these attributes).  ``state``
    walks ``idle -> head -> body -> busy -> flush -> idle`` for a POST
    (GETs skip ``body``/``busy``), and any close path parks it at
    ``closed`` so stale selector events and late future callbacks
    become no-ops.
    """

    __slots__ = ("sock", "fd", "addr", "loop_idx", "rbuf", "wbuf",
                 "state", "opened_at", "last_active", "assembly_t0",
                 "close_after_write", "mask", "paused",
                 "method", "path", "headers", "http10",
                 "body_need", "num_rows", "odometer", "req_seq",
                 "t0", "span_t0", "model_label", "trace", "slot",
                 "deadline", "write_t0")

    def __init__(self, sock: socket.socket, addr: Any, now: float):
        self.sock = sock
        self.fd = sock.fileno()
        self.addr = addr
        self.loop_idx = 0
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.state = "idle"
        self.opened_at = now
        self.last_active = now
        self.assembly_t0 = now
        self.close_after_write = False
        self.mask = 0
        self.paused = False
        self.method = ""
        self.path = ""
        self.headers: Dict[str, str] = {}
        self.http10 = False
        self.body_need = 0
        self.num_rows = 0
        self.odometer = False
        self.req_seq = -1
        self.t0: Optional[float] = None
        self.span_t0: Optional[float] = None
        self.model_label = "_unrouted"
        self.trace: Optional[Tuple[str, str, Optional[str]]] = None
        self.slot = None
        self.deadline = 0.0
        self.write_t0: Optional[float] = None


class EventLoopServer:
    """Selectors-based non-blocking HTTP/1.1 server for ScoringServer.

    Exposes the slice of the ``socketserver`` surface ScoringServer
    drives — ``server_address``, ``serve_forever(poll_interval=...)``,
    ``shutdown()``, ``server_close()`` — so the rest of the serving
    stack (start/drain/close, the router, ReplicaFleet) cannot tell the
    transports apart.
    """

    def __init__(self, server_address: Tuple[str, int],
                 app: Optional["server_mod.ScoringServer"] = None, *,
                 threads: Optional[int] = None,
                 idle_timeout_s: Optional[float] = None,
                 header_timeout_s: Optional[float] = None,
                 backlog: int = 1024):
        self.app = app
        if threads is None:
            try:
                threads = int(os.environ.get("DMLC_SERVE_EVLOOP_THREADS",
                                             "1") or 1)
            except ValueError:
                threads = 1
        self.num_loops = max(1, int(threads))
        # keep-alive idle deadline between requests: mirrors the threaded
        # handler's 30s socket timeout (silent close — the client simply
        # went away)
        if idle_timeout_s is None:
            idle_timeout_s = _fenv(os.environ.get("DMLC_SERVE_IDLE_S"),
                                   30.0)
        self.idle_timeout_s = float(idle_timeout_s)
        # request-assembly deadline, first byte to full head+body: the
        # slowloris/stalled-body bound (structured 408, then close)
        if header_timeout_s is None:
            header_timeout_s = _fenv(os.environ.get("DMLC_SERVE_HEADER_S"),
                                     10.0)
        self.header_timeout_s = float(header_timeout_s)
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._wake_r: List[int] = []
        self._wake_w: List[int] = []
        try:
            self._listen.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEADDR, 1)
            self._listen.bind(server_address)
            # deeper than the threaded transport's 128: the c10k ramp
            # connects in bursts and a kernel RST is the one shed form a
            # client cannot tell from a crash (capped by somaxconn)
            self._listen.listen(backlog)
            self._listen.setblocking(False)
            self.server_address = self._listen.getsockname()
            self._lock = threading.Lock()
            # the one cross-thread table: fd -> _Conn.  Reads are
            # lock-free snapshots; every write holds self._lock (accept-
            # register, close-pop, server_close-clear) — the races pass
            # pins exactly this.
            self._conns: Dict[int, _Conn] = {}
            # per-loop handoff queues, same lock: completed futures and
            # cross-loop accepted connections land here, the wake pipe
            # makes the owning loop drain them
            self._done: List[Deque[Tuple[int, int, Any]]] = \
                [deque() for _ in range(self.num_loops)]
            self._inbox: List[Deque[_Conn]] = \
                [deque() for _ in range(self.num_loops)]
            for _ in range(self.num_loops):
                r, w = os.pipe()
                os.set_blocking(r, False)
                os.set_blocking(w, False)
                self._wake_r.append(r)
                self._wake_w.append(w)
            self._stop = threading.Event()
            self._stopped = threading.Event()
            self._stopped.set()  # not serving yet: shutdown() can't hang
            self._threads: List[threading.Thread] = []
            self._seq = _serial(1)
            self._accept_rr = 0
            self._poll = 0.1
            self._closed = False
        except Exception:
            # a failed constructor orphans the instance: release the
            # listen socket + any wake pipes here or nothing else can
            self._listen.close()
            for fd in self._wake_r + self._wake_w:
                try:
                    os.close(fd)
                except OSError:
                    pass
            raise

    def fileno(self) -> int:
        return self._listen.fileno()

    # -- lifecycle (the socketserver surface ScoringServer drives) ------------

    def serve_forever(self, poll_interval: float = 0.1) -> None:
        self._poll = min(max(float(poll_interval), 0.005), 0.1)
        self._stopped.clear()
        try:
            for i in range(self.num_loops):
                t = threading.Thread(target=self._run_loop, args=(i,),
                                     name=f"serve-evloop-{i}", daemon=True)
                self._threads.append(t)
                t.start()
            log_debug(1, f"serve: evloop transport up "
                         f"({self.num_loops} loop thread(s), "
                         f"idle={self.idle_timeout_s:g}s, "
                         f"assembly={self.header_timeout_s:g}s)")
            self._stop.wait()
            for t in self._threads:
                t.join(5.0)
        finally:
            self._stopped.set()

    def shutdown(self) -> None:
        self._stop.set()
        for w in self._wake_w:
            self._wake_fd(w)
        self._stopped.wait(10.0)

    def server_close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._listen.close()
        except OSError:
            pass
        # normally the loops already closed their connections on the way
        # out; this is the fallback for a loop that died abnormally
        with self._lock:
            leftovers = list(self._conns.values())
            self._conns.clear()
        for conn in leftovers:
            try:
                conn.sock.close()
            except OSError:
                pass
        for fd in self._wake_r + self._wake_w:
            try:
                os.close(fd)
            except OSError:
                pass

    # -- cross-thread pokes ----------------------------------------------------

    @staticmethod
    def _wake_fd(w: int) -> None:
        try:
            os.write(w, b"\x01")
        except (BlockingIOError, OSError):
            pass  # pipe full == a wake is already pending; closed == exiting

    def _wake(self, idx: int) -> None:
        self._wake_fd(self._wake_w[idx])

    def _future_done(self, loop_idx: int, fd: int, seq: int,
                     future: Any) -> None:
        # runs on the batcher thread (or inline on the loop thread when
        # the future is already done): hand off, wake, never touch conn
        # state from here
        with self._lock:
            self._done[loop_idx].append((fd, seq, future))
        self._wake(loop_idx)

    # -- the loop --------------------------------------------------------------

    def _run_loop(self, idx: int) -> None:
        sel = selectors.DefaultSelector()
        try:
            sel.register(self._wake_r[idx], selectors.EVENT_READ, "wake")
            if idx == 0:
                sel.register(self._listen, selectors.EVENT_READ, "accept")
            last_sweep = clock.monotonic()
            while not self._stop.is_set():
                try:
                    events = sel.select(self._poll)
                except OSError:
                    break
                now = clock.monotonic()
                for key, mask in events:
                    data = key.data
                    if data == "wake":
                        self._drain_wake(idx)
                    elif data == "accept":
                        self._accept(sel, idx, now)
                    else:
                        conn = data
                        if mask & selectors.EVENT_WRITE \
                                and conn.state != "closed":
                            self._writable(sel, conn)
                        if mask & selectors.EVENT_READ \
                                and conn.state != "closed":
                            self._readable(sel, conn, now)
                self._drain_inbox(sel, idx)
                self._drain_done(sel, idx)
                now = clock.monotonic()
                if now - last_sweep >= 0.25:
                    last_sweep = now
                    self._sweep(sel, idx, now)
        except Exception as exc:  # noqa: BLE001 — a dead loop must say so
            log_warning(f"serve: evloop thread {idx} died: {exc!r}")
        finally:
            with self._lock:
                mine = [c for c in self._conns.values()
                        if c.loop_idx == idx]
                for c in mine:
                    self._conns.pop(c.fd, None)
            for c in mine:
                if c.odometer and self.app is not None:
                    self.app._request_end()
                    c.odometer = False
                try:
                    c.sock.close()
                except OSError:
                    pass
            if mine:
                telemetry.count("dmlc_serve_connections_closed_total",
                                len(mine), reason="server_shutdown")
            sel.close()

    def _drain_wake(self, idx: int) -> None:
        try:
            while os.read(self._wake_r[idx], 4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _drain_inbox(self, sel: selectors.BaseSelector, idx: int) -> None:
        items: List[_Conn] = []
        with self._lock:
            dq = self._inbox[idx]
            while dq:
                items.append(dq.popleft())
        for conn in items:
            try:
                sel.register(conn.sock, selectors.EVENT_READ, conn)
                conn.mask = selectors.EVENT_READ
            except (OSError, KeyError, ValueError):
                self._close(sel, conn, "error")

    def _drain_done(self, sel: selectors.BaseSelector, idx: int) -> None:
        items: List[Tuple[int, int, Any]] = []
        with self._lock:
            dq = self._done[idx]
            while dq:
                items.append(dq.popleft())
        for fd, seq, future in items:
            conn = self._conns.get(fd)
            # the seq guard is what makes fd reuse and request timeouts
            # safe: a late completion for a request already answered (or
            # a connection already gone) is dropped on the floor
            if conn is None or conn.loop_idx != idx \
                    or conn.req_seq != seq or conn.state != "busy":
                continue
            self._complete(sel, conn, future)
            if conn.state == "idle" and conn.rbuf:
                self._advance(sel, conn, clock.monotonic())

    # -- accept ----------------------------------------------------------------

    def _accept(self, sel: selectors.BaseSelector, idx: int,
                now: float) -> None:
        for _ in range(_ACCEPT_BURST):
            t0 = clock.monotonic()
            try:
                s, addr = self._listen.accept()
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break
            try:
                s.setblocking(False)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                try:
                    s.close()
                except OSError:
                    pass
                continue
            conn = _Conn(s, addr, now)
            target = self._accept_rr % self.num_loops
            self._accept_rr += 1
            conn.loop_idx = target
            with self._lock:
                self._conns[conn.fd] = conn
                if target != idx:
                    self._inbox[target].append(conn)
            if target == idx:
                try:
                    sel.register(s, selectors.EVENT_READ, conn)
                    conn.mask = selectors.EVENT_READ
                except (OSError, KeyError, ValueError):
                    self._close(sel, conn, "error")
                    continue
            else:
                self._wake(target)
            telemetry.count("dmlc_serve_connections_opened_total")
            if telemetry.enabled():
                telemetry.record_span("serve.accept", t0, clock.monotonic())

    # -- read side -------------------------------------------------------------

    def _readable(self, sel: selectors.BaseSelector, conn: _Conn,
                  now: float) -> None:
        try:
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as exc:
            self._client_gone(sel, conn, type(exc).__name__)
            return
        if not data:
            self._client_gone(sel, conn, "ClientDisconnect")
            return
        conn.last_active = now
        if conn.state == "idle":
            conn.state = "head"
            conn.assembly_t0 = now
        conn.rbuf += data
        if conn.state in ("busy", "flush"):
            # response pending: hold the pipelined bytes, and drop READ
            # interest past the cap so the kernel pushes back instead of
            # this buffer growing unboundedly
            if len(conn.rbuf) > _PIPELINE_CAP:
                conn.paused = True
                self._set_events(sel, conn, read=False,
                                 write=bool(conn.wbuf))
            return
        self._advance(sel, conn, now)

    def _client_gone(self, sel: selectors.BaseSelector, conn: _Conn,
                     excname: str) -> None:
        """EOF or reset from the client.  Between requests that is just a
        close; mid-request there is no one left to answer — mirror the
        threaded transport's abort accounting (status-0 metrics + the
        aborts counter) and drop the connection."""
        if conn.state in ("idle", "flush") \
                or (conn.state == "head" and not conn.odometer):
            self._close(sel, conn, "client_close")
            return
        telemetry.count("dmlc_serve_connection_aborts_total")
        if conn.odometer:
            self._end_post(conn, 0, excname)
        self._close(sel, conn, "aborted")

    # -- the request state machine --------------------------------------------

    def _advance(self, sel: selectors.BaseSelector, conn: _Conn,
                 now: float) -> None:
        """Drive parse/dispatch until the connection needs more bytes, a
        response is in flight, or it closed.  Loops (never recurses) so a
        pipelined burst of N requests is N iterations, not N frames."""
        while True:
            if conn.state == "idle":
                if not conn.rbuf:
                    return
                conn.state = "head"
                conn.assembly_t0 = now
            if conn.state == "head":
                if not self._parse_head(sel, conn):
                    return
                self._dispatch(sel, conn, now)
            if conn.state == "body":
                if len(conn.rbuf) < conn.body_need:
                    return
                self._score_body(sel, conn, now)
            if conn.state != "idle":
                return

    def _parse_head(self, sel: selectors.BaseSelector,
                    conn: _Conn) -> bool:
        """Incremental head parse; True once ``method/path/headers`` are
        populated.  Malformed or oversized heads answer a structured 400
        and close (no metrics: nothing was routed — the threaded
        transport's stdlib parser is equally silent here)."""
        end = conn.rbuf.find(b"\r\n\r\n")
        if end < 0:
            if len(conn.rbuf) > _HEAD_CAP:
                self._head_error(sel, conn, BadRequest(
                    f"request head exceeds {_HEAD_CAP} bytes"))
            return False
        head = bytes(conn.rbuf[:end])
        del conn.rbuf[:end + 4]
        lines = head.split(b"\r\n")
        try:
            parts = lines[0].decode("latin-1").split()
        except UnicodeDecodeError:  # pragma: no cover — latin-1 total
            parts = []
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            self._head_error(sel, conn,
                             BadRequest("malformed request line"))
            return False
        method, target, version = parts
        headers: Dict[str, str] = {}
        for raw in lines[1:]:
            if not raw:
                continue
            if len(headers) >= _MAX_HEADERS:
                self._head_error(sel, conn,
                                 BadRequest("too many request headers"))
                return False
            name, sep, value = raw.partition(b":")
            if not sep:
                self._head_error(sel, conn,
                                 BadRequest("malformed request header"))
                return False
            headers[name.strip().lower().decode("latin-1")] = \
                value.strip().decode("latin-1")
        conn.method = method
        conn.path = target
        conn.headers = headers
        conn.http10 = version == "HTTP/1.0"
        token = headers.get("connection", "").lower()
        conn.close_after_write = ("close" in token
                                  or (conn.http10
                                      and "keep-alive" not in token))
        return conn.state == "head"

    def _head_error(self, sel: selectors.BaseSelector, conn: _Conn,
                    exc: ServeError) -> None:
        excname = self._queue_response(conn, exc.status, exc.body(),
                                       exc.headers(), close=True)
        if excname is not None:
            self._close(sel, conn, "aborted")
            return
        self._after_respond(sel, conn)

    def _dispatch(self, sel: selectors.BaseSelector, conn: _Conn,
                  now: float) -> None:
        if conn.method == "GET":
            self._dispatch_get(sel, conn)
        elif conn.method == "POST":
            self._begin_post(sel, conn, now)
        else:
            self._head_error(sel, conn, BadRequest(
                f"unsupported method {conn.method!r}"))

    # -- GET -------------------------------------------------------------------

    def _dispatch_get(self, sel: selectors.BaseSelector,
                      conn: _Conn) -> None:
        app = self.app
        # a GET announcing a body would desync keep-alive framing (we do
        # not read bodies on GET): answer, then drop the link
        if conn.headers.get("content-length", "0") not in ("", "0"):
            conn.close_after_write = True
        try:
            if conn.path == "/healthz":
                body = json.dumps(healthz_payload(app),
                                  sort_keys=True).encode()
                excname = self._queue_response(conn, 200, body)
            elif conn.path == "/metrics":
                excname = self._queue_response(
                    conn, 200, telemetry.prometheus_text().encode(),
                    content_type="text/plain; version=0.0.4")
            elif conn.path == "/stats":
                body = json.dumps(app.stats(), sort_keys=True).encode()
                excname = self._queue_response(conn, 200, body)
            else:
                exc = BadRequest(f"no such path {conn.path!r}")
                excname = self._queue_response(conn, exc.status,
                                               exc.body(), exc.headers())
        except ServeError as exc:
            # e.g. /healthz on a registry with no slots: the probe must
            # read a structured error, not a dropped connection
            excname = self._queue_response(conn, exc.status, exc.body(),
                                           exc.headers())
        if excname is not None:
            self._close(sel, conn, "aborted")
            return
        self._after_respond(sel, conn)

    # -- POST ------------------------------------------------------------------

    def _begin_post(self, sel: selectors.BaseSelector, conn: _Conn,
                    now: float) -> None:
        app = self.app
        # the in-flight odometer brackets the whole request so drain only
        # exits once every admitted request has been answered
        app._request_begin()
        conn.odometer = True
        conn.t0 = clock.monotonic()
        conn.span_t0 = None
        conn.trace = None
        conn.model_label = "_unrouted"
        try:
            slot = route_slot(app, conn.path)
        except ServeError as exc:
            # body never read: an early response on a keep-alive
            # connection must close it (threaded parity, incl. the
            # metrics-without-span accounting)
            self._respond_error_post(sel, conn, exc, close=True)
            return
        conn.slot = slot
        conn.model_label = slot.name
        # trace continuation: an announced traceparent wins, else the
        # process-root context (env propagation), else untraced — the
        # same resolution the threaded handler's activate()+span() does
        incoming = tracecontext.from_traceparent(
            conn.headers.get("traceparent"))
        base = incoming if incoming is not None else tracecontext.current()
        conn.span_t0 = clock.monotonic()
        if telemetry.enabled() and base is not None:
            conn.trace = (base.trace_id, tracecontext.new_span_id(),
                          base.span_id)
        injected = fault.http_response("serve.request")
        if injected is not None:
            i_status, i_headers, i_body = injected
            if i_status == 503:
                telemetry.count("dmlc_serve_shed_total",
                                model=conn.model_label,
                                reason="injected_503")
            self._finish_post(sel, conn, i_status,
                              i_body or b'{"error": {"code": "injected"}}',
                              i_headers, errname=None, close=True)
            return
        try:
            # act kinds: delay/stall = a slow server; reset = the
            # connection dying mid-request.  NB: a sleeping act blocks
            # this loop thread — chaos drills only, never production.
            fault.inject("serve.request")
        except (BrokenPipeError, ConnectionResetError) as exc:
            telemetry.count("dmlc_serve_connection_aborts_total")
            self._end_post(conn, 0, type(exc).__name__)
            self._close(sel, conn, "aborted")
            return
        except ServeError as exc:
            self._respond_error_post(sel, conn, exc)
            return
        except Exception as exc:  # noqa: BLE001 — the 500 of last resort
            self._internal_error(sel, conn, exc)
            return
        try:
            length = int(conn.headers.get("content-length", ""))
        except ValueError:
            self._respond_error_post(sel, conn,
                                     BadRequest("Content-Length required"),
                                     close=True)
            return
        if length < 0:
            self._respond_error_post(
                sel, conn, BadRequest(f"invalid Content-Length {length}"),
                close=True)
            return
        max_body = server_mod.MAX_BODY_BYTES
        if length > max_body:
            exc = BadRequest(f"body of {length} bytes exceeds {max_body}")
            exc.status = 413
            exc.code = "payload_too_large"
            self._respond_error_post(sel, conn, exc, close=True)
            return
        conn.body_need = length
        conn.state = "body"

    def _score_body(self, sel: selectors.BaseSelector, conn: _Conn,
                    now: float) -> None:
        raw = bytes(conn.rbuf[:conn.body_need])
        del conn.rbuf[:conn.body_need]
        if telemetry.enabled():
            telemetry.record_span("serve.read", conn.assembly_t0,
                                  clock.monotonic(),
                                  trace=self._child_trace(conn),
                                  bytes=len(raw))
        try:
            obj = json.loads(raw)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            self._respond_error_post(
                sel, conn, BadRequest(f"body is not valid JSON: {e}"))
            return
        try:
            rows = parse_instances(obj, conn.slot.num_feature)
        except ServeError as exc:
            self._respond_error_post(sel, conn, exc)
            return
        conn.num_rows = int(rows.shape[0])
        try:
            if conn.trace is not None:
                # activate the serve.request span's identity around
                # submit so the batcher's queue-wait/predict attribution
                # spans parent to it (threaded parity: submit runs inside
                # the span's dynamic extent)
                ident = tracecontext.TraceContext(conn.trace[0],
                                                  conn.trace[1])
                with tracecontext.activate(ident):
                    future = conn.slot.batcher.submit(rows)
            else:
                future = conn.slot.batcher.submit(rows)
        except ServeError as exc:
            self._respond_error_post(sel, conn, exc)
            return
        except Exception as exc:  # noqa: BLE001
            self._internal_error(sel, conn, exc)
            return
        conn.req_seq = next(self._seq)
        conn.deadline = now + self.app.request_timeout_s
        conn.state = "busy"
        future.add_done_callback(
            functools.partial(self._future_done, conn.loop_idx, conn.fd,
                              conn.req_seq))

    def _complete(self, sel: selectors.BaseSelector, conn: _Conn,
                  future: Any) -> None:
        """The batcher future landed: build the success payload (or map
        the failure) exactly as the threaded ``_score`` tail does."""
        conn.req_seq = -1
        try:
            preds = np.asarray(future.result())
            if not np.isfinite(preds).all():
                # finite inputs produced a non-finite score (model
                # overflow): a structured 500 beats a 200 body of
                # RFC-invalid Infinity
                raise ServeError("model produced a non-finite prediction")
            version = getattr(future, "dmlc_served_version", None)
            payload = {"predictions": preds.tolist(),
                       "model": conn.slot.name,
                       "version": version if version is not None
                       else conn.slot.version,
                       "num_rows": conn.num_rows}
            body = json.dumps(payload, sort_keys=True).encode()
            self._finish_post(sel, conn, 200, body, None, errname=None)
        except ServeError as exc:
            self._respond_error_post(sel, conn, exc)
        except Exception as exc:  # noqa: BLE001 — the 500 of last resort
            self._internal_error(sel, conn, exc)

    def _timeout_request(self, sel: selectors.BaseSelector,
                         conn: _Conn) -> None:
        """The request-deadline sweep's 504: admitted but not answered in
        time.  The future is left to finish into the void (the seq guard
        drops its completion), exactly like the threaded transport's
        ``future.result(timeout=...)`` abandoning the slot."""
        conn.req_seq = -1
        timeout_s = self.app.request_timeout_s
        telemetry.count("dmlc_serve_shed_total", model=conn.model_label,
                        reason="timeout")
        self._respond_error_post(sel, conn, RequestTimeout(
            f"not answered within {timeout_s}s (queue + predict)",
            details={"timeout_s": timeout_s}))

    # -- response plumbing -----------------------------------------------------

    def _respond_error_post(self, sel: selectors.BaseSelector, conn: _Conn,
                            exc: ServeError, close: bool = False) -> None:
        self._finish_post(sel, conn, exc.status, exc.body(), exc.headers(),
                          errname=type(exc).__name__, close=close)

    def _internal_error(self, sel: selectors.BaseSelector, conn: _Conn,
                        exc: Exception) -> None:
        log_warning(f"serve: unexpected error handling request: {exc!r}")
        wrapped = ServeError(f"internal error: {exc}")
        # the body may be partially read or unread: keeping the
        # keep-alive connection would desync its framing
        self._finish_post(sel, conn, wrapped.status, wrapped.body(),
                          wrapped.headers(), errname=type(exc).__name__,
                          close=True)

    def _finish_post(self, sel: selectors.BaseSelector, conn: _Conn,
                     status: int, body: bytes,
                     headers: Optional[Dict[str, str]],
                     errname: Optional[str], close: bool = False) -> None:
        excname = self._queue_response(conn, status, body, headers,
                                       close=close)
        if excname is not None:
            # client tore the socket down before the answer landed
            telemetry.count("dmlc_serve_connection_aborts_total")
            self._end_post(conn, 0, excname)
            self._close(sel, conn, "aborted")
            return
        self._end_post(conn, status, errname)
        self._after_respond(sel, conn)

    def _end_post(self, conn: _Conn, status: int,
                  errname: Optional[str]) -> None:
        """The threaded handler's ``finally`` block: serve.request span +
        request metrics, exactly once per POST."""
        if conn.t0 is None:
            return
        t1 = clock.monotonic()
        if conn.span_t0 is not None:
            attrs: Dict[str, Any] = {"model": conn.model_label}
            if errname:
                attrs["error"] = errname
            telemetry.record_span("serve.request", conn.span_t0, t1,
                                  trace=conn.trace, **attrs)
            conn.span_t0 = None
        telemetry.count("dmlc_serve_requests_total",
                        model=conn.model_label, status=status)
        telemetry.observe("dmlc_serve_request_seconds", t1 - conn.t0,
                          model=conn.model_label, status=status)
        conn.t0 = None

    def _queue_response(self, conn: _Conn, status: int, body: bytes,
                        headers: Optional[Dict[str, str]] = None,
                        content_type: str = "application/json",
                        close: bool = False) -> Optional[str]:
        """Queue head+body and flush opportunistically; returns the
        exception name if the socket is already dead, else None."""
        if close:
            conn.close_after_write = True
        conn.wbuf += _head_bytes(status, len(body), headers, content_type)
        conn.wbuf += body
        if conn.write_t0 is None:
            conn.write_t0 = clock.monotonic()
        return self._try_flush(conn)

    @staticmethod
    def _try_flush(conn: _Conn) -> Optional[str]:
        try:
            while conn.wbuf:
                n = conn.sock.send(conn.wbuf)
                del conn.wbuf[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as exc:
            return type(exc).__name__
        return None

    def _after_respond(self, sel: selectors.BaseSelector,
                       conn: _Conn) -> None:
        if conn.wbuf:
            conn.state = "flush"
            self._set_events(sel, conn, read=not conn.paused, write=True)
            return
        self._cycle_done(sel, conn)

    def _writable(self, sel: selectors.BaseSelector, conn: _Conn) -> None:
        excname = self._try_flush(conn)
        if excname is not None:
            telemetry.count("dmlc_serve_connection_aborts_total")
            self._close(sel, conn, "aborted")
            return
        if conn.wbuf:
            return
        if conn.state == "flush":
            self._cycle_done(sel, conn)
            if conn.state == "idle" and conn.rbuf:
                self._advance(sel, conn, clock.monotonic())
        else:
            self._set_events(sel, conn, read=not conn.paused, write=False)

    def _cycle_done(self, sel: selectors.BaseSelector,
                    conn: _Conn) -> None:
        """Response fully flushed: emit serve.write, settle the odometer,
        then close or re-arm for the next (possibly pipelined) request."""
        now = clock.monotonic()
        if conn.write_t0 is not None:
            if telemetry.enabled():
                telemetry.record_span("serve.write", conn.write_t0, now,
                                      trace=self._child_trace(conn))
            conn.write_t0 = None
        if conn.odometer:
            self.app._request_end()
            conn.odometer = False
        if conn.close_after_write:
            self._close(sel, conn, "request_close")
            return
        conn.state = "idle"
        conn.trace = None
        conn.slot = None
        conn.req_seq = -1
        conn.last_active = now
        conn.paused = False
        self._set_events(sel, conn, read=True, write=False)

    def _child_trace(self, conn: _Conn) \
            -> Optional[Tuple[str, str, Optional[str]]]:
        if conn.trace is None:
            return None
        return (conn.trace[0], tracecontext.new_span_id(), conn.trace[1])

    # -- deadlines + gauges ----------------------------------------------------

    def _sweep(self, sel: selectors.BaseSelector, idx: int,
               now: float) -> None:
        snapshot = list(self._conns.values())
        if idx == 0 and telemetry.enabled():
            idle = sum(1 for c in snapshot if c.state == "idle")
            total = len(snapshot)
            telemetry.gauge_set("dmlc_serve_connections", total,
                                state="open")
            telemetry.gauge_set("dmlc_serve_connections", idle,
                                state="idle")
            telemetry.gauge_set("dmlc_serve_connections", total - idle,
                                state="active")
        for conn in snapshot:
            if conn.loop_idx != idx or conn.state == "closed":
                continue
            if conn.state == "idle":
                if now - conn.last_active >= self.idle_timeout_s:
                    # between requests: a silent close, same as the
                    # threaded handler's socket timeout
                    self._close(sel, conn, "idle_timeout")
            elif conn.state in ("head", "body"):
                if now - conn.assembly_t0 >= self.header_timeout_s:
                    self._slow_client(sel, conn)
            elif conn.state == "busy":
                if now >= conn.deadline:
                    self._timeout_request(sel, conn)
                    # the 504 keeps the connection alive: a pipelined
                    # request may already be buffered
                    if conn.state == "idle" and conn.rbuf:
                        self._advance(sel, conn, now)
            elif conn.state == "flush":
                if conn.write_t0 is not None \
                        and now - conn.write_t0 >= self.idle_timeout_s:
                    # client stopped reading its response
                    self._close(sel, conn, "write_stall")

    def _slow_client(self, sel: selectors.BaseSelector,
                     conn: _Conn) -> None:
        exc = ClientTimeout(
            f"request not received within {self.header_timeout_s:g}s",
            details={"timeout_s": self.header_timeout_s})
        if conn.odometer:
            # POST head already parsed (stalled mid-body): full abort
            # accounting, then the structured 408
            self._respond_error_post(sel, conn, exc, close=True)
        else:
            self._head_error(sel, conn, exc)

    # -- close -----------------------------------------------------------------

    def _close(self, sel: selectors.BaseSelector, conn: _Conn,
               reason: str) -> None:
        if conn.state == "closed":
            return
        conn.state = "closed"
        try:
            sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        with self._lock:
            self._conns.pop(conn.fd, None)
        if conn.odometer:
            self.app._request_end()
            conn.odometer = False
        try:
            conn.sock.close()
        except OSError:
            pass
        telemetry.count("dmlc_serve_connections_closed_total",
                        reason=reason)

    # -- selector interest -----------------------------------------------------

    @staticmethod
    def _set_events(sel: selectors.BaseSelector, conn: _Conn,
                    read: bool, write: bool) -> None:
        mask = (selectors.EVENT_READ if read else 0) \
            | (selectors.EVENT_WRITE if write else 0)
        if mask == conn.mask:
            return
        try:
            if mask:
                sel.modify(conn.sock, mask, conn)
            else:
                sel.unregister(conn.sock)
            conn.mask = mask
        except (KeyError, ValueError, OSError):
            pass
