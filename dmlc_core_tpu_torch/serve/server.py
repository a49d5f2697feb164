"""The scoring transport: stdlib HTTP in front of the model registry.

Counterpart of ``dmlc_core_tpu/serve/server.py``, on the threaded
transport only: the same routes, JSON bodies and error envelopes.  The
selectors event-loop transport (``transport="evloop"``) is not ported yet
(ROADMAP.md §1 item 4) and raises ``NotImplementedError``.

Endpoints (all JSON):

- ``POST /v1/score`` / ``POST /v1/score/<model>`` — ``{"instances":
  [row, ...]}`` where a row is either a dense ``[f0, f1, ...]`` list of
  ``num_feature`` numbers or a sparse ``{"index": [...], "value": [...]}``
  pair (feature ids in ``[0, num_feature)``); the bare path routes to the
  registry's default slot, the suffixed form to the named slot (unknown
  names are a structured 404).  Answers ``{"predictions": [...],
  "model": <slot>, "version": <checkpoint step>, "num_rows": n}`` or a
  structured error envelope (:mod:`.errors`) — the version field is how a
  client pins which model build answered;
- ``GET /healthz`` — liveness + per-slot model identity/version;
- ``GET /metrics`` — the telemetry registry in Prometheus text form;
- ``GET /stats`` — the serving SLO snapshot: per-histogram count/mean and
  p50/p95/p99 derived via :func:`dmlc_core_tpu_torch.telemetry.report.
  estimate_quantiles` (the same math the offline report uses), plus each
  slot's identity block.

Every request runs inside a ``serve.request`` telemetry span and lands in
``dmlc_serve_request_seconds{status=...}``; the ``serve.request`` fault
site fires before parsing (``http_status`` rules *replace* the response —
the chaos 503 storm — act rules model slow/broken connections).

The server is ``ThreadingHTTPServer``: one handler thread per connection,
all funneling into the single batcher thread — concurrency without a
thread-per-request predict path.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.serve.errors import (BadRequest, RequestTimeout,
                                              ServeError)
from dmlc_core_tpu_torch.serve.model_runtime import ModelRuntime
from dmlc_core_tpu_torch.serve.registry import ModelRegistry, ModelSlot
from dmlc_core_tpu_torch.telemetry import clock, tracecontext
from dmlc_core_tpu_torch.telemetry.report import (REPORT_QUANTILES,
                                                  _label_str,
                                                  estimate_quantiles)
from dmlc_core_tpu_torch.utils.logging import log_debug, log_info, log_warning

__all__ = ["ScoringServer", "parse_instances", "healthz_payload",
           "route_slot"]

MAX_BODY_BYTES = 8 << 20  # one request, not a bulk upload

# the two transports behind DMLC_SERVE_TRANSPORT: "threaded" is the
# ThreadingHTTPServer (one handler thread per connection); "evloop", the
# reference's selectors-based front end, is named so that asking for it
# says it is not ported rather than that it does not exist
TRANSPORTS = ("threaded", "evloop")


def parse_instances(obj: Any, num_feature: int) -> np.ndarray:
    """Validate + densify a ``{"instances": [...]}`` body to [n, F] f32.

    Every malformed shape raises :class:`BadRequest` naming the offending
    row — a scoring client debugging a 400 should never need server logs.
    """
    if not isinstance(obj, dict):
        raise BadRequest("body must be a JSON object")
    instances = obj.get("instances")
    if not isinstance(instances, list) or not instances:
        raise BadRequest("'instances' must be a non-empty list")
    out = np.zeros((len(instances), num_feature), np.float32)
    for i, row in enumerate(instances):
        if isinstance(row, list):
            if len(row) != num_feature:
                raise BadRequest(
                    f"instances[{i}]: expected {num_feature} features, "
                    f"got {len(row)}")
            try:
                out[i] = np.asarray(row, dtype=np.float32)
            except (TypeError, ValueError):
                raise BadRequest(
                    f"instances[{i}]: non-numeric feature value") from None
            if not np.isfinite(out[i]).all():
                # json.loads admits 1e400/NaN; letting them through would
                # end in a 200 whose body strict JSON parsers reject
                raise BadRequest(
                    f"instances[{i}]: non-finite feature value")
        elif isinstance(row, dict):
            idx, val = row.get("index"), row.get("value")
            if not isinstance(idx, list) or not isinstance(val, list) \
                    or len(idx) != len(val):
                raise BadRequest(
                    f"instances[{i}]: sparse rows need equal-length "
                    "'index' and 'value' lists")
            try:
                ids = np.asarray(idx, dtype=np.int64)
                vals = np.asarray(val, dtype=np.float32)
                # np.asarray silently truncates 1.7 -> 1: a float feature
                # id is a client bug that must 400, not mis-route a value
                if not np.array_equal(np.asarray(idx, dtype=np.float64),
                                      ids):
                    raise BadRequest(
                        f"instances[{i}]: non-integer feature index")
            except (TypeError, ValueError):
                raise BadRequest(
                    f"instances[{i}]: non-numeric index/value") from None
            if vals.size and not np.isfinite(vals).all():
                raise BadRequest(
                    f"instances[{i}]: non-finite feature value")
            if ids.size and (ids.min() < 0 or ids.max() >= num_feature):
                raise BadRequest(
                    f"instances[{i}]: feature index out of "
                    f"[0, {num_feature})")
            out[i, ids] = vals
        else:
            raise BadRequest(
                f"instances[{i}]: each row must be a list of "
                f"{num_feature} numbers or a sparse index/value object")
    return out


def healthz_payload(app: "ScoringServer") -> Dict[str, Any]:
    """The enriched ``/healthz`` body both transports serve: "status"
    keeps the plain ok/draining probe semantics existing checks rely on,
    "admission" adds the per-model load state the router routes on
    (queue-bytes, budget, shed EWMA)."""
    default = app.registry.get()
    return {
        "status": "draining" if app.draining else "ok",
        "model": default.family,
        "version": default.version,
        "num_feature": default.num_feature,
        "max_batch": default.batcher.max_batch,
        "models": app.registry.describe(),
        "admission": {
            name: app.registry.get(name).admission.describe()
            for name in app.registry.names()},
        "in_flight": app.in_flight,
        "uptime_s": round(clock.monotonic() - app.started_at, 3)}


def route_slot(app: "ScoringServer", path: str) -> ModelSlot:
    """``/v1/score`` -> default slot; ``/v1/score/<model>`` -> named
    slot (structured 404 for unknown names, 400 for other paths)."""
    if path == "/v1/score":
        return app.registry.get()
    if path.startswith("/v1/score/"):
        return app.registry.get(path[len("/v1/score/"):])
    raise BadRequest(f"no such path {path!r}")


class _Handler(BaseHTTPRequestHandler):
    server_version = "dmlc-serve/0.1"
    protocol_version = "HTTP/1.1"
    # per-socket deadline: a client announcing more body bytes than it
    # sends (or idling mid-request) must not pin a handler thread forever
    # — the same discipline as DMLC_TRACKER_SOCK_TIMEOUT on the tracker
    timeout = 30.0
    # TCP_NODELAY: a response goes out as two writes (headers, body), and
    # with Nagle on, the body waits for the client's delayed ACK of the
    # headers — about 40 ms added to every answer on a keep-alive
    # connection (the reference's threaded transport pays it)
    disable_nagle_algorithm = True

    # the app (ScoringServer) rides on the HTTPServer instance
    @property
    def app(self) -> "ScoringServer":
        return self.server.app  # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args: Any) -> None:
        # BaseHTTPRequestHandler prints to stderr; route through the
        # repo's logging (and keep per-request lines at debug verbosity)
        log_debug(2, f"serve: {self.address_string()} {fmt % args}")

    # -- plumbing -------------------------------------------------------------

    def _respond(self, status: int, body: bytes,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            if k.lower() not in ("content-type", "content-length"):
                self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _respond_json(self, status: int, payload: Dict[str, Any],
                      headers: Optional[Dict[str, str]] = None) -> None:
        self._respond(status, json.dumps(payload, sort_keys=True).encode(),
                      headers)

    def _respond_error(self, exc: ServeError) -> None:
        self._respond(exc.status, exc.body(), exc.headers())

    # -- routes ---------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        app = self.app
        try:
            if self.path == "/healthz":
                self._respond_json(200, healthz_payload(app))
            elif self.path == "/metrics":
                self._respond(200, telemetry.prometheus_text().encode(),
                              content_type="text/plain; version=0.0.4")
            elif self.path == "/stats":
                self._respond_json(200, app.stats())
            else:
                self._respond_error(BadRequest(f"no such path "
                                               f"{self.path!r}"))
        except ServeError as exc:
            # e.g. /healthz or /stats on a registry with no slots: the
            # probe must read a structured error, not a dropped connection
            self._respond_error(exc)

    def do_POST(self) -> None:  # noqa: N802 (http.server contract)
        # the in-flight odometer brackets the WHOLE request so a drain
        # (SIGTERM rolling restart) only exits once every admitted
        # request has been answered — including its error envelope
        app = self.app
        app._request_begin()
        try:
            self._handle_post(app)
        finally:
            app._request_end()

    def _handle_post(self, app: "ScoringServer") -> None:
        t0 = clock.monotonic()
        status = 500
        # route first: the per-model label every request-path metric
        # carries must name the slot, and an unroutable request must not
        # invent unbounded label values out of hostile paths
        model_label = "_unrouted"
        try:
            slot = self._route(app)
            model_label = slot.name
        except ServeError as exc:
            # the body was never read: keeping this keep-alive connection
            # would parse it as the next request line (same discipline as
            # every other early-response path)
            self.close_connection = True
            self._respond_error(exc)
            telemetry.count("dmlc_serve_requests_total", model=model_label,
                            status=exc.status)
            telemetry.observe("dmlc_serve_request_seconds",
                              clock.monotonic() - t0, model=model_label,
                              status=exc.status)
            return
        # continue the caller's W3C trace when one is announced: the
        # serve.request span (and everything the handler does under it —
        # batcher wait, predict share) joins the client's trace_id, which
        # is what lets the offline assembler resolve a scored request to
        # exactly one cross-process trace.  A malformed header decodes to
        # None and the request simply runs untraced (W3C: ignore, never 500)
        ctx = tracecontext.from_traceparent(self.headers.get("traceparent"))
        try:
            with tracecontext.activate(ctx), \
                    telemetry.span("serve.request", model=model_label):
                injected = fault.http_response("serve.request")
                if injected is not None:
                    i_status, i_headers, i_body = injected
                    status = i_status
                    if status == 503:
                        telemetry.count("dmlc_serve_shed_total",
                                        model=model_label,
                                        reason="injected_503")
                    # the request body was never read: keeping this
                    # keep-alive connection would parse it as the next
                    # request line
                    self.close_connection = True
                    self._respond(status, i_body or b'{"error": '
                                  b'{"code": "injected"}}', i_headers)
                    return
                # act kinds: delay/stall = a slow server thread; reset =
                # the connection dying mid-request (the one outcome a
                # client counts as crashed)
                fault.inject("serve.request")
                status, payload, headers = self._score(app, slot)
                self._respond_json(status, payload, headers)
        except ServeError as exc:
            status = exc.status
            self._respond_error(exc)
        except (BrokenPipeError, ConnectionResetError):
            # client (or an injected reset) tore the socket down: there is
            # no one left to answer — close, count, survive
            status = 0
            telemetry.count("dmlc_serve_connection_aborts_total")
            self.close_connection = True
        except Exception as exc:  # noqa: BLE001 — the 500 of last resort
            status = 500
            log_warning(f"serve: unexpected error handling request: {exc!r}")
            # the body may be partially read or unread here: keeping the
            # keep-alive connection would desync its framing (same reason
            # every early-response path above closes)
            self.close_connection = True
            try:
                self._respond_error(ServeError(f"internal error: {exc}"))
            except OSError:
                pass
        finally:
            telemetry.count("dmlc_serve_requests_total", model=model_label,
                            status=status)
            telemetry.observe("dmlc_serve_request_seconds",
                              clock.monotonic() - t0, model=model_label,
                              status=status)

    def _route(self, app: "ScoringServer") -> ModelSlot:
        return route_slot(app, self.path)

    def _score(self, app: "ScoringServer", slot: ModelSlot) \
            -> Tuple[int, Dict[str, Any], Optional[Dict[str, str]]]:
        try:
            length = int(self.headers.get("Content-Length", ""))
        except ValueError:
            self.close_connection = True  # unread body would desync keep-alive
            raise BadRequest("Content-Length required") from None
        if length < 0:
            # rfile.read(-1) would block until client EOF — a hostile
            # header must not pin a handler thread
            self.close_connection = True
            raise BadRequest(f"invalid Content-Length {length}")
        if length > MAX_BODY_BYTES:
            # responding without draining would desync this keep-alive
            # connection; the body is too big to drain, so drop the link
            self.close_connection = True
            exc = BadRequest(
                f"body of {length} bytes exceeds {MAX_BODY_BYTES}")
            exc.status = 413
            exc.code = "payload_too_large"
            raise exc
        raw = self.rfile.read(length)
        try:
            obj = json.loads(raw)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise BadRequest(f"body is not valid JSON: {e}") from None
        rows = parse_instances(obj, slot.num_feature)
        future = slot.batcher.submit(rows)
        try:
            preds = future.result(timeout=app.request_timeout_s)
        except FutureTimeout:
            telemetry.count("dmlc_serve_shed_total", model=slot.name,
                            reason="timeout")
            raise RequestTimeout(
                f"not answered within {app.request_timeout_s}s "
                "(queue + predict)", details={
                    "timeout_s": app.request_timeout_s}) from None
        preds = np.asarray(preds)
        if not np.isfinite(preds).all():
            # finite inputs produced a non-finite score (model overflow):
            # a structured 500 beats a 200 body of RFC-invalid Infinity
            raise ServeError("model produced a non-finite prediction")
        # the version of the runtime that actually computed these
        # predictions (the batcher annotates it from its per-batch
        # runtime snapshot) — NOT the slot's current version, which a
        # swap landing mid-request could have moved past the scoring one.
        # The hot-swap drill asserts predictions match this exact version.
        version = getattr(future, "dmlc_served_version", None)
        return 200, {"predictions": preds.tolist(),
                     "model": slot.name,
                     "version": version if version is not None
                     else slot.version,
                     "num_rows": int(rows.shape[0])}, None


class _Server(ThreadingHTTPServer):
    daemon_threads = True       # handler threads must not block shutdown
    allow_reuse_address = True
    # socketserver's default listen backlog is 5: an open-loop burst (every
    # client is a fresh connection) overflows it and the kernel RSTs the
    # excess — which a client can only read as a crash.  Deep backlog +
    # admission control is the correct order: shed with a structured 503,
    # never with a refused connection.
    request_queue_size = 128

    def handle_error(self, request, client_address) -> None:
        # default prints a traceback to stderr per dropped connection —
        # under an injected reset storm that is pure noise
        log_debug(1, f"serve: connection error from {client_address}")


class ScoringServer:
    """The assembled service: model registry + transport.

    Construct with either a single :class:`~.model_runtime.ModelRuntime`
    (wrapped into a one-slot registry named after the runtime family —
    the pre-lifecycle API, unchanged for existing callers) or a
    pre-populated :class:`~.registry.ModelRegistry` whose slots carry
    their own batch/budget knobs (the knob arguments here then apply to
    nothing and must be left at their defaults).
    """

    def __init__(self, model: "ModelRuntime | ModelRegistry", *,
                 host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 64,
                 max_delay_ms: float = 2.0,
                 max_queue_bytes: Optional[int] = None,
                 request_timeout_s: float = 10.0, warmup: bool = True,
                 transport: Optional[str] = None):
        if isinstance(model, ModelRegistry):
            # slots already carry their own knobs: a knob passed HERE
            # would be silently dropped — make the misuse loud instead
            if (max_batch, max_delay_ms, max_queue_bytes) != (64, 2.0,
                                                              None):
                raise ValueError(
                    "max_batch/max_delay_ms/max_queue_bytes are per-slot "
                    "knobs: set them on registry.add(...), not on "
                    "ScoringServer when passing a ModelRegistry")
            self.registry = model
        else:
            self.registry = ModelRegistry()
            self.registry.add(model.name, model, max_batch=max_batch,
                              max_delay_ms=max_delay_ms,
                              max_queue_bytes=max_queue_bytes,
                              default=True)
        self.request_timeout_s = float(request_timeout_s)
        self._warmup = warmup
        # transport selection: the argument wins, then DMLC_SERVE_TRANSPORT,
        # then the threaded default — the env form is what lets the parity
        # test rig (and a fleet of replica subprocesses) flip every server
        # in a process tree without touching call sites
        if transport is None:
            transport = os.environ.get("DMLC_SERVE_TRANSPORT", "threaded")
        transport = (transport or "threaded").strip().lower()
        if transport not in TRANSPORTS:
            raise ValueError(
                f"unknown serve transport {transport!r}: expected one of "
                f"{TRANSPORTS} (DMLC_SERVE_TRANSPORT)")
        self.transport = transport
        if transport == "evloop":
            raise NotImplementedError(
                "transport='evloop' needs the port of serve/eventloop.py "
                "(ROADMAP.md §1 item 4a); use transport='threaded'")
        self._httpd = _Server((host, port), _Handler)
        self._httpd.app = self  # type: ignore[attr-defined]
        self._serve_thread: Optional[threading.Thread] = None
        # drain/lifecycle state: handler threads bump the in-flight
        # odometer, the drain path and /healthz read it
        self._state_lock = threading.Lock()
        self._in_flight = 0
        self._draining = False
        self._closed = False
        self.started_at = clock.monotonic()

    # -- drain bookkeeping (handler threads + the SIGTERM path) ---------------

    def _request_begin(self) -> None:
        with self._state_lock:
            self._in_flight += 1

    def _request_end(self) -> None:
        with self._state_lock:
            self._in_flight -= 1

    @property
    def in_flight(self) -> int:
        with self._state_lock:
            return self._in_flight

    @property
    def draining(self) -> bool:
        with self._state_lock:
            return self._draining

    # -- single-model compatibility views (the default slot's pieces) ---------

    @property
    def runtime(self) -> ModelRuntime:
        return self.registry.get().runtime

    @property
    def batcher(self):
        return self.registry.get().batcher

    @property
    def admission(self):
        return self.registry.get().admission

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ScoringServer":
        self.registry.start(warmup=self._warmup)
        self.started_at = clock.monotonic()
        self._serve_thread = threading.Thread(
            target=self._serve, name="serve-http", daemon=False)
        self._serve_thread.start()
        names = self.registry.names()
        if names:
            default = self.registry.get()
            log_info(f"serve: listening on {self.url} "
                     f"(transport={self.transport}, models={names}, "
                     f"default={default.name}:{default.family}, "
                     f"max_batch={default.batcher.max_batch}, "
                     f"max_delay_ms={default.batcher.max_delay_s * 1e3:g}, "
                     f"max_queue_bytes={default.admission.max_queue_bytes})")
        else:
            # an empty registry can still serve /metrics and structured
            # 404s — a deploy that adds slots before routing traffic
            log_info(f"serve: listening on {self.url} (no models "
                     "registered yet)")
        return self

    def _serve(self) -> None:
        try:
            self._httpd.serve_forever(poll_interval=0.1)
        except Exception as exc:  # noqa: BLE001 — ferried, not swallowed
            log_warning(f"serve: listener exited abnormally: {exc!r}")

    def drain(self, timeout_s: Optional[float] = None,
              settle_s: float = 0.5) -> None:
        """Zero-downtime shutdown: stop being a routing target, finish
        every in-flight request, then close.

        Flips ``/healthz`` to ``"draining"`` immediately (the router's
        prober stops routing here within one probe interval), keeps
        serving for at least ``settle_s`` (covering that notice window —
        requests already routed our way must land, not crash), waits for
        the in-flight odometer to hit zero, then closes.  Bounded by
        ``timeout_s`` (default ``DMLC_SERVE_DRAIN_S``, 10s): a wedged
        request must not turn a rolling restart into a hung deploy.
        """
        with self._state_lock:
            already = self._draining
            self._draining = True
        if not already:
            log_info(f"serve: draining {self.url} "
                     f"(in_flight={self.in_flight})")
        if timeout_s is None:
            timeout_s = float(os.environ.get("DMLC_SERVE_DRAIN_S", "10"))
        start = clock.monotonic()
        deadline = start + max(float(timeout_s), 0.0)
        while clock.monotonic() < deadline:
            if self.in_flight == 0 \
                    and clock.monotonic() - start >= settle_s:
                break
            time.sleep(0.05)
        leftover = self.in_flight
        if leftover:
            log_warning(f"serve: drain deadline ({timeout_s:g}s) hit with "
                        f"{leftover} request(s) still in flight")
        else:
            log_info(f"serve: drained in "
                     f"{clock.monotonic() - start:.2f}s, shutting down")
        self.close()

    def close(self) -> None:
        with self._state_lock:
            if self._closed:
                return  # drain() already closed us; __exit__ is a no-op
            self._closed = True
        self._httpd.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join(10.0)
            self._serve_thread = None
        self._httpd.server_close()
        self.registry.close()

    def __enter__(self) -> "ScoringServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- the SLO snapshot -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Live serving stats: counters + histogram quantiles, the same
        estimates the offline ``telemetry report`` prints."""
        default = self.registry.get()
        out: Dict[str, Any] = {
            "model": default.family,
            "version": default.version,
            "models": {
                name: dict(info,
                           queue_bytes=self.registry.get(name)
                           .admission.queued_bytes)
                for name, info in self.registry.describe().items()},
            "queue_bytes": default.admission.queued_bytes,
            "max_queue_bytes": default.admission.max_queue_bytes,
            "uptime_s": round(clock.monotonic() - self.started_at, 3),
            "metrics": {},
        }
        for fam in telemetry.get_registry().families():
            if not fam.name.startswith("dmlc_serve_"):
                continue
            for key, child in fam.samples():
                # the same renderer the offline report uses, so /stats
                # series names join 1:1 against the aggregated table
                series = fam.name + _label_str(dict(key))
                if fam.kind == "counter":
                    out["metrics"][series] = child.value
                elif fam.kind == "gauge":
                    out["metrics"][series] = child.value
                else:
                    counts = child.bucket_counts
                    ests = estimate_quantiles(
                        child.buckets, counts,
                        [q for _, q in REPORT_QUANTILES])
                    entry: Dict[str, Any] = {
                        "count": child.count,
                        "mean": (child.sum / child.count
                                 if child.count else None)}
                    for (name, _), est in zip(REPORT_QUANTILES, ests):
                        entry[name] = est
                    out["metrics"][series] = entry
        return out
