"""The multi-replica routing tier: health-checked failover + hedging.

Counterpart of ``dmlc_core_tpu/serve/router.py`` (a copy).  One
:class:`RouterServer` fronts N scoring replicas (each a
:class:`~.server.ScoringServer` process, normally launched by
:class:`~.fleet.ReplicaFleet`).  The router owns no model and touches no
device — it owns the *robustness* contract of the tier: a client keeps
getting structured answers while replicas die, straggle, saturate, and
roll-restart underneath it.

Per-replica health state machine (each transition logged and exported as
``dmlc_router_replica_state{replica}``)::

    healthy --1 consecutive connect failure--> degraded
    degraded/healthy --3 consecutive failures--> ejected
    ejected --/healthz probe ok (half-open trial)--> healthy
    any --/healthz says "draining"--> draining (not routed; a fresh
        process answering "ok" on the same port recovers via half-open)

Failure counting is **passive** (every forward attempt that dies at the
connect level feeds the counter) plus **active**: a prober thread GETs
each replica's ``/healthz`` every ``DMLC_ROUTER_PROBE_S`` seconds, which
both accelerates ejection of a dead replica and is the only road back —
an ejected replica that answers probes enters *half-open*: it is offered
at most one in-flight trial request at a time (no thundering herd on a
cold restart), and either that trial or enough consecutive probe
successes promote it back to healthy.

Forwarding discipline:

- per-try deadline ``DMLC_ROUTER_TRY_TIMEOUT_S`` on every replica hop;
- bounded retries (``DMLC_ROUTER_RETRIES``) with full-jitter backoff, on
  **connect-level failures only**: refused/reset/timed-out before any
  response byte was read.  Scoring is idempotent, but the router still
  never replays a request after response bytes were read — a half-read
  answer becomes a structured 503 ``replica_failed`` and the *client*
  decides (it can retry; the router will not guess);
- each retry runs on a freshly picked replica (the failed one is
  excluded) — the retry budget buys failover, not hammering a corpse;
- replica 503s are relayed verbatim AND recorded router-side: the
  ``Retry-After`` marks that replica saturated, and :meth:`RouterServer.
  _pick` routes around it until the mark expires.  When **all** replicas
  are saturated the router sheds with its own structured 503
  (``reason=all_saturated``, Retry-After = the earliest expiry) — the
  tier degrades visibly, never with a refused connection;
- least-loaded routing: among routable replicas, pick by (state rank,
  in-flight count, queue fraction from the enriched ``/healthz``).

Request hedging ("tail at scale"): after a self-tuned delay tracking the
router's own p95 forward latency (an EWMA-style stochastic quantile
estimator — no sample buffer), a second attempt is launched on a
different replica.  First response wins and is the only one delivered
(the handler thread is the sole writer to the client socket, so a
duplicate can never be double-delivered); the loser is discarded and
counted in ``dmlc_router_hedges_total{outcome}``.

Chaos: the ``serve.router.forward`` fault site fires once per forward
attempt (``reset``/``delay``/``stall``/``error``/``http_status``).
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import random
import socket
import threading
import time
from typing import Any, Dict, FrozenSet, List, Optional, Tuple
from urllib.parse import urlsplit

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.param import _parse_bool
from dmlc_core_tpu_torch.serve.errors import (BadRequest, Overloaded,
                                        RequestTimeout, ServeError,
                                        UpstreamFailed)
from dmlc_core_tpu_torch.serve.server import MAX_BODY_BYTES, _Handler, _Server
from dmlc_core_tpu_torch.telemetry import clock, tracecontext
from dmlc_core_tpu_torch.telemetry.report import (REPORT_QUANTILES, _label_str,
                                            estimate_quantiles)
from dmlc_core_tpu_torch.utils.logging import log_debug, log_info, log_warning

__all__ = ["Replica", "RouterServer"]

# health state machine thresholds
DEGRADE_AFTER = 1    # consecutive connect failures -> deprioritized
EJECT_AFTER = 3      # consecutive connect failures -> not routed at all
HALF_OPEN_PROBES = 2  # consecutive probe successes to re-enter healthy

# hedging: clamp the self-tuned delay so a cold estimator can neither
# hedge every request (floor) nor never hedge (cap)
_HEDGE_MIN_S = 0.02
_HEDGE_MAX_S = 2.0
_HEDGE_INIT_S = 0.25  # until the first latency sample lands
_P95_Q = 0.95
_P95_ETA = 0.05       # estimator step, scaled by the current estimate

# full-jitter retry backoff (AWS-style: sleep U(0, min(cap, base*2^n)))
_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 0.5

_STATE_CODES = {"healthy": 0, "degraded": 1, "ejected": 2, "draining": 3}


class _Retryable(Exception):
    """Internal: a forward attempt died before any response byte was read
    — the one class of failure the router is allowed to retry."""

    def __init__(self, reason: str, detail: str):
        super().__init__(detail)
        self.reason = reason


def _retry_after_s(value: Optional[str]) -> float:
    """Delta-seconds Retry-After -> float, clamped to [1, 30]."""
    try:
        secs = float(value) if value is not None else 1.0
    except ValueError:
        secs = 1.0
    return min(max(secs, 1.0), 30.0)


class Replica:
    """Router-side record of one backend: address + health odometers.

    Every mutable field is written only under ``self._lock`` — handler
    threads (passive failure counting), the prober thread, and hedge
    threads all feed the same state machine concurrently.
    """

    def __init__(self, url: str, name: str):
        parts = urlsplit(url if "//" in url else f"http://{url}")
        if not parts.hostname or not parts.port:
            raise ValueError(f"replica URL needs host:port, got {url!r}")
        self.url = f"http://{parts.hostname}:{parts.port}"
        self.host = parts.hostname
        self.port = int(parts.port)
        self.name = name
        self._lock = threading.Lock()
        self.state = "healthy"
        self.failures = 0          # consecutive connect-level failures
        self.half_open = False     # ejected/draining but answering probes
        self.probe_successes = 0   # consecutive, while half-open
        self.saturated_until = 0.0  # monotonic deadline from a 503
        self.in_flight = 0
        self.queue_bytes = 0       # sum over models, from /healthz
        self.queue_fraction = 0.0  # worst slot's queue_bytes/max
        self.version: Optional[int] = None

    def _set_state_locked(self, state: str) -> None:
        if state != self.state:
            log_info(f"router: replica {self.name} ({self.url}) "
                     f"{self.state} -> {state}")
            self.state = state
        telemetry.gauge_set("dmlc_router_replica_state",
                            _STATE_CODES[state], replica=self.name)

    def begin(self) -> None:
        with self._lock:
            self.in_flight += 1

    def end(self) -> None:
        with self._lock:
            self.in_flight -= 1

    def note_success(self) -> None:
        """A forward attempt got an HTTP response: the transport works."""
        with self._lock:
            self.failures = 0
            if self.state in ("degraded", "ejected"):
                # a half-open trial (or a deprioritized replica) answered
                # real traffic — that IS the recovery proof
                self._set_state_locked("healthy")
            self.half_open = False
            self.probe_successes = 0

    def note_failure(self) -> None:
        """A forward attempt (or probe) failed at the connect level."""
        with self._lock:
            self.failures += 1
            self.half_open = False
            self.probe_successes = 0
            if self.failures >= EJECT_AFTER:
                self._set_state_locked("ejected")
            elif self.failures >= DEGRADE_AFTER \
                    and self.state == "healthy":
                self._set_state_locked("degraded")

    def note_saturated(self, retry_after_s: float) -> None:
        """The replica shed with a 503: honor its Retry-After as shared
        admission state (route around it, don't eject — it's healthy,
        just full)."""
        with self._lock:
            self.saturated_until = clock.monotonic() + retry_after_s

    def note_probe(self, payload: Optional[Dict[str, Any]]) -> None:
        """Fold one /healthz probe result into the state machine.

        ``payload`` is the parsed JSON on success, None on any failure
        (refused, timeout, non-200, unparseable).
        """
        if payload is None:
            self.note_failure()
            return
        queue_bytes = 0
        fraction = 0.0
        admission = payload.get("admission")
        if isinstance(admission, dict):
            for info in admission.values():
                if not isinstance(info, dict):
                    continue
                qb = int(info.get("queue_bytes") or 0)
                queue_bytes += qb
                cap = info.get("max_queue_bytes")
                if cap:
                    fraction = max(fraction, qb / float(cap))
        with self._lock:
            self.queue_bytes = queue_bytes
            self.queue_fraction = fraction
            version = payload.get("version")
            if version is not None:
                self.version = version
            telemetry.gauge_set("dmlc_router_replica_queue_bytes",
                                queue_bytes, replica=self.name)
            if payload.get("status") == "draining":
                # the replica asked to be taken out of rotation BEFORE it
                # stops serving — the zero-downtime half of rolling restart
                self._set_state_locked("draining")
                self.half_open = False
                self.probe_successes = 0
                return
            self.failures = 0
            if self.state in ("ejected", "draining"):
                # half-open: routable for one trial at a time; promoted
                # after enough consecutive probe successes even without
                # traffic (an idle fleet must still converge to healthy)
                self.probe_successes += 1
                if self.probe_successes >= HALF_OPEN_PROBES:
                    self._set_state_locked("healthy")
                    self.half_open = False
                    self.probe_successes = 0
                else:
                    self.half_open = True
            elif self.state == "degraded":
                self._set_state_locked("healthy")

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"name": self.name, "url": self.url,
                    "state": self.state, "half_open": self.half_open,
                    "failures": self.failures,
                    "in_flight": self.in_flight,
                    "queue_bytes": self.queue_bytes,
                    "queue_fraction": round(self.queue_fraction, 4),
                    "saturated_until": self.saturated_until,
                    "version": self.version}


class _RouterHandler(_Handler):
    """Router transport: same plumbing as the replica handler (keep-alive
    desync discipline included), different routes."""

    server_version = "dmlc-router/0.1"

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        app = self.app
        try:
            if self.path == "/healthz":
                self._respond_json(200, app.health())
            elif self.path == "/metrics":
                self._respond(200, telemetry.prometheus_text().encode(),
                              content_type="text/plain; version=0.0.4")
            elif self.path == "/stats":
                self._respond_json(200, app.stats())
            else:
                self._respond_error(BadRequest(f"no such path "
                                               f"{self.path!r}"))
        except ServeError as exc:
            self._respond_error(exc)

    def do_POST(self) -> None:  # noqa: N802 (http.server contract)
        app = self.app
        t0 = clock.monotonic()
        status = 500
        try:
            if self.path != "/v1/score" \
                    and not self.path.startswith("/v1/score/"):
                # body unread: keep-alive would parse it as the next
                # request line
                self.close_connection = True
                raise BadRequest(f"no such path {self.path!r}")
            body = self._read_body()
            # continue the caller's W3C trace through the router hop: the
            # router.request span joins the client trace, router.forward
            # children join it, and the replica's serve.request continues
            # from the traceparent the forward attempt sends
            ctx = tracecontext.from_traceparent(
                self.headers.get("traceparent"))
            with tracecontext.activate(ctx), \
                    telemetry.span("router.request", path=self.path):
                status, headers, data = app.forward(self.path, body)
                self._respond(status, data, headers)
        except ServeError as exc:
            status = exc.status
            if status == 503:
                telemetry.count("dmlc_router_shed_total",
                                reason=exc.details.get("reason", exc.code))
            self._respond_error(exc)
        except (BrokenPipeError, ConnectionResetError):
            # the CLIENT side of the socket died — nobody left to answer
            status = 0
            telemetry.count("dmlc_router_connection_aborts_total")
            self.close_connection = True
        except Exception as exc:  # noqa: BLE001 — the 500 of last resort
            status = 500
            log_warning(f"router: unexpected error handling request: "
                        f"{exc!r}")
            self.close_connection = True
            try:
                self._respond_error(ServeError(f"internal error: {exc}"))
            except OSError:
                pass
        finally:
            telemetry.count("dmlc_router_requests_total", status=status)
            telemetry.observe("dmlc_router_request_seconds",
                              clock.monotonic() - t0, status=status)

    def _read_body(self) -> bytes:
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
            self.close_connection = True
            exc = BadRequest(
                f"body of {length} bytes exceeds {MAX_BODY_BYTES}")
            exc.status = 413
            exc.code = "payload_too_large"
            raise exc
        return self.rfile.read(length)


class RouterServer:
    """HTTP front for N scoring replicas: health, failover, hedging.

    ``replica_urls`` are ``http://host:port`` (or bare ``host:port``)
    addresses of already-launched :class:`~.server.ScoringServer`
    processes — see :class:`~.fleet.ReplicaFleet` for the supervised
    form.  Knob arguments default from the environment:
    ``DMLC_ROUTER_RETRIES`` (2), ``DMLC_ROUTER_TRY_TIMEOUT_S`` (5),
    ``DMLC_ROUTER_PROBE_S`` (0.25), ``DMLC_ROUTER_HEDGE`` (1).
    """

    def __init__(self, replica_urls: List[str], *,
                 host: str = "127.0.0.1", port: int = 0,
                 hedge: Optional[bool] = None,
                 retries: Optional[int] = None,
                 try_timeout_s: Optional[float] = None,
                 probe_interval_s: Optional[float] = None,
                 request_timeout_s: float = 15.0):
        if not replica_urls:
            raise ValueError("RouterServer needs at least one replica URL")
        self.replicas = [Replica(url, f"r{i}")
                         for i, url in enumerate(replica_urls)]
        if len({r.url for r in self.replicas}) != len(self.replicas):
            raise ValueError(f"duplicate replica URLs in {replica_urls}")
        self.hedge = (_parse_bool(os.environ.get("DMLC_ROUTER_HEDGE", "1"))
                      if hedge is None else bool(hedge))
        self.retries = (int(os.environ.get("DMLC_ROUTER_RETRIES", "2"))
                        if retries is None else int(retries))
        self.try_timeout_s = (
            float(os.environ.get("DMLC_ROUTER_TRY_TIMEOUT_S", "5"))
            if try_timeout_s is None else float(try_timeout_s))
        self.probe_interval_s = (
            float(os.environ.get("DMLC_ROUTER_PROBE_S", "0.25"))
            if probe_interval_s is None else float(probe_interval_s))
        if self.retries < 0 or self.try_timeout_s <= 0 \
                or self.probe_interval_s <= 0:
            raise ValueError(
                "retries must be >= 0 and timeouts/intervals > 0 "
                f"(got retries={self.retries}, "
                f"try_timeout_s={self.try_timeout_s}, "
                f"probe_interval_s={self.probe_interval_s})")
        self.request_timeout_s = float(request_timeout_s)
        self._lock = threading.Lock()   # guards the hedge-delay estimator
        self._p95_s: Optional[float] = None
        self._stop = threading.Event()
        self._httpd = _Server((host, port), _RouterHandler)
        self._httpd.app = self  # type: ignore[attr-defined]
        self._serve_thread: Optional[threading.Thread] = None
        self._probe_thread: Optional[threading.Thread] = None
        self.started_at = clock.monotonic()

    # -- lifecycle ------------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "RouterServer":
        # prime health + queue state synchronously so the first routed
        # request already knows who is alive and how loaded
        for rep in self.replicas:
            self._probe_one(rep)
        self.started_at = clock.monotonic()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="router-prober", daemon=True)
        self._probe_thread.start()
        self._serve_thread = threading.Thread(
            target=self._serve, name="router-http", daemon=False)
        self._serve_thread.start()
        log_info(f"router: listening on {self.url} fronting "
                 f"{len(self.replicas)} replica(s) "
                 f"(hedge={'on' if self.hedge else 'off'}, "
                 f"retries={self.retries}, "
                 f"try_timeout_s={self.try_timeout_s:g}, "
                 f"probe_s={self.probe_interval_s:g})")
        return self

    def _serve(self) -> None:
        try:
            self._httpd.serve_forever(poll_interval=0.1)
        except Exception as exc:  # noqa: BLE001 — ferried, not swallowed
            log_warning(f"router: listener exited abnormally: {exc!r}")

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._httpd.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join(10.0)
            self._serve_thread = None
        if self._probe_thread is not None:
            self._probe_thread.join(5.0)
            self._probe_thread = None
        self._httpd.server_close()

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- the hedge-delay estimator --------------------------------------------

    def _observe_latency(self, lat_s: float) -> None:
        """Fold one delivered-response latency into the p95 estimate
        (stochastic quantile approximation: step up on the 5% of samples
        above the estimate, down on the 95% below — fixed memory, adapts
        when the fleet's latency regime shifts)."""
        with self._lock:
            if self._p95_s is None:
                self._p95_s = max(lat_s, _HEDGE_MIN_S)
            else:
                step = _P95_ETA * max(self._p95_s, _HEDGE_MIN_S)
                if lat_s > self._p95_s:
                    self._p95_s += step * _P95_Q
                else:
                    self._p95_s -= step * (1.0 - _P95_Q)
                self._p95_s = max(self._p95_s, 1e-4)
            est = self._p95_s
        telemetry.gauge_set("dmlc_router_hedge_delay_seconds",
                            min(max(est, _HEDGE_MIN_S), _HEDGE_MAX_S))

    def hedge_delay_s(self) -> float:
        with self._lock:
            est = self._p95_s
        if est is None:
            est = _HEDGE_INIT_S
        return min(max(est, _HEDGE_MIN_S), _HEDGE_MAX_S)

    # -- routing --------------------------------------------------------------

    def _pick(self, exclude: FrozenSet[str]) -> Replica:
        """Least-loaded routable replica, or a structured 503.

        Routable = not ejected/draining (half-open admits one trial at a
        time), not excluded, and not inside a 503 Retry-After window.
        """
        now = clock.monotonic()
        candidates: List[Tuple[int, int, float, float, int]] = []
        saturated_until: List[float] = []
        for idx, rep in enumerate(self.replicas):
            snap = rep.snapshot()
            if snap["name"] in exclude:
                continue
            trial = snap["half_open"]
            if snap["state"] in ("ejected", "draining") and not trial:
                continue
            if trial and snap["in_flight"] > 0:
                continue  # half-open: one trial at a time, no herd
            if snap["saturated_until"] > now:
                saturated_until.append(snap["saturated_until"])
                continue
            rank = 0 if snap["state"] == "healthy" and not trial else 1
            candidates.append((rank, snap["in_flight"],
                               snap["queue_fraction"], random.random(),
                               idx))
        if candidates:
            return self.replicas[min(candidates)[-1]]
        if saturated_until:
            retry_after = min(max(min(saturated_until) - now, 1.0), 30.0)
            raise Overloaded(
                "all replicas saturated; retry later",
                retry_after=retry_after,
                details={"reason": "all_saturated",
                         "replicas": len(self.replicas)})
        raise Overloaded(
            "no routable replicas (all ejected, draining, or excluded)",
            retry_after=1.0,
            details={"reason": "no_replicas",
                     "replicas": len(self.replicas)})

    # -- forwarding -----------------------------------------------------------

    def forward(self, path: str, body: bytes) \
            -> Tuple[int, Dict[str, str], bytes]:
        """Forward one fully-read request body; returns the winning
        replica response (status, relay headers, body).

        Runs the primary attempt chain in a worker thread and waits on a
        result queue; if no result lands within the hedge delay, launches
        one hedge attempt on a different replica.  The calling handler
        thread is the only writer to the client socket, so the losing
        response is structurally impossible to double-deliver — it is
        drained, counted, and dropped.
        """
        t0 = clock.monotonic()
        parent = tracecontext.current()
        results: "queue.Queue[Tuple[str, Any, Dict[str, Any]]]" = \
            queue.Queue()
        first = self._pick(frozenset())
        self._spawn_attempts(first, path, body, parent, "primary",
                             results, self.retries + 1)
        outstanding = 1
        hedged = False
        deadline = t0 + self.request_timeout_s
        last_err: Optional[ServeError] = None
        winner: Optional[Tuple[Tuple[int, Dict[str, str], bytes],
                               Dict[str, Any]]] = None
        while outstanding > 0 and winner is None:
            now = clock.monotonic()
            if now >= deadline:
                break
            if self.hedge and not hedged:
                wait = min(self.hedge_delay_s(), deadline - now)
            else:
                wait = deadline - now
            try:
                kind, payload, meta = results.get(timeout=max(wait, 1e-3))
            except queue.Empty:
                if self.hedge and not hedged:
                    hedged = True
                    try:
                        rep = self._pick(frozenset({first.name}))
                    except ServeError:
                        continue  # nowhere to hedge: keep waiting
                    telemetry.count("dmlc_router_hedges_total",
                                    outcome="fired")
                    log_debug(1, f"router: hedging to {rep.name} after "
                                 f"{clock.monotonic() - t0:.3f}s")
                    self._spawn_attempts(rep, path, body, parent, "hedge",
                                         results, 1)
                    outstanding += 1
                continue
            outstanding -= 1
            if kind == "response":
                winner = (payload, meta)
            else:
                last_err = payload
        if winner is not None:
            (status, headers, data), meta = winner
            if hedged:
                telemetry.count(
                    "dmlc_router_hedges_total",
                    outcome=("hedge_won" if meta.get("tag") == "hedge"
                             else "primary_won"))
                # the loser (still outstanding) will finish, ferry its
                # result into this request-local queue, and be GC'd with
                # it — never delivered
                for _ in range(outstanding):
                    telemetry.count("dmlc_router_hedges_total",
                                    outcome="discarded")
            self._observe_latency(clock.monotonic() - t0)
            headers = dict(headers)
            if meta.get("replica"):
                headers["X-Dmlc-Replica"] = meta["replica"]
            return status, headers, data
        if last_err is not None:
            raise last_err
        raise RequestTimeout(
            f"no replica answered within {self.request_timeout_s}s",
            details={"timeout_s": self.request_timeout_s,
                     "hedged": hedged})

    def _spawn_attempts(self, rep: Replica, path: str, body: bytes,
                        parent: Optional[tracecontext.TraceContext],
                        tag: str,
                        results: "queue.Queue[Tuple[str, Any, Dict[str, Any]]]",
                        tries: int) -> None:
        worker = threading.Thread(
            target=self._run_attempts,
            args=(rep, path, body, parent, tag, results, tries),
            name=f"router-{tag}", daemon=True)
        worker.start()

    def _run_attempts(self, rep: Replica, path: str, body: bytes,
                      parent: Optional[tracecontext.TraceContext],
                      tag: str,
                      results: "queue.Queue[Tuple[str, Any, Dict[str, Any]]]",
                      tries: int) -> None:
        """One attempt chain: try, retry on connect-level failure (fresh
        replica each time, full-jitter backoff), ferry the outcome into
        the waiter's queue.  Never raises — a dead worker thread would
        strand the handler until its deadline."""
        try:
            used = {rep.name}
            last_detail = ""
            for attempt in range(tries):
                if attempt:
                    telemetry.count("dmlc_router_retries_total", tag=tag)
                    time.sleep(random.uniform(0.0, min(
                        _BACKOFF_CAP_S,
                        _BACKOFF_BASE_S * (2 ** (attempt - 1)))))
                    try:
                        rep = self._pick(frozenset(used))
                    except ServeError as exc:
                        results.put(("error", exc, {"tag": tag}))
                        return
                    used.add(rep.name)
                try:
                    response = self._attempt(rep, path, body, parent, tag,
                                             attempt)
                except _Retryable as exc:
                    last_detail = str(exc)
                    log_debug(1, f"router: {tag} attempt {attempt} on "
                                 f"{rep.name} failed retryably: "
                                 f"{last_detail}")
                    continue
                except ServeError as exc:
                    results.put(("error", exc, {"tag": tag}))
                    return
                results.put(("response", response,
                             {"tag": tag, "replica": rep.name}))
                return
            results.put(("error", UpstreamFailed(
                f"no replica reachable after {tries} attempt(s): "
                f"{last_detail}",
                details={"attempts": tries, "tried": sorted(used)}),
                {"tag": tag}))
        except Exception as exc:  # noqa: BLE001 — ferried to the waiter
            results.put(("error",
                         ServeError(f"router internal error: {exc!r}"),
                         {"tag": tag}))

    def _attempt(self, rep: Replica, path: str, body: bytes,
                 parent: Optional[tracecontext.TraceContext], tag: str,
                 attempt: int) -> Tuple[int, Dict[str, str], bytes]:
        """One forward hop to one replica under the per-try deadline.

        Raises :class:`_Retryable` only when **zero response bytes** were
        read (refused, reset pre-response, connect timeout, replica died
        before the status line) — past that point a failure is terminal
        and structured, because the request may already have been scored.
        """
        rep.begin()
        conn: Optional[http.client.HTTPConnection] = None
        t0 = clock.monotonic()
        outcome = "ok"
        phase = "connect"
        try:
            with tracecontext.activate(parent), \
                    telemetry.span("router.forward", replica=rep.name,
                                   tag=tag, attempt=attempt):
                injected = fault.http_response(
                    "serve.router.forward", replica=rep.name, tag=tag,
                    attempt=attempt)
                if injected is not None:
                    outcome = "injected"
                    i_status, i_headers, i_body = injected
                    return i_status, dict(i_headers), \
                        i_body or b'{"error": {"code": "injected"}}'
                # act kinds fire before the connection opens: 'reset'
                # models a replica dying at connect time (retryable),
                # 'stall'/'delay' a slow link, 'error' a router bug
                fault.inject("serve.router.forward", replica=rep.name,
                             tag=tag, attempt=attempt)
                conn = http.client.HTTPConnection(
                    rep.host, rep.port, timeout=self.try_timeout_s)
                conn.connect()
                phase = "send"
                headers = {"Content-Type": "application/json"}
                traceparent = tracecontext.current_traceparent()
                if traceparent:
                    headers["traceparent"] = traceparent
                conn.request("POST", path, body=body, headers=headers)
                phase = "status"
                resp = conn.getresponse()
                phase = "read"  # status line read: the no-replay point
                data = resp.read()
                rep.note_success()
                relay: Dict[str, str] = {}
                for key in ("Content-Type", "Retry-After"):
                    value = resp.getheader(key)
                    if value is not None:
                        relay[key] = value
                if resp.status == 503:
                    # a saturated-but-healthy replica: honor its
                    # Retry-After router-side as shared admission state
                    rep.note_saturated(
                        _retry_after_s(relay.get("Retry-After")))
                return resp.status, relay, data
        except http.client.RemoteDisconnected as exc:
            # zero response bytes: the replica never answered this body
            outcome = "connect_failed"
            rep.note_failure()
            raise _Retryable("disconnected",
                             f"{rep.name}: {exc!r}") from None
        except socket.timeout:
            outcome = "timeout"
            rep.note_failure()
            if phase == "connect":
                raise _Retryable(
                    "connect_timeout",
                    f"{rep.name}: connect timed out") from None
            raise RequestTimeout(
                f"replica {rep.name} exceeded the {self.try_timeout_s:g}s "
                "per-try deadline",
                details={"replica": rep.name, "phase": phase}) from None
        except OSError as exc:
            rep.note_failure()
            if phase in ("connect", "send", "status"):
                # refused / reset before any response byte was read
                outcome = "connect_failed"
                raise _Retryable(phase, f"{rep.name}: {exc!r}") from None
            outcome = "failed"
            raise UpstreamFailed(
                f"replica {rep.name} failed after response bytes were "
                f"read: {exc!r}",
                details={"replica": rep.name, "phase": phase}) from None
        except http.client.HTTPException as exc:
            # partial/garbled status line: bytes WERE read, never replay
            outcome = "failed"
            rep.note_failure()
            raise UpstreamFailed(
                f"replica {rep.name} sent an unparseable response: "
                f"{exc!r}",
                details={"replica": rep.name}) from None
        except ServeError:
            raise
        except Exception as exc:  # noqa: BLE001 — injected 'error' et al.
            outcome = "error"
            rep.note_failure()
            raise UpstreamFailed(
                f"forwarding to {rep.name} failed: {exc!r}",
                details={"replica": rep.name}) from None
        finally:
            if conn is not None:
                conn.close()
            rep.end()
            telemetry.observe("dmlc_router_forward_seconds",
                              clock.monotonic() - t0, replica=rep.name)
            telemetry.count("dmlc_router_forward_total", replica=rep.name,
                            outcome=outcome)

    # -- active probing -------------------------------------------------------

    def _probe_loop(self) -> None:
        try:
            while not self._stop.is_set():
                for rep in self.replicas:
                    if self._stop.is_set():
                        break
                    self._probe_one(rep)
                self._stop.wait(self.probe_interval_s)
        except Exception as exc:  # noqa: BLE001 — ferried, not swallowed
            log_warning(f"router: prober exited abnormally: {exc!r}")

    def _probe_one(self, rep: Replica) -> None:
        conn: Optional[http.client.HTTPConnection] = None
        payload: Optional[Dict[str, Any]] = None
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.port,
                timeout=min(1.0, self.try_timeout_s))
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status == 200:
                parsed = json.loads(raw)
                if isinstance(parsed, dict):
                    payload = parsed
        except (OSError, http.client.HTTPException, ValueError):
            payload = None
        finally:
            if conn is not None:
                conn.close()
        telemetry.count("dmlc_router_probes_total", replica=rep.name,
                        outcome="ok" if payload is not None else "fail")
        rep.note_probe(payload)

    # -- introspection --------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        snaps = {rep.name: rep.snapshot() for rep in self.replicas}
        routable = sum(1 for s in snaps.values()
                       if s["state"] in ("healthy", "degraded")
                       or s["half_open"])
        return {"status": "ok", "role": "router",
                "replicas": snaps, "routable": routable,
                "hedge": self.hedge,
                "hedge_delay_s": round(self.hedge_delay_s(), 4),
                "uptime_s": round(clock.monotonic() - self.started_at, 3)}

    def stats(self) -> Dict[str, Any]:
        """Router SLO snapshot: replica states + every dmlc_router_*
        series (same quantile math as the replica's /stats)."""
        out: Dict[str, Any] = dict(self.health())
        out["metrics"] = {}
        for fam in telemetry.get_registry().families():
            if not fam.name.startswith("dmlc_router_"):
                continue
            for key, child in fam.samples():
                series = fam.name + _label_str(dict(key))
                if fam.kind in ("counter", "gauge"):
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
                    for (qname, _), est in zip(REPORT_QUANTILES, ests):
                        entry[qname] = est
                    out["metrics"][series] = entry
        return out
