"""Open-loop load generator + the SLO accounting it reports.

Counterpart of ``dmlc_core_tpu/serve/loadgen.py``.  One addition: a
caller may pass ``make_rows(rng)`` to :func:`run_load` to draw each
request's instances (a held-out pool, a varying row count) in place of
the uniform synthetic rows.

**Open-loop matters**: a closed-loop client (send, wait, send) slows down
exactly when the server does, hiding the latency it came to measure
(coordinated omission).  Here arrivals are a seeded Poisson process at the
offered rate, dispatched on schedule regardless of how many requests are
still in flight, and each request's latency is measured **from its
scheduled arrival time** — a dispatch that couldn't start on time counts
against the server, not for it.

Outcome taxonomy (the SLO vocabulary of the serving tier):

=============  ==============================================================
``ok``         200 with a parseable predictions body of the right length
``shed``       structured 503 (admission, predict-failure, injected storm)
``timeout``    structured 504, or the client-side deadline elapsed
``rejected``   structured 4xx (the load was malformed — a client bug), or
               connection **refused**: nothing was listening, which in the
               multi-replica era means a restart window (the OS said "not
               here" before any bytes moved — cleanly retryable, nothing
               was lost mid-flight)
``error``      any other structured 5xx
``crashed``    no structured answer at all: connection reset mid-request,
               truncated body, unparseable response
``invalid``    200 whose body fails the caller's ``response_check`` —
               the answer arrived but is WRONG (the hot-swap drill uses
               this to catch a response whose predictions do not match
               the model version it claims served them)
=============  ==============================================================

The graceful-degradation proof is ``crashed == 0`` under an active fault
plan: every request got *an* answer, even if that answer was "not now".

Every request additionally carries a fresh W3C ``traceparent`` (the client
is each trace's root), the per-request sample records its ``trace_id``,
and the report lists the **top-5 slowest trace ids** — so the worst-p99
offenders in an SLO report can be looked up directly in the merged trace
instead of being anonymous latency numbers.

The report also carries a **scoring-drift canary**: every ``ok``
response's mean prediction is bucketed by its *scheduled* arrival window
(``drift_window_s``, default 1 s), and the ``drift`` block reports the
per-window mean-prediction series.  Against a fixed model the series is
flat noise; under continuous training it visibly tracks the data
distribution the trainer is absorbing.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.telemetry import clock, tracecontext

__all__ = ["run_load", "run_churn", "percentile", "LoadReport", "PoolLoad",
           "load_line", "RouterProcess"]

# how many worst-latency samples the report names by trace id
SLOWEST_TRACES = 5

OUTCOMES = ("ok", "shed", "timeout", "rejected", "error", "crashed",
            "invalid")

LoadReport = Dict[str, Any]


def percentile(sorted_values: List[float], q: float) -> Optional[float]:
    """Exact (linear-interpolated) percentile of a pre-sorted sample."""
    if not sorted_values:
        return None
    if len(sorted_values) == 1:
        return sorted_values[0]
    pos = q * (len(sorted_values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac


def _gen_rows(rng: random.Random, n: int, num_feature: int) -> List[List[float]]:
    return [[rng.uniform(-1.0, 1.0) for _ in range(num_feature)]
            for _ in range(n)]


class _Recorder:
    """Thread-safe outcome/latency sink (one sample per request, with the
    request's trace_id so any latency can be found in the merged trace)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.counts = {k: 0 for k in OUTCOMES}
        self.statuses: Dict[str, int] = {}
        # connection accounting: every SLO report states how many sockets
        # were in flight at once and whether the transport ever slammed
        # the door (refused = nothing listening; reset = RST mid-request)
        self.inflight = 0
        self.peak_inflight = 0
        self.refused = 0
        self.resets = 0
        # (latency_s, trace_id, outcome, status) per request — the single
        # store every latency view (quantiles, slowest table) derives from
        self.samples: List[Tuple[float, str, str, Optional[int]]] = []
        # drift canary: window index -> [n_requests, sum of per-request
        # mean predictions] over ok responses only
        self.drift: Dict[int, List[float]] = {}
        # per-window outcome counts, keyed by SCHEDULED arrival window —
        # what availability-during-a-kill-window gates are computed from
        self.windows: Dict[int, Dict[str, int]] = {}

    def begin(self) -> None:
        with self.lock:
            self.inflight += 1
            if self.inflight > self.peak_inflight:
                self.peak_inflight = self.inflight

    def end(self, conn_event: Optional[str]) -> None:
        with self.lock:
            self.inflight -= 1
            if conn_event == "refused":
                self.refused += 1
            elif conn_event == "reset":
                self.resets += 1

    def record(self, outcome: str, latency_s: float,
               status: Optional[int], trace_id: str,
               window: Optional[int] = None) -> None:
        with self.lock:
            self.counts[outcome] += 1
            if status is not None:
                key = str(status)
                self.statuses[key] = self.statuses.get(key, 0) + 1
            self.samples.append((latency_s, trace_id, outcome, status))
            if window is not None:
                acc = self.windows.setdefault(window,
                                              {k: 0 for k in OUTCOMES})
                acc[outcome] += 1

    def window_series(self, window_s: float) -> List[Dict[str, Any]]:
        with self.lock:
            items = sorted((w, dict(c)) for w, c in self.windows.items())
        return [dict({"window": w, "t_s": round(w * window_s, 3)}, **c)
                for w, c in items]

    def record_drift(self, window: int, mean_prediction: float) -> None:
        with self.lock:
            acc = self.drift.setdefault(window, [0, 0.0])
            acc[0] += 1
            acc[1] += mean_prediction

    def drift_series(self, window_s: float) -> List[Dict[str, Any]]:
        with self.lock:
            items = sorted(self.drift.items())
        return [{"window": w, "t_s": round(w * window_s, 3), "n": n,
                 "mean_prediction": round(total / n, 6)}
                for w, (n, total) in items if n]

    def latencies(self, outcome: Optional[str] = None) -> List[float]:
        with self.lock:
            return [s[0] for s in self.samples
                    if outcome is None or s[2] == outcome]

    def slowest(self, n: int) -> List[Dict[str, Any]]:
        with self.lock:
            worst = sorted(self.samples, key=lambda s: -s[0])[:n]
        return [{"trace_id": t, "latency_ms": round(lat * 1e3, 3),
                 "outcome": outcome, "status": status}
                for lat, t, outcome, status in worst]


def _mean_prediction(preds: List[Any]) -> Optional[float]:
    """Mean over a predictions list (scalars, or per-class rows for
    softmax — flattened); None when nothing numeric is there."""
    flat: List[float] = []
    for p in preds:
        if isinstance(p, (int, float)):
            flat.append(float(p))
        elif isinstance(p, list):
            flat.extend(float(v) for v in p
                        if isinstance(v, (int, float)))
    return sum(flat) / len(flat) if flat else None


def _issue(url: str, path: str, body: bytes, timeout_s: float,
           expect_rows: int, traceparent: str, rows=None,
           response_check=None) -> tuple:
    """One POST; returns (outcome, status|None, mean_prediction|None,
    conn_event|None) where conn_event is ``"refused"`` (nothing was
    listening) or ``"reset"`` (the transport tore the connection)."""
    req = urllib.request.Request(
        url + path, data=body,
        headers={"Content-Type": "application/json",
                 "traceparent": traceparent}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            payload = json.load(resp)
            preds = payload.get("predictions")
            if isinstance(preds, list) and len(preds) == expect_rows:
                if response_check is not None \
                        and not response_check(payload, rows):
                    # a well-formed 200 that is WRONG (e.g. predictions
                    # inconsistent with the version it claims): worse
                    # than a shed, and the one outcome a half-swapped
                    # model could produce
                    return "invalid", resp.status, None, None
                return "ok", resp.status, _mean_prediction(preds), None
            # 200 with a wrong-shaped body
            return "crashed", resp.status, None, None
    except urllib.error.HTTPError as e:
        status = e.code
        try:
            err = json.load(e)
            structured = isinstance(err, dict) and "error" in err
        except Exception:
            structured = False
        if not structured:
            return "crashed", status, None, None
        if status == 503:
            return "shed", status, None, None
        if status == 504:
            return "timeout", status, None, None
        if 400 <= status < 500:
            return "rejected", status, None, None
        return "error", status, None, None
    except TimeoutError:
        return "timeout", None, None, None
    except urllib.error.URLError as e:
        # urllib wraps connect-phase deadline expiry in URLError: that is
        # the client's deadline, not a server crash
        reason = getattr(e, "reason", None)
        if isinstance(reason, TimeoutError):
            return "timeout", None, None, None
        if isinstance(reason, ConnectionRefusedError):
            # nothing listening on the port: a replica/router restart
            # window, not a dropped in-flight request
            return "rejected", None, None, "refused"
        if isinstance(reason, ConnectionResetError):
            return "crashed", None, None, "reset"
        return "crashed", None, None, None
    except ConnectionRefusedError:
        return "rejected", None, None, "refused"
    except ConnectionResetError:
        return "crashed", None, None, "reset"
    except (ConnectionError, OSError):
        return "crashed", None, None, None
    except Exception:
        return "crashed", None, None, None


def run_load(url: str, *, qps: float, duration_s: float, num_feature: int,
             rows_per_request: int = 1, seed: int = 0,
             timeout_s: float = 10.0, max_workers: int = 64,
             model: Optional[str] = None,
             response_check=None,
             drift_window_s: float = 1.0,
             make_rows=None) -> LoadReport:
    """Drive open-loop traffic at ``qps`` for ``duration_s``; returns the
    SLO report dict (see module docstring for the outcome taxonomy).

    ``model`` routes every request to ``/v1/score/<model>`` (multi-model
    serving); ``response_check(payload, rows) -> bool`` (``rows`` = the
    instances this request sent) classifies a well-formed 200 whose body
    is semantically wrong as ``invalid``; ``drift_window_s`` sets the
    scoring-drift canary's bucketing (report ``drift`` block);
    ``make_rows(rng) -> rows`` draws each request's instances in place of
    ``rows_per_request`` uniform synthetic rows."""
    from concurrent.futures import ThreadPoolExecutor

    path = "/v1/score" if model is None else f"/v1/score/{model}"

    rng = random.Random(seed)
    # Poisson arrival offsets within [0, duration)
    arrivals: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(qps)
        if t >= duration_s:
            break
        arrivals.append(t)
    if make_rows is None:
        rows_sent = [_gen_rows(rng, rows_per_request, num_feature)
                     for _ in arrivals]
    else:
        rows_sent = [make_rows(rng) for _ in arrivals]
    bodies = [json.dumps({"instances": rows}).encode()
              for rows in rows_sent]
    rec = _Recorder()
    start = clock.monotonic()

    def fire(scheduled_at: float, body: bytes, rows) -> None:
        # each request roots a fresh trace.  The header is attached even
        # when THIS process collects nothing (the W3C propagation norm:
        # the server side may be tracing — its spans then carry ids the
        # report names); with local telemetry on, the client span is
        # recorded under these exact ids so the server's serve.request
        # parents to a span that really exists in the assembled trace.
        trace_id = tracecontext.new_trace_id()
        span_id = tracecontext.new_span_id()
        tp = tracecontext.format_traceparent(
            tracecontext.TraceContext(trace_id, span_id))
        t0 = clock.monotonic()
        rec.begin()
        outcome, status, mean_pred, conn_event = _issue(
            url, path, body, timeout_s, len(rows), tp, rows,
            response_check)
        t1 = clock.monotonic()
        rec.end(conn_event)
        telemetry.record_span("client.request", t0, t1,
                              trace=(trace_id, span_id, None),
                              outcome=outcome, status=status or 0)
        rec.record(outcome, t1 - start - scheduled_at, status, trace_id,
                   window=int(scheduled_at // drift_window_s))
        if mean_pred is not None:
            # bucket by SCHEDULED time: the canary plots what the model
            # answered for traffic offered at t, not when it got around
            # to answering it
            rec.record_drift(int(scheduled_at // drift_window_s),
                             mean_pred)

    with ThreadPoolExecutor(max_workers=max_workers,
                            thread_name_prefix="loadgen") as pool:
        for at, body, rows in zip(arrivals, bodies, rows_sent):
            delay = at - (clock.monotonic() - start)
            if delay > 0:
                time.sleep(delay)
            pool.submit(fire, at, body, rows)
        # pool __exit__ joins all in-flight requests
    wall = clock.monotonic() - start

    lat_ok = sorted(rec.latencies("ok"))
    lat_all = sorted(rec.latencies())
    n = len(arrivals)
    report: LoadReport = {
        "offered_qps": qps,
        "duration_s": duration_s,
        "wall_s": round(wall, 3),
        "rows_per_request": rows_per_request if make_rows is None else None,
        "requests": n,
        "counts": dict(rec.counts),
        "statuses": dict(sorted(rec.statuses.items())),
        "achieved_qps": round(rec.counts["ok"] / wall, 2) if wall else 0.0,
        "shed_rate": round(rec.counts["shed"] / n, 4) if n else 0.0,
        "error_rate": round((rec.counts["error"] + rec.counts["crashed"]
                             + rec.counts["invalid"]) / n, 4) if n else 0.0,
        "model": model,
        "latency_ms": {
            "p50": _ms(percentile(lat_ok, 0.50)),
            "p95": _ms(percentile(lat_ok, 0.95)),
            "p99": _ms(percentile(lat_ok, 0.99)),
            "max": _ms(lat_ok[-1] if lat_ok else None),
        },
        "latency_all_ms": {
            "p50": _ms(percentile(lat_all, 0.50)),
            "p99": _ms(percentile(lat_all, 0.99)),
        },
        # connection accounting in EVERY report: how many sockets were in
        # flight at the peak, and whether the transport ever slammed the
        # door.  refused = connect got ECONNREFUSED (restart window or an
        # exhausted backlog); resets = the socket was torn (RST) after
        # bytes moved.  The c10k gate reads refused == resets == 0.
        "connections": {
            "peak_inflight": rec.peak_inflight,
            "refused": rec.refused,
            "resets": rec.resets,
        },
        # the worst offenders BY NAME: feed these ids to
        # `telemetry trace <dir>` to see where each one's time went
        "slowest_traces": rec.slowest(SLOWEST_TRACES),
        # scoring-drift canary: per-window mean prediction of ok answers
        "drift": {
            "window_s": drift_window_s,
            "series": rec.drift_series(drift_window_s),
        },
        # outcome counts bucketed by scheduled arrival window: what a
        # "availability >= X% during the kill window" gate reads
        "outcome_windows": {
            "window_s": drift_window_s,
            "series": rec.window_series(drift_window_s),
        },
        # exactly-once accounting: one recorded outcome per issued
        # request.  A hedged router response that somehow got delivered
        # twice (double-counted) would make recorded > requests and flip
        # ok to false — the chaos drill gates on it.
        "accounting": {
            "requests": n,
            "recorded": sum(rec.counts.values()),
            "ok": sum(rec.counts.values()) == n,
        },
    }
    server_stats = _fetch_stats(url, timeout_s)
    if server_stats is not None:
        report["server"] = server_stats
    return report


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 3)


def _raise_nofile_limit(need: int) -> None:
    """Best-effort bump of RLIMIT_NOFILE toward ``need`` descriptors so a
    c10k client army doesn't die on the default soft limit; silently does
    nothing where resource limits are unavailable or capped below need."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want = min(hard, max(soft, need))
        if want > soft:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
    except Exception:
        pass


def run_churn(url: str, *, connections: int, duration_s: float,
              num_feature: int, active: int = 32,
              churn_per_s: float = 0.0, seed: int = 0,
              timeout_s: float = 10.0) -> Dict[str, Any]:
    """High-concurrency connection-churn scenario: the c10k drill.

    Opens ``connections`` raw keep-alive sockets that sit **idle** (the
    realistic shape of 10k+ concurrent clients: most are between
    requests), while ``active`` keep-alive HTTP workers score requests
    continuously over their own persistent connections.  Optionally
    churns the idle army at ``churn_per_s`` (close one, open a fresh
    one) to exercise accept/close pressure under load.

    The verdict the report carries:

    - ``connections.refused`` — connects the OS bounced (full backlog or
      nothing listening).  Must be 0 for the c10k claim.
    - ``connections.resets`` — sockets torn mid-request (RST).  Must be 0.
    - ``connections.closed_by_server`` — idle army sockets the server
      dropped during the window (idle-timeout misfires show up here).
    - ``connections.peak_open`` — idle army + active workers actually
      connected at once: the concurrency actually demonstrated.

    The caller is responsible for a server whose idle timeout
    (``DMLC_SERVE_IDLE_S``) exceeds ``duration_s``.
    """
    import socket
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    host, port = parts.hostname or "127.0.0.1", parts.port or 80
    _raise_nofile_limit(connections + active + 64)
    rng = random.Random(seed)

    idle: List[Any] = []
    refused = 0
    open_errors = 0
    opened_total = 0
    for _ in range(connections):
        try:
            s = socket.create_connection((host, port), timeout=timeout_s)
            idle.append(s)
            opened_total += 1
        except ConnectionRefusedError:
            refused += 1
        except OSError:
            open_errors += 1

    body = json.dumps(
        {"instances": _gen_rows(rng, 1, num_feature)}).encode()
    lock = threading.Lock()
    stats = {"ok": 0, "errors": 0, "resets": 0}
    lats: List[float] = []
    start = clock.monotonic()
    stop_at = start + duration_s

    def worker() -> None:
        import http.client

        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        try:
            while clock.monotonic() < stop_at:
                t0 = clock.monotonic()
                try:
                    conn.request("POST", "/v1/score", body,
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    resp.read()
                    status = resp.status
                except (ConnectionResetError, BrokenPipeError):
                    with lock:
                        stats["resets"] += 1
                    conn.close()
                    continue
                except (ConnectionError, OSError,
                        http.client.HTTPException):
                    with lock:
                        stats["errors"] += 1
                    conn.close()
                    continue
                with lock:
                    if status == 200:
                        stats["ok"] += 1
                        lats.append(clock.monotonic() - t0)
                    else:
                        stats["errors"] += 1
        finally:
            conn.close()

    workers = [threading.Thread(target=worker, daemon=True)
               for _ in range(active)]
    for t in workers:
        t.start()

    churned = 0
    peak_open = len(idle) + active
    while clock.monotonic() < stop_at:
        if churn_per_s > 0 and idle:
            # swap one idle soldier: close + reconnect (accept pressure
            # while the request path is busy)
            victim = idle.pop(rng.randrange(len(idle)))
            try:
                victim.close()
            except OSError:
                pass
            try:
                s = socket.create_connection((host, port),
                                             timeout=timeout_s)
                idle.append(s)
                opened_total += 1
                churned += 1
            except ConnectionRefusedError:
                refused += 1
            except OSError:
                open_errors += 1
            peak_open = max(peak_open, len(idle) + active)
            time.sleep(1.0 / churn_per_s)
        else:
            time.sleep(0.05)
    for t in workers:
        t.join(timeout_s + 5.0)

    # roll call: any idle soldier the server dropped (EOF/RST waiting in
    # its buffer) is a broken keep-alive promise
    closed_by_server = 0
    for s in idle:
        try:
            s.setblocking(False)
            if s.recv(1) == b"":
                closed_by_server += 1
        except (BlockingIOError, InterruptedError):
            pass  # still open and silent: the healthy case
        except OSError:
            closed_by_server += 1
        finally:
            try:
                s.close()
            except OSError:
                pass

    wall = clock.monotonic() - start
    lat = sorted(lats)
    report: Dict[str, Any] = {
        "target_connections": connections,
        "active_workers": active,
        "duration_s": duration_s,
        "wall_s": round(wall, 3),
        "connections": {
            "peak_open": peak_open,
            "opened_total": opened_total + active,
            "churned": churned,
            "refused": refused,
            "resets": stats["resets"],
            "open_errors": open_errors,
            "closed_by_server": closed_by_server,
        },
        "requests": {"ok": stats["ok"], "errors": stats["errors"]},
        "achieved_qps": round(stats["ok"] / wall, 2) if wall else 0.0,
        "latency_ms": {
            "p50": _ms(percentile(lat, 0.50)),
            "p95": _ms(percentile(lat, 0.95)),
            "p99": _ms(percentile(lat, 0.99)),
            "max": _ms(lat[-1] if lat else None),
        },
    }
    server_stats = _fetch_stats(url, timeout_s)
    if server_stats is not None:
        report["server"] = server_stats
    return report


def _fetch_stats(url: str, timeout_s: float) -> Optional[Dict[str, Any]]:
    try:
        with urllib.request.urlopen(url + "/stats",
                                    timeout=timeout_s) as resp:
            return json.load(resp)
    except Exception:
        return None


class PoolLoad:
    """:func:`run_load`'s request source and answer check over a held-out
    pool: each request 1-``max_rows`` rows of ``pool``, each 200 answer
    held bitwise to ``want[version]`` (the scores of the pool that the
    answering model version must give), the rows of good answers
    counted."""

    def __init__(self, pool, want: Dict[Any, Any], max_rows: int = 64):
        import numpy as np

        self._np = np
        self.rows = pool.tolist()
        self.index = {tuple(r): i for i, r in enumerate(self.rows)}
        self.want = want
        self.max_rows = max_rows
        self.lock = threading.Lock()
        self.versions: Dict[Any, int] = {}
        self.rows_ok = 0

    def make_rows(self, rng: random.Random) -> List[List[float]]:
        return [self.rows[rng.randrange(len(self.rows))]
                for _ in range(rng.randint(1, self.max_rows))]

    def check(self, payload: Dict[str, Any], rows) -> bool:
        np = self._np
        v = payload.get("version")
        want = self.want.get(v)
        if want is None:
            return False
        idx = [self.index[tuple(r)] for r in rows]
        got = np.asarray(payload["predictions"], np.float32)
        if not np.array_equal(got.view(np.uint32), want[idx].view(np.uint32)):
            return False
        with self.lock:
            self.versions[v] = self.versions.get(v, 0) + 1
            self.rows_ok += len(rows)
        return True

    def run(self, url: str, qps: float, duration_s: float, seed: int,
            num_feature: int, **kwargs) -> Tuple[LoadReport, float,
                                                 Dict[Any, int]]:
        """:func:`run_load` over the pool; returns the report, the rows/s
        of good answers and the count of good answers per version."""
        with self.lock:
            self.versions, self.rows_ok = {}, 0
        report = run_load(url, qps=qps, duration_s=duration_s,
                          num_feature=num_feature, seed=seed,
                          make_rows=self.make_rows,
                          response_check=self.check, **kwargs)
        return report, self.rows_ok / report["wall_s"], dict(self.versions)


def load_line(label: str, report: LoadReport, rows_s: float) -> str:
    """One line of a load report: offered rate, outcome counts, latency
    percentiles, achieved requests/s and rows/s."""
    lat = report["latency_ms"]
    c = report["counts"]
    return (f"{label}: offered {report['offered_qps']:.1f}/s for "
            f"{report['duration_s']:g} s, {report['requests']} requests: ok "
            f"{c['ok']}, shed {c['shed']}, timeout {c['timeout']}, rejected "
            f"{c['rejected']}, error {c['error']}, crashed {c['crashed']}, "
            f"invalid {c['invalid']}; latency p50 {lat['p50']} ms, p95 "
            f"{lat['p95']} ms, p99 {lat['p99']} ms; {report['achieved_qps']} "
            f"requests/s, {rows_s:.0f} rows/s")


def _router_main(urls: List[str], conn) -> None:
    """A ``RouterServer`` over ``urls`` in a process of its own: sends its
    URL, then serves until told to stop (or the parent goes away)."""
    from dmlc_core_tpu_torch.serve.router import RouterServer

    telemetry.enable()
    router = RouterServer(urls).start()
    conn.send(router.url)
    try:
        conn.recv()
    except EOFError:
        pass
    router.close()


class RouterProcess:
    """A ``RouterServer`` over ``urls`` in a spawned process of its own, as
    the serving CLI runs it with ``--replicas``: a load generator in the
    calling process then shares its interpreter lock with nothing but its
    own threads.  Its state is read over HTTP (``/healthz``, ``/stats``)."""

    def __init__(self, urls: List[str], start_timeout_s: float = 120.0):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_router_main, args=(urls, child),
                                daemon=True)
        self.proc.start()
        if not self._conn.poll(start_timeout_s):
            self.close()
            raise RuntimeError(f"the router process did not start in "
                               f"{start_timeout_s:g} s")
        self.url = self._conn.recv()

    def get(self, path: str, timeout_s: float = 60.0) -> Dict[str, Any]:
        with urllib.request.urlopen(self.url + path,
                                    timeout=timeout_s) as resp:
            return json.load(resp)

    def counter(self, series: str) -> float:
        return self.get("/stats")["metrics"].get(series, 0.0)

    def close(self) -> None:
        if self.proc.is_alive():
            try:
                self._conn.send("stop")
            except OSError:
                pass
            self.proc.join(30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)
