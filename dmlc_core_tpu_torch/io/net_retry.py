"""Connection-reestablishing retry shared by the remote-FS HTTP clients.

The reference re-connects on curl errors and short reads
(src/io/s3_filesys.cc:318-341, 703-733).  Every client here opens a fresh
connection per request, so a retry IS a re-connect; this module is the one
place the transport failure set, transient status set, and backoff policy
live, so the S3/GCS and Azure clients cannot drift.

Backoff policy (docs/robustness.md):

- **full jitter**: each sleep is uniform in ``[0, min(cap, base * 2^attempt))``
  — a fleet of workers thundering against a throttling endpoint must not
  re-synchronize on the retry schedule;
- **Retry-After honored**: when a 429/503 carries a ``Retry-After`` header
  (delta-seconds or HTTP-date), the sleep is at least that long (capped at
  :data:`RETRY_AFTER_CAP`) — the server knows its own recovery better than
  our exponent does;
- **total deadline**: ``DMLC_NET_RETRY_DEADLINE`` (seconds, 0 = off) bounds
  the whole retry envelope; a sleep that would cross it is skipped and the
  caller gets the final failure *now* instead of minutes of doomed backoff.

The ``net.request`` fault site (:mod:`dmlc_core_tpu_torch.fault`) lets chaos runs
inject 503 storms, resets, and stalls here without a real flaky endpoint.

Counterpart of ``dmlc_core_tpu/io/net_retry.py`` (a copy).
"""

from __future__ import annotations

import datetime
import email.utils
import http.client
import logging
import random
import socket
import ssl
import time
from typing import Callable, Dict, Optional, Tuple

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.param import get_env

__all__ = ["RETRYABLE_EXC", "RETRYABLE_STATUS", "request_with_retries",
           "BACKOFF_BASE", "BACKOFF_CAP", "RETRY_AFTER_CAP"]

logger = logging.getLogger("dmlc_core_tpu_torch.io.net")

# transport-level failures worth re-establishing a connection for
RETRYABLE_EXC = (ConnectionError, socket.timeout, ssl.SSLError,
                 http.client.IncompleteRead, http.client.BadStatusLine,
                 http.client.CannotSendRequest, http.client.ResponseNotReady)
# server statuses that are transient by contract (503 SlowDown on S3,
# 429 rateLimitExceeded on the GCS interop API / Azure throttling,
# 5xx incl. 504 from front-end proxies)
RETRYABLE_STATUS = (429, 500, 502, 503, 504)

BACKOFF_BASE = 0.1    # seconds; doubles per attempt (pre-jitter ceiling)
BACKOFF_CAP = 30.0    # ceiling on any single backoff window
RETRY_AFTER_CAP = 60.0  # never trust a Retry-After past this

Response = Tuple[int, Dict[str, str], bytes]

# module-level so tests can seed it for deterministic jitter
_rng = random.Random()


def request_with_retries(perform: Callable[[], Response],
                         ok: Tuple[int, ...],
                         describe: str) -> Response:
    """Run ``perform`` (one full connect+send+read) with retry.

    Transport failures and transient statuses retry up to
    ``S3_MAX_ERROR_RETRY`` times (default 3) with full-jitter doubling
    backoff, honoring ``Retry-After`` and the ``DMLC_NET_RETRY_DEADLINE``
    total budget; ``perform`` is called fresh each attempt, so
    time-sensitive signatures re-sign.  Statuses in ``ok`` are returned
    immediately; non-ok final statuses are returned to the caller to report
    (not raised here).
    """
    max_retry = get_env("S3_MAX_ERROR_RETRY", int, 3)
    deadline_s = get_env("DMLC_NET_RETRY_DEADLINE", float, 0.0)
    start = time.monotonic()
    for attempt in range(max_retry + 1):
        try:
            injected = (fault.http_response("net.request", describe=describe,
                                            attempt=attempt)
                        if fault.enabled() else None)
            if injected is not None:
                status, headers, data = injected
            else:
                if fault.enabled():
                    fault.inject("net.request", describe=describe,
                                 attempt=attempt)
                status, headers, data = perform()
        except RETRYABLE_EXC as exc:
            if attempt >= max_retry:
                telemetry.count("dmlc_net_retry_exhausted_total",
                                status_class="transport")
                raise
            sleep_s = _backoff(attempt, None, deadline_s, start)
            if sleep_s is None:
                telemetry.count("dmlc_net_retry_deadline_total",
                                status_class="transport")
                logger.warning("%s: retry deadline (%gs) reached; giving up "
                               "after %d attempt(s): %s", describe,
                               deadline_s, attempt + 1, exc)
                raise
            logger.warning("re-establishing connection (%s, retry %d): %s",
                           describe, attempt + 1, exc)
            _note_retry("transport", sleep_s)
            time.sleep(sleep_s)
            continue
        if status in RETRYABLE_STATUS and status not in ok \
                and attempt < max_retry:
            sleep_s = _backoff(attempt, _retry_after(headers), deadline_s,
                               start)
            if sleep_s is None:
                telemetry.count("dmlc_net_retry_deadline_total",
                                status_class=_status_class(status))
                logger.warning("%s returned %d; retry deadline (%gs) "
                               "reached, giving up", describe, status,
                               deadline_s)
                return status, headers, data
            logger.warning("%s returned %d; retry %d", describe, status,
                           attempt + 1)
            _note_retry(_status_class(status), sleep_s)
            time.sleep(sleep_s)
            continue
        if status in RETRYABLE_STATUS and attempt >= max_retry:
            telemetry.count("dmlc_net_retry_exhausted_total",
                            status_class=_status_class(status))
        return status, headers, data
    raise AssertionError("unreachable")


def _backoff(attempt: int, retry_after: Optional[float],
             deadline_s: float, start: float) -> Optional[float]:
    """One backoff decision: full-jitter window for ``attempt`` (0-based),
    raised to the server's Retry-After when present, or None when the sleep
    would cross the total deadline (the caller stops retrying)."""
    window = min(BACKOFF_CAP, BACKOFF_BASE * (2 ** attempt))
    delay = _rng.uniform(0.0, window)
    if retry_after is not None:
        delay = max(delay, min(retry_after, RETRY_AFTER_CAP))
    if deadline_s and (time.monotonic() - start) + delay > deadline_s:
        return None
    return delay


def _retry_after(headers: Dict[str, str]) -> Optional[float]:
    """Parse a Retry-After header (delta-seconds or HTTP-date) to seconds."""
    value = None
    for key, v in headers.items():
        if key.lower() == "retry-after":
            value = v
            break
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        dt = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if dt is None:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return max(0.0, dt.timestamp() - time.time())


def _status_class(status: int) -> str:
    """Coarse status bucket for metric labels ("4xx"/"5xx")."""
    return f"{status // 100}xx"


def _note_retry(status_class: str, backoff_s: float) -> None:
    """One retry decision -> the dmlc_net_retry_* metric family."""
    if not telemetry.enabled():
        return
    telemetry.count("dmlc_net_retry_retries_total",
                    status_class=status_class)
    telemetry.count("dmlc_net_retry_backoff_seconds_total", backoff_s,
                    status_class=status_class)
