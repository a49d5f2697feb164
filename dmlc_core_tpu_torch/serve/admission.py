"""Admission control: shed on queue-bytes so the server degrades, not OOMs.

Counterpart of ``dmlc_core_tpu/serve/admission.py`` (a copy).  The
byte-cost discipline of the ingest pipeline (``ThreadedIter(max_bytes=,
cost_fn=)``) applied at the serving front door:
every admitted request *reserves* its payload bytes, every completed (or
failed) batch *releases* them, and a request that would push the
reservation past ``max_queue_bytes`` is **shed** with a structured 503
(:class:`~dmlc_core_tpu_torch.serve.errors.Overloaded`) carrying a ``Retry-After``
estimated from the observed drain rate, so a fleet of well-behaved
clients self-paces instead of retry-storming.

Why bytes, not request count: requests carry wildly different row counts;
counting them bounds nothing.  Bytes are what OOM the process.

Default bound: ``DMLC_SERVE_QUEUE_BYTES`` (64 MiB).  A request larger than
the whole bound is rejected 400 — no amount of retrying fits it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.serve.errors import BadRequest, Overloaded
from dmlc_core_tpu_torch.telemetry import clock

__all__ = ["AdmissionController", "DEFAULT_QUEUE_BYTES", "queue_bytes_from_env"]

DEFAULT_QUEUE_BYTES = 64 << 20

# Retry-After clamps: never tell a client "0" (it would hot-loop) and never
# park it past what a drain-rate estimate can honestly promise
RETRY_AFTER_FLOOR = 1.0
RETRY_AFTER_CAP = 30.0

_EWMA_ALPHA = 0.3  # drain-rate smoothing: responsive but not twitchy
# shed-fraction smoothing: slower than the drain rate on purpose — the
# router reads this from /healthz as "how hot has this slot been lately",
# and a single admitted request must not erase a shedding episode
_SHED_EWMA_ALPHA = 0.05
# minimum sampling window for a drain-rate observation: releases landing
# microseconds apart (batches completing back-to-back) would otherwise
# produce absurd instantaneous rates that swamp the EWMA
_RATE_WINDOW_S = 0.05


def queue_bytes_from_env() -> int:
    raw = os.environ.get("DMLC_SERVE_QUEUE_BYTES", "").strip()
    if not raw:
        return DEFAULT_QUEUE_BYTES
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"DMLC_SERVE_QUEUE_BYTES must be an integer byte count, "
            f"got {raw!r}") from None
    if v <= 0:
        raise ValueError(f"DMLC_SERVE_QUEUE_BYTES must be > 0, got {v}")
    return v


class AdmissionController:
    """Byte-reservation gate in front of the micro-batch queue.

    Every model slot owns its own controller (``name`` labels the metrics)
    with its own byte budget — the per-model admission discipline of
    the serving lifecycle: one model's burst sheds *that
    model's* traffic, never a co-hosted neighbour's.
    """

    def __init__(self, max_queue_bytes: int = DEFAULT_QUEUE_BYTES,
                 name: str = "default"):
        if max_queue_bytes <= 0:
            raise ValueError(
                f"max_queue_bytes must be > 0, got {max_queue_bytes}")
        self.name = name
        self.max_queue_bytes = int(max_queue_bytes)
        self._lock = threading.Lock()
        self._queued = 0
        self._drain_rate: Optional[float] = None  # EWMA bytes/second
        self._window_start: Optional[float] = None
        self._window_bytes = 0  # drained since _window_start
        self._shed_ewma = 0.0   # EWMA of shed-vs-admit decisions in [0, 1]

    @property
    def queued_bytes(self) -> int:
        with self._lock:
            return self._queued

    def try_admit(self, nbytes: int) -> None:
        """Reserve ``nbytes`` or raise the structured rejection.

        Raises :class:`BadRequest` (400) when the request alone exceeds the
        whole bound, :class:`Overloaded` (503 + Retry-After) when the queue
        is full — the caller maps these straight onto the wire.
        """
        nbytes = int(nbytes)
        if nbytes > self.max_queue_bytes:
            telemetry.count("dmlc_serve_shed_total", model=self.name,
                            reason="oversized")
            raise BadRequest(
                f"request payload ({nbytes} bytes) exceeds the server's "
                f"whole queue bound ({self.max_queue_bytes}); split it",
                details={"payload_bytes": nbytes,
                         "max_queue_bytes": self.max_queue_bytes})
        with self._lock:
            if self._queued + nbytes > self.max_queue_bytes:
                retry = self._retry_after_locked(nbytes)
                queued = self._queued
                self._shed_ewma += _SHED_EWMA_ALPHA * (1.0 - self._shed_ewma)
            else:
                self._queued += nbytes
                self._shed_ewma -= _SHED_EWMA_ALPHA * self._shed_ewma
                telemetry.gauge_set("dmlc_serve_queue_bytes", self._queued,
                                    model=self.name)
                return
        telemetry.count("dmlc_serve_shed_total", model=self.name,
                        reason="queue_bytes")
        raise Overloaded(
            f"scoring queue full ({queued}/{self.max_queue_bytes} bytes "
            f"reserved); retry after {retry:.0f}s",
            retry_after=retry,
            details={"queued_bytes": queued,
                     "max_queue_bytes": self.max_queue_bytes})

    def release(self, nbytes: int) -> None:
        """Return ``nbytes`` to the budget (batch completed or failed) and
        feed the drain-rate estimate the Retry-After hints come from.

        Rate observations are taken over windows of at least
        ``_RATE_WINDOW_S``: bytes accumulate until the window closes, so
        back-to-back releases cannot fabricate gigabytes-per-second
        samples out of microsecond spacing.
        """
        nbytes = int(nbytes)
        now = clock.monotonic()
        with self._lock:
            self._queued = max(0, self._queued - nbytes)
            telemetry.gauge_set("dmlc_serve_queue_bytes", self._queued,
                                model=self.name)
            if self._window_start is None:
                self._window_start = now
                self._window_bytes = nbytes
                return
            self._window_bytes += nbytes
            dt = now - self._window_start
            if dt >= _RATE_WINDOW_S:
                rate = self._window_bytes / dt
                self._drain_rate = (
                    rate if self._drain_rate is None
                    else _EWMA_ALPHA * rate
                    + (1 - _EWMA_ALPHA) * self._drain_rate)
                self._window_start = now
                self._window_bytes = 0

    def describe(self) -> Dict[str, Any]:
        """The admission snapshot ``/healthz`` publishes per model slot —
        what the multi-replica router routes on (least-loaded by queue
        fraction) instead of bare liveness."""
        with self._lock:
            return {"queue_bytes": self._queued,
                    "max_queue_bytes": self.max_queue_bytes,
                    "drain_rate_bps": (round(self._drain_rate, 1)
                                       if self._drain_rate else None),
                    "shed_ewma": round(self._shed_ewma, 6)}

    def _retry_after_locked(self, nbytes: int) -> float:
        """Seconds until ``nbytes`` plausibly fits, from the drain EWMA.

        With no drain observed yet (cold start under burst) the floor is
        the honest answer: anything else is invented precision.
        """
        if not self._drain_rate or self._drain_rate <= 0:
            return RETRY_AFTER_FLOOR
        excess = self._queued + nbytes - self.max_queue_bytes
        est = excess / self._drain_rate
        return min(max(est, RETRY_AFTER_FLOOR), RETRY_AFTER_CAP)
