"""Shared telemetry naming for filesystem backends.

One helper so s3/gs, azure, http and hdfs all emit the same
``dmlc_filesystem_*`` metric families with the same label shape (``fs`` =
protocol, ``op`` = request verb) — the per-backend clients call
:func:`note_request` once per remote round-trip and cannot drift apart in
naming.  Everything is a no-op while telemetry is disabled.

Counterpart of ``dmlc_core_tpu/io/fs_metrics.py`` (a copy).
"""

from __future__ import annotations

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.telemetry import clock

__all__ = ["request_start", "note_request"]


def request_start() -> float:
    """Monotonic begin-of-request reading (0.0 while disabled — callers can
    pass it straight back to :func:`note_request` unconditionally)."""
    return clock.monotonic() if telemetry.enabled() else 0.0


def note_request(fs: str, op: str, start: float,
                 nread: int = 0, nwritten: int = 0) -> None:
    """Record one remote round-trip: latency histogram + byte counters."""
    if not telemetry.enabled():
        return
    if start:
        # a 0.0 start means telemetry was enabled mid-request: the latency
        # was never measured, so skip the sample rather than fabricate 0.0s
        telemetry.observe("dmlc_filesystem_request_seconds",
                          clock.elapsed(start), fs=fs, op=op)
    if nread:
        telemetry.count("dmlc_filesystem_read_bytes_total", nread, fs=fs)
    if nwritten:
        telemetry.count("dmlc_filesystem_write_bytes_total", nwritten, fs=fs)
