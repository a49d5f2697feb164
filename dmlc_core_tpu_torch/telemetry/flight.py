"""Flight recorder: the last N span completions, kept where a crash can't
eat them.

The span buffer and the atexit flush cover the happy path; the failures
worth diagnosing are exactly the ones that skip it — a bench child SIGTERMed
by its parent's watchdog after 300 silent seconds, a worker ``os._exit``'d
by a chaos plan, an unhandled exception past the last flush.  This module
keeps a bounded ring of recent span events (and fault-site fires), fed on
every record, and **dumps it** to ``DMLC_TELEMETRY_DIR`` when the process
dies abnormally:

- unhandled exception (a chained ``sys.excepthook``);
- ``SIGTERM`` (a chained handler — installed only from the main thread, and
  any pre-existing handler still runs after the dump);
- explicitly, from watchdog/soft-deadline paths (``bench.py``) and from the
  fault injector's ``exit`` kind before ``os._exit``;
- optionally every ``DMLC_FLIGHT_INTERVAL_S`` seconds from a daemon thread,
  so even ``SIGKILL`` leaves a dump at most one interval stale (``bench.py``
  arms this for its children; default off — most processes don't need a
  background writer).

The dump is one small JSON file, ``flight-r<rank>-p<pid>.json``, written
atomically; the trace assembler (``telemetry trace``) merges its events
with the regular per-process span files (deduplicating overlap) and marks
the process as crashed with the dump's ``reason``.

Knobs: ``DMLC_FLIGHT=0`` disables handler installation entirely;
``DMLC_FLIGHT_MAX`` sizes the ring (default 512 entries);
``DMLC_FLIGHT_INTERVAL_S`` arms the periodic writer.  Feeding the ring
costs one deque append per recorded span — and recording only happens when
telemetry is enabled, so disabled-mode cost stays zero.

Counterpart of ``dmlc_core_tpu/telemetry/flight.py`` (a copy).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from dmlc_core_tpu_torch.telemetry import clock

__all__ = ["note_event", "note", "snapshot", "dump", "install", "reset",
           "installed", "DEFAULT_MAX_ENTRIES"]

DEFAULT_MAX_ENTRIES = 512


def _ring_size() -> int:
    raw = os.environ.get("DMLC_FLIGHT_MAX", "").strip()
    try:
        return max(16, int(raw)) if raw else DEFAULT_MAX_ENTRIES
    except ValueError:
        return DEFAULT_MAX_ENTRIES


# deque.append with maxlen is atomic under the GIL: the ring needs no lock
# on the hot path (snapshot() copies via list(), also atomic)
_ring: "deque[Dict[str, Any]]" = deque(maxlen=_ring_size())
_dump_dir: Optional[str] = None
_installed = False
_prev_excepthook = None
_prev_sigterm = None
_interval_thread: Optional[threading.Thread] = None
# reentrant: the SIGTERM handler runs ON the main thread and calls dump();
# a plain Lock would deadlock it against a dump already in progress there
# (bench's soft-deadline dump racing the parent watchdog's terminate())
_dump_lock = threading.RLock()


def note_event(event: Dict[str, Any]) -> None:
    """Feed one span/instant event dict into the ring (called by the span
    tracer on every record — including ones the bounded span buffer
    dropped: the flight ring always keeps the most recent tail)."""
    _ring.append(event)


def note(name: str, /, **payload: Any) -> None:
    """Feed a non-span marker (e.g. a fault fire outside any span).

    ``name`` is positional-only so payload keys named ``name`` (or any
    other identifier — fault fires carry ``kind=``) can never collide."""
    entry: Dict[str, Any] = {"ph": "i", "name": name,
                             "ts": round(clock.trace_time_us(), 3),
                             "pid": os.getpid(),
                             "tid": threading.get_ident()}
    if payload:
        entry["args"] = payload
    _ring.append(entry)


def snapshot() -> List[Dict[str, Any]]:
    return list(_ring)


def reset() -> None:
    """Drop ring contents (test isolation; handlers stay installed)."""
    _ring.clear()


def installed() -> bool:
    return _installed


def dump(reason: str, dirpath: Optional[str] = None) -> Optional[str]:
    """Write the ring to ``flight-r<rank>-p<pid>.json``; returns the path.

    Never raises (a failing dump on a dying process must not replace the
    original failure); returns None with nothing written when no directory
    is known or the write fails.
    """
    target = dirpath or _dump_dir or os.environ.get("DMLC_TELEMETRY_DIR")
    if not target:
        return None
    try:
        # cold path: the lazy import avoids a spans->flight->export->spans
        # import cycle at module load
        from dmlc_core_tpu_torch.telemetry.export import rank_from_env

        with _dump_lock:
            os.makedirs(target, exist_ok=True)
            path = os.path.join(
                target, f"flight-r{rank_from_env()}-p{os.getpid()}.json")
            payload = {
                "reason": reason,
                "time": time.time(),
                "wall_epoch_s": clock.wall_epoch(),
                "pid": os.getpid(),
                "rank": rank_from_env(),
                "entries": snapshot(),
            }
            try:
                from dmlc_core_tpu_torch import telemetry

                payload["spans_dropped"] = telemetry.get_tracer().dropped
            except Exception:
                pass
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
            return path
    except Exception:
        return None


# -- abnormal-exit handlers ---------------------------------------------------

def _on_uncaught(exc_type, exc, tb) -> None:
    dump(f"unhandled_exception:{getattr(exc_type, '__name__', exc_type)}")
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def _on_sigterm(signum, frame) -> None:
    dump("sigterm")
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    elif prev != signal.SIG_IGN:
        # SIG_DFL — or None, a handler installed by non-Python code that
        # we cannot call: restore the default and re-raise so the process
        # still DIES on SIGTERM (swallowing it would strand supervisors
        # into SIGKILL, losing the clean shutdown the chain preserves)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


_logger = logging.getLogger("dmlc_core_tpu_torch.telemetry.flight")


def _interval_loop(interval_s: float) -> None:
    # daemon loop, whole body guarded: a failing periodic dump must never
    # take anything down (the thread dies with the process), but the
    # failure itself is ferried to the log rather than lost
    try:
        while True:
            time.sleep(interval_s)
            dump("interval")
    except Exception as exc:  # noqa: BLE001 — ferried, not swallowed
        _logger.warning("flight interval writer stopped: %r", exc)


def install(dirpath: str) -> None:
    """Arm the abnormal-exit dumps into ``dirpath`` (idempotent).

    Called by ``telemetry.enable(flush_dir)`` — i.e. whenever
    ``DMLC_TELEMETRY_DIR`` is set — unless ``DMLC_FLIGHT=0``.  Signal
    installation is skipped off the main thread (CPython restriction) and
    never clobbers an existing handler: the previous one is chained after
    the dump.
    """
    global _installed, _dump_dir, _prev_excepthook, _prev_sigterm
    global _interval_thread, _ring
    _dump_dir = dirpath
    if _ring.maxlen != _ring_size():
        # the ring was sized at import; honor a DMLC_FLIGHT_MAX set after
        # that but before enable() — same late-binding the interval knob
        # gets — keeping whatever tail was already recorded
        _ring = deque(_ring, maxlen=_ring_size())
    if _installed:
        return
    if os.environ.get("DMLC_FLIGHT", "").strip() == "0":
        return
    _installed = True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _on_uncaught
    if threading.current_thread() is threading.main_thread():
        try:
            _prev_sigterm = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            _prev_sigterm = None
    raw = os.environ.get("DMLC_FLIGHT_INTERVAL_S", "").strip()
    try:
        interval = float(raw) if raw else 0.0
    except ValueError:
        interval = 0.0
    if interval > 0 and _interval_thread is None:
        _interval_thread = threading.Thread(
            target=_interval_loop, args=(interval,),
            name="flight-recorder", daemon=True)
        _interval_thread.start()
