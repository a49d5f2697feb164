"""glog-style logging and the ``CHECK`` family.

Counterpart of ``dmlc_core_tpu/utils/logging.py``: severity-leveled
lines (``LOG``, ``log_*``, the stream-style :class:`LogMessage`) written
as ``<severity letter> [HH:MM:SS] file:line: msg`` to stderr or to a sink
set with :func:`set_log_sink`, a minimum-severity filter
(:func:`set_min_severity`), ``VLOG``-style debug lines gated by
``DMLC_LOG_DEBUG``, and ``CHECK*`` assertions whose fatal path logs and
raises :class:`Error` with the caller's file:line and the same
"Check failed: x op y msg" text.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from typing import Any, Callable, Optional

__all__ = [
    "Error",
    "LOG",
    "LogMessage",
    "CHECK",
    "CHECK_EQ",
    "CHECK_NE",
    "CHECK_LT",
    "CHECK_GT",
    "CHECK_LE",
    "CHECK_GE",
    "CHECK_NOTNULL",
    "DCHECK",
    "set_log_sink",
    "log_info",
    "log_warning",
    "log_error",
    "log_fatal",
    "log_debug",
    "set_min_severity",
]

INFO = "INFO"
WARNING = "WARNING"
ERROR = "ERROR"
FATAL = "FATAL"
_SEVERITY_ORDER = {INFO: 0, WARNING: 1, ERROR: 2, FATAL: 3}


class Error(RuntimeError):
    """Exception thrown by the fatal logging path (reference logging.h:26-32)."""


# Application-redirected sink; when None, write to stderr
# (reference: CustomLogMessage::Log, logging.h:233-252).
_log_sink: Optional[Callable[[str, str], None]] = None
# Minimum severity actually emitted (stderr logger always emits in the
# reference; we add a filter knob for bench runs).
_min_severity = INFO


def set_log_sink(sink: Optional[Callable[[str, str], None]]) -> None:
    """Redirect log output. ``sink(severity, formatted_line)``; None restores stderr."""
    global _log_sink
    _log_sink = sink


def set_min_severity(severity: str) -> None:
    global _min_severity
    if severity not in _SEVERITY_ORDER:
        raise ValueError(f"unknown severity {severity!r}")
    _min_severity = severity


def _caller(depth: int = 2) -> str:
    try:
        frame = sys._getframe(depth)
        return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
    except Exception:  # pragma: no cover - _getframe always available in CPython
        return "?:?"


def _emit(severity: str, msg: str, where: str) -> None:
    stamp = time.strftime("%H:%M:%S", time.localtime())
    line = f"[{stamp}] {where}: {msg}"
    if _log_sink is not None:
        _log_sink(severity, line)
        return
    if _SEVERITY_ORDER[severity] >= _SEVERITY_ORDER[_min_severity]:
        sys.stderr.write(f"{severity[0]} {line}\n")
        sys.stderr.flush()


def LOG(severity: str, msg: Any = "") -> None:
    """LOG(severity, message). FATAL raises :class:`Error` after logging.

    Mirrors the reference's LOG(severity) << msg stream macros
    (logging.h:152-205) with the throw-on-fatal default.
    """
    where = _caller()
    text = str(msg)
    if severity == FATAL:
        stack = "".join(traceback.format_stack(sys._getframe(1), limit=8))
        _emit(FATAL, text, where)
        raise Error(f"[{where}] {text}\nStack trace:\n{stack}")
    _emit(severity, text, where)


def log_info(msg: Any) -> None:
    _emit(INFO, str(msg), _caller())


def log_warning(msg: Any) -> None:
    _emit(WARNING, str(msg), _caller())


def log_error(msg: Any) -> None:
    _emit(ERROR, str(msg), _caller())


def log_fatal(msg: Any) -> None:
    LOG(FATAL, msg)


def log_debug(verbosity: int, msg: Any) -> None:
    """VLOG-equivalent, gated by DMLC_LOG_DEBUG (reference logging.h:152-158)."""
    if int(os.environ.get("DMLC_LOG_DEBUG", "0")) >= verbosity:
        _emit(INFO, str(msg), _caller())


class LogMessage:
    """Stream-style log builder: ``LogMessage(INFO) << "x=" << x`` then emits on del.

    Provided for API familiarity (reference logging.h:207-230); the functional
    :func:`LOG` is the idiomatic entry point.
    """

    def __init__(self, severity: str = INFO):
        self._severity = severity
        self._parts: list = []
        self._where = _caller()

    def __lshift__(self, other: Any) -> "LogMessage":
        self._parts.append(str(other))
        return self

    def flush(self) -> None:
        msg = "".join(self._parts)
        self._parts = []
        if self._severity == FATAL:
            _emit(FATAL, msg, self._where)
            raise Error(f"[{self._where}] {msg}")
        _emit(self._severity, msg, self._where)

    def __del__(self):
        if self._parts and self._severity != FATAL:
            try:
                self.flush()
            except Exception:
                pass


def _fail(op: str, x: Any, y: Any, msg: Any) -> None:
    detail = f"Check failed: {x!r} {op} {y!r}" if op else f"Check failed: {x!r}"
    if msg:
        detail += f" {msg}"
    where = _caller(3)
    _emit(FATAL, detail, where)
    raise Error(f"[{where}] {detail}")


def CHECK(cond: Any, msg: Any = "") -> None:
    """CHECK(cond): raise Error when cond is falsy (reference logging.h:104-115)."""
    if not cond:
        _fail("", cond, None, msg)


def CHECK_EQ(x: Any, y: Any, msg: Any = "") -> None:
    if not (x == y):
        _fail("==", x, y, msg)


def CHECK_NE(x: Any, y: Any, msg: Any = "") -> None:
    if not (x != y):
        _fail("!=", x, y, msg)


def CHECK_LT(x: Any, y: Any, msg: Any = "") -> None:
    if not (x < y):
        _fail("<", x, y, msg)


def CHECK_GT(x: Any, y: Any, msg: Any = "") -> None:
    if not (x > y):
        _fail(">", x, y, msg)


def CHECK_LE(x: Any, y: Any, msg: Any = "") -> None:
    if not (x <= y):
        _fail("<=", x, y, msg)


def CHECK_GE(x: Any, y: Any, msg: Any = "") -> None:
    if not (x >= y):
        _fail(">=", x, y, msg)


def CHECK_NOTNULL(x: Any, msg: Any = "") -> Any:
    """Returns x; raises when x is None (reference logging.h:125-128)."""
    if x is None:
        _fail("is not", x, None, msg or "CHECK_NOTNULL")
    return x


# DCHECK*: compiled out in NDEBUG builds in the reference (logging.h:130-140);
# here gated on PYTHONOPTIMIZE / __debug__.
if __debug__:
    DCHECK = CHECK
    DCHECK_EQ = CHECK_EQ
    DCHECK_NE = CHECK_NE
    DCHECK_LT = CHECK_LT
    DCHECK_GT = CHECK_GT
    DCHECK_LE = CHECK_LE
    DCHECK_GE = CHECK_GE
else:  # pragma: no cover
    def _noop(*a: Any, **k: Any) -> None:
        return None

    DCHECK = DCHECK_EQ = DCHECK_NE = DCHECK_LT = DCHECK_GT = DCHECK_LE = DCHECK_GE = _noop
