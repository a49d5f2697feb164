"""``CHECK`` macros and leveled log lines.

Counterpart of ``dmlc_core_tpu/utils/logging.py`` (only the part the port
uses): the fatal path throws :class:`Error` with the caller's file:line
and the same "Check failed: x op y msg" text; ``log_*`` write
``<severity letter> [HH:MM:SS] file:line: msg`` lines to stderr.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any

__all__ = ["Error", "CHECK", "CHECK_EQ", "CHECK_NE", "CHECK_LT", "CHECK_LE",
           "log_info", "log_warning", "log_fatal"]


class Error(RuntimeError):
    """Raised by a failed :func:`CHECK` and by :func:`log_fatal`."""


def _caller(depth: int) -> str:
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return "?:0"
    return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"


def _emit(severity: str, msg: str, where: str) -> None:
    stamp = time.strftime("%H:%M:%S", time.localtime())
    sys.stderr.write(f"{severity[0]} [{stamp}] {where}: {msg}\n")
    sys.stderr.flush()


def log_info(msg: Any) -> None:
    _emit("INFO", str(msg), _caller(2))


def log_warning(msg: Any) -> None:
    _emit("WARNING", str(msg), _caller(2))


def log_fatal(msg: Any) -> None:
    """Log at FATAL and raise :class:`Error`."""
    where = _caller(2)
    _emit("FATAL", str(msg), where)
    raise Error(f"[{where}] {msg}")


def _fail(op: str, x: Any, y: Any, msg: Any) -> None:
    detail = f"Check failed: {x!r} {op} {y!r}" if op else \
        f"Check failed: {x!r}"
    if msg:
        detail += f" {msg}"
    raise Error(f"[{_caller(3)}] {detail}")


def CHECK(cond: Any, msg: Any = "") -> None:
    """Raise :class:`Error` when ``cond`` is falsy."""
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


def CHECK_LE(x: Any, y: Any, msg: Any = "") -> None:
    if not (x <= y):
        _fail("<=", x, y, msg)
