"""``CHECK``: raise a structured error when a condition fails.

Counterpart of ``dmlc_core_tpu/utils/logging.py`` (only the part the port
uses): the fatal path throws :class:`Error` with the caller's file:line.
"""

from __future__ import annotations

import os
import sys
from typing import Any

__all__ = ["Error", "CHECK"]


class Error(RuntimeError):
    """Raised by a failed :func:`CHECK`."""


def _caller(depth: int) -> str:
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return "?:0"
    return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"


def CHECK(cond: Any, msg: Any = "") -> None:
    """Raise :class:`Error` when ``cond`` is falsy."""
    if not cond:
        detail = f"Check failed: {cond!r}"
        if msg:
            detail += f" {msg}"
        raise Error(f"[{_caller(2)}] {detail}")
