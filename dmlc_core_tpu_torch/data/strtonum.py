"""Scalar string->number helpers (reference src/data/strtonum.h:37-300).

The bulk path is vectorized in :mod:`dmlc_core_tpu_torch.data.text_np`; these scalar
helpers exist for API parity (ParsePair/ParseTriple are the token grammar of
the libsvm/libfm formats) and for host-side config parsing.

Counterpart of ``dmlc_core_tpu/data/strtonum.py`` (a copy).
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["str2float", "str2int", "parse_pair", "parse_triple"]


def str2float(s: bytes | str) -> float:
    """strtof equivalent (strtonum.h:37-101)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    return float(s)


def str2int(s: bytes | str, base: int = 10) -> int:
    """strtoint/strtouint equivalent (strtonum.h:103-150)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    return int(s, base)


def _tok(s: str) -> list:
    return s.replace(":", " ").split()


def parse_pair(token: bytes | str) -> Tuple[int, Optional[float], Optional[float]]:
    """Parse ``a[:b]``; returns (num_parsed, a, b) (reference ParsePair,
    strtonum.h:227-264)."""
    if isinstance(token, bytes):
        token = token.decode("ascii")
    parts = _tok(token)
    if not parts:
        return 0, None, None
    if len(parts) == 1:
        return 1, float(parts[0]), None
    return 2, float(parts[0]), float(parts[1])


def parse_triple(token: bytes | str) -> Tuple[int, Optional[float], Optional[float], Optional[float]]:
    """Parse ``a[:b[:c]]`` (reference ParseTriple, strtonum.h:265-300)."""
    if isinstance(token, bytes):
        token = token.decode("ascii")
    parts = _tok(token)
    out = [None, None, None]
    for i, p in enumerate(parts[:3]):
        out[i] = float(p)
    return min(len(parts), 3), out[0], out[1], out[2]
