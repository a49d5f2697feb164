"""Small common helpers (reference: include/dmlc/common.h:20-45).

Counterpart of ``dmlc_core_tpu/utils/common.py`` (a copy).
"""

from __future__ import annotations

from typing import List

__all__ = ["split_string", "hash_combine"]


def split_string(s: str, delim: str) -> List[str]:
    """Split a string by a single-char delimiter, dropping empty tokens.

    Matches the reference's ``dmlc::Split`` (common.h:20-32), which is built on
    istream getline and therefore never yields empty fields.
    """
    return [t for t in s.split(delim) if t != ""]


def hash_combine(seed: int, value: int) -> int:
    """Combine hash values boost-style (reference common.h:38-44), mod 2**64."""
    seed ^= (hash(value) + 0x9E3779B9 + ((seed << 6) & 0xFFFFFFFFFFFFFFFF) + (seed >> 2)) & 0xFFFFFFFFFFFFFFFF
    return seed & 0xFFFFFFFFFFFFFFFF
