"""Shared numpy-vectorized text tokenization for the parsers.

The reference's hot loop is hand-rolled char scanning + ``strtof``
(src/data/strtonum.h:37-300).  The Python-side equivalent vectorizes at the
chunk level with **whole-chunk byte arrays** — no per-line Python loop:

- one 256-entry class-table lookup marks whitespace/newline bytes;
- token boundaries come from shifted-mask comparisons (a token starts at a
  non-ws byte whose predecessor is ws), so start/end/length vectors for the
  whole chunk cost three O(n) passes in C;
- the token matrix is built with a single fancy-indexed gather into an
  ``S``-dtype array (numpy's C parser then bulk-converts via ``astype``);
- per-line token counts come from counting newline bytes before each token
  start — empty lines drop out for free (no token starts inside them).

The port has no native core: this is its only parse engine.

Counterpart of ``dmlc_core_tpu/data/text_np.py`` (a copy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dmlc_core_tpu_torch.utils.logging import CHECK, CHECK_EQ

__all__ = ["tokenize_ws", "split_tokens_at_colon"]

# byte-class tables: bytes.split() whitespace (space \t \n \r \v \f) and the
# line separators bytes.splitlines() honors (\r, \n; \r\n collapses for free
# because grouping only compares newline *counts* for inequality)
_WS_TABLE = np.zeros(256, dtype=bool)
_WS_TABLE[[9, 10, 11, 12, 13, 32]] = True
_NL_TABLE = np.zeros(256, dtype=bool)
_NL_TABLE[[10, 13]] = True

# widest token the gather path will build a dense [n, w] matrix for; a chunk
# with a longer "token" (binary garbage, an unbroken line) falls back to the
# list path, which handles any width at bytes.split() speed
_MAX_GATHER_WIDTH = 256

_S1_EMPTY = np.empty(0, dtype="S1")
_I64_EMPTY = np.empty(0, dtype=np.int64)


def _line_counts(start_pos: np.ndarray, nl_pos: np.ndarray) -> np.ndarray:
    """Per-line token counts: two tokens share a line iff no newline byte
    sits between their start offsets (searchsorted over the newline
    positions — O(n log L), far cheaper than a full-chunk cumsum)."""
    line_of = np.searchsorted(nl_pos, start_pos)
    new_line = np.empty(len(start_pos), dtype=bool)
    new_line[0] = True
    np.not_equal(line_of[1:], line_of[:-1], out=new_line[1:])
    group_starts = np.flatnonzero(new_line)
    counts = np.empty(len(group_starts), dtype=np.int64)
    counts[:-1] = np.diff(group_starts)
    counts[-1] = len(start_pos) - group_starts[-1]
    return counts


def tokenize_ws(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Whitespace-tokenize all non-empty lines of `data`.

    Returns ``(tokens, counts)``: a 1-d S-dtype array of every token in order,
    and the per-line token counts (empty lines dropped — the reference skips
    them, libsvm_parser.h:53-57).
    """
    if not data:
        return _S1_EMPTY, _I64_EMPTY
    arr = np.frombuffer(data, dtype=np.uint8)
    ws = _WS_TABLE[arr]
    nonws = ~ws
    starts = nonws.copy()
    starts[1:] &= ws[:-1]
    start_pos = np.flatnonzero(starts)
    if start_pos.size == 0:
        return _S1_EMPTY, _I64_EMPTY
    ends = nonws
    ends[:-1] &= ws[1:]          # nonws is dead after this: reuse in place
    end_pos = np.flatnonzero(ends)
    lengths = end_pos - start_pos + 1
    counts = _line_counts(start_pos, np.flatnonzero(_NL_TABLE[arr]))

    width = int(lengths.max())
    n = len(start_pos)
    if width > _MAX_GATHER_WIDTH or len(arr) >= 2**31:
        # pathological token (unbroken binary line): the dense gather matrix
        # would be n*width bytes — and a >=2GiB buffer would wrap the int32
        # gather offsets below.  Let C bytes.split() handle both instead
        tokens = np.array(data.split())
        CHECK_EQ(len(tokens), n, "tokenizer boundary count mismatch")
        return tokens, counts

    # gather every token into one [n, width] byte matrix in a single fancy
    # index, then reinterpret the rows as a null-padded S array — no Python
    # bytes objects are ever created.  int32 offsets: chunks are bounded by
    # the 8MB input-split buffer, and halving index memory is ~2x gather
    # throughput
    col32 = np.arange(width, dtype=np.int32)
    idx = start_pos.astype(np.int32)[:, None] + col32
    np.minimum(idx, np.int32(len(arr) - 1), out=idx)  # clamp: masked below
    mat = arr[idx]
    mat[col32 >= lengths[:, None]] = 0
    tokens = mat.reshape(-1).view(f"S{width}")
    return tokens, counts


def split_tokens_at_colon(tokens: np.ndarray):
    """Partition each token at its first ``:``.

    Returns ``(head, has_colon, tail)`` where ``head``/``tail`` are S-dtype
    arrays (tail is b"" when no colon).  Vectorized: one byte-matrix compare
    finds the first colon per token, ``head`` masks bytes at/after it, and
    ``tail`` is a clamped fancy-indexed left-shift of each row.
    """
    if tokens.size == 0:
        return _S1_EMPTY, np.empty(0, dtype=bool), _S1_EMPTY
    tokens = np.ascontiguousarray(tokens)
    width = tokens.dtype.itemsize
    if width == 0:
        return tokens, np.zeros(len(tokens), dtype=bool), tokens
    n = len(tokens)
    mat = tokens.view(np.uint8).reshape(n, width)
    is_colon = mat == 0x3A
    has_colon = is_colon.any(axis=1)
    first = np.where(has_colon, is_colon.argmax(axis=1),
                     width).astype(np.int32)

    col = np.arange(width, dtype=np.int32)
    head = np.where(col < first[:, None], mat, np.uint8(0))
    head = np.ascontiguousarray(head).reshape(-1).view(f"S{width}")

    # tail row i = mat[i, first[i]+1:] — a per-row left shift done as one
    # gather; indexes clamped to a zeros column (S padding is 0 anyway)
    padded = np.zeros((n, width + 1), dtype=np.uint8)
    padded[:, :width] = mat
    idx = first[:, None] + 1 + col
    np.minimum(idx, np.int32(width), out=idx)
    tail = padded[np.arange(n, dtype=np.int32)[:, None], idx]
    tail = np.ascontiguousarray(tail).reshape(-1).view(f"S{width}")
    return head, has_colon, tail


def parse_floats(tokens: np.ndarray, what: str) -> np.ndarray:
    """Bulk str->float32 (the strtof analog); raises with context on garbage."""
    try:
        return tokens.astype(np.float32)
    except ValueError as exc:
        raise ValueError(f"invalid {what} in input: {exc}") from None


def parse_ints(tokens: np.ndarray, dtype, what: str) -> np.ndarray:
    """Bulk str->integer index (the strtoint analog)."""
    try:
        # S->int via float is lossy for huge ids; go through int64 directly
        return tokens.astype(np.int64).astype(dtype)
    except ValueError as exc:
        raise ValueError(f"invalid {what} in input: {exc}") from None
