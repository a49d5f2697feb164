"""Parser iteration protocol + threaded decorator + text-chunk parallelism.

Counterpart of ``dmlc_core_tpu/data/parser.py`` on the thread pool only: no
process pool (``DMLC_PARSE_PROC`` is not read) and no native C++ parser.
Parity with the reference's parser core (src/data/parser.h:23-126) and
``TextParserBase`` (src/data/text_parser.h:24-118):

- :class:`Parser` — the ``DataIter<RowBlock>`` protocol (data.h:52-63):
  ``before_first`` / ``next`` / ``bytes_read``;
- :class:`ParserImpl` — block-vector iteration (parser.h:30-44): subclasses
  produce lists of :class:`RowBlockContainer` per source chunk;
- :class:`TextParserBase` — one InputSplit chunk is cut into per-worker
  sub-ranges realigned at newlines and parsed in parallel (FillData,
  text_parser.h:89-118); workers run in a thread pool (the reference's OpenMP
  team) and the heavy lifting is vectorized numpy, which releases the GIL;
- :class:`ThreadedParser` — prefetch decorator running the whole parse on a
  producer thread with a bounded queue (parser.h:70-126, capacity 8); the
  queue is additionally bounded by decoded-block *bytes*
  (``DMLC_PARSE_QUEUE_BYTES``, default 256 MiB), since 8 blocks of wide CSV
  can dwarf 8 blocks of sparse libsvm.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.data.row_block import RowBlock, RowBlockContainer, concat_blocks
from dmlc_core_tpu_torch.io.input_split import InputSplit
from dmlc_core_tpu_torch.io.threadediter import ThreadedIter
from dmlc_core_tpu_torch.utils.logging import CHECK, log_warning

__all__ = ["Parser", "ParserImpl", "TextParserBase", "ThreadedParser"]

DEFAULT_PARSE_QUEUE_BYTES = 256 << 20


def _parse_queue_bytes() -> Optional[int]:
    """DMLC_PARSE_QUEUE_BYTES: decoded-bytes bound for the parse prefetch
    queue (<=0 disables the byte bound; item-count capacity still applies)."""
    raw = os.environ.get("DMLC_PARSE_QUEUE_BYTES", "").strip()
    if not raw:
        return DEFAULT_PARSE_QUEUE_BYTES
    try:
        value = int(raw)
    except ValueError:
        log_warning(f"ignoring non-integer DMLC_PARSE_QUEUE_BYTES={raw!r}")
        return DEFAULT_PARSE_QUEUE_BYTES
    return value if value > 0 else None


class Parser:
    """DataIter over RowBlocks (reference Parser<IndexType>, data.h:252-285)."""

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> Optional[RowBlock]:
        """Next batch, or None at end of data."""
        raise NotImplementedError

    def bytes_read(self) -> int:
        raise NotImplementedError

    def __iter__(self):
        while True:
            block = self.next()
            if block is None:
                return
            yield block


class ParserImpl(Parser):
    """Block-vector iteration protocol (reference parser.h:30-66)."""

    def __init__(self):
        self._blocks: List[RowBlock] = []
        self._pos = 0

    def parse_next_blocks(self) -> Optional[List[RowBlockContainer]]:
        """Produce the containers parsed from the next source chunk (or None)."""
        raise NotImplementedError

    def next(self) -> Optional[RowBlock]:
        while self._pos >= len(self._blocks):
            containers = self.parse_next_blocks()
            if containers is None:
                # drop the last chunk's blocks at EOF
                self._blocks, self._pos = [], 0
                return None
            self._blocks = [c.get_block() for c in containers if c.size > 0]
            self._pos = 0
        block = self._blocks[self._pos]
        self._pos += 1
        return block


class TextParserBase(ParserImpl):
    """Chunk -> per-worker newline-realigned sub-ranges -> parallel parse."""

    def __init__(self, source: InputSplit, nthread: int = 2):
        super().__init__()
        self._source = source
        self._bytes_read = 0
        self._nthread = max(1, nthread)
        # acquired last: every statement after this is a plain assignment,
        # so a constructor failure can never orphan the executor
        self._pool = (ThreadPoolExecutor(max_workers=self._nthread,
                                         thread_name_prefix="dmlc-parse")
                      if self._nthread > 1 else None)

    def before_first(self) -> None:
        self._source.before_first()
        self._blocks, self._pos = [], 0

    def bytes_read(self) -> int:
        return self._bytes_read

    def parse_block(self, data: bytes) -> RowBlockContainer:
        """Parse one newline-delimited byte range (per-format)."""
        raise NotImplementedError

    def parse_next_blocks(self) -> Optional[List[RowBlockContainer]]:
        """One source chunk -> containers, with per-chunk telemetry (span +
        ``dmlc_parser_{rows,bytes}_total``, labeled by parser class)."""
        before = self._bytes_read
        with telemetry.span("parser.parse_chunk",
                            parser=type(self).__name__) as sp:
            out = self._parse_next_blocks_impl()
            if out is not None and telemetry.enabled():
                nrows = sum(c.size for c in out)
                nbytes = self._bytes_read - before
                sp.set(rows=nrows, nbytes=nbytes)
                telemetry.count("dmlc_parser_rows_total", nrows,
                                parser=type(self).__name__)
                telemetry.count("dmlc_parser_bytes_total", nbytes,
                                parser=type(self).__name__)
        return out

    def _parse_next_blocks_impl(self) -> Optional[List[RowBlockContainer]]:
        chunk = self._source.next_chunk()
        if chunk is None:
            return None
        self._bytes_read += len(chunk)
        ranges = self._split_ranges(chunk, self._nthread)
        if self._pool is None or len(ranges) <= 1:
            return [self.parse_block(r) for r in ranges]
        return list(self._pool.map(self.parse_block, ranges))

    @staticmethod
    def _split_ranges(chunk: bytes, n: int) -> List[bytes]:
        """Cut into ~n ranges ending on newlines (reference FillData +
        BackFindEndLine, text_parser.h:71-118)."""
        total = len(chunk)
        if total == 0:
            return []
        step = (total + n - 1) // n
        ranges: List[bytes] = []
        begin = 0
        while begin < total:
            end = min(begin + step, total)
            if end < total:
                nl = chunk.rfind(b"\n", begin, end)
                nr = chunk.rfind(b"\r", begin, end)
                cut = max(nl, nr)
                if cut < begin:
                    # no newline inside the range: extend to the next one
                    nxt = chunk.find(b"\n", end)
                    cut = nxt if nxt >= 0 else total - 1
                end = cut + 1
            ranges.append(chunk[begin:end])
            begin = end
        return ranges

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        self._source.close()


class _ParseProducer:
    def __init__(self, base: ParserImpl):
        self._base = base

    def before_first(self) -> None:
        self._base.before_first()

    def next(self, reuse):
        block = self._base.next()
        return block  # None ends the epoch


class ThreadedParser(Parser):
    """Prefetch decorator: parsing runs on a producer thread
    (reference ThreadedParser, parser.h:70-126, queue capacity 8).

    The queue is bounded both by item count and by decoded-block bytes
    (``max_bytes``, default from ``DMLC_PARSE_QUEUE_BYTES``): 8 queued
    blocks is ~8x chunk_size x fan-out of decoded arrays, which for wide
    rows can be gigabytes — the byte bound keeps prefetch memory flat
    regardless of row shape."""

    def __init__(self, base: ParserImpl, max_capacity: int = 8,
                 max_bytes: Optional[int] = None):
        self._base = base
        if max_bytes is None:
            max_bytes = _parse_queue_bytes()
        self._iter = ThreadedIter(_ParseProducer(base),
                                  max_capacity=max_capacity, name="parse",
                                  max_bytes=max_bytes,
                                  cost_fn=RowBlock.memory_cost_bytes)

    def before_first(self) -> None:
        self._iter.before_first()

    def next(self) -> Optional[RowBlock]:
        return self._iter.next()

    def bytes_read(self) -> int:
        return self._base.bytes_read()

    def close(self) -> None:
        self._iter.destroy()
        if hasattr(self._base, "close"):
            self._base.close()
