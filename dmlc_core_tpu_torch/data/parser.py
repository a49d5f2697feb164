"""Parser iteration protocol + threaded decorator + text-chunk parallelism.

Counterpart of ``dmlc_core_tpu/data/parser.py``.  Parity with the
reference's parser core (src/data/parser.h:23-126) and ``TextParserBase``
(src/data/text_parser.h:24-118):

- :class:`Parser` — the ``DataIter<RowBlock>`` protocol (data.h:52-63):
  ``before_first`` / ``next`` / ``bytes_read``;
- :class:`ParserImpl` — block-vector iteration (parser.h:30-44): subclasses
  produce lists of :class:`RowBlockContainer` per source chunk;
- :class:`TextParserBase` — one InputSplit chunk is cut into per-worker
  sub-ranges realigned at newlines and parsed in parallel (FillData,
  text_parser.h:89-118); workers run in a thread pool (the reference's OpenMP
  team) and the heavy lifting is vectorized numpy, which releases the GIL.
  That is the numpy engine.  By default a whole chunk goes to the native
  C++ parser instead (:mod:`dmlc_core_tpu_torch.native_bridge`), which
  threads internally, and a native split hands it the chunk in place;
  ``DMLC_TPU_DISABLE_NATIVE`` asks for the numpy engine.
  With ``DMLC_PARSE_PROC=N`` the numpy engine's fan-out moves to worker
  *processes* whose RowBlock columns come back through shared memory with
  zero copies (:mod:`dmlc_core_tpu_torch.data.parse_proc`) — off while the
  native engine parses chunks, with a clean fallback to the thread path;
- :class:`ThreadedParser` — prefetch decorator running the whole parse on a
  producer thread with a bounded queue (parser.h:70-126, capacity 8); the
  queue is additionally bounded by decoded-block *bytes*
  (``DMLC_PARSE_QUEUE_BYTES``, default 256 MiB), since 8 blocks of wide CSV
  can dwarf 8 blocks of sparse libsvm.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from dmlc_core_tpu_torch import native_bridge, telemetry
from dmlc_core_tpu_torch.data import parse_proc
from dmlc_core_tpu_torch.data.row_block import RowBlock, RowBlockContainer, concat_blocks
from dmlc_core_tpu_torch.io.input_split import InputSplit
from dmlc_core_tpu_torch.io.threadediter import ThreadedIter
from dmlc_core_tpu_torch.utils.logging import CHECK, log_info, log_warning

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
        self._nproc = parse_proc.resolve_nproc()
        self._proc_pool: Optional[parse_proc.ProcParsePool] = None
        self._proc_off = self._nproc < 2
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

    def parse_chunk_native(self, data) -> Optional[RowBlockContainer]:
        """Whole-chunk parse through the native engine (bytes or a
        zero-copy ``(addr, len)`` view); None for a format without a native
        parser.  The native parser threads internally (the reference's
        OpenMP team, text_parser.h:100-115)."""
        return None

    def _proc_spec(self):
        """``(module, class, kwargs)`` rebuilding a source-less, thread-less
        twin of this parser inside each worker process.  Subclasses whose
        constructor takes extra state (CSV args) extend the kwargs."""
        idx = np.dtype(getattr(self, "_index_dtype", np.uint32))
        return (type(self).__module__, type(self).__qualname__,
                {"nthread": 1, "index_dtype": idx.str})

    def _get_proc_pool(self) -> Optional[parse_proc.ProcParsePool]:
        """The lazy process pool, or None (off / native engine / failed)."""
        if self._proc_off:
            return None
        if self._proc_pool is not None and not self._proc_pool.alive():
            # the shared pool this handle was built on died (worker kill):
            # drop the handle so a retried epoch self-heals on a fresh pool
            self._proc_pool = None
        if self._proc_pool is None:
            if native_bridge.enabled():
                # the native parser threads internally without the GIL;
                # stacking processes on top only costs transport
                log_info(f"{parse_proc.ENV_NPROC}={self._nproc} is not used: "
                         "the native engine parses whole chunks (set "
                         "DMLC_TPU_DISABLE_NATIVE=1 for the process pool)")
                self._proc_off = True
                return None
            try:
                self._proc_pool = parse_proc.ProcParsePool(
                    self._proc_spec(), self._nproc)
            except Exception as exc:  # noqa: BLE001 - any bring-up failure
                log_warning("process parse backend unavailable "
                            f"({exc!r}); falling back to threads")
                self._proc_off = True
                return None
        return self._proc_pool

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
        native = native_bridge.enabled()
        # None while the native engine is on: the pool switches itself off
        pool = self._get_proc_pool()
        # zero-copy path: a native split hands an (addr, len) view over its
        # resident chunk buffer and the native parser reads it in place, with
        # no Python bytes between the two C++ stages
        view_fn = getattr(self._source, "next_chunk_view", None)
        if native and view_fn is not None:
            view = view_fn()
            if view is None:
                return None
            self._bytes_read += view[1]
            block = self.parse_chunk_native(view)
            if block is not None:
                return [block]
            # a format without a native parser: materialize, fall through
            chunk = ctypes.string_at(*view)
        else:
            chunk = self._source.next_chunk()
            if chunk is None:
                return None
            self._bytes_read += len(chunk)
            if native:
                block = self.parse_chunk_native(chunk)
                if block is not None:
                    return [block]
        ranges = self._split_ranges(chunk, pool.nproc if pool is not None
                                    else self._nthread)
        if pool is not None and len(ranges) > 1:
            return pool.parse_ranges(ranges, parser_name=type(self).__name__)
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
        if self._proc_pool is not None:
            self._proc_pool.close()
            self._proc_pool = None
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
