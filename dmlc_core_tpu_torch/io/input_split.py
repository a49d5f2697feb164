"""Sharded multi-file text input: deterministic byte-range partitioning
with record-boundary realignment, plus a threaded read-ahead decorator.

Counterpart of ``dmlc_core_tpu/io/input_split.py``, text path on local
files only: ``InputSplitBase`` (';'-separated multi-file lists with regex
glob expansion, cumulative size table, aligned partition math with record
realignment at both shard edges, boundary-safe chunk reads with overflow
carry), ``LineSplitter``, ``SingleFileSplit`` (stdin) and
``ThreadedInputSplit``.  The port has one engine, this Python one; the JAX
package takes the same engine when its native library is absent, so the
bytes each partition yields are the same.  Recordio, indexed recordio, the
``#cachefile`` cache and the shuffle decorator are not ported yet.

The invariant that makes partitions disjoint and exhaustive: partition k covers
aligned byte range [k*nstep, (k+1)*nstep) of the *concatenated* file bytes,
with each edge moved forward to the next record head **within the file that
contains it** (file starts are always record heads, so realignment never
crosses a file boundary).
"""

from __future__ import annotations

import bisect
import os
import re
import sys
from typing import Callable, List, Optional

from dmlc_core_tpu_torch.io import filesys as fsys
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream
from dmlc_core_tpu_torch.io.threadediter import ThreadedIter
from dmlc_core_tpu_torch.io.uri_spec import URISpec
from dmlc_core_tpu_torch.utils.logging import (CHECK, CHECK_EQ, CHECK_LT,
                                               CHECK_NE, log_fatal)

__all__ = [
    "InputSplit",
    "InputSplitBase",
    "LineSplitter",
    "SingleFileSplit",
    "ThreadedInputSplit",
    "create_input_split",
]

# default chunk buffer: 8 MB (reference kBufferSize = 2<<20 uint32 words,
# src/io/input_split_base.h:40)
DEFAULT_BUFFER_SIZE = 8 << 20

class ChunkCursor:
    """A consumer-side view over one chunk of bytes, advanced record by record
    (the reference's Chunk begin/end pointer pair)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes = b""):
        self.data = data
        self.pos = len(data) if not data else 0

    def exhausted(self) -> bool:
        return self.pos >= len(self.data)


class InputSplit:
    """Abstract record input split (reference include/dmlc/io.h:135-280)."""

    def before_first(self) -> None:
        raise NotImplementedError

    def next_record(self) -> Optional[memoryview]:
        """Next record as a zero-copy view (invalidated by the next call)."""
        raise NotImplementedError

    def next_chunk(self) -> Optional[bytes]:
        """Next chunk of whole records, for chunk-parallel parsing."""
        raise NotImplementedError

    def hint_chunk_size(self, chunk_size: int) -> None:
        pass

    def get_total_size(self) -> int:
        raise NotImplementedError

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __iter__(self):
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec

    # factory — see create_input_split below
    @staticmethod
    def create(uri: str, part_index: int, num_parts: int, type: str = "text",
               **kwargs) -> "InputSplit":
        return create_input_split(uri, part_index, num_parts, type, **kwargs)


def _convert_to_uris(fs: fsys.FileSystem, uri: str) -> List[fsys.URI]:
    """';'-list + regex-glob expansion (reference ConvertToURIs, .cc:95-146)."""
    expanded: List[fsys.URI] = []
    for token in uri.split(";"):
        if not token:
            continue
        path = fsys.URI(token)
        pos = path.name.rfind("/")
        if pos < 0 or pos + 1 == len(path.name):
            expanded.append(path)
            continue
        parent = path.copy()
        parent.name = path.name[:pos]
        try:
            dfiles = fs.list_directory(parent)
        except OSError:
            expanded.append(path)
            continue
        stripped_target = path.name.rstrip("/")
        exact = [f for f in dfiles if f.path.name.rstrip("/") == stripped_target]
        if exact:
            expanded.append(exact[0].path)
            continue
        # regex expansion against the directory listing
        try:
            pattern = re.compile(path.name)
        except re.error as exc:
            log_fatal(f"bad regex {path.name!r}: {exc}")
        for f in dfiles:
            if f.type != fsys.FileType.FILE or f.size == 0:
                continue
            if pattern.fullmatch(f.path.name.rstrip("/")):
                expanded.append(f.path)
    return expanded


def _expand_input_files(fs: fsys.FileSystem, uri: str) -> List[fsys.FileInfo]:
    """Expanded, non-empty input files for a (possibly ;-listed/glob) URI."""
    files: List[fsys.FileInfo] = []
    for path in _convert_to_uris(fs, uri):
        info = fs.get_path_info(path)
        if info.type == fsys.FileType.DIRECTORY:
            for sub in fs.list_directory(info.path):
                if sub.size != 0 and sub.type == fsys.FileType.FILE:
                    files.append(sub)
        elif info.size != 0:
            files.append(info)
    CHECK_NE(len(files), 0,
             f"cannot find any files that match the URI pattern {uri!r}")
    return files


def _next_record_from_chunks(holder, fetch_chunk: Callable, extract: Callable
                             ) -> Optional[memoryview]:
    """Shared drain-cursor-else-refill loop; ``holder`` owns ``._cursor``."""
    while True:
        rec = extract(holder._cursor)
        if rec is not None:
            return rec
        chunk = fetch_chunk()
        if chunk is None:
            return None
        holder._cursor = ChunkCursor(chunk)


class InputSplitBase(InputSplit):
    """Byte-range sharding engine over a list of files."""

    def __init__(self, fs: fsys.FileSystem, uri: str, align_bytes: int):
        self._filesys = fs
        self._align = align_bytes
        self._files: List[fsys.FileInfo] = []
        self._init_input_file_info(uri)
        offsets = [0]
        for info in self._files:
            CHECK_EQ(info.size % align_bytes, 0,
                     f"file {info.path.str()} does not align by {align_bytes} bytes")
            offsets.append(offsets[-1] + info.size)
        self._file_offset = offsets
        self._fs: Optional[SeekStream] = None
        self._file_ptr = 0
        self._file_ptr_end = 0
        self._offset_begin = 0
        self._offset_end = 0
        self._offset_curr = 0
        self._overflow = b""
        self._buffer_size = DEFAULT_BUFFER_SIZE
        self._cursor = ChunkCursor()

    # -- file-list expansion (reference ConvertToURIs, .cc:95-146) -----------
    def _convert_to_uris(self, uri: str) -> List[fsys.URI]:
        return _convert_to_uris(self._filesys, uri)

    def _init_input_file_info(self, uri: str) -> None:
        self._files.extend(_expand_input_files(self._filesys, uri))

    # -- partition math (reference ResetPartition, .cc:29-63) ----------------
    def reset_partition(self, part_index: int, num_parts: int) -> None:
        ntotal = self._file_offset[-1]
        nstep = (ntotal + num_parts - 1) // num_parts
        nstep = ((nstep + self._align - 1) // self._align) * self._align
        self._offset_begin = min(nstep * part_index, ntotal)
        self._offset_end = min(nstep * (part_index + 1), ntotal)
        self._offset_curr = self._offset_begin
        if self._offset_begin == self._offset_end:
            self._cursor = ChunkCursor()
            self._overflow = b""
            return
        self._file_ptr = self._upper_bound(self._offset_begin)
        self._file_ptr_end = self._upper_bound(self._offset_end)
        self._close_fs()
        # realign the end edge to the next record head inside its file
        if self._offset_end != self._file_offset[self._file_ptr_end]:
            fs = self._filesys.open_for_read(self._files[self._file_ptr_end].path)
            fs.seek(self._offset_end - self._file_offset[self._file_ptr_end])
            self._offset_end += self.seek_record_begin(fs)
            fs.close()
        # realign the begin edge likewise
        self._fs = self._filesys.open_for_read(self._files[self._file_ptr].path)
        if self._offset_begin != self._file_offset[self._file_ptr]:
            self._fs.seek(self._offset_begin - self._file_offset[self._file_ptr])
            self._offset_begin += self.seek_record_begin(self._fs)
        self.before_first()

    def _upper_bound(self, offset: int) -> int:
        """Index of the file containing byte `offset` of the concatenation."""
        return bisect.bisect_right(self._file_offset, offset) - 1

    def before_first(self) -> None:
        if self._offset_begin >= self._offset_end:
            return
        fp = self._upper_bound(self._offset_begin)
        if self._fs is None or self._file_ptr != fp:
            self._close_fs()
            self._file_ptr = fp
            self._fs = self._filesys.open_for_read(self._files[fp].path)
        self._fs.seek(self._offset_begin - self._file_offset[self._file_ptr])
        self._offset_curr = self._offset_begin
        self._cursor = ChunkCursor()
        self._overflow = b""

    def get_total_size(self) -> int:
        return self._file_offset[-1]

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._buffer_size = max(chunk_size, self._buffer_size)

    def _close_fs(self) -> None:
        if self._fs is not None:
            self._fs.close()
            self._fs = None

    def close(self) -> None:
        self._close_fs()

    # -- reading (reference Read/ReadChunk, .cc:171-233) ---------------------
    def read(self, size: int) -> bytes:
        """Read up to `size` bytes of this partition, crossing file boundaries."""
        if self._offset_begin >= self._offset_end or self._fs is None:
            return b""
        size = min(size, self._offset_end - self._offset_curr)
        if size == 0:
            return b""
        out = bytearray()
        while len(out) < size:
            chunk = self._fs.read(size - len(out))
            if chunk:
                out.extend(chunk)
                self._offset_curr += len(chunk)
                continue
            CHECK_EQ(self._offset_curr, self._file_offset[self._file_ptr + 1],
                     "file offset not calculated correctly")
            if self._file_ptr + 1 >= len(self._files):
                break
            self._file_ptr += 1
            self._close_fs()
            self._fs = self._filesys.open_for_read(self._files[self._file_ptr].path)
        return bytes(out)

    def read_chunk(self, max_size: int) -> Optional[bytes]:
        """One chunk ending at a record boundary.

        Returns None at partition end; b"" when `max_size` is too small to hold
        one full record (caller grows the buffer — reference's *size=0 signal).
        """
        if max_size <= len(self._overflow):
            return b""
        head, self._overflow = self._overflow, b""
        data = head + self.read(max_size - len(head))
        if not data:
            return None
        if len(data) != max_size:
            return data  # partition tail: ends exactly at the realigned edge
        cut = self.find_last_record_begin(data)
        self._overflow = data[cut:]
        return data[:cut]

    def next_chunk_bytes(self) -> Optional[bytes]:
        """Next non-empty chunk, growing the buffer for oversized records
        (reference Chunk::Load, .cc:235-252)."""
        size = self._buffer_size
        while True:
            chunk = self.read_chunk(size)
            if chunk is None:
                return None
            if chunk == b"":
                size *= 2
                continue
            return chunk

    def next_chunk(self) -> Optional[bytes]:
        return self.next_chunk_bytes()

    def next_record(self) -> Optional[memoryview]:
        return _next_record_from_chunks(self, self.next_chunk_bytes,
                                        self.extract_next_record)

    # -- per-format hooks ----------------------------------------------------
    def seek_record_begin(self, fs: Stream) -> int:
        """Bytes to skip from the current position to the next record head."""
        raise NotImplementedError

    def find_last_record_begin(self, data: bytes) -> int:
        """Offset of the last record head in `data` (0 if none beyond start)."""
        raise NotImplementedError

    def extract_next_record(self, cursor: ChunkCursor) -> Optional[memoryview]:
        raise NotImplementedError


def _next_line_record(cursor: ChunkCursor) -> Optional[memoryview]:
    """Advance a cursor over a chunk of lines (reference line_split.cc:36-55)."""
    if cursor.exhausted():
        return None
    data, pos = cursor.data, cursor.pos
    ln = data.find(b"\n", pos)
    lr = data.find(b"\r", pos)
    if ln < 0:
        p = lr if lr >= 0 else len(data)
    elif lr < 0:
        p = ln
    else:
        p = min(ln, lr)
    rec = memoryview(data)[pos:p]
    # skip the newline run (reference line_split.cc:42-45)
    while p < len(data) and data[p] in (0x0A, 0x0D):
        p += 1
    cursor.pos = p
    return rec


class LineSplitter(InputSplitBase):
    """Record = line (reference src/io/line_split.cc)."""

    def __init__(self, fs: fsys.FileSystem, uri: str, part_index: int, num_parts: int):
        super().__init__(fs, uri, align_bytes=1)
        self.reset_partition(part_index, num_parts)

    def seek_record_begin(self, fs: Stream) -> int:
        # scan to the first end-of-line, then past the newline run
        # (reference line_split.cc:9-26); over-reading is fine because the
        # engine re-seeks before reading data.
        nstep = 0
        seen_eol = False
        while True:
            block = fs.read(4096)
            if not block:
                return nstep
            for b in block:
                if not seen_eol:
                    nstep += 1
                    if b in (0x0A, 0x0D):
                        seen_eol = True
                else:
                    if b in (0x0A, 0x0D):
                        nstep += 1
                    else:
                        return nstep

    def find_last_record_begin(self, data: bytes) -> int:
        n = max(data.rfind(b"\n"), data.rfind(b"\r"))
        return n + 1 if n > 0 else 0

    def extract_next_record(self, cursor: ChunkCursor) -> Optional[memoryview]:
        return _next_line_record(cursor)




class SingleFileSplit(InputSplit):
    """Line records from a single file or stdin, no partitioning
    (reference src/io/single_file_split.h:27-173)."""

    def __init__(self, uri: str):
        self._cursor = ChunkCursor()
        self._buffer_size = DEFAULT_BUFFER_SIZE
        self._eof = False
        # opened last: a constructor failure after the open would orphan
        # the fd (no caller ever holds the instance to close it)
        if uri in ("stdin", "-"):
            self._f = sys.stdin.buffer
            self._stdin = True
        else:
            self._f = open(uri, "rb")
            self._stdin = False

    def before_first(self) -> None:
        CHECK(not self._stdin, "cannot rewind stdin")
        self._f.seek(0)
        self._cursor = ChunkCursor()
        self._eof = False

    def get_total_size(self) -> int:
        if self._stdin:
            return 0
        return os.fstat(self._f.fileno()).st_size

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        CHECK_EQ(num_parts, 1, "SingleFileSplit does not support partitioning")
        self.before_first()

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._buffer_size = max(chunk_size, self._buffer_size)

    def next_chunk(self) -> Optional[bytes]:
        if self._eof:
            return None
        data = self._f.read(self._buffer_size)
        if not data:
            self._eof = True
            return None
        if data[-1:] not in (b"\n", b"\r"):
            # extend to the end of the line
            extra = bytearray()
            while True:
                c = self._f.read(1)
                if not c:
                    self._eof = True
                    break
                extra += c
                if c in (b"\n", b"\r"):
                    break
            data += bytes(extra)
        return data

    def next_record(self) -> Optional[memoryview]:
        while True:
            rec = LineSplitter.extract_next_record(self, self._cursor)  # type: ignore[arg-type]
            if rec is not None:
                return rec
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._cursor = ChunkCursor(chunk)

    def close(self) -> None:
        if not self._stdin:
            self._f.close()


class _ChunkProducer:
    """ThreadedIter producer yielding chunks from an InputSplitBase."""

    def __init__(self, base: InputSplitBase):
        self._base = base

    def before_first(self) -> None:
        self._base.before_first()

    def next(self, reuse):
        return self._base.next_chunk_bytes()


class ThreadedInputSplit(InputSplit):
    """Double-buffered read-ahead decorator (reference
    src/io/threaded_input_split.h:23-101; ThreadedIter capacity 2)."""

    def __init__(self, base: InputSplitBase):
        self._base = base
        self._iter: ThreadedIter = ThreadedIter(_ChunkProducer(base), max_capacity=2,
                                                name="split_chunk")
        self._cursor = ChunkCursor()

    def before_first(self) -> None:
        self._iter.before_first()
        self._cursor = ChunkCursor()

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._base.hint_chunk_size(chunk_size)

    def get_total_size(self) -> int:
        return self._base.get_total_size()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        # pause the producer, reshard, restart (reference threaded_input_split.h:55-60)
        self._iter.destroy()
        self._base.reset_partition(part_index, num_parts)
        self._iter = ThreadedIter(_ChunkProducer(self._base), max_capacity=2,
                                  name="split_chunk")
        self._cursor = ChunkCursor()

    def next_chunk(self) -> Optional[bytes]:
        return self._iter.next()

    def next_record(self) -> Optional[memoryview]:
        return _next_record_from_chunks(self, self._iter.next,
                                        self._base.extract_next_record)

    def close(self) -> None:
        self._iter.destroy()
        self._base.close()


def create_input_split(
    uri: str,
    part_index: int,
    num_parts: int,
    type: str = "text",
    threaded: bool = True,
) -> InputSplit:
    """Factory (reference InputSplit::Create, src/io.cc:63-117).

    "stdin" or "-" gives a :class:`SingleFileSplit`.  Only ``type="text"``
    is ported; recordio, indexed recordio and ``#cachefile`` URIs raise.
    """
    spec = URISpec(uri, part_index, num_parts)
    if spec.uri in ("stdin", "-"):
        return SingleFileSplit(spec.uri)
    CHECK_LT(part_index, num_parts, "invalid input parameters for create_input_split")
    if type in ("recordio", "indexed_recordio"):
        log_fatal(f"input split type {type!r} is not yet in the PyTorch port "
                  f"(ROADMAP §1: recordio splits)")
    if type != "text":
        log_fatal(f"unknown input split type {type!r}")
    CHECK(not spec.cache_file,
          f"'#{spec.cache_file}' cache files are not yet in the PyTorch port "
          f"(ROADMAP §1: cached splits)")
    path = fsys.URI(spec.uri)
    split = LineSplitter(fsys.get_filesystem(path), spec.uri, part_index,
                         num_parts)
    if threaded:
        return ThreadedInputSplit(split)
    return split
