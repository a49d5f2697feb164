"""Sharded multi-file input: deterministic byte-range partitioning with
record-boundary realignment, plus threaded/cached/shuffled decorators.

Counterpart of ``dmlc_core_tpu/io/input_split.py``, over every registered
filesystem:

- ``InputSplitBase`` engine (src/io/input_split_base.{h,cc}): ';'-separated
  multi-file lists with regex glob expansion (ConvertToURIs .cc:95-146),
  cumulative size table, aligned partition math with record realignment at both
  shard edges (ResetPartition .cc:29-63), boundary-safe chunk reads with
  overflow carry (ReadChunk .cc:205-233);
- ``LineSplitter`` (src/io/line_split.cc), ``RecordIOSplitter``
  (src/io/recordio_split.cc), ``IndexedRecordIOSplitter``
  (src/io/indexed_recordio_split.cc), ``SingleFileSplit`` (stdin,
  src/io/single_file_split.h);
- ``ThreadedInputSplit`` double-buffered prefetch (src/io/threaded_input_split.h),
  ``CachedInputSplit`` epoch-cache (src/io/cached_input_split.h),
  ``InputSplitShuffle`` macro-shuffling (include/dmlc/input_split_shuffle.h);
- the native split engine (``csrc/native/input_split.cc``):
  ``NativeLineSplitter`` for text and recordio, ``NativeCachedSplitter`` for
  ``#cachefile`` URIs, and the span reader under ``IndexedRecordIOSplitter``;
- the factory (InputSplit::Create, src/io.cc:63-117).

The factory takes the native engine unless ``DMLC_TPU_DISABLE_NATIVE`` is
set or ``threaded=False`` is asked for; then the Python engine runs.  Local
files are read with ``FILE*``; remote ones take the Python engine unless
``DMLC_TPU_NATIVE_REMOTE=1`` asks for the native one, whose byte reads then
go through a read-at callback (``_ReadAtAdapter``).  Both engines yield the
same bytes for every partition.

The invariant that makes partitions disjoint and exhaustive: partition k covers
aligned byte range [k*nstep, (k+1)*nstep) of the *concatenated* file bytes,
with each edge moved forward to the next record head **within the file that
contains it** (file starts are always record heads, so realignment never
crosses a file boundary).
"""

from __future__ import annotations

import bisect
import ctypes
import os
import random
import re
import struct
import sys
from typing import Callable, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch import native_bridge
from dmlc_core_tpu_torch.io import filesys as fsys
from dmlc_core_tpu_torch.io import recordio as rio
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream
from dmlc_core_tpu_torch.io.threadediter import ThreadedIter
from dmlc_core_tpu_torch.io.uri_spec import URISpec
from dmlc_core_tpu_torch.param import get_env
from dmlc_core_tpu_torch.utils.logging import (CHECK, CHECK_EQ, CHECK_LT,
                                               CHECK_NE, log_fatal)

__all__ = [
    "InputSplit",
    "InputSplitBase",
    "LineSplitter",
    "NativeLineSplitter",
    "RecordIOSplitter",
    "IndexedRecordIOSplitter",
    "SingleFileSplit",
    "ThreadedInputSplit",
    "CachedInputSplit",
    "InputSplitShuffle",
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


def _next_recordio_record(cursor: ChunkCursor) -> Optional[memoryview]:
    """Advance a cursor over a chunk of RecordIO frames, reassembling escaped
    (multi-part) records (reference recordio.cc NextRecord)."""
    if cursor.exhausted():
        return None
    data = cursor.data
    CHECK(cursor.pos + 8 <= len(data), "invalid RecordIO format")
    magic, lrec = struct.unpack_from("<II", data, cursor.pos)
    CHECK_EQ(magic, rio.RECORDIO_MAGIC, "invalid RecordIO format")
    cflag, clen = rio.decode_flag(lrec), rio.decode_length(lrec)
    start = cursor.pos + 8
    cursor.pos = start + (((clen + 3) >> 2) << 2)
    CHECK(cursor.pos <= len(data), "invalid RecordIO format")
    if cflag == 0:
        return memoryview(data)[start:start + clen]
    CHECK_EQ(cflag, 1, "invalid RecordIO format")
    parts = [bytes(memoryview(data)[start:start + clen])]
    while cflag != 3:
        CHECK(cursor.pos + 8 <= len(data), "invalid RecordIO format")
        magic, lrec = struct.unpack_from("<II", data, cursor.pos)
        CHECK_EQ(magic, rio.RECORDIO_MAGIC, "invalid RecordIO format")
        cflag, clen = rio.decode_flag(lrec), rio.decode_length(lrec)
        start = cursor.pos + 8
        parts.append(rio._MAGIC_BYTES)
        parts.append(bytes(memoryview(data)[start:start + clen]))
        cursor.pos = start + (((clen + 3) >> 2) << 2)
    return memoryview(b"".join(parts))


class RecordIOSplitter(InputSplitBase):
    """Record = magic-framed RecordIO blob (reference src/io/recordio_split.cc)."""

    def __init__(self, fs: fsys.FileSystem, uri: str, part_index: int, num_parts: int):
        super().__init__(fs, uri, align_bytes=4)
        self.reset_partition(part_index, num_parts)

    def seek_record_begin(self, fs: Stream) -> int:
        # word-scan for magic followed by cflag 0/1 (reference recordio_split.cc:9-26)
        nstep = 0
        pending: bytes = b""
        saw_magic = False
        while True:
            block = pending + fs.read(4096)
            pending = b""
            if len(block) < 4:
                return nstep
            nwords = len(block) // 4
            words = np.frombuffer(block, dtype="<u4", count=nwords)
            i = 0
            while i < nwords:
                if saw_magic:
                    nstep += 4
                    cflag = rio.decode_flag(int(words[i]))
                    saw_magic = False
                    if cflag in (0, 1):
                        return nstep - 8
                    i += 1
                    continue
                if int(words[i]) == rio.RECORDIO_MAGIC:
                    nstep += 4
                    saw_magic = True
                    i += 1
                else:
                    nstep += 4
                    i += 1
            pending = block[nwords * 4:]

    def find_last_record_begin(self, data: bytes) -> int:
        nwords = len(data) // 4
        if nwords < 2:
            return 0
        words = np.frombuffer(data, dtype="<u4", count=nwords)
        cand = np.nonzero(words[:nwords - 1] == rio.RECORDIO_MAGIC)[0]
        flags = (words[cand + 1] >> 29) & 7
        cand = cand[(flags == 0) | (flags == 1)]
        cand = cand[cand > 0]
        return int(cand[-1]) * 4 if cand.size else 0

    def extract_next_record(self, cursor: ChunkCursor) -> Optional[memoryview]:
        return _next_recordio_record(cursor)


class IndexedRecordIOSplitter(RecordIOSplitter):
    """Index-file-driven record partitioning with optional shuffled batches
    (reference src/io/indexed_recordio_split.cc)."""

    KRAND_MAGIC = 111

    def __init__(self, fs: fsys.FileSystem, uri: str, index_uri: str,
                 part_index: int, num_parts: int, batch_size: int = 256,
                 shuffle: bool = False, seed: int = 0):
        InputSplitBase.__init__(self, fs, uri, align_bytes=4)
        self._shuffle = shuffle
        self._rng = random.Random(self.KRAND_MAGIC + seed)
        self._batch_size = batch_size
        self._index: List[Tuple[int, int]] = []  # (offset, size) per record batch head
        self._read_index_file(index_uri)
        self._permutation: List[int] = []
        self._current_index = 0
        self._index_begin = 0
        self._index_end = 0
        self._n_overflow = 0
        # native span reader: index policy (partitioning, shuffle) stays
        # here; the byte-moving + read-ahead runs in C++ unless
        # DMLC_TPU_DISABLE_NATIVE is set when the split is built, or the
        # filesystem is remote without DMLC_TPU_NATIVE_REMOTE=1
        # (_native_unavailable is then permanent); a mid-epoch plan
        # abandonment just drops the reader, and before_first recreates it
        # with a fresh plan
        self._span_reader = None
        self._span_adapter = None
        self._native_unavailable = False
        self._plan_batch = batch_size
        self._popped = 0
        self.reset_partition(part_index, num_parts)

    def _read_index_file(self, index_uri: str) -> None:
        paths = self._convert_to_uris(index_uri)
        CHECK_EQ(len(paths), 1, "IndexedRecordIOSplitter supports a single index file")
        stream = self._filesys.open_for_read(paths[0])
        text = stream.as_file().read().decode("utf-8")
        stream.close()
        offsets = sorted(int(tok.split()[1]) for tok in text.splitlines() if tok.strip())
        CHECK(len(offsets) > 0, "empty index file")
        total = self._file_offset[-1]
        for a, b in zip(offsets, offsets[1:] + [total]):
            self._index.append((a, b - a))
        # array mirror of _index for bulk plan construction (shuffle epochs
        # index one span per record; per-tuple Python loops would pay ~the
        # cost of a small read per epoch at millions of records)
        self._index_arr = np.asarray(self._index, dtype=np.int64)

    # record-count-based partitioning (reference .cc:12-41)
    def reset_partition(self, part_index: int, num_parts: int) -> None:
        ntotal = len(self._index)
        nstep = (ntotal + num_parts - 1) // num_parts
        if part_index * nstep >= ntotal:
            # empty partition: clear ALL cursor state (a previous partition's
            # index window / open stream / native plan must not replay)
            self._offset_begin = self._offset_end = 0
            self._index_begin = self._index_end = 0
            self._current_index = 0
            self._n_overflow = 0
            self._permutation = []
            self._cursor = ChunkCursor()
            self._close_fs()
            if self._span_reader is not None:
                self._span_reader.set_plan([], [], [])
                self._popped = 0
            return
        self._index_begin = part_index * nstep
        self._offset_begin = self._index[self._index_begin][0]
        if (part_index + 1) * nstep < ntotal:
            self._index_end = (part_index + 1) * nstep
            self._offset_end = self._index[self._index_end][0]
        else:
            self._index_end = ntotal
            self._offset_end = self._file_offset[-1]
        self._offset_curr = self._offset_begin
        self._file_ptr = self._upper_bound(self._offset_begin)
        self._file_ptr_end = self._upper_bound(self._offset_end)
        self._close_fs()
        self._fs = self._filesys.open_for_read(self._files[self._file_ptr].path)
        self._n_overflow = 0
        self.before_first()

    def before_first(self) -> None:
        if self._shuffle:
            self._permutation = list(range(self._index_begin, self._index_end))
            self._rng.shuffle(self._permutation)
            self._current_index = 0
        else:
            self._current_index = self._index_begin
        self._n_overflow = 0
        if self._offset_begin < self._offset_end:
            InputSplitBase.before_first(self)
        reader = self._native_reader()
        if reader is not None:
            # set_plan's native Invalidate() sentinel drops cached remote
            # streams + stale errors with the producer joined (race-free)
            offs, szs, counts = self._epoch_plan()
            reader.set_plan(offs, szs, counts)
            self._plan_batch = self._batch_size
            self._popped = 0

    # -- native span fast path ----------------------------------------------
    def _native_reader(self):
        """The C++ span reader, created on first use (the library is built
        then, and a failed build raises); None when the Python engine was
        asked for.  Non-local filesystems read through a _ReadAtAdapter
        callback (opt-in, the same gate as the factory's native_ok)."""
        if self._native_unavailable:
            return None
        if self._span_reader is None:
            local = isinstance(self._filesys, fsys.LocalFileSystem)
            if not native_bridge.enabled() or (
                    not local and not _native_remote_asked()):
                self._native_unavailable = True
                return None
            self._span_adapter = (
                None if local else _ReadAtAdapter(self._filesys, self._files))
            self._span_reader = native_bridge.NativeSpanReader(
                [info.path.name for info in self._files],
                [info.size for info in self._files],
                read_at=self._span_adapter)
        return self._span_reader

    def _epoch_plan(self):
        """(offsets, sizes, batch counts) for one epoch of batch reads."""
        bs = self._batch_size
        if self._offset_begin >= self._offset_end:
            return [], [], []
        if self._shuffle:
            # one span per record, numpy-gathered from the index mirror
            perm = np.asarray(self._permutation, dtype=np.int64)
            spans = self._index_arr[perm]               # [n, 2] (off, size)
            n = len(perm)
            counts = np.full(-(-n // bs), bs, dtype=np.int64)
            if n % bs:
                counts[-1] = n % bs
            return spans[:, 0], spans[:, 1], counts
        # contiguous batches: one span per batch
        heads = np.arange(self._index_begin, self._index_end, bs,
                          dtype=np.int64)
        lasts = np.minimum(heads + bs, self._index_end)
        offs = self._index_arr[heads, 0]
        ends = np.where(lasts == self._index_end, self._offset_end,
                        self._index_arr[np.minimum(lasts,
                                                   len(self._index) - 1), 0])
        return offs, ends - offs, np.ones(len(heads), dtype=np.int64)

    def _resync_from_native(self) -> None:
        """Abandon the native plan (batch size changed mid-epoch): restore
        the Python cursor from the number of batches already delivered.
        The next before_first() recreates the reader with a fresh plan."""
        consumed = self._popped * self._plan_batch
        if self._shuffle:
            self._current_index = min(consumed, len(self._permutation))
        else:
            self._current_index = min(self._index_begin + consumed,
                                      self._index_end)
        self._n_overflow = 0
        if self._span_reader is not None:
            self._span_reader.close()
            self._span_reader = None
        if self._span_adapter is not None:
            self._span_adapter.close()
            self._span_adapter = None

    def _index_offset_end(self, idx: int) -> int:
        if idx < len(self._index):
            return self._index[idx][0]
        return self._file_offset[-1]

    def _seek_to(self, offset: int) -> None:
        fp = self._upper_bound(offset)
        if fp != self._file_ptr or self._fs is None:
            self._close_fs()
            self._file_ptr = fp
            self._fs = self._filesys.open_for_read(self._files[fp].path)
        self._fs.seek(offset - self._file_offset[fp])
        self._offset_curr = offset

    def _read_exact_span(self, offset: int, size: int) -> bytes:
        self._seek_to(offset)
        saved_end = self._offset_end
        self._offset_end = max(self._offset_end, offset + size)
        data = self.read(size)
        self._offset_end = saved_end
        return data

    def next_batch_bytes(self, n_records: int) -> Optional[bytes]:
        """Read the next `n_records` batch as one chunk (reference NextBatchEx)."""
        if self._span_reader is not None and not self._native_unavailable:
            if n_records == self._plan_batch and not self._n_overflow:
                try:
                    chunk = self._span_reader.next_chunk()
                except OSError as exc:
                    _raise_native_error(self._span_adapter, exc)
                if chunk is not None:
                    self._popped += 1
                return chunk
            self._resync_from_native()
        if self._shuffle:
            n = self._n_overflow if self._n_overflow else n_records
            parts: List[bytes] = []
            n_read = 0
            while n_read < n and self._current_index < len(self._permutation):
                off, size = self._index[self._permutation[self._current_index]]
                parts.append(self._read_exact_span(off, size))
                n_read += 1
                self._current_index += 1
            if n_read == 0:
                return None
            self._n_overflow = n - n_read
            return b"".join(parts)
        n = self._n_overflow if self._n_overflow else n_records
        last = min(self._current_index + n, self._index_end)
        self._n_overflow = self._current_index + n - last
        if last == self._current_index:
            return None
        begin_off = self._index[self._current_index][0]
        end_off = self._offset_end if last == self._index_end else self._index[last][0]
        size = end_off - begin_off
        self._current_index = last
        data = self._read_exact_span(begin_off, size)
        return data if data else None

    def next_chunk(self) -> Optional[bytes]:
        return self.next_batch_bytes(self._batch_size)

    def next_chunk_bytes(self) -> Optional[bytes]:
        return self.next_batch_bytes(self._batch_size)

    def next_batch(self, n_records: int) -> Optional[bytes]:
        return self.next_batch_bytes(n_records)

    def set_batch_size(self, batch_size: int) -> None:
        self._batch_size = batch_size

    def set_random_seed(self, seed: int) -> None:
        self._rng = random.Random(self.KRAND_MAGIC + seed)

    def close(self) -> None:
        if self._span_reader is not None:
            self._span_reader.close()
            self._span_reader = None
        if self._span_adapter is not None:
            self._span_adapter.close()
            self._span_adapter = None
        InputSplitBase.close(self)


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


class CachedInputSplit(InputSplit):
    """Epoch-1 streams from the source while teeing chunks into a local cache
    file; later epochs replay the cache (reference src/io/cached_input_split.h)."""

    def __init__(self, base: InputSplitBase, cache_file: str):
        self._base = base
        self._cache_file = cache_file
        self._cursor = ChunkCursor()
        self._preproc = True
        self._cache_fo = open(cache_file, "wb")
        try:
            self._iter = ThreadedIter(self._make_preproc_producer(),
                                      max_capacity=2, name="split_preproc")
        except BaseException:
            # a failed producer bring-up orphans the cache fd (and leaves a
            # zero-byte cache file): the caller never gets the instance,
            # so close() is unreachable
            self._cache_fo.close()
            raise

    def _make_preproc_producer(self):
        parent = self

        class _Producer:
            def before_first(self) -> None:
                parent._base.before_first()

            def next(self, reuse):
                chunk = parent._base.next_chunk_bytes()
                if chunk is None:
                    return None
                parent._cache_fo.write(struct.pack("<Q", len(chunk)))
                parent._cache_fo.write(chunk)
                return chunk

        return _Producer()

    def _make_cache_producer(self):
        parent = self

        class _Producer:
            def __init__(self) -> None:
                self._fi = open(parent._cache_file, "rb")

            def before_first(self) -> None:
                self._fi.seek(0)

            def next(self, reuse):
                header = self._fi.read(8)
                if len(header) < 8:
                    return None
                (size,) = struct.unpack("<Q", header)
                data = self._fi.read(size)
                CHECK_EQ(len(data), size, "corrupt cache file")
                return data

        return _Producer()

    def _finish_preproc(self) -> None:
        # drain the remaining chunks into the cache, then swap producers
        # (reference cached_input_split.h:63-86)
        while self._iter.next() is not None:
            pass
        self._iter.destroy()
        self._cache_fo.close()
        self._base.close()
        self._preproc = False
        self._iter = ThreadedIter(self._make_cache_producer(), max_capacity=2,
                                  name="split_cache")

    def before_first(self) -> None:
        if self._preproc:
            self._finish_preproc()
        else:
            self._iter.before_first()
        self._cursor = ChunkCursor()

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._base.hint_chunk_size(chunk_size)

    def get_total_size(self) -> int:
        return self._base.get_total_size()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        log_fatal("CachedInputSplit does not support reset_partition; "
                  "recreate it with the new shard (cache files are per-part)")

    def next_chunk(self) -> Optional[bytes]:
        chunk = self._iter.next()
        if chunk is None and self._preproc:
            # first epoch exhausted: finalize cache so the next epoch replays it
            self._finish_preproc_tail()
        return chunk

    def _finish_preproc_tail(self) -> None:
        if self._preproc:
            self._iter.destroy()
            self._cache_fo.close()
            self._base.close()
            self._preproc = False
            self._iter = ThreadedIter(self._make_cache_producer(), max_capacity=2,
                                      name="split_cache")
            # leave the new iterator at end-of-epoch state: consume nothing; the
            # caller's before_first() rewinds it.
            while self._iter.next() is not None:
                pass

    def next_record(self) -> Optional[memoryview]:
        return _next_record_from_chunks(self, self.next_chunk,
                                        self._base.extract_next_record)

    def close(self) -> None:
        self._iter.destroy()
        if self._preproc:
            self._cache_fo.close()
        self._base.close()


class InputSplitShuffle(InputSplit):
    """Macro-shuffle: divide this rank's shard into N sub-parts and visit them
    in a reshuffled order each epoch (reference include/dmlc/input_split_shuffle.h)."""

    KRAND_MAGIC = 666

    def __init__(self, uri: str, part_index: int, num_parts: int, type: str,
                 num_shuffle_parts: int, shuffle_seed: int = 0):
        CHECK(num_shuffle_parts > 0, "number of shuffle parts must be positive")
        self._part_index = part_index
        self._num_parts = num_parts
        self._num_shuffle = num_shuffle_parts
        self._rng = random.Random(
            self.KRAND_MAGIC + part_index + num_parts + num_shuffle_parts + shuffle_seed)
        self._indexes = list(range(num_shuffle_parts))
        self._rng.shuffle(self._indexes)
        self._cur = 0
        idx = self._indexes[0] + part_index * num_shuffle_parts
        self._source = create_input_split(
            uri, idx, num_parts * num_shuffle_parts, type)

    @staticmethod
    def create(uri: str, part_index: int, num_parts: int, type: str,
               num_shuffle_parts: int, shuffle_seed: int = 0) -> InputSplit:
        return InputSplitShuffle(uri, part_index, num_parts, type,
                                 num_shuffle_parts, shuffle_seed)

    def _advance_subpart(self) -> bool:
        if self._cur == self._num_shuffle - 1:
            return False
        self._cur += 1
        idx = self._indexes[self._cur] + self._part_index * self._num_shuffle
        self._source.reset_partition(idx, self._num_parts * self._num_shuffle)
        return True

    def before_first(self) -> None:
        if self._num_shuffle > 1:
            self._rng.shuffle(self._indexes)
            idx = self._indexes[0] + self._part_index * self._num_shuffle
            self._source.reset_partition(idx, self._num_parts * self._num_shuffle)
            self._cur = 0
        else:
            self._source.before_first()

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._source.hint_chunk_size(chunk_size)

    def get_total_size(self) -> int:
        return self._source.get_total_size()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        CHECK_EQ(num_parts, self._num_parts, "num_parts is not consistent")
        self._part_index = part_index
        idx = self._indexes[0] + part_index * self._num_shuffle
        self._source.reset_partition(idx, num_parts * self._num_shuffle)
        self._cur = 0

    def next_record(self) -> Optional[memoryview]:
        while True:
            rec = self._source.next_record()
            if rec is not None:
                return rec
            if not self._advance_subpart():
                return None

    def next_chunk(self) -> Optional[bytes]:
        while True:
            chunk = self._source.next_chunk()
            if chunk is not None:
                return chunk
            if not self._advance_subpart():
                return None

    def close(self) -> None:
        self._source.close()


def _native_remote_asked() -> bool:
    """Whether remote reads take the native engine: only under
    ``DMLC_TPU_NATIVE_REMOTE=1``, read on every call."""
    return os.environ.get("DMLC_TPU_NATIVE_REMOTE", "") == "1"


class _ReadAtAdapter:
    """Python half of the native engine's remote path: a READ_AT_FN-shaped
    callable serving (file_idx, offset, size) reads from any FileSystem's
    SeekStreams.  Runs on the native prefetch thread (ctypes takes the GIL
    per call); the first exception is parked on ``.error`` and surfaces as
    the stream error when the consumer next pops a chunk.

    Epoch boundaries arrive as an ``idx < 0`` sentinel call: the native
    engines issue it from ``Invalidate()`` strictly between joining the
    old producer and starting the new one, so dropping cached streams and
    forgetting a stale parked error here can never race an in-flight read.
    A consumer-side reopen flag could clear ``.error`` just before a dying
    read re-parked its dead-epoch exception."""

    def __init__(self, fs: fsys.FileSystem, files):
        self._fs = fs
        self._files = files
        self._streams: dict = {}
        self._pos: dict = {}
        self.error: Optional[BaseException] = None

    def __call__(self, ctx, idx, offset, buf, size) -> int:
        try:
            if idx < 0:
                # invalidate sentinel (new epoch / replaced files): no
                # producer is alive, so teardown + error clear are race-free
                self._close_streams()
                self.error = None
                return 0
            stream = self._streams.get(idx)
            if stream is None:
                stream = self._fs.open_for_read(self._files[idx].path)
                self._streams[idx] = stream
                self._pos[idx] = 0
            if self._pos[idx] != offset:
                stream.seek(offset)
            data = stream.read(size)
            self._pos[idx] = offset + len(data)
            if data:
                ctypes.memmove(buf, data, len(data))
            return len(data)
        except BaseException as exc:  # noqa: BLE001 — ferried to the consumer
            self.error = exc
            return -1

    def _close_streams(self) -> None:
        for stream in self._streams.values():
            try:
                stream.close()
            except Exception:
                pass
        self._streams.clear()

    def close(self) -> None:
        """Final teardown — only call once the native producer is stopped
        (engine closed/drained)."""
        self._close_streams()


def _raise_native_error(adapter: Optional[_ReadAtAdapter],
                        exc: OSError) -> None:
    """Surface the Python-side exception that made the native reader fail,
    falling back to the native error text.  The parked error is consumed so
    a stale epoch's exception can never mask a later unrelated failure."""
    if adapter is not None and adapter.error is not None:
        err, adapter.error = adapter.error, None
        raise err
    raise exc


def _native_split_setup(fs: fsys.FileSystem, uri: str, format: str):
    """Shared NativeLineSplitter/NativeCachedSplitter construction: expand
    the file list exactly like the Python engine, check recordio alignment,
    pick the record extractor, and build the remote read-at adapter."""
    files = _expand_input_files(fs, uri)
    if format == "recordio":
        for info in files:
            CHECK_EQ(info.size % 4, 0,
                     f"file {info.path.str()} does not align by 4 bytes")
    extract = (_next_recordio_record if format == "recordio"
               else _next_line_record)
    adapter = (None if isinstance(fs, fsys.LocalFileSystem)
               else _ReadAtAdapter(fs, files))
    return files, extract, adapter


def _native_ring(adapter) -> int:
    """Native prefetch-ring depth: the classic double buffer locally, a
    deeper pre-posted ring on the remote callback path so one batched
    ``next_chunks`` crossing amortizes the Python-to-C round trip over
    everything the ring buffered (``DMLC_NATIVE_RING`` overrides either
    default)."""
    return max(2, get_env("DMLC_NATIVE_RING", int,
                          2 if adapter is None else 8))


class NativeLineSplitter(InputSplit):
    """C++ split engine with built-in prefetch (csrc/native/input_split.cc).

    Drop-in for ``ThreadedInputSplit(LineSplitter(...))`` (or the RecordIO
    equivalent, ``format="recordio"``): the chunk sharding/realignment loop
    and the double-buffered read-ahead run natively (reference
    src/io/input_split_base.cc + line_split.cc/recordio_split.cc +
    threaded_input_split.h in one).  Local files are read with FILE*
    directly; any other filesystem routes its byte reads through a
    :class:`_ReadAtAdapter` callback, so remote URIs ride the same native
    path.  Selected by the factory unless the Python engine is asked for
    (and, for remote URIs, only under ``DMLC_TPU_NATIVE_REMOTE=1``).
    """

    def __init__(self, fs: fsys.FileSystem, uri: str, part_index: int,
                 num_parts: int, format: str = "line"):
        files, self._extract, self._adapter = _native_split_setup(
            fs, uri, format)
        self._part, self._nparts = part_index, num_parts
        self._buffer_size = DEFAULT_BUFFER_SIZE
        self._native = native_bridge.NativeLineSplit(
            [info.path.name for info in files],
            [info.size for info in files], part_index, num_parts,
            buffer_size=self._buffer_size, format=format,
            read_at=self._adapter, ring=_native_ring(self._adapter))
        self._cursor = ChunkCursor()

    def before_first(self) -> None:
        # reset()'s native Invalidate() sentinel reopens remote streams and
        # clears stale adapter errors between producer join and restart
        self._native.reset(self._part, self._nparts)
        self._cursor = ChunkCursor()

    def hint_chunk_size(self, chunk_size: int) -> None:
        # like the Python engines: grows the chunk buffer in place without
        # disturbing the read position
        if chunk_size > self._buffer_size:
            self._buffer_size = chunk_size
            self._native.hint_chunk_size(chunk_size)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self._part, self._nparts = part_index, num_parts
        self.before_first()

    def next_chunk(self) -> Optional[bytes]:
        try:
            return self._native.next_chunk()
        except OSError as exc:
            _raise_native_error(self._adapter, exc)

    def next_chunk_view(self):
        """Zero-copy ``(addr, len)`` chunk view, valid until the next call
        on this split (consumed in place by the native parsers)."""
        try:
            return self._native.next_chunk_view()
        except OSError as exc:
            _raise_native_error(self._adapter, exc)

    def next_record(self) -> Optional[memoryview]:
        return _next_record_from_chunks(self, self.next_chunk,
                                        self._extract)

    def get_total_size(self) -> int:
        return self._native.total_size()

    def close(self) -> None:
        self._native.close()
        if self._adapter is not None:
            self._adapter.close()


class NativeCachedSplitter(InputSplit):
    """Native cached split: epoch 1 streams the partition through the C++
    engine whose producer tees every chunk into a length-framed cache
    file; later epochs replay the cache with native read-ahead (reference
    src/io/cached_input_split.h:28-189, both halves native, unlike the
    Python :class:`CachedInputSplit`, whose cache file has the same
    frames).  Works over local and remote sources (epoch 1 uses the same
    read-at callback path as :class:`NativeLineSplitter`; the cache itself
    is always local)."""

    def __init__(self, fs: fsys.FileSystem, uri: str, part_index: int,
                 num_parts: int, cache_file: str, format: str = "line"):
        files, self._extract, self._adapter = _native_split_setup(
            fs, uri, format)
        self._cache_file = cache_file
        self._native = native_bridge.NativeLineSplit(
            [info.path.name for info in files],
            [info.size for info in files], part_index, num_parts,
            format=format, read_at=self._adapter, cache_path=cache_file,
            ring=_native_ring(self._adapter))
        self._total = self._native.total_size()
        self._replay = None
        self._at_end = False   # replay exhausted (or just swapped in)
        self._cursor = ChunkCursor()

    def _swap_to_replay(self, at_end: bool) -> None:
        """Finish the preproc epoch (drain + close cache) and hand the
        chunk stream to the native replay engine."""
        try:
            self._native.finish_cache()
        except OSError as exc:
            _raise_native_error(self._adapter, exc)
        self._native.close()
        self._native = None
        if self._adapter is not None:
            self._adapter.close()
            self._adapter = None
        self._replay = native_bridge.NativeCacheReplay(self._cache_file)
        self._at_end = at_end

    def before_first(self) -> None:
        if self._replay is None:
            self._swap_to_replay(at_end=False)
        else:
            self._replay.reset()
            self._at_end = False
        self._cursor = ChunkCursor()

    def _next_chunk_impl(self, preproc_fetch, replay_fetch):
        if self._replay is None:
            try:
                chunk = preproc_fetch()
            except OSError as exc:
                _raise_native_error(self._adapter, exc)
            if chunk is None:
                # first epoch exhausted: finalize the cache; stay at end
                # until the caller's before_first() rewinds the replay
                self._swap_to_replay(at_end=True)
            return chunk
        if self._at_end:
            return None
        chunk = replay_fetch()
        if chunk is None:
            self._at_end = True
        return chunk

    def next_chunk(self) -> Optional[bytes]:
        return self._next_chunk_impl(
            lambda: self._native.next_chunk(),
            lambda: self._replay.next_chunk())

    def next_chunk_view(self):
        """Zero-copy ``(addr, len)`` chunk view, valid until the next call
        on this split."""
        return self._next_chunk_impl(
            lambda: self._native.next_chunk_view(),
            lambda: self._replay.next_chunk_view())

    def next_record(self) -> Optional[memoryview]:
        return _next_record_from_chunks(self, self.next_chunk,
                                        self._extract)

    def hint_chunk_size(self, chunk_size: int) -> None:
        if self._native is not None:
            self._native.hint_chunk_size(chunk_size)

    def get_total_size(self) -> int:
        return self._total

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        log_fatal("NativeCachedSplitter does not support reset_partition; "
                  "recreate it with the new shard (cache files are per-part)")

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None
        if self._adapter is not None:
            self._adapter.close()
            self._adapter = None
        if self._replay is not None:
            self._replay.close()
            self._replay = None


def create_input_split(
    uri: str,
    part_index: int,
    num_parts: int,
    type: str = "text",
    index_uri: Optional[str] = None,
    shuffle: bool = False,
    seed: int = 0,
    batch_size: int = 256,
    threaded: bool = True,
) -> InputSplit:
    """Factory (reference InputSplit::Create, src/io.cc:63-117).

    Supports the URI sugar ``path?k=v#cachefile``; "stdin" or "-" gives a
    :class:`SingleFileSplit`.  ``type`` is "text", "recordio", or
    "indexed_recordio" (requires ``index_uri``).  Text and recordio take
    the native engine unless ``threaded=False`` or
    ``DMLC_TPU_DISABLE_NATIVE`` asks for the Python one; indexed recordio
    reads its batches through the native span reader unless
    ``DMLC_TPU_DISABLE_NATIVE`` is set.  Remote URIs take the Python
    engines unless ``DMLC_TPU_NATIVE_REMOTE=1`` asks for the native one
    (read on every call).
    """
    spec = URISpec(uri, part_index, num_parts)
    if spec.uri in ("stdin", "-"):
        return SingleFileSplit(spec.uri)
    CHECK_LT(part_index, num_parts, "invalid input parameters for create_input_split")
    path = fsys.URI(spec.uri)
    fs = fsys.get_filesystem(path)
    # the native engine serves every filesystem: local files via FILE*,
    # anything else through the read-at callback (_ReadAtAdapter).  Local
    # is the default; remote defaults to the Python engines, as in the JAX
    # package, and takes the native one only under DMLC_TPU_NATIVE_REMOTE=1
    native_ok = threaded and native_bridge.enabled() and (
        isinstance(fs, fsys.LocalFileSystem) or _native_remote_asked())

    if type == "text":
        if native_ok:
            if spec.cache_file:
                return NativeCachedSplitter(fs, spec.uri, part_index,
                                            num_parts, spec.cache_file)
            return NativeLineSplitter(fs, spec.uri, part_index, num_parts)
        split: InputSplitBase = LineSplitter(fs, spec.uri, part_index, num_parts)
    elif type == "recordio":
        if native_ok:
            if spec.cache_file:
                return NativeCachedSplitter(fs, spec.uri, part_index,
                                            num_parts, spec.cache_file,
                                            format="recordio")
            return NativeLineSplitter(fs, spec.uri, part_index, num_parts,
                                      format="recordio")
        split = RecordIOSplitter(fs, spec.uri, part_index, num_parts)
    elif type == "indexed_recordio":
        CHECK(index_uri is not None, "need an index file to use indexed_recordio")
        index_spec = URISpec(index_uri, part_index, num_parts)
        split = IndexedRecordIOSplitter(fs, spec.uri, index_spec.uri, part_index,
                                        num_parts, batch_size, shuffle, seed)
    else:
        log_fatal(f"unknown input split type {type!r}")
    if spec.cache_file:
        return CachedInputSplit(split, spec.cache_file)
    if threaded:
        return ThreadedInputSplit(split)
    return split
