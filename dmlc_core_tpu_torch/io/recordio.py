"""RecordIO: splittable magic-framed binary record format.

Capability parity with the reference (include/dmlc/recordio.h:38-187,
src/recordio.cc:11-156) and format-compatible with it, so ``.rec`` files
written by either implementation interchange:

- every record part is ``[magic u32][lrec u32][payload][pad to 4B]``;
- ``lrec`` packs ``cflag`` (top 3 bits) and payload length (low 29 bits);
- a payload containing the 4-byte-aligned magic word in-band is *escaped* by
  splitting it at each magic cell into parts with cflag 1 (start) / 2 (middle)
  / 3 (end); a plain record has cflag 0 (recordio.h:33-36);
- readers resync from any 4-byte-aligned position by scanning for
  ``magic`` followed by cflag 0/1 — which is what makes the format splittable
  (src/recordio.cc:85-100).

Counterpart of ``dmlc_core_tpu/io/recordio.py``.  The batched write
(``write_records``) frames through the native engine and
``RecordIOChunkReader`` scans through it, unless ``DMLC_TPU_DISABLE_NATIVE``
asks for the numpy path; there the magic-cell scan is vectorized with numpy
(the reference's hand loop, src/recordio.cc:22-38) and escape hits, being
rare, stay scalar.  Both paths write and read the same bytes.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from dmlc_core_tpu_torch import native_bridge
from dmlc_core_tpu_torch.io.stream import Stream
from dmlc_core_tpu_torch.utils.logging import CHECK, CHECK_EQ

__all__ = [
    "RECORDIO_MAGIC",
    "RecordIOWriter",
    "IndexedRecordIOWriter",
    "RecordIOReader",
    "RecordIOChunkReader",
    "encode_lrec",
    "decode_flag",
    "decode_length",
]

# (magic >> 29) & 7 == 6 > 3, so an lrec word can never equal the magic
# (reference recordio.h:40-44).
RECORDIO_MAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", RECORDIO_MAGIC)


def encode_lrec(cflag: int, length: int) -> int:
    return (cflag << 29) | length


def decode_flag(lrec: int) -> int:
    return (lrec >> 29) & 7


def decode_length(lrec: int) -> int:
    return lrec & ((1 << 29) - 1)


def _aligned_magic_positions(data: bytes, limit: int) -> np.ndarray:
    """Byte offsets (multiples of 4, < limit) where the magic word occurs."""
    nwords = limit // 4
    if nwords == 0:
        return np.empty(0, dtype=np.int64)
    words = np.frombuffer(data, dtype="<u4", count=nwords)
    return (np.nonzero(words == RECORDIO_MAGIC)[0] * 4).astype(np.int64)


class RecordIOWriter:
    """Write records onto a stream (reference RecordIOWriter, recordio.cc:11-51)."""

    def __init__(self, stream: Stream):
        self._stream = stream
        self.except_counter = 0  # number of in-band magic escapes performed

    def write_record(self, data: bytes) -> None:
        CHECK(len(data) < (1 << 29), "RecordIO only accepts records below 2^29 bytes")
        if isinstance(data, (bytearray, memoryview)):
            data = bytes(data)
        lower_align = (len(data) >> 2) << 2
        out: List[bytes] = []
        dptr = 0
        for pos in _aligned_magic_positions(data, lower_align):
            pos = int(pos)
            out.append(_MAGIC_BYTES)
            out.append(struct.pack("<I", encode_lrec(1 if dptr == 0 else 2, pos - dptr)))
            out.append(data[dptr:pos])
            dptr = pos + 4
            self.except_counter += 1
        out.append(_MAGIC_BYTES)
        out.append(struct.pack("<I", encode_lrec(3 if dptr != 0 else 0, len(data) - dptr)))
        out.append(data[dptr:])
        pad = (-(len(data) - dptr)) % 4
        if pad:
            out.append(b"\x00" * pad)
        self._stream.write(b"".join(out))

    def write_records(self, records: List[bytes]) -> List[int]:
        """Batch write; returns the stream offset of each record.  Frames
        through the native engine (csrc/native/recordio.cc) unless
        ``DMLC_TPU_DISABLE_NATIVE`` asks for the numpy path."""
        base = self.tell()
        if native_bridge.enabled():
            lens = np.fromiter((len(r) for r in records), dtype=np.int64,
                               count=len(records))
            CHECK(bool((lens < (1 << 29)).all()),
                  "RecordIO only accepts records below 2^29 bytes")
            framed, offsets, nexc = native_bridge.recordio_frame(
                b"".join(records), lens)
            self._stream.write(framed)
            self.except_counter += nexc
            return [base + int(o) for o in offsets]
        out = []
        for rec in records:
            out.append(self.tell())
            # unbound base call: subclasses (IndexedRecordIOWriter) track
            # offsets in their write_records override, not per record here
            RecordIOWriter.write_record(self, rec)
        return out

    def tell(self) -> int:
        return self._stream.tell()


class IndexedRecordIOWriter(RecordIOWriter):
    """RecordIO writer that also tracks the index-file entries consumed by
    :class:`dmlc_core_tpu_torch.io.input_split.IndexedRecordIOSplitter` (text lines
    of ``<record-id> <byte-offset>``, reference indexed_recordio_split.cc
    ReadIndexFile)."""

    def __init__(self, stream: Stream):
        super().__init__(stream)
        self.offsets: List[int] = []
        self._next_id = 0

    def write_record(self, data: bytes) -> None:
        self.offsets.append(self.tell())
        super().write_record(data)
        self._next_id += 1

    def write_records(self, records: List[bytes]) -> List[int]:
        offs = super().write_records(records)
        self.offsets.extend(offs)
        self._next_id += len(records)
        return offs

    def save_index(self, index_stream: Stream) -> None:
        text = "".join(f"{i} {off}\n" for i, off in enumerate(self.offsets))
        index_stream.write(text.encode("ascii"))


class RecordIOReader:
    """Sequentially read records from a stream (reference recordio.cc:53-83)."""

    def __init__(self, stream: Stream):
        self._stream = stream
        self._eos = False

    def next_record(self) -> Optional[bytes]:
        """Next logical record, or None at end of stream."""
        if self._eos:
            return None
        parts: List[bytes] = []
        while True:
            header = self._stream.read(8)
            if len(header) == 0 and not parts:
                self._eos = True
                return None
            CHECK_EQ(len(header), 8, "invalid RecordIO file: truncated header")
            magic, lrec = struct.unpack("<II", header)
            CHECK_EQ(magic, RECORDIO_MAGIC, "invalid RecordIO file: bad magic")
            cflag, length = decode_flag(lrec), decode_length(lrec)
            upper_align = ((length + 3) >> 2) << 2
            payload = self._stream.read_exact(upper_align) if upper_align else b""
            parts.append(payload[:length])
            if cflag in (0, 3):
                break
            parts.append(_MAGIC_BYTES)  # escaped in-band magic cell
        return b"".join(parts)

    def __iter__(self):
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def find_next_record_head(chunk: bytes, start: int, end: int) -> int:
    """First 4-aligned offset in [start, end) holding a record head (magic +
    cflag 0/1); ``end`` when none (reference FindNextRecordIOHead,
    recordio.cc:85-100)."""
    CHECK_EQ(start % 4, 0)
    words = np.frombuffer(chunk, dtype="<u4", count=len(chunk) // 4)
    sw, ew = start // 4, end // 4
    for widx in np.nonzero(words[sw:ew - 1] == RECORDIO_MAGIC)[0]:
        cflag = decode_flag(int(words[sw + int(widx) + 1]))
        if cflag in (0, 1):
            return (sw + int(widx)) * 4
    return end


class RecordIOChunkReader:
    """Parse records out of an in-memory chunk, optionally sub-partitioned for
    parallel parsing (reference RecordIOChunkReader, recordio.cc:102-156)."""

    def __init__(self, chunk: bytes, part_index: int = 0, num_parts: int = 1):
        self._chunk = bytes(chunk) if isinstance(chunk, (bytearray, memoryview)) else chunk
        size = len(self._chunk)
        nstep = (size + num_parts - 1) // num_parts
        nstep = ((nstep + 3) >> 2) << 2
        begin = min(size, nstep * part_index)
        end = min(size, nstep * (part_index + 1))
        # native path: one C++ pass over the partition up front
        # (csrc/native/recordio.cc), then per-record emission walks arrays
        self._scan = None
        self._scan_i = 0
        if native_bridge.enabled():
            head, plen, escaped, pbegin, pend = native_bridge.recordio_scan(
                self._chunk, begin, end)
            self._scan = (head, plen, escaped)
            self._pbegin, self._pend = pbegin, pend
            return
        self._pbegin = find_next_record_head(self._chunk, begin, size)
        self._pend = find_next_record_head(self._chunk, end, size)

    def _next_record_scanned(self) -> Optional[memoryview]:
        head, plen, escaped = self._scan
        i = self._scan_i
        if i >= len(head):
            return None
        self._scan_i = i + 1
        start = int(head[i])
        length = int(plen[i])
        view = memoryview(self._chunk)
        if not escaped[i]:
            return view[start + 8:start + 8 + length]
        # rare: reassemble the escaped parts natively (restores the in-band
        # magic cells; the scan already validated the part structure)
        out = native_bridge.recordio_extract(self._chunk, start, length)
        CHECK_EQ(len(out), length, "invalid RecordIO format")
        return memoryview(out)

    def next_record(self) -> Optional[memoryview]:
        """Next record (zero-copy memoryview for unescaped records), or None."""
        if self._scan is not None:
            return self._next_record_scanned()
        if self._pbegin >= self._pend:
            return None
        view = memoryview(self._chunk)
        magic, lrec = struct.unpack_from("<II", self._chunk, self._pbegin)
        CHECK_EQ(magic, RECORDIO_MAGIC, "invalid RecordIO format")
        cflag, clen = decode_flag(lrec), decode_length(lrec)
        if cflag == 0:
            start = self._pbegin + 8
            self._pbegin = start + (((clen + 3) >> 2) << 2)
            CHECK(self._pbegin <= self._pend, "invalid RecordIO format")
            return view[start:start + clen]
        CHECK_EQ(cflag, 1, "invalid RecordIO format")
        parts: List[bytes] = []
        while True:
            CHECK(self._pbegin + 8 <= self._pend, "invalid RecordIO format")
            magic, lrec = struct.unpack_from("<II", self._chunk, self._pbegin)
            CHECK_EQ(magic, RECORDIO_MAGIC, "invalid RecordIO format")
            cflag, clen = decode_flag(lrec), decode_length(lrec)
            parts.append(self._chunk[self._pbegin + 8:self._pbegin + 8 + clen])
            self._pbegin += 8 + (((clen + 3) >> 2) << 2)
            if cflag == 3:
                break
            parts.append(_MAGIC_BYTES)
        return memoryview(b"".join(parts))

    def __iter__(self):
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec
