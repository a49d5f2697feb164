"""Abstract byte streams + typed read/write helpers.

Counterpart of ``dmlc_core_tpu/io/stream.py`` (a copy).

Capability parity with the reference's ``dmlc::Stream``/``SeekStream``/
``Serializable`` (include/dmlc/io.h:29-126) and the iostream adapters
(io.h:295-419; in Python, :meth:`Stream.as_file` wraps a stream into a
file-like object).

Typed helpers use little-endian fixed-width layouts with ``uint64`` length
prefixes for strings/vectors, matching the reference serializer's on-disk
layout (include/dmlc/serializer.h POD + vector handlers) so that blobs written
by either side of the C++/Python boundary interoperate.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

import numpy as np

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.utils.logging import CHECK, CHECK_EQ

__all__ = [
    "Stream",
    "SeekStream",
    "Serializable",
    "create_stream",
    "create_stream_for_read",
]


class Stream:
    """Abstract byte stream (reference io.h:29-86)."""

    def read(self, nbytes: int) -> bytes:
        """Read up to ``nbytes``; b"" at end of stream."""
        raise NotImplementedError

    def write(self, data: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- exact-size reads ----------------------------------------------------
    def read_exact(self, nbytes: int) -> bytes:
        """Read exactly ``nbytes`` or raise (short read = corrupt input)."""
        chunks = []
        remaining = nbytes
        if fault.enabled():
            # an injected truncation models a cut object/dropped connection:
            # the stream "ends" early and the short-read CHECK below fires
            remaining = fault.truncate("io.stream.read", nbytes)
        while remaining > 0:
            chunk = self.read(remaining)
            if not chunk:
                break
            chunks.append(chunk)
            remaining -= len(chunk)
        data = b"".join(chunks)
        CHECK_EQ(len(data), nbytes, "short read: truncated stream")
        return data

    # -- typed scalar IO (reference io.h:71-85 Write<T>/Read<T>) -------------
    def write_scalar(self, value: Any, fmt: str) -> None:
        """Write one scalar with a struct format char, little-endian."""
        self.write(struct.pack("<" + fmt, value))

    def read_scalar(self, fmt: str) -> Any:
        size = struct.calcsize("<" + fmt)
        return struct.unpack("<" + fmt, self.read_exact(size))[0]

    def write_u32(self, v: int) -> None:
        self.write_scalar(v, "I")

    def read_u32(self) -> int:
        return self.read_scalar("I")

    def write_u64(self, v: int) -> None:
        self.write_scalar(v, "Q")

    def read_u64(self) -> int:
        return self.read_scalar("Q")

    def write_i64(self, v: int) -> None:
        self.write_scalar(v, "q")

    def read_i64(self) -> int:
        return self.read_scalar("q")

    def write_f64(self, v: float) -> None:
        self.write_scalar(v, "d")

    def read_f64(self) -> float:
        return self.read_scalar("d")

    # -- string / array IO ---------------------------------------------------
    def write_string(self, s: bytes | str) -> None:
        """uint64 length + raw bytes (reference serializer string layout)."""
        if isinstance(s, str):
            s = s.encode("utf-8")
        self.write_u64(len(s))
        self.write(s)

    def read_string(self) -> bytes:
        n = self.read_u64()
        return self.read_exact(n)

    def write_array(self, arr: np.ndarray) -> None:
        """uint64 element count + raw little-endian POD data (vector<T>
        layout).  LE is pinned regardless of host order (reference
        include/dmlc/endian.h contract); on LE hosts the astype is a
        no-copy no-op."""
        arr = np.ascontiguousarray(arr)
        CHECK(arr.dtype.kind in "iuf", f"write_array: non-POD dtype {arr.dtype}")
        self.write_u64(arr.size)
        self.write(arr.astype(arr.dtype.newbyteorder("<"),
                              copy=False).tobytes())

    def read_array(self, dtype: np.dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        n = self.read_u64()
        data = self.read_exact(n * dtype.itemsize)
        # bytes on the wire are LE; hand back the caller's native dtype
        return (np.frombuffer(data, dtype=dtype.newbyteorder("<"))
                .astype(dtype, copy=False).copy())

    # -- adapters -------------------------------------------------------------
    def as_file(self) -> "_StreamFile":
        """File-like wrapper (the reference's dmlc::ostream/istream, io.h:295-419)."""
        return _StreamFile(self)


class SeekStream(Stream):
    """Stream with random access (reference io.h:89-109)."""

    def seek(self, pos: int) -> None:
        raise NotImplementedError

    def tell(self) -> int:
        raise NotImplementedError


class Serializable:
    """Objects that save/load onto a Stream (reference io.h:112-126).

    This is the checkpoint contract: "checkpoint = save to any URI".
    """

    def save(self, stream: Stream) -> None:
        raise NotImplementedError

    def load(self, stream: Stream) -> None:
        raise NotImplementedError


class _StreamFile:
    """Minimal file-object adapter over a Stream."""

    def __init__(self, stream: Stream):
        self._stream = stream
        self._readbuf = b""

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = [self._readbuf]
            self._readbuf = b""
            while True:
                chunk = self._stream.read(1 << 20)
                if not chunk:
                    break
                chunks.append(chunk)
            return b"".join(chunks)
        out = self._readbuf[:n]
        self._readbuf = self._readbuf[n:]
        while len(out) < n:
            chunk = self._stream.read(n - len(out))
            if not chunk:
                break
            out += chunk
        return out

    def readline(self) -> bytes:
        while b"\n" not in self._readbuf:
            chunk = self._stream.read(1 << 16)
            if not chunk:
                out, self._readbuf = self._readbuf, b""
                return out
            self._readbuf += chunk
        idx = self._readbuf.index(b"\n") + 1
        out, self._readbuf = self._readbuf[:idx], self._readbuf[idx:]
        return out

    def __iter__(self):
        while True:
            line = self.readline()
            if not line:
                return
            yield line

    def write(self, data: bytes) -> int:
        self._stream.write(data)
        return len(data)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._stream.close()


def create_stream(uri: str, mode: str, allow_null: bool = False) -> Optional[Stream]:
    """URI-dispatched stream factory (reference Stream::Create, src/io.cc:119-125).

    ``mode`` is "r"/"w"/"a".  Dispatch by URI protocol is handled by
    :func:`dmlc_core_tpu_torch.io.filesys.get_filesystem`.
    """
    from dmlc_core_tpu_torch.io import filesys

    CHECK(mode in ("r", "w", "a"), f"invalid stream mode {mode!r}")
    uri_obj = filesys.URI(uri)
    fs = filesys.get_filesystem(uri_obj)
    try:
        with telemetry.span("io.stream.open",
                            protocol=uri_obj.protocol or "file://",
                            mode=mode):
            if fault.enabled():
                fault.inject("io.stream.open", uri=uri, mode=mode)
            return fs.open(uri_obj, mode)
    except (OSError, IOError):
        if allow_null:
            return None
        raise


def create_stream_for_read(uri: str, allow_null: bool = False) -> Optional[SeekStream]:
    """Seekable read stream (reference SeekStream::CreateForRead, io.h:107-108)."""
    from dmlc_core_tpu_torch.io import filesys

    uri_obj = filesys.URI(uri)
    fs = filesys.get_filesystem(uri_obj)
    try:
        with telemetry.span("io.stream.open",
                            protocol=uri_obj.protocol or "file://",
                            mode="r"):
            if fault.enabled():
                fault.inject("io.stream.open", uri=uri, mode="r")
            return fs.open_for_read(uri_obj)
    except (OSError, IOError):
        if allow_null:
            return None
        raise
