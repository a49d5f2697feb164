"""In-memory streams (reference include/dmlc/memory_io.h:21-103).

Counterpart of ``dmlc_core_tpu/io/memory_io.py`` (a copy).
"""

from __future__ import annotations

from dmlc_core_tpu_torch.io.stream import SeekStream
from dmlc_core_tpu_torch.utils.logging import CHECK, CHECK_LE

__all__ = ["MemoryFixedSizeStream", "MemoryStringStream"]


class MemoryFixedSizeStream(SeekStream):
    """Stream over a fixed-size caller-owned buffer (memory_io.h:21-60).

    Writes past the end raise; reads stop at the buffer end.  The buffer must
    support the writable buffer protocol (bytearray / writable memoryview /
    numpy uint8 array).
    """

    def __init__(self, buffer) -> None:
        self._buf = memoryview(buffer).cast("B")
        self._pos = 0

    def read(self, nbytes: int) -> bytes:
        end = min(self._pos + nbytes, len(self._buf))
        out = bytes(self._buf[self._pos:end])
        self._pos = end
        return out

    def write(self, data: bytes) -> None:
        CHECK_LE(self._pos + len(data), len(self._buf),
                 "MemoryFixedSizeStream: write beyond fixed buffer")
        self._buf[self._pos:self._pos + len(data)] = data
        self._pos += len(data)

    def seek(self, pos: int) -> None:
        CHECK(0 <= pos <= len(self._buf), f"seek out of range: {pos}")
        self._pos = pos

    def tell(self) -> int:
        return self._pos


class MemoryStringStream(SeekStream):
    """Growable stream over a bytearray (memory_io.h:66-103).

    The backing bytearray is shared with the caller: pass one in to write into
    it, or read :attr:`data` afterwards.
    """

    def __init__(self, data: bytearray | None = None) -> None:
        self.data = bytearray() if data is None else data
        self._pos = 0

    def read(self, nbytes: int) -> bytes:
        end = min(self._pos + nbytes, len(self.data))
        out = bytes(self.data[self._pos:end])
        self._pos = end
        return out

    def write(self, data: bytes) -> None:
        end = self._pos + len(data)
        if end > len(self.data):
            self.data.extend(b"\x00" * (end - len(self.data)))
        self.data[self._pos:end] = data
        self._pos = end

    def seek(self, pos: int) -> None:
        CHECK(0 <= pos <= len(self.data), f"seek out of range: {pos}")
        self._pos = pos

    def tell(self) -> int:
        return self._pos
