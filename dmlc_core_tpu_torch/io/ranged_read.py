"""Standard-file adapter over the ranged-read FS layer.

The remote page-cache fetch (data/page_cache.py `_open_remote_layout`)
taught the FS layer open-by-footer discipline: `get_path_info` for the
object size, then seek+read spans through one `open_for_read` stream.
Columnar consumers (the Parquet footer/row-group reader) need the same
capability but through the *standard* Python file protocol — relative
`seek(offset, whence)`, `tell`, `read(-1)`, `closed` — because pyarrow
drives the file object itself (footer last, then per-row-group column
chunk ranges).

:class:`RangedReadFile` is that adapter: size learned once up front, every
read a bounded ranged read on the underlying seekable stream, nothing
buffered beyond what the FS stream itself buffers.  It works over any
registered filesystem (s3/http/azure/hdfs/file), so a remote Parquet
source costs exactly footer + touched row groups — never a whole-object
download.

Counterpart of ``dmlc_core_tpu/io/ranged_read.py`` (a copy).
"""

from __future__ import annotations

from dmlc_core_tpu_torch import telemetry

__all__ = ["RangedReadFile"]


class RangedReadFile:
    """Read-only, seekable file object over ``fs.open_for_read(uri)``.

    Implements the subset of the io protocol random-access consumers
    (``pyarrow.parquet.ParquetFile``, zipfile, …) drive: ``read``/``seek``
    (all three whences)/``tell``/``close``/``closed``/``readable``/
    ``seekable`` plus ``size()``.  Reads past EOF return short/empty bytes
    like a regular file, never raise.
    """

    def __init__(self, uri: str):
        from dmlc_core_tpu_torch.io import filesys as fsys

        self._uri = uri
        uri_obj = fsys.URI(uri)
        fs = fsys.get_filesystem(uri_obj)
        self._size = fs.get_path_info(uri_obj).size  # FileNotFoundError here
        self._stream = fs.open_for_read(uri_obj)
        self._pos = 0
        self._closed = False

    # -- io protocol ----------------------------------------------------------
    def read(self, nbytes: int = -1) -> bytes:
        self._check_open()
        if nbytes is None or nbytes < 0:
            nbytes = self._size - self._pos
        nbytes = max(0, min(nbytes, self._size - self._pos))
        if nbytes == 0:
            return b""
        self._stream.seek(self._pos)
        chunks = []
        remaining = nbytes
        while remaining > 0:
            chunk = self._stream.read(remaining)
            if not chunk:
                break
            chunks.append(chunk)
            remaining -= len(chunk)
        data = b"".join(chunks)
        self._pos += len(data)
        telemetry.count("dmlc_ranged_file_read_bytes_total", len(data))
        return data

    def seek(self, offset: int, whence: int = 0) -> int:
        self._check_open()
        if whence == 0:
            pos = offset
        elif whence == 1:
            pos = self._pos + offset
        elif whence == 2:
            pos = self._size + offset
        else:
            raise ValueError(f"invalid whence: {whence}")
        if pos < 0:
            raise OSError(f"negative seek position {pos}")
        self._pos = pos
        return self._pos

    def tell(self) -> int:
        self._check_open()
        return self._pos

    def size(self) -> int:
        return self._size

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def flush(self) -> None:
        pass

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._stream.close()

    def __enter__(self) -> "RangedReadFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError(f"I/O operation on closed file {self._uri!r}")
