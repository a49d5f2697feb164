"""Read-only http:// and https:// filesystem.

The reference routes http/https URIs to its S3 reader (src/io.cc:44-48);
here they get a plain ranged-GET stream with no signing, useful for public
datasets.  Seek uses Range requests when the server supports them, else
re-streams from the start.

Counterpart of ``dmlc_core_tpu/io/http_filesys.py`` (a copy).
"""

from __future__ import annotations

import http.client
import urllib.parse
from typing import List

from dmlc_core_tpu_torch.io import filesys as fsys
from dmlc_core_tpu_torch.io import fs_metrics
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream
from dmlc_core_tpu_torch.registry import Registry
from dmlc_core_tpu_torch.utils.logging import CHECK, log_fatal

__all__ = ["HTTPFileSystem"]


class _HTTPReadStream(SeekStream):
    def __init__(self, secure: bool, host: str, path: str, size: int,
                 accept_ranges: bool, buffer_bytes: int = 4 << 20):
        self._secure = secure
        self._host = host
        self._path = path
        self._size = size
        self._ranges = accept_ranges
        self._pos = 0
        self._buf = b""
        self._buf_start = 0
        self._buffer_bytes = buffer_bytes

    def _fetch(self, start: int, length: int) -> bytes:
        conn = (http.client.HTTPSConnection if self._secure
                else http.client.HTTPConnection)(self._host, timeout=60)
        t0 = fs_metrics.request_start()
        try:
            headers = {}
            if self._ranges:
                headers["Range"] = f"bytes={start}-{start + length - 1}"
            conn.request("GET", self._path, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            fs_metrics.note_request("http", "GET", t0, nread=len(data))
            CHECK(resp.status in (200, 206),
                  f"http error {resp.status} for {self._path}")
            if resp.status == 200 and self._ranges:
                self._ranges = False
            if not self._ranges:
                return data[start:start + length]
            return data
        finally:
            conn.close()

    def read(self, nbytes: int) -> bytes:
        if self._size and self._pos >= self._size:
            return b""
        off = self._pos - self._buf_start
        if not (0 <= off < len(self._buf)):
            want = max(nbytes, self._buffer_bytes)
            if self._size:
                want = min(want, self._size - self._pos)
            self._buf = self._fetch(self._pos, want)
            self._buf_start = self._pos
            off = 0
            if not self._buf:
                return b""
        out = self._buf[off:off + nbytes]
        self._pos += len(out)
        return out

    def write(self, data: bytes) -> None:
        log_fatal("http streams are read-only")

    def seek(self, pos: int) -> None:
        self._pos = pos

    def tell(self) -> int:
        return self._pos


class HTTPFileSystem(fsys.FileSystem):
    def _head(self, path: fsys.URI):
        secure = path.protocol == "https://"
        conn = (http.client.HTTPSConnection if secure
                else http.client.HTTPConnection)(path.host, timeout=60)
        try:
            conn.request("HEAD", path.name or "/")
            resp = conn.getresponse()
            resp.read()
            headers = {k.lower(): v for k, v in resp.getheaders()}
            return resp.status, headers, secure
        finally:
            conn.close()

    def get_path_info(self, path: fsys.URI) -> fsys.FileInfo:
        status, headers, _ = self._head(path)
        if status >= 400:
            raise FileNotFoundError(path.str())
        return fsys.FileInfo(path.copy(),
                             int(headers.get("content-length", 0)),
                             fsys.FileType.FILE)

    def list_directory(self, path: fsys.URI) -> List[fsys.FileInfo]:
        log_fatal("http filesystem does not support directory listing")

    def open(self, path: fsys.URI, mode: str) -> Stream:
        CHECK(mode == "r", "http streams are read-only")
        return self.open_for_read(path)

    def open_for_read(self, path: fsys.URI) -> SeekStream:
        status, headers, secure = self._head(path)
        if status >= 400:
            raise FileNotFoundError(path.str())
        return _HTTPReadStream(secure, path.host, path.name or "/",
                               int(headers.get("content-length", 0)),
                               headers.get("accept-ranges", "") == "bytes")


Registry.get("filesystem").add("http", HTTPFileSystem,
                               description="read-only http")
Registry.get("filesystem").add("https", HTTPFileSystem,
                               description="read-only https")
