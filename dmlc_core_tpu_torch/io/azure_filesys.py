"""Azure Blob Storage filesystem (azure://container/path).

Capability parity with the reference's src/io/azure_filesys.{h,cc} (which
wraps the azure-storage-cpp SDK; account/key from env, azure_filesys.cc:38-39).
The rebuild talks the Blob REST API directly with SharedKey authorization —
same zero-SDK stance as the S3 engine:

- ranged GET reads through the same buffered SeekStream pattern;
- writes via Put Block + Put Block List (the multipart-upload analog),
  small blobs as a single Put Blob;
- listing via ``?restype=container&comp=list`` with prefix/delimiter.

Env contract: ``AZURE_STORAGE_ACCOUNT`` + ``AZURE_STORAGE_ACCESS_KEY``
(base64), optional ``AZURE_ENDPOINT`` override (mock/azurite/sovereign clouds).

Counterpart of ``dmlc_core_tpu/io/azure_filesys.py`` (a copy).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import http.client
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from dmlc_core_tpu_torch.io import filesys as fsys
from dmlc_core_tpu_torch.io import fs_metrics
from dmlc_core_tpu_torch.io.net_retry import request_with_retries
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream
from dmlc_core_tpu_torch.param import get_env
from dmlc_core_tpu_torch.registry import Registry
from dmlc_core_tpu_torch.utils.logging import CHECK, log_fatal

__all__ = ["AzureFileSystem"]


class _AzureClient:
    def __init__(self, container: str):
        self.account = os.environ.get("AZURE_STORAGE_ACCOUNT", "")
        key_b64 = os.environ.get("AZURE_STORAGE_ACCESS_KEY", "")
        if not self.account or not key_b64:
            log_fatal("Need AZURE_STORAGE_ACCOUNT and AZURE_STORAGE_ACCESS_KEY "
                      "in the environment to access azure:// paths "
                      "(reference azure_filesys.cc:38-39)")
        self.key = base64.b64decode(key_b64)
        self.container = container
        endpoint = os.environ.get(
            "AZURE_ENDPOINT", f"https://{self.account}.blob.core.windows.net")
        parsed = urllib.parse.urlparse(endpoint)
        self.secure = parsed.scheme != "http"
        self.host = parsed.netloc

    def _sign(self, method: str, path: str, query: Dict[str, str],
              headers: Dict[str, str], content_length: str) -> str:
        canon_headers = "".join(
            f"{k}:{headers[k]}\n" for k in sorted(headers)
            if k.startswith("x-ms-"))
        canon_resource = f"/{self.account}/{self.container}"
        if path:
            canon_resource += f"/{path}"
        for k in sorted(query):
            canon_resource += f"\n{k}:{query[k]}"
        string_to_sign = "\n".join([
            method, "", "", content_length, "", "", "", "", "", "", "",
            headers.get("Range", ""), canon_headers + canon_resource,
        ])
        sig = base64.b64encode(hmac.new(self.key, string_to_sign.encode(),
                                        hashlib.sha256).digest()).decode()
        return f"SharedKey {self.account}:{sig}"

    def request(self, method: str, path: str, query: Optional[Dict] = None,
                body: bytes = b"", headers: Optional[Dict] = None,
                ok: Tuple[int, ...] = (200, 201),
                ) -> Tuple[int, Dict[str, str], bytes]:
        query = {k: str(v) for k, v in (query or {}).items()}
        base_headers = dict(headers or {})
        url = f"/{self.container}"
        if path:
            url += "/" + urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(sorted(query.items()))

        def perform():
            # sign per attempt: x-ms-date must stay within Azure's clock-skew
            # window even after long retry backoffs
            hdrs = dict(base_headers)
            now = datetime.datetime.now(datetime.timezone.utc)
            hdrs["x-ms-date"] = now.strftime("%a, %d %b %Y %H:%M:%S GMT")
            hdrs["x-ms-version"] = "2021-08-06"
            clen = str(len(body)) if body else ""
            hdrs["Authorization"] = self._sign(method, path, query, hdrs,
                                               clen)
            if body:
                hdrs["Content-Length"] = clen
            conn = (http.client.HTTPSConnection if self.secure
                    else http.client.HTTPConnection)(self.host, timeout=60)
            try:
                conn.request(method, url, body=body or None, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                return (resp.status,
                        {k.lower(): v for k, v in resp.getheaders()}, data)
            finally:
                conn.close()

        # shared retry policy (net_retry); Put Block / Put Block List are
        # idempotent per block id, so replays are safe
        def timed_perform():
            # timed per attempt so dmlc_filesystem_request_seconds keeps
            # its one-round-trip meaning (backoff between attempts already
            # lands in dmlc_net_retry_backoff_seconds_total)
            t0 = fs_metrics.request_start()
            attempt = perform()
            fs_metrics.note_request("azure", method, t0,
                                    nread=len(attempt[2]),
                                    nwritten=len(body))
            return attempt

        status, rheaders, data = request_with_retries(
            timed_perform, ok, f"{method} {self.host}{url}")
        if status not in ok:
            log_fatal(f"azure error {status} on {method} {url}: "
                      f"{data[:500]!r}")
        return status, rheaders, data


class _AzureReadStream(SeekStream):
    def __init__(self, client: _AzureClient, path: str, size: int,
                 buffer_bytes: int = 4 << 20):
        self._client = client
        self._path = path
        self._size = size
        self._pos = 0
        self._buf = b""
        self._buf_start = 0
        self._buffer_bytes = buffer_bytes

    def read(self, nbytes: int) -> bytes:
        if self._pos >= self._size:
            return b""
        off = self._pos - self._buf_start
        if not (0 <= off < len(self._buf)):
            end = min(self._pos + max(nbytes, self._buffer_bytes),
                      self._size) - 1
            _, _, data = self._client.request(
                "GET", self._path,
                headers={"Range": f"bytes={self._pos}-{end}"}, ok=(200, 206))
            self._buf, self._buf_start, off = data, self._pos, 0
        out = self._buf[off:off + nbytes]
        self._pos += len(out)
        return out

    def write(self, data: bytes) -> None:
        log_fatal("azure read stream is read-only")

    def seek(self, pos: int) -> None:
        CHECK(0 <= pos <= self._size, f"seek out of range: {pos}")
        self._pos = pos

    def tell(self) -> int:
        return self._pos


class _AzureWriteStream(Stream):
    """Put Block / Put Block List writer (the multipart analog)."""

    def __init__(self, client: _AzureClient, path: str):
        self._client = client
        self._path = path
        self._buffer = bytearray()
        self._block_bytes = get_env("DMLC_AZURE_WRITE_BUFFER_MB", int, 64) << 20
        self._block_ids: List[str] = []
        self._closed = False

    def write(self, data: bytes) -> None:
        self._buffer.extend(data)
        while len(self._buffer) >= self._block_bytes:
            self._put_block(bytes(self._buffer[:self._block_bytes]))
            del self._buffer[:self._block_bytes]

    def _put_block(self, block: bytes) -> None:
        block_id = base64.b64encode(
            f"block-{len(self._block_ids):08d}".encode()).decode()
        self._client.request("PUT", self._path,
                             query={"comp": "block", "blockid": block_id},
                             body=block)
        self._block_ids.append(block_id)

    def abort(self) -> None:
        """Abandon without committing: nothing lands at the path (Put Block
        List in :meth:`close` is the commit point); uncommitted blocks are
        garbage-collected by the service after a week."""
        self._closed = True
        self._buffer.clear()
        self._block_ids.clear()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if not self._block_ids:
            self._client.request("PUT", self._path, body=bytes(self._buffer),
                                 headers={"x-ms-blob-type": "BlockBlob"})
            return
        if self._buffer:
            self._put_block(bytes(self._buffer))
            self._buffer.clear()
        blocks = "".join(f"<Latest>{b}</Latest>" for b in self._block_ids)
        body = f"<BlockList>{blocks}</BlockList>".encode()
        self._client.request("PUT", self._path, query={"comp": "blocklist"},
                             body=body)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AzureFileSystem(fsys.FileSystem):
    """azure://container/path (reference AzureFileSystem)."""

    def _split(self, path: fsys.URI) -> Tuple[_AzureClient, str]:
        return _AzureClient(path.host), path.name.lstrip("/")

    def get_path_info(self, path: fsys.URI) -> fsys.FileInfo:
        client, key = self._split(path)
        status, headers, _ = client.request("HEAD", key, ok=(200, 404))
        if status == 404:
            if self.list_directory(path):
                return fsys.FileInfo(path.copy(), 0, fsys.FileType.DIRECTORY)
            raise FileNotFoundError(path.str())
        return fsys.FileInfo(path.copy(),
                             int(headers.get("content-length", 0)),
                             fsys.FileType.FILE)

    def list_directory(self, path: fsys.URI) -> List[fsys.FileInfo]:
        client, prefix = self._split(path)
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        _, _, data = client.request(
            "GET", "", query={"restype": "container", "comp": "list",
                              "prefix": prefix, "delimiter": "/"})
        root = ET.fromstring(data)
        out: List[fsys.FileInfo] = []
        for blob in root.iter("Blob"):
            sub = path.copy()
            sub.name = "/" + blob.find("Name").text
            size_node = blob.find("Properties/Content-Length")
            size = int(size_node.text) if size_node is not None else 0
            out.append(fsys.FileInfo(sub, size, fsys.FileType.FILE))
        for pfx in root.iter("BlobPrefix"):
            sub = path.copy()
            sub.name = "/" + pfx.find("Name").text.rstrip("/")
            out.append(fsys.FileInfo(sub, 0, fsys.FileType.DIRECTORY))
        return out

    def open(self, path: fsys.URI, mode: str) -> Stream:
        if mode == "r":
            return self.open_for_read(path)
        CHECK(mode == "w", "azure streams support 'r' and 'w' only")
        client, key = self._split(path)
        return _AzureWriteStream(client, key)

    def open_for_read(self, path: fsys.URI) -> SeekStream:
        info = self.get_path_info(path)
        client, key = self._split(path)
        return _AzureReadStream(client, key, info.size)


Registry.get("filesystem").add("azure", AzureFileSystem,
                               description="Azure Blob Storage (SharedKey REST)")
