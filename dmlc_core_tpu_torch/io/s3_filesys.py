"""S3 (and S3-compatible) filesystem: buffered range-GET reads, multipart
uploads, ListObjectsV2 — over http.client with SigV4 signing.

Capability parity with the reference's src/io/s3_filesys.{h,cc} (1.1k LoC of
libcurl state machine):

- :class:`S3ReadStream` — seekable buffered reads via ranged GETs
  (CURLReadStreamBase::FillBuffer, s3_filesys.cc:392+);
- :class:`S3WriteStream` — multipart upload: parts buffered to
  ``DMLC_S3_WRITE_BUFFER_MB`` (default 64, reference s3_filesys.cc:560) and
  PUT on overflow; completion XML POSTed on close (s3_filesys.cc:551-798);
  small objects fall back to a single PUT;
- list/stat via ListObjectsV2 + HEAD (ListObjects, s3_filesys.cc:801+);
- credentials/region from the same env contract (AWS_ACCESS_KEY_ID,
  AWS_SECRET_ACCESS_KEY, AWS_SESSION_TOKEN, AWS_REGION, s3_filesys.cc:890-918),
  plus ``S3_ENDPOINT`` / ``S3_VERIFY_SSL`` overrides for S3-compatible stores
  and test servers.

GCS rides the same engine through its S3-interoperability XML API — see
:class:`GCSFileSystem`.

Counterpart of ``dmlc_core_tpu/io/s3_filesys.py`` (a copy).
"""

from __future__ import annotations

import hashlib
import http.client
import os
import ssl
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from dmlc_core_tpu_torch.io import filesys as fsys
from dmlc_core_tpu_torch.io import fs_metrics
from dmlc_core_tpu_torch.io.aws_sig import Credentials, sign_request
from dmlc_core_tpu_torch.io.net_retry import request_with_retries
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream
from dmlc_core_tpu_torch.param import get_env
from dmlc_core_tpu_torch.registry import Registry
from dmlc_core_tpu_torch.utils.logging import CHECK, log_fatal

__all__ = ["S3FileSystem", "GCSFileSystem"]

_EMPTY_SHA = hashlib.sha256(b"").hexdigest()

# metadata key marking which multipart upload produced an object (see
# S3WriteStream._init_multipart)
_TOKEN_HEADER = "x-amz-meta-dmlc-write-token"


class _S3Client:
    """One bucket-scoped signed HTTP client."""

    def __init__(self, bucket: str, env_prefix: str = "AWS",
                 default_endpoint: Optional[str] = None, service: str = "s3"):
        self.bucket = bucket
        key_id = (os.environ.get(f"{env_prefix}_ACCESS_KEY_ID")
                  or os.environ.get("AWS_ACCESS_KEY_ID"))
        secret = (os.environ.get(f"{env_prefix}_SECRET_ACCESS_KEY")
                  or os.environ.get("AWS_SECRET_ACCESS_KEY"))
        if not key_id or not secret:
            log_fatal(
                f"Need {env_prefix}_ACCESS_KEY_ID/{env_prefix}_SECRET_ACCESS_KEY "
                f"(or AWS_*) in the environment to access {service}://{bucket}")
        region = (os.environ.get("AWS_REGION")
                  or os.environ.get("AWS_DEFAULT_REGION") or "us-east-1")
        self.creds = Credentials(key_id, secret,
                                 os.environ.get("AWS_SESSION_TOKEN"), region)
        endpoint = (os.environ.get("S3_ENDPOINT") or default_endpoint
                    or f"https://s3.{region}.amazonaws.com")
        parsed = urllib.parse.urlparse(endpoint)
        self.secure = parsed.scheme != "http"
        self.host = parsed.netloc
        # path-style addressing keeps one endpoint working for real S3,
        # GCS-interop, minio, and the in-process mock server
        self.base_path = f"/{bucket}"
        self.service = service

    def _connect(self) -> http.client.HTTPConnection:
        if self.secure:
            ctx = None
            if get_env("S3_VERIFY_SSL", str, "1") == "0":
                ctx = ssl._create_unverified_context()
            return http.client.HTTPSConnection(self.host, context=ctx, timeout=60)
        return http.client.HTTPConnection(self.host, timeout=60)

    def request(self, method: str, key: str, query: Optional[Dict] = None,
                body: bytes = b"", headers: Optional[Dict] = None,
                ok: Tuple[int, ...] = (200,)) -> Tuple[int, Dict[str, str], bytes]:
        """One signed request with connection-reestablishing retry (see
        :mod:`.net_retry` for the shared failure/backoff policy).

        All client request types are safe to repeat: GETs/HEADs are
        idempotent, part PUTs re-upload the same part, and a retried
        complete-multipart POST is reconciled by the 404 handling in
        :meth:`S3WriteStream.close`.
        """
        query = {k: str(v) for k, v in (query or {}).items()}
        path = self.base_path + ("/" + key.lstrip("/") if key else "")
        payload_hash = hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA
        # quote_via=quote: spaces must travel as %20, the form sign_request
        # canonicalizes — urlencode's default '+' is signed differently and
        # real endpoints 403 it (SignatureDoesNotMatch)
        qs = urllib.parse.urlencode(sorted(query.items()),
                                    quote_via=urllib.parse.quote)
        # the wire path must be the percent-encoded form (spaces/unicode in
        # keys are illegal in an HTTP request line); sign_request encodes
        # the raw path identically for the canonical URI, so wire == signed
        url = (urllib.parse.quote(path, safe="/-_.~")
               + (f"?{qs}" if qs else ""))

        def perform():
            # sign per attempt: long backoffs must not outlive the SigV4
            # clock-skew window on a replayed x-amz-date
            signed = sign_request(self.creds, method, self.host, path, query,
                                  dict(headers or {}), payload_hash,
                                  service="s3")
            conn = self._connect()
            try:
                conn.request(method, url, body=body or None, headers=signed)
                resp = conn.getresponse()
                data = resp.read()
                return (resp.status,
                        {k.lower(): v for k, v in resp.getheaders()}, data)
            finally:
                conn.close()

        def timed_perform():
            # timed per attempt so dmlc_filesystem_request_seconds keeps
            # its one-round-trip meaning (backoff between attempts already
            # lands in dmlc_net_retry_backoff_seconds_total)
            t0 = fs_metrics.request_start()
            attempt = perform()
            fs_metrics.note_request(self.service, method, t0,
                                    nread=len(attempt[2]),
                                    nwritten=len(body))
            return attempt

        status, rheaders, data = request_with_retries(
            timed_perform, ok, f"{method} {self.host}{url}")
        if status not in ok:
            log_fatal(f"{self.service} error {status} on "
                      f"{method} {url}: {data[:500]!r}")
        return status, rheaders, data


class S3ReadStream(SeekStream):
    """Buffered ranged-GET reader (reference ReadStream, s3_filesys.cc:462+)."""

    def __init__(self, client: _S3Client, key: str, size: int,
                 buffer_bytes: int = 4 << 20):
        self._client = client
        self._key = key
        self._size = size
        self._pos = 0
        self._buf = b""
        self._buf_start = 0
        self._buffer_bytes = buffer_bytes

    def read(self, nbytes: int) -> bytes:
        if self._pos >= self._size:
            return b""
        # serve from buffer when possible
        off = self._pos - self._buf_start
        if not (0 <= off < len(self._buf)):
            fetch = max(nbytes, self._buffer_bytes)
            end = min(self._pos + fetch, self._size) - 1
            status, _, data = self._client.request(
                "GET", self._key, headers={"Range": f"bytes={self._pos}-{end}"},
                ok=(200, 206))
            self._buf = data
            self._buf_start = self._pos
            off = 0
        out = self._buf[off:off + nbytes]
        self._pos += len(out)
        return out

    def write(self, data: bytes) -> None:
        log_fatal("S3ReadStream is read-only")

    def seek(self, pos: int) -> None:
        CHECK(0 <= pos <= self._size, f"seek out of range: {pos}")
        self._pos = pos

    def tell(self) -> int:
        return self._pos


class S3WriteStream(Stream):
    """Multipart-upload writer (reference WriteStream, s3_filesys.cc:551-798)."""

    def __init__(self, client: _S3Client, key: str):
        self._client = client
        self._key = key
        self._buffer = bytearray()
        self._buffer_mb = get_env("DMLC_S3_WRITE_BUFFER_MB", int, 64)
        self._part_bytes = max(5, self._buffer_mb) << 20
        self._upload_id: Optional[str] = None
        self._etags: List[str] = []
        self._total_bytes = 0
        self._write_token = ""
        self._closed = False

    def _init_multipart(self) -> None:
        # unique write token carried as object metadata: the one
        # store-agnostic way to later prove "the object at this key is THIS
        # upload" (ETag arithmetic breaks on SSE-KMS/interop stores whose
        # part ETags are not plain part-MD5s)
        self._write_token = uuid.uuid4().hex
        _, _, data = self._client.request(
            "POST", self._key, query={"uploads": ""},
            headers={_TOKEN_HEADER: self._write_token})
        root = ET.fromstring(data)
        node = root.find("{*}UploadId")
        if node is None:
            node = root.find("UploadId")
        CHECK(node is not None, "malformed InitiateMultipartUpload response")
        self._upload_id = node.text

    def write(self, data: bytes) -> None:
        self._total_bytes += len(data)
        self._buffer.extend(data)
        while len(self._buffer) >= self._part_bytes:
            self._upload_part(bytes(self._buffer[:self._part_bytes]))
            del self._buffer[:self._part_bytes]

    def _upload_part(self, part: bytes) -> None:
        if self._upload_id is None:
            self._init_multipart()
        part_no = len(self._etags) + 1
        _, headers, _ = self._client.request(
            "PUT", self._key, query={"partNumber": part_no,
                                     "uploadId": self._upload_id},
            body=part)
        self._etags.append(headers.get("etag", ""))

    def abort(self) -> None:
        """Abandon the upload WITHOUT committing — nothing lands at the key.

        :meth:`close` is the commit point (CompleteMultipartUpload, or the
        small-object PUT), so error paths must call this instead: completing
        a partial upload would land a truncated object for every reader to
        trip over.  Best-effort AbortMultipartUpload frees the parts already
        uploaded; an orphaned upload id only costs storage until the
        bucket's abort-incomplete-uploads lifecycle rule."""
        if self._closed:
            return
        self._closed = True
        self._buffer.clear()
        if self._upload_id is not None:
            try:
                self._client.request(
                    "DELETE", self._key,
                    query={"uploadId": self._upload_id},
                    ok=(200, 204, 404))  # 404: already expired/reconciled
            except Exception:
                pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._upload_id is None:
            # small object: single PUT (cheaper than multipart)
            self._client.request("PUT", self._key, body=bytes(self._buffer))
            return
        if self._buffer:
            self._upload_part(bytes(self._buffer))
            self._buffer.clear()
        parts = "".join(
            f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{etag}</ETag></Part>"
            for i, etag in enumerate(self._etags))
        body = (f"<CompleteMultipartUpload>{parts}"
                f"</CompleteMultipartUpload>").encode()
        # CompleteMultipartUpload is the one non-idempotent call: if a
        # transport retry re-sends it after S3 already committed, S3 answers
        # 404 NoSuchUpload.  Accept the 404 only when the object at the key
        # is provably THIS upload: it must carry the unique write token we
        # attached at initiate (object metadata survives the complete), and
        # have exactly the bytes we wrote — a stale same-size object under
        # an overwritten key (the fixed-shape checkpoint case) has neither.
        status, _, _ = self._client.request(
            "POST", self._key, query={"uploadId": self._upload_id},
            body=body, ok=(200, 404))
        if status == 404:
            hs, headers, _ = self._client.request("HEAD", self._key,
                                                  ok=(200, 404))
            landed = (hs == 200
                      and int(headers.get("content-length", -1))
                      == self._total_bytes
                      and headers.get(_TOKEN_HEADER.lower(), "")
                      == self._write_token)
            CHECK(landed,
                  f"multipart upload of {self._key} lost: complete returned "
                  f"NoSuchUpload and the object at the key is missing or is "
                  f"not this upload (expected {self._total_bytes} bytes, "
                  f"write token {self._write_token})")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class S3FileSystem(fsys.FileSystem):
    """s3:// filesystem (reference S3FileSystem)."""

    env_prefix = "AWS"
    default_endpoint: Optional[str] = None
    service = "s3"

    def _client(self, uri: fsys.URI) -> _S3Client:
        return _S3Client(uri.host, self.env_prefix, self.default_endpoint,
                         self.service)

    def get_path_info(self, path: fsys.URI) -> fsys.FileInfo:
        client = self._client(path)
        key = path.name.lstrip("/")
        status, headers, _ = client.request("HEAD", key, ok=(200, 404))
        if status == 404:
            # directories exist implicitly when any key has the prefix
            entries = self.list_directory(path)
            if entries:
                return fsys.FileInfo(path.copy(), 0, fsys.FileType.DIRECTORY)
            raise FileNotFoundError(path.str())
        return fsys.FileInfo(path.copy(), int(headers.get("content-length", 0)),
                             fsys.FileType.FILE)

    def list_directory(self, path: fsys.URI) -> List[fsys.FileInfo]:
        client = self._client(path)
        prefix = path.name.lstrip("/")
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        out: List[fsys.FileInfo] = []
        token: Optional[str] = None
        while True:
            query = {"list-type": "2", "prefix": prefix, "delimiter": "/"}
            if token:
                query["continuation-token"] = token
            _, _, data = client.request("GET", "", query=query)
            root = ET.fromstring(data)
            ns = root.tag.split("}")[0] + "}" if "}" in root.tag else ""
            for item in root.findall(f"{ns}Contents"):
                key = item.find(f"{ns}Key").text
                size = int(item.find(f"{ns}Size").text)
                sub = path.copy()
                sub.name = "/" + key
                out.append(fsys.FileInfo(sub, size, fsys.FileType.FILE))
            for item in root.findall(f"{ns}CommonPrefixes"):
                sub = path.copy()
                sub.name = "/" + item.find(f"{ns}Prefix").text.rstrip("/")
                out.append(fsys.FileInfo(sub, 0, fsys.FileType.DIRECTORY))
            next_node = root.find(f"{ns}NextContinuationToken")
            if next_node is None or not next_node.text:
                return out
            token = next_node.text

    def open(self, path: fsys.URI, mode: str) -> Stream:
        if mode == "r":
            return self.open_for_read(path)
        CHECK(mode == "w", "s3 streams support 'r' and 'w' only "
              "(append is not an object-store operation)")
        return S3WriteStream(self._client(path), path.name.lstrip("/"))

    def open_for_read(self, path: fsys.URI) -> SeekStream:
        info = self.get_path_info(path)
        return S3ReadStream(self._client(path), path.name.lstrip("/"),
                            info.size)


class GCSFileSystem(S3FileSystem):
    """gs:// via GCS's S3-interoperability XML API (HMAC keys).

    Credentials: ``GCS_ACCESS_KEY_ID``/``GCS_SECRET_ACCESS_KEY`` (interop HMAC
    keys) falling back to AWS_*; endpoint https://storage.googleapis.com
    (override with S3_ENDPOINT).  This is the TPU-world default object store
    (SURVEY.md §7 stage 2).
    """

    env_prefix = "GCS"
    default_endpoint = "https://storage.googleapis.com"
    service = "gs"


Registry.get("filesystem").add("s3", S3FileSystem,
                               description="Amazon S3 / S3-compatible stores")
Registry.get("filesystem").add("gs", GCSFileSystem,
                               description="Google Cloud Storage (interop XML API)")
