"""Columnar page cache v2: raw little-endian column buffers + mmap replay.

The v1 cache (``RowBlockContainer.save`` framing, reference
row_block.h:181-205) re-deserializes every page each epoch: every
``load`` is read -> frombuffer -> copy.  v2 lays pages out so that a later
epoch is *one mmap and zero copies*:

- **file header** (32 B): magic ``DMLCRBC2``, version, the index dtype the
  cache was built with, reserved;
- **pages**: an 80 B checksummed page header (page magic, a CRC32 covering
  the header's own size/count/max fields *and* the payload, payload size,
  six column element counts, max_field/max_index) followed by the six
  column buffers — offset ``int64``, label/weight/value ``float32``,
  field/index in the header dtype — each padded to 8-byte alignment so
  every ``np.frombuffer`` lands aligned;
- **footer**: a TOC (page count + page byte offsets) and a fixed 24 B tail
  (TOC offset, CRC32 of the TOC, magic ``DMLCRBE2``) written *last* — a
  build that died mid-write has no tail and is rejected as
  :class:`CacheFormatError`, never silently truncated data.

Builds are atomic: :class:`PageCacheWriter` writes to a temp file in the
cache's directory, fsyncs, and ``os.replace``s into place on
:meth:`commit` (plus a directory fsync so the rename itself is durable).

:class:`PageCacheReader` validates magic/version/dtype/TOC and every page
CRC once, then hands out RowBlocks whose arrays are read-only views into
the mapping — the same objects every epoch, which is what makes epoch>=2
zero-copy by construction.

Counterpart of ``dmlc_core_tpu/data/page_cache.py`` (a copy).
"""

from __future__ import annotations

import hashlib
import mmap
import os
import struct
import tempfile
import threading
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.data.row_block import (COLUMN_ORDER, RowBlock,
                                                RowBlockContainer, align8)
from dmlc_core_tpu_torch.param import get_env

__all__ = ["PageCacheWriter", "PageCacheReader", "CacheFormatError",
           "HEAD_MAGIC", "fetch_remote_cache", "publish_cache",
           "default_local_path"]

HEAD_MAGIC = b"DMLCRBC2"
TAIL_MAGIC = b"DMLCRBE2"
VERSION = 2
_PAGE_MAGIC = 0x32474150  # "PAG2", little-endian

_HEAD = struct.Struct("<8sI4s16x")          # magic, version, dtype str
_PAGE_HEAD = struct.Struct("<IIQ6Q2Q")  # magic, crc, payload, counts[6], maxes
# the page CRC covers the header fields after the CRC itself (payload size,
# column counts, maxes) AND the payload: a corrupted count is as fatal as a
# corrupted byte — it re-slices every column
_PAGE_META = struct.Struct("<Q6Q2Q")
_TAIL = struct.Struct("<QI4x8s")            # toc offset, toc crc, magic

# column layout order shared with the shm transport (row_block.COLUMN_ORDER);
# (real) dtypes resolved per cache index dtype
_COL_ORDER = COLUMN_ORDER
_align8 = align8


class CacheFormatError(RuntimeError):
    """A cache file that cannot be trusted (truncated, corrupt, or built
    with different parameters) — callers rebuild or abort loudly."""


def _dtype_tag(index_dtype: np.dtype) -> bytes:
    tag = np.dtype(index_dtype).newbyteorder("<").str.encode()
    return tag.ljust(4, b"\0")


def _page_dtypes(index_dtype) -> Tuple[np.dtype, ...]:
    """Per-column dtypes in :data:`_COL_ORDER` for one cache index dtype."""
    idx = np.dtype(index_dtype)
    return (np.dtype(np.int64), np.dtype(np.float32), np.dtype(np.float32),
            idx, idx, np.dtype(np.float32))


def _validate_page(view: memoryview, off: int, end: int, ctx: str,
                   index_dtype, exact: bool = False) -> Tuple[Tuple, int]:
    """The ONE page trust check, shared by the local mmap reader and the
    remote fetch: magic, header CRC over the size/count fields AND the
    payload, and counts-vs-payload agreement under the column dtype
    ladder.  ``exact`` additionally requires the page to fill
    ``[off, end)`` exactly (the fetch case: ``end - off`` is the TOC's
    span for this page).  Returns ``(counts, payload_start)``."""
    if off + _PAGE_HEAD.size > end:
        raise CacheFormatError(f"{ctx}: page header truncated at {off}")
    fields = _PAGE_HEAD.unpack_from(view, off)
    magic, crc, payload_bytes = fields[0], fields[1], fields[2]
    counts = fields[3:9]
    if magic != _PAGE_MAGIC:
        raise CacheFormatError(f"{ctx}: bad page magic at {off}")
    start = off + _PAGE_HEAD.size
    if start + payload_bytes > end:
        raise CacheFormatError(f"{ctx}: page payload truncated at {off}")
    if exact and start + payload_bytes != end:
        raise CacheFormatError(
            f"{ctx}: page payload disagrees with its TOC span")
    if zlib.crc32(view[start:start + payload_bytes],
                  zlib.crc32(view[off + 8:start])) != crc:
        raise CacheFormatError(
            f"{ctx}: page checksum mismatch at {off}")
    if sum(_align8(count * dtype.itemsize)
           for count, dtype in zip(counts, _page_dtypes(index_dtype))
           ) != payload_bytes:
        # CRC makes this unreachable short of a collision, but a
        # mis-sliced column must surface as a cache error, never as a
        # frombuffer ValueError outside the rebuild path
        raise CacheFormatError(
            f"{ctx}: column counts disagree with payload size")
    return counts, start


class PageCacheWriter:
    """Atomic v2 cache build: temp file -> fsync -> rename on commit."""

    def __init__(self, path: str, index_dtype=np.uint32):
        self._path = path
        self._index_dtype = np.dtype(index_dtype)
        self._tmp = f"{path}.build-{os.getpid()}.tmp"
        self._page_offsets: List[int] = []
        self._pos = 0
        self.pages_written = 0
        self._fo = open(self._tmp, "wb")
        try:
            self._write(_HEAD.pack(HEAD_MAGIC, VERSION,
                                   _dtype_tag(self._index_dtype)))
        except BaseException:
            # a failed header write (disk full) must not orphan the fd and
            # the temp file: the caller never receives the instance, so
            # abort() is unreachable
            self._fo.close()
            os.unlink(self._tmp)
            raise

    def _write(self, data: bytes) -> None:
        self._fo.write(data)
        self._pos += len(data)

    def _col_arrays(self, block: RowBlock) -> List[np.ndarray]:
        idx = self._index_dtype
        empty = np.empty(0, np.float32)
        return [
            np.ascontiguousarray(block.offset, dtype=np.int64),
            np.ascontiguousarray(block.label, dtype=np.float32),
            (np.ascontiguousarray(block.weight, dtype=np.float32)
             if block.weight is not None else empty),
            (np.ascontiguousarray(block.field, dtype=idx)
             if block.field is not None else np.empty(0, idx)),
            np.ascontiguousarray(block.index, dtype=idx),
            (np.ascontiguousarray(block.value, dtype=np.float32)
             if block.value is not None else empty),
        ]

    def write_page(self, container: RowBlockContainer) -> None:
        """Serialize one page (a RowBlockContainer worth of rows)."""
        self.write_block(container.get_block(),
                         max_field=container.max_field,
                         max_index=container.max_index)

    def write_block(self, block: RowBlock, max_field: int = 0,
                    max_index: int = 0) -> None:
        """Serialize one RowBlock as a page, container-free.

        The page serializer proper — :meth:`write_page` is a thin
        container adapter over it.  Block producers whose pages arrive
        already materialized (e.g. Arrow-mapped blocks from
        ``arrow_ingest.table_to_block``) can call this directly instead
        of re-staging through a RowBlockContainer; maxes default to the
        block's own."""
        cols = self._col_arrays(block)
        payload = bytearray()
        for arr in cols:
            raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
            payload += raw
            payload += b"\0" * (_align8(len(raw)) - len(raw))
        nnz = block.num_nonzero
        max_field = max_field or (
            int(block.field.max()) if block.field is not None and nnz else 0)
        max_index = max_index or (
            int(block.index.max()) if nnz else 0)
        meta = _PAGE_META.pack(len(payload), *(len(c) for c in cols),
                               max_field, max_index)
        payload = bytes(payload)
        crc = zlib.crc32(payload, zlib.crc32(meta))
        self._page_offsets.append(self._pos)
        self._write(struct.pack("<II", _PAGE_MAGIC, crc) + meta)
        self._write(payload)
        self.pages_written += 1
        telemetry.count("dmlc_cache_pages_written_total")

    def commit(self) -> None:
        """Write TOC + tail, fsync, and atomically move into place."""
        toc = struct.pack("<Q", len(self._page_offsets))
        toc += struct.pack(f"<{len(self._page_offsets)}Q",
                           *self._page_offsets)
        toc_offset = self._pos
        self._write(toc)
        self._write(_TAIL.pack(toc_offset, zlib.crc32(toc), TAIL_MAGIC))
        _commit_durable(self._fo, self._tmp, self._path)

    def abort(self) -> None:
        """Drop the partial build; the real cache path is untouched."""
        try:
            self._fo.close()
        finally:
            if os.path.exists(self._tmp):
                os.unlink(self._tmp)


class PageCacheReader:
    """Validate + mmap a v2 cache; serve zero-copy RowBlocks per page."""

    def __init__(self, path: str, index_dtype=np.uint32):
        self._path = path
        self._index_dtype = np.dtype(index_dtype)
        size = os.path.getsize(path)
        if size < _HEAD.size + _TAIL.size:
            raise CacheFormatError(f"{path}: too small for a v2 cache "
                                   f"({size} bytes)")
        self._fd = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._fd.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        except BaseException:
            # a failed mmap orphans the fd: close() can never reach it
            # because the constructor raise means no one holds the instance
            self._fd.close()
            raise
        try:
            self._pages = self._load_pages(size)
        except Exception:
            self.close()
            raise
        self.blocks: List[RowBlock] = [p for p in self._pages]

    def _load_pages(self, size: int) -> List[RowBlock]:
        mm = self._mm
        magic, version, dtype_tag = _HEAD.unpack(mm[:_HEAD.size])
        if magic != HEAD_MAGIC:
            raise CacheFormatError(f"{self._path}: not a v2 cache")
        if version != VERSION:
            raise CacheFormatError(
                f"{self._path}: cache version {version} != {VERSION}")
        want = _dtype_tag(self._index_dtype)
        if dtype_tag != want:
            have_s = dtype_tag.rstrip(b"\0").decode(errors="replace")
            want_s = want.rstrip(b"\0").decode(errors="replace")
            raise CacheFormatError(
                f"{self._path}: cache index dtype {have_s!r} != "
                f"requested {want_s!r}")
        toc_offset, toc_crc, tail_magic = _TAIL.unpack(mm[size - _TAIL.size:])
        if tail_magic != TAIL_MAGIC:
            raise CacheFormatError(
                f"{self._path}: missing footer (interrupted build or "
                "truncated file)")
        if not _HEAD.size <= toc_offset <= size - _TAIL.size - 8:
            raise CacheFormatError(f"{self._path}: TOC offset out of range")
        toc = bytes(mm[toc_offset:size - _TAIL.size])
        if zlib.crc32(toc) != toc_crc:
            raise CacheFormatError(f"{self._path}: TOC checksum mismatch")
        (npages,) = struct.unpack_from("<Q", toc, 0)
        if len(toc) != 8 + 8 * npages:
            raise CacheFormatError(f"{self._path}: TOC size mismatch")
        offsets = struct.unpack_from(f"<{npages}Q", toc, 8)
        # page CRCs run over a memoryview: slicing the mmap itself would
        # copy every payload byte just to checksum it
        view = memoryview(mm)
        try:
            return [self._load_page(off, toc_offset, view)
                    for off in offsets]
        finally:
            view.release()

    def _wrap(self, off: int, count: int, dtype) -> Optional[np.ndarray]:
        if count == 0:
            return None
        return np.frombuffer(self._mm, dtype=dtype, count=count, offset=off)

    def _load_page(self, off: int, limit: int, view: memoryview) -> RowBlock:
        counts, start = _validate_page(view, off, limit, self._path,
                                       self._index_dtype)
        views = []
        pos = start
        for count, dtype in zip(counts, _page_dtypes(self._index_dtype)):
            nbytes = count * dtype.itemsize
            views.append(self._wrap(pos, count, dtype))
            pos += _align8(nbytes)
        offset, label, weight, field, index, value = views
        return RowBlock(offset, label,
                        (index if index is not None
                         else np.empty(0, self._index_dtype)),
                        value, weight, field)

    def close(self) -> None:
        """Best-effort unmap; live views keep the mapping alive via GC."""
        try:
            self._mm.close()
        except BufferError:
            pass  # exported RowBlock views still hold pointers
        self._fd.close()


def _commit_durable(fo, tmp: str, path: str) -> None:
    """fsync + atomic rename + directory fsync: the shared tail of every
    cache build/fetch — a crash after commit() returns can lose neither the
    bytes nor the rename."""
    fo.flush()
    os.fsync(fo.fileno())
    fo.close()
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


# -- remote v2 caches over the ranged-read FS layer ---------------------------
#
# The v2 format was designed for exactly this: the CRC'd footer/TOC written
# last means ONE tail ranged read proves the remote object is a complete,
# trustworthy cache; the checksummed page headers mean every page fetch is
# independently validated before a byte of it is served.  A fetch
# materializes the remote cache into a local "cache of the cache"
# (atomic temp+fsync+rename, as PageCacheWriter does), so this run — and
# every later run on this host — mmaps at the local replay's zero-copy speed
# while the fleet shares one parse.

# footer + TOC in one tail ranged read for caches up to ~32k pages (≈2 TB of
# 64 MB pages); bigger TOCs cost one extra ranged read
_TAIL_PROBE = 256 << 10

_FETCH_SITE = "io.cache.fetch"


class _RemoteLayout:
    """Validated layout of a remote v2 cache: everything the page fetch ring
    needs, learned from the header + one tail ranged read."""

    __slots__ = ("size", "header", "tail", "spans")

    def __init__(self, size: int, header: bytes, tail: bytes,
                 spans: List[Tuple[int, int]]):
        self.size = size          # total object bytes
        self.header = header      # the 32 B file header, validated
        self.tail = tail          # TOC + 24 B tail, CRC-validated
        self.spans = spans        # per-page (offset, nbytes)


def _read_span(stream, offset: int, nbytes: int, ctx: str) -> bytes:
    """Exactly ``nbytes`` at ``offset`` via the seekable stream, with
    ``io.cache.fetch`` fault injection (truncate models a cut object)."""
    if fault.enabled():
        fault.inject(_FETCH_SITE, uri=ctx, offset=offset)
        nbytes_injected = fault.truncate(_FETCH_SITE, nbytes, uri=ctx,
                                         offset=offset)
    else:
        nbytes_injected = nbytes
    stream.seek(offset)
    chunks = []
    remaining = nbytes_injected
    while remaining > 0:
        chunk = stream.read(remaining)
        if not chunk:
            break
        chunks.append(chunk)
        remaining -= len(chunk)
    data = b"".join(chunks)
    if len(data) != nbytes:
        raise CacheFormatError(
            f"{ctx}: short read at {offset} ({len(data)} of {nbytes} bytes)")
    return data


def _check_header(buf: bytes, ctx: str, index_dtype: np.dtype) -> None:
    """Validate the 32 B file header bytes (magic, version, index dtype)."""
    magic, version, dtype_tag = _HEAD.unpack(buf)
    if magic != HEAD_MAGIC:
        raise CacheFormatError(f"{ctx}: not a v2 cache")
    if version != VERSION:
        raise CacheFormatError(f"{ctx}: cache version {version} != {VERSION}")
    want = _dtype_tag(index_dtype)
    if dtype_tag != want:
        have_s = dtype_tag.rstrip(b"\0").decode(errors="replace")
        want_s = want.rstrip(b"\0").decode(errors="replace")
        raise CacheFormatError(
            f"{ctx}: cache index dtype {have_s!r} != requested {want_s!r}")


def _check_page(buf: bytes, ctx: str, index_dtype: np.dtype) -> None:
    """Validate one fetched page (exactly its TOC span) without building
    views — the fetch-side entry to the shared page trust check."""
    view = memoryview(buf)   # slicing bytes would copy the payload
    try:
        _validate_page(view, 0, len(buf), ctx, index_dtype, exact=True)
    finally:
        view.release()


def _open_remote_layout(uri: str, index_dtype: np.dtype) -> _RemoteLayout:
    """Open-by-footer: one tail ranged read (plus the 32 B header) proves the
    remote object is a complete v2 cache and yields the page spans.

    Raises FileNotFoundError when no object is at ``uri`` and
    :class:`CacheFormatError` for anything present but untrustable
    (footer-less/interrupted upload, v1 framing, dtype drift, corrupt TOC).
    """
    from dmlc_core_tpu_torch.io import filesys as fsys

    uri_obj = fsys.URI(uri)
    fs = fsys.get_filesystem(uri_obj)
    info = fs.get_path_info(uri_obj)          # FileNotFoundError on absence
    size = info.size
    if size < _HEAD.size + _TAIL.size + 8:
        raise CacheFormatError(f"{uri}: too small for a v2 cache "
                               f"({size} bytes)")
    stream = fs.open_for_read(uri_obj)
    try:
        header = _read_span(stream, 0, _HEAD.size, uri)
        _check_header(header, uri, index_dtype)
        probe_len = min(size - _HEAD.size, _TAIL_PROBE)
        probe = _read_span(stream, size - probe_len, probe_len, uri)
        toc_offset, toc_crc, tail_magic = _TAIL.unpack(probe[-_TAIL.size:])
        if tail_magic != TAIL_MAGIC:
            raise CacheFormatError(
                f"{uri}: missing footer (interrupted upload or truncated "
                "object)")
        if not _HEAD.size <= toc_offset <= size - _TAIL.size - 8:
            raise CacheFormatError(f"{uri}: TOC offset out of range")
        if toc_offset >= size - probe_len:
            toc = probe[toc_offset - (size - probe_len):-_TAIL.size]
        else:  # TOC bigger than the probe: one extra ranged read
            toc = _read_span(stream, toc_offset,
                             size - _TAIL.size - toc_offset, uri)
        if zlib.crc32(toc) != toc_crc:
            raise CacheFormatError(f"{uri}: TOC checksum mismatch")
        (npages,) = struct.unpack_from("<Q", toc, 0)
        if len(toc) != 8 + 8 * npages:
            raise CacheFormatError(f"{uri}: TOC size mismatch")
        offsets = struct.unpack_from(f"<{npages}Q", toc, 8)
        bounds = list(offsets) + [toc_offset]
        # pages must tile [header, TOC) EXACTLY: the fetch materializes
        # header+pages+tail contiguously with the remote TOC copied
        # verbatim, so any gap (a foreign writer's padding) would shift
        # every local offset and commit a corrupt file
        if bounds[0] != _HEAD.size:
            raise CacheFormatError(
                f"{uri}: pages do not tile the file "
                f"(first page at {bounds[0]}, expected {_HEAD.size})")
        spans = []
        for i in range(npages):
            if not (bounds[i] < bounds[i + 1] <= toc_offset):
                raise CacheFormatError(f"{uri}: page offsets out of order")
            spans.append((bounds[i], bounds[i + 1] - bounds[i]))
        return _RemoteLayout(size, header, toc + _TAIL.pack(
            toc_offset, toc_crc, tail_magic), spans)
    finally:
        stream.close()


def default_local_path(remote_uri: str) -> str:
    """Where a remote cache materializes on this host: keyed by the URI's
    digest under ``DMLC_CACHE_LOCAL_DIR`` so every run (and every process)
    of the same dataset agrees on one local file.

    The default directory is per-user (uid-suffixed, created 0700 by the
    fetch/build path): a shared ``/tmp/dmlc-page-cache`` would break the
    second user's runs on a multi-user host (first-creator owns the dir)
    and let any local user plant a valid-CRC file at another user's
    digest path to be served as training data."""
    getuid = getattr(os, "getuid", None)      # absent on Windows
    suffix = f"-u{getuid()}" if getuid is not None else ""
    base = get_env("DMLC_CACHE_LOCAL_DIR", str,
                   os.path.join(tempfile.gettempdir(),
                                f"dmlc-page-cache{suffix}"))
    digest = hashlib.sha256(remote_uri.encode()).hexdigest()[:24]
    name = os.path.basename(remote_uri.rstrip("/")) or "cache"
    return os.path.join(base, f"{digest}-{name}")


def fetch_remote_cache(uri: str, local_path: str, index_dtype=np.uint32,
                       prefetch: Optional[int] = None) -> int:
    """Fetch + validate a remote v2 cache into ``local_path``; returns the
    bytes fetched.

    A pre-posted ring of ``prefetch`` (default ``DMLC_CACHE_PREFETCH``)
    ranged page fetches keeps the wire busy while earlier pages validate
    and land in the local temp file — the same dispatch-ahead/block-at-
    hand-off shape as the device feed's double buffering.  Every page's CRC
    is checked before its bytes are written; the local file appears only
    via atomic rename after everything validated, so a concurrent fetch of
    the same cache from another process races safely (both rename a fully
    validated file).  Raises FileNotFoundError / CacheFormatError / OSError
    — the caller falls back to stream-parsing.
    """
    index_dtype = np.dtype(index_dtype)
    if prefetch is None:
        prefetch = max(1, get_env("DMLC_CACHE_PREFETCH", int, 4))
    layout = _open_remote_layout(uri, index_dtype)
    from dmlc_core_tpu_torch.io import filesys as fsys

    uri_obj = fsys.URI(uri)
    fs = fsys.get_filesystem(uri_obj)
    local = threading.local()
    streams: List = []   # every worker stream, closed once the pool drains

    def fetch_page(item: Tuple[int, Tuple[int, int]]) -> bytes:
        i, (off, nbytes) = item
        stream = getattr(local, "stream", None)
        if stream is None:
            stream = fs.open_for_read(uri_obj)
            local.stream = stream
            streams.append(stream)
        with telemetry.span("cache.fetch.page", page=i, bytes=nbytes):
            data = _read_span(stream, off, nbytes, uri)
        _check_page(data, f"{uri} page {i}", index_dtype)
        return data

    dirpath = os.path.dirname(os.path.abspath(local_path))
    # 0700 on creation: the default cache dir is per-user private (see
    # default_local_path); no-op for directories that already exist
    os.makedirs(dirpath, mode=0o700, exist_ok=True)
    # unique per CALL, not per process: two loaders in one process (train +
    # eval over the same dataset) fetching concurrently must not share a
    # temp file — a pid-only name would let one thread truncate the
    # other's in-progress bytes, and keep writing into the committed inode
    # after the rename
    tmp = (f"{local_path}.fetch-{os.getpid()}-{threading.get_ident()}-"
           f"{uuid.uuid4().hex[:8]}.tmp")
    fetched = 0
    with telemetry.span("cache.fetch", uri=uri, pages=len(layout.spans)):
        with ThreadPoolExecutor(max_workers=prefetch,
                                thread_name_prefix="cache-fetch") as pool:
            try:
                with open(tmp, "wb") as fo:
                    fo.write(layout.header)
                    pending = []
                    items = list(enumerate(layout.spans))
                    for item in items[:prefetch]:       # pre-post the ring
                        pending.append(pool.submit(fetch_page, item))
                    posted = len(pending)
                    while pending:
                        data = pending.pop(0).result()
                        if posted < len(items):         # keep the ring full
                            pending.append(pool.submit(fetch_page,
                                                       items[posted]))
                            posted += 1
                        fo.write(data)
                        fetched += len(data)
                        telemetry.count(
                            "dmlc_cache_remote_bytes_fetched_total",
                            len(data))
                    fo.write(layout.tail)
                    fetched += len(layout.header) + len(layout.tail)
                    telemetry.count("dmlc_cache_remote_bytes_fetched_total",
                                    len(layout.header) + len(layout.tail))
                    _commit_durable(fo, tmp, local_path)
            except BaseException:
                # don't wait out in-flight page fetches on the error path,
                # and leave no half-fetched file where a later run would
                # find-and-validate it
                pool.shutdown(wait=True, cancel_futures=True)
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            finally:
                for stream in streams:
                    try:
                        stream.close()
                    except Exception:
                        pass
    return fetched


def _delete_partial_publish(uri: str) -> None:
    """Best-effort removal of a half-written publish target on a
    write-through filesystem (the stream had no ``abort()``); a leftover
    footer-less object would send every fetcher down the loud
    invalid-classify-and-re-parse path until overwritten."""
    target = uri[7:] if uri.startswith("file://") else uri
    try:
        if "://" not in target:
            os.unlink(target)
            return
        from dmlc_core_tpu_torch.io import filesys as fsys

        uri_obj = fsys.URI(uri)
        delete = getattr(fsys.get_filesystem(uri_obj), "delete", None)
        if delete is not None:
            delete(uri_obj)
    except Exception:
        pass


def publish_cache(local_path: str, uri: str) -> None:
    """Upload a locally built v2 cache so the fleet fetches instead of
    re-parsing: streamed through the URI's write path (multipart upload on
    the object stores), counted as ``dmlc_cache_remote_publishes_total``."""
    from dmlc_core_tpu_torch.io.stream import create_stream

    size = os.path.getsize(local_path)
    with telemetry.span("cache.publish", uri=uri, bytes=size):
        fo = create_stream(uri, "w")
        try:
            with open(local_path, "rb") as fi:
                while True:
                    chunk = fi.read(8 << 20)
                    if not chunk:
                        break
                    fo.write(chunk)
        except BaseException:
            # a failed publish must ABANDON, never commit: close() is the
            # commit point on the buffered object stores
            # (CompleteMultipartUpload / Put Block List), and write-through
            # streams (plain files, hdfs://) have already materialized
            # partial bytes AT the target — either way a footer-less
            # truncated object at the fleet URI would make every worker's
            # fetch classify it invalid, warn, and re-parse until someone
            # overwrites it
            abort = getattr(fo, "abort", None)
            if abort is not None:
                abort()          # S3/Azure: nothing ever lands at the key
            else:
                try:
                    fo.close()
                except Exception:
                    pass
                _delete_partial_publish(uri)
            raise
        fo.close()
    telemetry.count("dmlc_cache_remote_publishes_total")
