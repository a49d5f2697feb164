"""Row-block iterators: in-memory and disk-cached.

Capability parity with the reference's ``BasicRowIter``
(src/data/basic_row_iter.h:23-82, full in-memory load with MB/s progress logs)
and ``DiskRowIter`` (src/data/disk_row_iter.h:28-139, 64MB-page disk cache
built on first pass, replayed on later epochs).

Local caches are built in the **columnar v2 format**
(:mod:`dmlc_core_tpu_torch.data.page_cache`): atomic temp+fsync+rename build,
checksummed pages, and mmap'd zero-copy replay — epoch >= 2 serves the same
read-only RowBlock views every time instead of re-deserializing.  A legacy
v1 cache (``RowBlockContainer`` framing) still loads through the stream
path.

Remote (URI) cache files ride the **fleet-shared remote page cache**: the
v2 file is fetched over the ranged-read FS layer (open-by-footer, a
prefetching page-fetch ring, per-page CRC validation) and materialized
into a local cache-of-cache under ``DMLC_CACHE_LOCAL_DIR``, so one worker
parses and publishes (``DMLC_CACHE_REMOTE``) while the rest of the fleet
fetches — and every epoch on every host still mmaps locally at zero-copy
speed.  Anything untrustable (footer-less object, v1 framing, dtype
drift, a corrupt or truncated page) falls back to stream-parsing with a
loud warning; a bad page is never served.

Counterpart of ``dmlc_core_tpu/data/iterators.py`` (a copy).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.data import page_cache
from dmlc_core_tpu_torch.data.page_cache import CacheFormatError
from dmlc_core_tpu_torch.data.parser import Parser
from dmlc_core_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_core_tpu_torch.io.stream import create_stream_for_read
from dmlc_core_tpu_torch.io.threadediter import ThreadedIter
from dmlc_core_tpu_torch.param import get_env
from dmlc_core_tpu_torch.utils.logging import CHECK, log_info, log_warning
from dmlc_core_tpu_torch.utils.timer import get_time

__all__ = ["RowBlockIter", "BasicRowIter", "DiskRowIter"]


class RowBlockIter:
    """Iterator over RowBlocks (reference RowBlockIter, data.h:221-247)."""

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> Optional[RowBlock]:
        raise NotImplementedError

    def __iter__(self):
        while True:
            block = self.next()
            if block is None:
                return
            yield block


class BasicRowIter(RowBlockIter):
    """Load everything into memory up front (reference basic_row_iter.h:23-82)."""

    def __init__(self, parser: Parser, index_dtype=np.uint32):
        start = get_time()
        container = RowBlockContainer(index_dtype)
        bytes_logged = 0
        for block in parser:
            container.push_block(block)
            nread = parser.bytes_read()
            if nread >= bytes_logged + (10 << 20):  # every 10MB, ref :70-75
                elapsed = max(get_time() - start, 1e-9)
                log_info(f"{nread >> 20} MB read, "
                         f"{nread / (1 << 20) / elapsed:.2f} MB/sec")
                bytes_logged = nread
        self._block = container.get_block()
        elapsed = max(get_time() - start, 1e-9)
        log_info(f"finished reading {parser.bytes_read() / (1 << 20):.2f} MB, "
                 f"{parser.bytes_read() / (1 << 20) / elapsed:.2f} MB/sec")
        if hasattr(parser, "close"):
            parser.close()
        self._done = False

    def before_first(self) -> None:
        self._done = False

    def next(self) -> Optional[RowBlock]:
        if self._done:
            return None
        self._done = True
        return self._block

    def get_block(self) -> RowBlock:
        return self._block


def _remote_cache_config(cache_file: str) -> tuple:
    """(remote_uri, publish): where a remote copy of the cache lives and
    whether a local build should be uploaded there.

    ``DMLC_CACHE_REMOTE`` is the fleet-sharing knob: ``1`` publishes a
    local build to the remote cache URI itself; an explicit ``<uri>``
    names the remote location (fetch + publish) even when the
    ``#cachefile`` is a local path.  A remote ``#cachefile`` is always
    *fetch*-eligible — publish stays opt-in so N racing cold workers
    don't all upload."""
    env = os.environ.get("DMLC_CACHE_REMOTE", "").strip()
    remote_uri = cache_file if "://" in cache_file else None
    publish = False
    if "://" in env:
        remote_uri = env
        publish = True
    elif env:
        # the repo-wide bool grammar (param._parse_bool, same as every
        # other DMLC_* boolean knob): "False"/"NO" disable regardless of
        # case, and garbage raises instead of silently enabling publish
        publish = get_env("DMLC_CACHE_REMOTE", bool, False)
    return remote_uri, publish and remote_uri is not None


class DiskRowIter(RowBlockIter):
    """Build a paged disk cache on the first pass, then iterate the cache
    (reference disk_row_iter.h:28-139).

    Caches use the v2 columnar format: the build goes to a temp file and
    is renamed into place only after the checksummed footer is durable (a
    crash mid-build can never leave a trusted-but-truncated cache), and
    replay mmaps the file once — every epoch serves the *same* zero-copy
    RowBlock views.  An existing cache that fails validation (truncated
    tail, bad page CRC, different index dtype) is rebuilt with a loud
    warning.  v1 caches still load via the legacy stream path.

    A remote cache URI (or an explicit ``DMLC_CACHE_REMOTE=<uri>``) makes
    the cache fleet-shared: a valid remote v2 object is fetched through
    the ranged-read FS layer and materialized locally (see
    :func:`page_cache.fetch_remote_cache`); otherwise this worker stream-
    parses, builds the v2 file locally, and — with publish enabled —
    uploads it so the rest of the fleet fetches instead of re-parsing."""

    PAGE_BYTES = 64 << 20  # reference kPageSize (disk_row_iter.h:32)

    def __init__(self, parser, cache_file: str, reuse_cache: bool = True,
                 index_dtype=np.uint32):
        # ``parser`` may be a zero-arg factory instead of a Parser: it is
        # only invoked when the cache actually has to be (re)built, so a
        # warm run — local materialization or fleet fetch — never pays
        # parser/input-split construction (or its remote stat traffic)
        self._cache_file = cache_file
        self._index_dtype = np.dtype(index_dtype)
        # page granularity is also the remote fetch/pipeline unit: smaller
        # pages let the prefetch ring overlap validation with the wire
        self._page_bytes = max(1 << 20, get_env("DMLC_CACHE_PAGE_BYTES", int,
                                                self.PAGE_BYTES))
        self._remote_uri, self._publish = _remote_cache_config(cache_file)
        self._local_path = (page_cache.default_local_path(self._remote_uri)
                            if "://" in cache_file else cache_file)
        self._reader: Optional[page_cache.PageCacheReader] = None
        self._iter: Optional[ThreadedIter] = None
        if reuse_cache and os.path.exists(self._local_path):
            try:
                self._open_cache()
            except CacheFormatError as exc:
                log_warning(f"cache {self._local_path} failed validation "
                            f"({exc}); rebuilding")
                telemetry.count("dmlc_cache_rebuilds_total")
                self._acquire_cache(parser)
        else:
            self._acquire_cache(parser)
        self.before_first()

    # -- acquire: remote fetch, else stream-parse build (+ publish) -----------
    def _acquire_cache(self, parser) -> None:
        if self._remote_uri is not None and self._try_fetch():
            try:
                self._open_cache()
                return
            except CacheFormatError as exc:
                # defense in depth: the fetch validated every page, but a
                # materialized file the reader still rejects must fall back
                # to the source, not crash the worker
                log_warning(f"fetched cache {self._local_path} failed local "
                            f"validation ({exc}); rebuilding from source")
                telemetry.count("dmlc_cache_rebuilds_total")
                self._reader = None
        if not isinstance(parser, Parser) and callable(parser):
            parser = parser()
        self._build_cache(parser)
        if self._publish:
            try:
                page_cache.publish_cache(self._local_path, self._remote_uri)
                log_info(f"published cache to {self._remote_uri}")
            except Exception as exc:  # noqa: BLE001 — data is served locally
                log_warning(f"cache publish to {self._remote_uri} failed "
                            f"({exc!r}); continuing with the local cache")
        self._open_cache()

    def _try_fetch(self) -> bool:
        """One attempt at the fleet-shared path; False falls back to the
        stream-parse build.  A bad page is never served: validation
        failures surface here, before the local file exists."""
        start = get_time()
        try:
            nbytes = page_cache.fetch_remote_cache(
                self._remote_uri, self._local_path, self._index_dtype)
        except Exception as exc:  # noqa: BLE001 — a bad remote store must
            # degrade to stream-parsing, never crash the worker: beyond
            # OSError, the FS layer raises logging.Error (a RuntimeError)
            # when an object store fails persistently (403, retry-exhausted
            # 5xx), and injected faults may raise ValueError/RuntimeError
            reason = ("absent" if isinstance(exc, FileNotFoundError)
                      else "invalid" if isinstance(exc, CacheFormatError)
                      else "io" if isinstance(exc, OSError)
                      else "error")
            telemetry.count("dmlc_cache_remote_misses_total", reason=reason)
            if reason != "absent":
                # an unusable remote cache is worth a loud warning and a
                # rebuild count — it means the fleet-shared copy is bad
                log_warning(f"remote cache {self._remote_uri} unusable "
                            f"({exc}); falling back to stream parse")
                telemetry.count("dmlc_cache_rebuilds_total")
            else:
                log_info(f"no remote cache at {self._remote_uri}; "
                         "stream-parsing")
            return False
        telemetry.count("dmlc_cache_remote_hits_total")
        elapsed = max(get_time() - start, 1e-9)
        log_info(f"fetched {nbytes >> 20} MB cache from {self._remote_uri}, "
                 f"{nbytes / (1 << 20) / elapsed:.2f} MB/sec")
        return True

    # -- build ----------------------------------------------------------------
    def _build_cache(self, parser: Parser) -> None:
        start = get_time()
        dirpath = os.path.dirname(os.path.abspath(self._local_path))
        # 0700 on creation: the default materialization dir is per-user
        # private (page_cache.default_local_path); existing dirs untouched
        os.makedirs(dirpath, mode=0o700, exist_ok=True)
        writer = page_cache.PageCacheWriter(self._local_path,
                                            self._index_dtype)
        page = RowBlockContainer(self._index_dtype)
        page_bytes = 0
        total = 0
        with telemetry.span("cache.build", path=self._local_path) as sp:
            try:
                for block in parser:
                    page.push_block(block)
                    page_bytes += block.memory_cost_bytes()
                    if page_bytes >= self._page_bytes:
                        writer.write_page(page)
                        total += page_bytes
                        elapsed = max(get_time() - start, 1e-9)
                        log_info(f"wrote {total >> 20} MB cache, "
                                 f"{total / (1 << 20) / elapsed:.2f} MB/sec")
                        page = RowBlockContainer(self._index_dtype)
                        page_bytes = 0
                if page.size:
                    writer.write_page(page)
                writer.commit()
                sp.set(pages=writer.pages_written,
                       nbytes=total + page_bytes)
            except BaseException:
                # never leave a half-written file where a trusted cache goes
                writer.abort()
                raise
            finally:
                if hasattr(parser, "close"):
                    parser.close()

    # -- open -----------------------------------------------------------------
    def _open_cache(self) -> None:
        """Attach to the cache: v2 mmap when the header says so, else the
        legacy v1 stream path.  Raises CacheFormatError on an untrustable
        v2 file (missing footer, checksum mismatch, dtype drift)."""
        self._reader = None
        with open(self._local_path, "rb") as probe:
            head = probe.read(len(page_cache.HEAD_MAGIC))
        if head == page_cache.HEAD_MAGIC:
            self._reader = page_cache.PageCacheReader(self._local_path,
                                                      self._index_dtype)
            telemetry.count("dmlc_cache_open_total", format="v2-mmap")
            return
        telemetry.count("dmlc_cache_open_total", format="v1")

    def _make_producer(self):
        parent = self
        if self._reader is not None:
            class _PageProducer:
                """Replays the reader's mmap-backed blocks: the same array
                objects every epoch — zero per-epoch copies."""

                def __init__(self) -> None:
                    self._pos = 0

                def before_first(self) -> None:
                    self._pos = 0

                def next(self, reuse):
                    blocks = parent._reader.blocks
                    if self._pos >= len(blocks):
                        return None
                    block = blocks[self._pos]
                    self._pos += 1
                    telemetry.count("dmlc_cache_page_reads_total",
                                    source="mmap")
                    return block

            return _PageProducer()

        class _Producer:
            def __init__(self) -> None:
                self._fi = create_stream_for_read(parent._local_path)

            def before_first(self) -> None:
                self._fi.seek(0)

            def next(self, reuse):
                container = RowBlockContainer(parent._index_dtype)
                if not container.load(self._fi):
                    return None
                telemetry.count("dmlc_cache_page_reads_total",
                                source="stream")
                return container.get_block()

        return _Producer()

    def cache_blocks(self) -> Optional[list]:
        """The mmap'd zero-copy RowBlock views backing a v2 cache (the
        same objects every epoch), or None on the v1/stream path.

        This is the streaming-binner feed (``bridge.binning.fit_binner``):
        quantile edges are computed directly over the mapped views without
        a second parse or any row copy."""
        return None if self._reader is None else self._reader.blocks

    def before_first(self) -> None:
        if self._iter is None:
            self._iter = ThreadedIter(self._make_producer(), max_capacity=2,
                                      name="row_iter")
        else:
            self._iter.before_first()

    def next(self) -> Optional[RowBlock]:
        return self._iter.next()

    def close(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
        if self._reader is not None:
            self._reader.close()
