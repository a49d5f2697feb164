"""Process-parallel parse backend: GIL-free fan-out over worker processes
with zero-copy shared-memory RowBlock transport.

Counterpart of ``dmlc_core_tpu/data/parse_proc.py`` (a copy).  The one
change is the start method's test: a parent that has imported ``torch``
(and so may hold a CUDA context, which a forked child cannot use) spawns
its workers, as the JAX package spawns when jax is loaded.  Workers import
the port's parser modules, which import no torch, so spawn stays cheap.

The thread-pool fan-out in
:class:`~dmlc_core_tpu_torch.data.parser.TextParserBase`
is the reference's OpenMP team (text_parser.h:89-118) minus real parallelism:
numpy releases the GIL inside each kernel, but the Python glue between
kernels serializes, so parse throughput plateaus long before the cores do.
This module moves the workers into processes:

- the consumer cuts a source chunk into newline-aligned sub-ranges exactly
  as the thread path does, and ships each range to a worker process;
- each worker runs the parser's ``parse_block`` (pure numpy, no source, no
  threads) and writes the resulting :class:`RowBlockContainer` columns into
  ONE ``multiprocessing.shared_memory`` segment — offsets/labels/indices/
  values never cross the pipe;
- the worker returns only plain metadata (segment name, per-column dtype/
  offset/length, max_index/max_field, in-worker parse seconds);
- the consumer attaches the segment, **unlinks it immediately** (the mapping
  outlives the name), and wraps every column with a ``np.frombuffer`` view —
  zero copies end to end.  A ``weakref.finalize`` on the shared base array
  closes the segment when the last RowBlock view dies, so lifetime is
  exactly "as long as anyone holds the block".

Array payloads are **never pickled** on this path; the executor pickles
only the input byte ranges and the metadata dicts.

One **shared, self-healing pool per process** serves every parser: workers
build per-format parser twins lazily by spec, bring-up cost is paid once
(not per parser or epoch), total worker count stays bounded however many
pipeline stages exist, and a pool broken by a worker death is dropped so
the next parser starts a fresh one.

Knobs:

- ``DMLC_PARSE_PROC=N``   — enable with N workers (``auto`` = cpu count;
  0/1/unset = off, the thread path is used);
- ``DMLC_PARSE_PROC_START`` — multiprocessing start method.  The default
  is ``spawn`` whenever the parent is multi-threaded or has torch loaded
  (forking then risks inherited-lock deadlocks in the child, and a CUDA
  context does not survive a fork) and ``fork`` otherwise; workers never
  import torch, so spawn stays cheap.

Block order is deterministic: ranges are submitted and collected in source
order (``Executor.map``).  A worker killed mid-chunk surfaces as a
``RuntimeError`` on the consumer (ferried through ``ThreadedParser`` like
any parse error) — never a hang.  The chaos suite drives this through the
``data.parse_worker`` fault site.
"""

from __future__ import annotations

import importlib
import os
import threading
import time
import weakref
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Any, Dict, List, Optional, Sequence, Tuple

import multiprocessing as mp
from multiprocessing import shared_memory

import numpy as np

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.data.row_block import (COLUMN_ORDER, RowBlock,
                                                RowBlockContainer, align8)
from dmlc_core_tpu_torch.telemetry import tracecontext
from dmlc_core_tpu_torch.utils.logging import log_warning

__all__ = ["ProcParsePool", "resolve_nproc", "attach_block", "engaged",
           "shutdown"]

ENV_NPROC = "DMLC_PARSE_PROC"
ENV_START = "DMLC_PARSE_PROC_START"

# RowBlock columns in transport order (shared with the page cache via
# row_block.COLUMN_ORDER); offset is always int64, label/weight/value
# float32, field/index carry the parser's index dtype
_COLUMNS = COLUMN_ORDER


def resolve_nproc(environ: Optional[Dict[str, str]] = None) -> int:
    """Worker count from ``DMLC_PARSE_PROC`` (0 = backend off)."""
    raw = (environ if environ is not None else os.environ) \
        .get(ENV_NPROC, "").strip().lower()
    if not raw or raw in ("0", "off", "false", "no"):
        return 0
    if raw == "auto":
        return os.cpu_count() or 1
    try:
        return max(0, int(raw))
    except ValueError:
        log_warning(f"ignoring non-integer {ENV_NPROC}={raw!r}")
        return 0


_align8 = align8


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """Drop the worker-side resource_tracker registration.

    The segment's lifetime belongs to the consumer (attach + unlink);
    without this the tracker inherited by the worker would re-unlink the
    already-unlinked name at exit and log spurious leak warnings."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


# -- worker side --------------------------------------------------------------

# per-worker parser instances keyed by spec (one worker pool serves every
# parser/format in the process; the parser twin is built on first use)
_WORKER_PARSERS: Dict[str, Any] = {}


def _worker_init() -> None:
    if not fault.enabled():
        # spawn-started workers don't inherit the parent's configured plan;
        # re-read the env so chaos plans reach them either way
        try:
            fault._init_from_env()
        except Exception:
            pass


def _worker_ready() -> bool:
    """Warmup probe: forces worker spawn + import before the first chunk."""
    return True


def _spec_key(spec: Tuple[str, str, Dict[str, Any]]) -> str:
    module, qualname, kwargs = spec
    return f"{module}:{qualname}:{sorted(kwargs.items())!r}"


def _worker_parser(spec: Tuple[str, str, Dict[str, Any]]) -> Any:
    key = _spec_key(spec)
    parser = _WORKER_PARSERS.get(key)
    if parser is None:
        module, qualname, kwargs = spec
        cls = getattr(importlib.import_module(module), qualname)
        kw = dict(kwargs)
        if "index_dtype" in kw:
            kw["index_dtype"] = np.dtype(kw["index_dtype"])
        parser = _WORKER_PARSERS[key] = cls(None, **kw)
    return parser


def _worker_parse(spec: Tuple[str, str, Dict[str, Any]], data: bytes,
                  traceparent: Optional[str] = None) -> Dict[str, Any]:
    """Parse one newline-aligned range; columns go out via shared memory.

    ``traceparent`` is the consumer's trace context shipped alongside the
    range (the same W3C string the serving path puts in HTTP headers): the
    worker's parse span — recorded in ITS process, flushed in ITS span
    file — joins the parent's trace, so the assembled timeline shows the
    fan-out instead of orphaned worker activity.
    """
    t0 = time.monotonic()
    parser = _worker_parser(spec)
    with tracecontext.activate(tracecontext.from_traceparent(traceparent)):
        if fault.enabled():
            fault.inject("data.parse_worker", parser=type(parser).__name__)
        with telemetry.span("parse_worker.parse_block",
                            parser=type(parser).__name__, nbytes=len(data)):
            container = parser.parse_block(data)
    block = container.get_block()
    meta: Dict[str, Any] = {
        "rows": int(block.size),
        "max_index": int(container.max_index),
        "max_field": int(container.max_field),
        "shm": None, "nbytes": 0, "cols": [],
    }
    if block.size:
        cols: List[Tuple[str, str, int, int]] = []
        arrays: List[Optional[np.ndarray]] = []
        total = 0
        for name in _COLUMNS:
            arr = getattr(block, name)
            if arr is not None:
                arr = np.ascontiguousarray(arr)
                cols.append((name, arr.dtype.str, total, arr.nbytes))
                total += _align8(arr.nbytes)
            else:
                cols.append((name, "", 0, 0))
            arrays.append(arr)
        shm = shared_memory.SharedMemory(create=True, size=max(total, 1))
        try:
            for (name, _, off, nbytes), arr in zip(cols, arrays):
                if nbytes:
                    np.frombuffer(shm.buf, np.uint8, nbytes, off)[:] = \
                        arr.view(np.uint8).reshape(-1)
            meta.update(shm=shm.name, nbytes=total, cols=cols)
        except BaseException:
            # the consumer never learns this segment's name: unlink it
            # HERE or the bytes sit in /dev/shm until reboot
            shm.close()
            shm.unlink()
            raise
        shm.close()
        _untrack(shm)
    meta["busy_s"] = time.monotonic() - t0
    return meta


# -- consumer side ------------------------------------------------------------

def _discard_meta(meta: Optional[Dict[str, Any]]) -> None:
    """Unlink a worker result's segment without wrapping it (error paths).

    Already-attached metas are a no-op: attach_block unlinks on attach, so
    the name is gone and only the (lease-managed) mapping remains."""
    if not meta or not meta.get("shm"):
        return
    try:
        seg = shared_memory.SharedMemory(name=meta["shm"])
    except FileNotFoundError:
        return
    try:
        seg.unlink()
    except FileNotFoundError:
        pass
    seg.close()


def _release_lease(mm, buf, gauge_bytes: int) -> None:
    try:
        buf.release()
        mm.close()
    except BufferError:
        # interpreter-shutdown ordering: views may still be alive when the
        # atexit finalizer sweep runs; the OS reclaims the mapping anyway
        pass
    if gauge_bytes:
        try:
            telemetry.gauge_add("dmlc_parse_shm_bytes_in_flight",
                                -gauge_bytes)
        except Exception:
            pass  # observability must never block a mapping release


def attach_block(meta: Dict[str, Any], index_dtype) -> RowBlockContainer:
    """Wrap one worker result into a RowBlockContainer without copying."""
    out = RowBlockContainer(index_dtype)
    out.max_index = meta["max_index"]
    out.max_field = meta["max_field"]
    if not meta["shm"]:
        return out
    shm = shared_memory.SharedMemory(name=meta["shm"])
    try:
        shm.unlink()  # mapping survives; the name must not
    except FileNotFoundError:
        pass
    # steal the mapping from the SharedMemory object: its __del__ would
    # close() under GC/shutdown and raise BufferError while RowBlock views
    # still export pointers — lifetime belongs to the finalizer below
    mm, buf = shm._mmap, shm._buf
    shm._mmap = shm._buf = None
    if getattr(shm, "_fd", -1) >= 0:  # mmap no longer needs the fd
        os.close(shm._fd)
        shm._fd = -1
    try:
        seg = np.frombuffer(buf, dtype=np.uint8)
        track = meta["nbytes"] if telemetry.enabled() else 0
        if track:
            telemetry.gauge_add("dmlc_parse_shm_bytes_in_flight", track)
    except BaseException:
        # no finalizer is registered yet: release the stolen mapping here
        # or it outlives every view that could ever free it.  Gauge delta
        # 0: gauge_add raising means the increment never landed.
        _release_lease(mm, buf, 0)
        raise
    try:
        # every column view chains its .base to `seg`; when the last view
        # dies, seg dies, and the finalizer releases the mapping
        weakref.finalize(seg, _release_lease, mm, buf, track)
    except BaseException:
        # the increment above DID land: release with the full delta so
        # the in-flight gauge cannot drift upward on this path
        _release_lease(mm, buf, track)
        raise
    views: Dict[str, Optional[np.ndarray]] = {}
    for name, dtype_str, off, nbytes in meta["cols"]:
        views[name] = (seg[off:off + nbytes].view(dtype_str)
                       if nbytes else None)
    # a range of label-only rows has rows>0 but an empty index column —
    # RowBlock needs a real len-0 array there, not None
    index = views["index"] if views["index"] is not None \
        else np.empty(0, np.dtype(index_dtype))
    out.push_block(RowBlock(views["offset"], views["label"], index,
                            views["value"], views["weight"], views["field"]))
    return out


def _default_start_method() -> str:
    import sys

    methods = mp.get_all_start_methods()
    if "spawn" in methods and ("torch" in sys.modules
                               or threading.active_count() > 1):
        # forking a multi-threaded parent (a ThreadedParser producer, the
        # torch runtime, telemetry writers) can snapshot a held lock into
        # the child and deadlock the first worker that logs or counts, and
        # a forked child cannot use the parent's CUDA context; spawn is
        # safe and stays cheap because workers never import torch (lazy
        # package design).  The pool is usually created lazily on the
        # producer thread, so in practice spawn is the threaded default
        # and fork only serves single-threaded CLI/bench use.
        return "spawn"
    return "fork" if "fork" in methods else methods[0]


# -- the process-wide worker pool ---------------------------------------------
#
# ONE executor serves every parser in the process: spawn bring-up (~0.5s a
# worker under the thread-safe default start method) is paid once, not per
# parser/epoch, and total worker count stays bounded however many pipeline
# stages exist.  Workers build per-format parser twins lazily by spec.

_pool_lock = threading.Lock()
_shared_pool: Optional[ProcessPoolExecutor] = None
_shared_size = 0

# bound on the bring-up warmup probe below: it runs under _pool_lock, so a
# wedged spawn (e.g. an inherited-state deadlock in a worker) must surface
# as a loud bring-up failure — which the caller already handles by falling
# back to the thread path — instead of parking every parser thread on the
# lock forever
_WARMUP_TIMEOUT_S = 120.0


def _get_shared_pool(nproc: int) -> Tuple[ProcessPoolExecutor, int]:
    global _shared_pool, _shared_size
    with _pool_lock:
        if _shared_pool is None:
            method = (os.environ.get(ENV_START, "").strip()
                      or _default_start_method())
            pool = ProcessPoolExecutor(max_workers=nproc,
                                       mp_context=mp.get_context(method),
                                       initializer=_worker_init)
            # warmup probe: surfaces a broken start method HERE, where the
            # caller can still fall back to the thread path, instead of as
            # a BrokenProcessPool mid-parse — and forces worker spawn so
            # the first chunk doesn't pay it
            try:
                pool.submit(_worker_ready).result(_WARMUP_TIMEOUT_S)
            except BaseException:
                # a failed bring-up must not leak the executor's queue/
                # threads/half-spawned workers on every retrying parser
                pool.shutdown(wait=False, cancel_futures=True)
                raise
            _shared_pool, _shared_size = pool, nproc
            telemetry.gauge_set("dmlc_parse_proc_workers", nproc)
        elif _shared_size != nproc:
            log_warning(f"parse worker pool already sized {_shared_size}; "
                        f"ignoring request for {nproc}")
        return _shared_pool, _shared_size


def _unstick_call_queue(queue) -> None:
    """Free a feeder thread wedged on the call-queue pipe of a broken pool.

    CPython's executor (the gh-94777 deadlock lineage, unfixed on 3.10):
    after a worker is killed, ``terminate_broken`` joins the call queue's
    feeder thread — but with every worker dead nothing drains the call
    queue, ``Queue.close`` never closes the parent's read end (no EPIPE),
    and a feeder blocked mid-write on a full pipe never returns, so the
    executor's management thread parks on the join and interpreter exit
    then hangs in ``_python_exit`` forever.  Draining the parent-side read
    end lets the blocked write complete and the feeder reach its close
    sentinel.  Only safe on a BROKEN pool: with workers alive this would
    steal their work items off the shared pipe.  Takes the queue, not the
    executor — ``Executor.shutdown`` nulls ``_call_queue``."""
    feeder = getattr(queue, "_thread", None)
    reader = getattr(queue, "_reader", None)
    if feeder is None or reader is None:
        return
    deadline = time.monotonic() + 10.0
    while feeder.is_alive() and time.monotonic() < deadline:
        try:
            if reader.poll(0.05):
                reader.recv_bytes()
        except (OSError, EOFError):
            break


def _discard_shared_pool(pool: ProcessPoolExecutor) -> None:
    """Drop a broken pool so the next parser self-heals with a fresh one."""
    global _shared_pool, _shared_size
    with _pool_lock:
        if _shared_pool is pool:
            _shared_pool, _shared_size = None, 0
            telemetry.gauge_set("dmlc_parse_proc_workers", 0)
    queue = getattr(pool, "_call_queue", None)   # shutdown() nulls it
    pool.shutdown(wait=False, cancel_futures=True)
    _unstick_call_queue(queue)


def engaged() -> bool:
    """True while the shared worker pool is up (the process backend is
    actually serving parses, not the thread fallback) — the public probe
    benchmarks/monitoring should use."""
    return _shared_pool is not None


def shutdown() -> None:
    """Tear the shared pool down (tests / explicit lifecycle control)."""
    global _shared_pool, _shared_size
    with _pool_lock:
        pool, _shared_pool, _shared_size = _shared_pool, None, 0
    if pool is not None:
        pool.shutdown(wait=False, cancel_futures=True)


class ProcParsePool:
    """A handle for one TextParserBase onto the shared worker pool.

    ``spec`` is ``(module, qualname, kwargs)`` — enough to rebuild a
    source-less, single-threaded twin of the owning parser inside a worker
    (see ``TextParserBase._proc_spec``); workers cache twins by spec, so
    any mix of formats shares the same processes."""

    def __init__(self, spec: Tuple[str, str, Dict[str, Any]], nproc: int):
        self._spec = spec
        self._index_dtype = np.dtype(spec[2].get("index_dtype", np.uint32))
        self._pool, self.nproc = _get_shared_pool(max(2, int(nproc)))

    def alive(self) -> bool:
        """True while this handle's executor is still the shared pool (a
        worker death discards the shared pool; stale handles must not
        submit to a shut-down executor)."""
        return self._pool is not None and self._pool is _shared_pool

    def parse_ranges(self, ranges: Sequence[bytes],
                     parser_name: str = "") -> List[RowBlockContainer]:
        """Parse ranges on the workers; containers in submission order.

        Error discipline: if any range fails (parse error, killed worker),
        every segment the *other* ranges already created is unlinked before
        the error propagates — the workers unregister their segments from
        the resource tracker (the consumer owns cleanup), so a dropped meta
        would otherwise leak /dev/shm bytes until reboot."""
        # context propagation rides NEXT TO the payload, never inside it:
        # the worker re-activates it around the parse span only
        tp = (tracecontext.current_traceparent()
              if telemetry.enabled() else None)
        futures = [self._pool.submit(_worker_parse, self._spec, r, tp)
                   for r in ranges]
        metas: List[Dict[str, Any]] = []
        error: Optional[BaseException] = None
        for future in futures:
            try:
                metas.append(future.result())
            except BaseException as exc:  # noqa: BLE001 - cleanup then raise
                error = exc
                break
        if error is not None:
            # drain the uncollected tail's segments too (metas holds the
            # successes before the failure; futures[len(metas)] raised)
            for future in futures[len(metas) + 1:]:
                try:
                    metas.append(future.result())
                except BaseException:    # noqa: BLE001 - already failing
                    pass
            for meta in metas:
                _discard_meta(meta)
            if isinstance(error, BrokenProcessPool):
                # the executor is unusable after a worker death: drop it so
                # the next parser self-heals with a fresh pool
                _discard_shared_pool(self._pool)
                raise RuntimeError(
                    "parse worker died mid-chunk (killed or crashed); "
                    f"the parse cannot continue: {error}") from error
            raise error
        if telemetry.enabled():
            telemetry.count("dmlc_parse_proc_ranges_total", len(ranges),
                            parser=parser_name)
            telemetry.count("dmlc_parse_proc_busy_seconds_total",
                            sum(m["busy_s"] for m in metas),
                            parser=parser_name)
        try:
            return [attach_block(m, self._index_dtype) for m in metas]
        except BaseException:
            for meta in metas:           # unattached leftovers would leak
                _discard_meta(meta)
            raise

    def close(self) -> None:
        """Release the handle; the shared pool outlives any one parser
        (call :func:`shutdown` for explicit process-wide teardown)."""
        self._pool = None
