"""Micro-batching scheduler: coalesce concurrent requests, pad to buckets.

Counterpart of ``dmlc_core_tpu/serve/scheduler.py``; the one change is the
sync point, where a dispatched batch's scores come to the host
(:func:`~.model_runtime.to_host`).

The latency/throughput knee of an online scorer is set by two knobs:

- ``max_batch`` — the most rows one predict call may carry (throughput
  ceiling: bigger batches amortize dispatch + matmul overhead);
- ``max_delay_ms`` — how long the first request of a batch may wait for
  company (latency floor under light load: an idle server answers a lone
  request after at most this delay).

One **batcher thread** owns the assembly loop: it blocks for the first
pending request, then gathers more until the batch is full or the delay
budget is spent, pads the assembled rows up to the next rung of the bucket
ladder (:func:`batch_buckets` — the ``bridge.batching.bucket_size`` ladder
from 1), and runs the model runtime's predict exactly once for the whole
batch.  Bucketing keeps the set of batch shapes logarithmic in
``max_batch``; warmup runs all of them at load, so steady-state requests
never pay a first call's allocations.

Failure discipline (the chaos suite drives these paths):

- a predict failure fails **that batch's** requests with a structured 503
  (:class:`~.errors.PredictFailed`, Retry-After 1) and the loop continues
  — one poisoned batch cannot take the server down;
- the batcher thread itself is crash-ferried: an escape from the loop body
  is recorded, pending requests are failed structurally, and the next
  ``submit`` restarts the thread (self-healing);
- shutdown fails queued-but-unbatched requests with ``Overloaded
  (shutting_down)`` rather than leaving their futures hanging.

**Double-buffered dispatch** (the device-feed discipline of
``bridge/loader.py`` applied to serving): a batch's predict is *dispatched*
(``runtime.predict_async`` — host binning, device transfer, compute and
the scores' copy back, all queued on the device's stream) and only
*synced* after the next batch has been assembled and dispatched, so the
next batch's binning and transfer hide behind the in-flight predict.  The
sync waits on the batch's own event, not on the whole stream, so it does
not wait for the batch queued behind it.  When the queue is idle the in-flight batch resolves
immediately — pipelining engages exactly when there is load to pipeline,
and light-load latency is unchanged.

**Hot swap**: :meth:`MicroBatcher.
set_runtime` is the atomic pointer flip the model registry swaps through —
taken under the batcher's own ``_thread_lock``, with the dispatch loop
snapshotting ``self.runtime`` exactly once per batch, so an in-flight batch
always finishes on the runtime it was dispatched against and no request is
ever scored by a half-swapped model.

Fault sites: ``serve.queue`` fires once per batch assembly (a ``stall``
models a stuck consumer — the queue backs up and admission starts
shedding); ``serve.predict`` fires before the model call (``error`` models
a killed predict worker).
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.bridge.batching import bucket_size
from dmlc_core_tpu_torch.serve.admission import AdmissionController
from dmlc_core_tpu_torch.serve.errors import (BadRequest, Overloaded,
                                              PredictFailed)
from dmlc_core_tpu_torch.serve.model_runtime import ModelRuntime, to_host
from dmlc_core_tpu_torch.telemetry import clock, tracecontext
from dmlc_core_tpu_torch.utils.logging import log_error, log_warning

__all__ = ["MicroBatcher", "batch_buckets"]

# histogram bounds for batch row counts (powers of two up to the practical
# serving range; the registry adds +Inf)
_BATCH_ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def batch_buckets(max_batch: int) -> List[int]:
    """Ascending bucket ladder ``[1, 2, 3, 4, 6, 8, ...]`` capped so the
    largest rung is exactly ``max_batch`` (every padded shape the scheduler
    can emit, i.e. every shape warmup must run)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b = bucket_size(b + 1, minimum=b)
    out.append(max_batch)
    return out


class _Pending:
    """One admitted request riding the queue toward a batch."""

    __slots__ = ("rows", "future", "nbytes", "enqueued_at", "ctx")

    def __init__(self, rows: np.ndarray, future, nbytes: int, now: float,
                 ctx=None):
        self.rows = rows
        self.future = future
        self.nbytes = nbytes
        self.enqueued_at = now
        # the submitting request's trace context (handler thread), so the
        # batcher thread can credit queue wait + predict share back to the
        # request's own trace even though it runs them on behalf of many
        self.ctx = ctx


class _InFlight:
    """A dispatched-but-unsynced batch riding the double buffer."""

    __slots__ = ("batch", "handle", "runtime", "bucket", "rows",
                 "t_dispatch", "ctx")

    def __init__(self, batch, handle, runtime, bucket, rows, t_dispatch,
                 ctx):
        self.batch = batch          # List[_Pending]
        self.handle = handle        # un-synced predict result
        self.runtime = runtime      # the runtime snapshot it ran on
        self.bucket = bucket
        self.rows = rows
        self.t_dispatch = t_dispatch
        self.ctx = ctx              # the serve.batch span's trace context


class MicroBatcher:
    """Request coalescer + the single predict consumer thread."""

    def __init__(self, runtime: ModelRuntime, *, max_batch: int = 64,
                 max_delay_ms: float = 2.0,
                 admission: Optional[AdmissionController] = None,
                 name: Optional[str] = None):
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        self.runtime = runtime
        #: the model-slot name riding every metric's ``model=`` label
        #: (defaults to the runtime family for single-model servers, so
        #: legacy series keys are unchanged)
        self.name = name or runtime.name
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.admission = admission or AdmissionController(name=self.name)
        self.buckets = batch_buckets(self.max_batch)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._carry: Optional[_Pending] = None  # overflow from last assembly
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # reentrant: _ensure_thread locks for itself AND is called from
        # submit()'s stop-check/enqueue critical section
        self._thread_lock = threading.RLock()
        self._crash: Optional[BaseException] = None
        # requests popped by an assembly that then crashed, answered by the
        # crash handler once the thread is deregistered
        self._popped: List[_Pending] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._ensure_thread()

    def set_runtime(self, runtime: ModelRuntime) -> None:
        """Atomically swap the model behind the queue (the hot-swap flip).

        The new runtime must honor the slot's feature contract — requests
        already validated against ``num_feature`` may still be queued.
        Taken under ``_thread_lock`` (the same lock submit/close/crash
        recovery use); the dispatch loop snapshots ``self.runtime`` once
        per batch, so in-flight batches finish on the old runtime and
        every later batch runs entirely on the new one — there is no
        half-swapped state a request could observe.
        """
        if runtime.num_feature != self.runtime.num_feature:
            raise ValueError(
                f"cannot swap in a runtime with num_feature="
                f"{runtime.num_feature}; this batcher's contract is "
                f"{self.runtime.num_feature}")
        with self._thread_lock:
            self.runtime = runtime

    def _ensure_thread(self) -> None:
        with self._thread_lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._crash = None
            self._thread = threading.Thread(
                target=self._loop, name="serve-batcher", daemon=False)
            self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the batcher and fail anything still queued (structured)."""
        self._stop.set()
        with self._thread_lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                log_warning("serve-batcher did not stop within "
                            f"{timeout}s; abandoning it")
        self._drain_failed(Overloaded("server shutting down",
                                      retry_after=5.0), reason="shutdown")

    def _drain_failed(self, exc: Exception, *, reason: str) -> None:
        pending = []
        # close() drains from the caller's thread while the batcher loop
        # may still be parked in _assemble: the carry swap must hold the
        # same (reentrant) lock _assemble uses
        with self._thread_lock:
            if self._carry is not None:
                pending.append(self._carry)
                self._carry = None
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if pending:
            self.admission.release(sum(i.nbytes for i in pending))
            for item in pending:
                _fail_future(item.future, exc)
            telemetry.count("dmlc_serve_shed_total", len(pending),
                            model=self.name, reason=reason)

    # -- producer side -------------------------------------------------------

    def submit(self, rows: np.ndarray):
        """Admit + enqueue ``rows`` ([n, F] float32); returns the Future
        resolving to this request's ``[n]``/``[n, K]`` predictions.

        Raises the structured rejections directly: ``BadRequest`` on a
        contract violation, ``Overloaded`` from admission.
        """
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.runtime.num_feature:
            raise BadRequest(
                f"instances must be [n, {self.runtime.num_feature}] "
                f"(got shape {tuple(rows.shape)})")
        n = rows.shape[0]
        if n == 0:
            raise BadRequest("empty instances")
        if n > self.max_batch:
            raise BadRequest(
                f"{n} instances exceed max_batch={self.max_batch}; "
                "split the request",
                details={"max_batch": self.max_batch})
        if self._crash is not None:
            # the previous thread died outside the per-batch guard: surface
            # once, then self-heal below
            log_warning(f"serve-batcher restarting after crash: "
                        f"{self._crash!r}")
        self.admission.try_admit(rows.nbytes)
        from concurrent.futures import Future

        ctx = tracecontext.current() if telemetry.enabled() else None
        item = _Pending(rows, Future(), rows.nbytes, clock.monotonic(),
                        ctx=ctx)
        with self._thread_lock:
            if self._stop.is_set():
                self.admission.release(item.nbytes)
                telemetry.count("dmlc_serve_shed_total", model=self.name,
                                reason="shutdown")
                raise Overloaded("server shutting down", retry_after=5.0)
            self._ensure_thread()  # self-heal a dead batcher
            # enqueue under the lock: a put after close()'s drain would
            # strand this item (future unresolved, bytes leaked)
            self._queue.put(item)
        telemetry.gauge_set("dmlc_serve_queue_depth", self._queue.qsize(),
                            model=self.name)
        return item.future

    # -- consumer side -------------------------------------------------------

    def _loop(self) -> None:
        # the whole-target try/except is the lockset-thread-leak discipline:
        # nothing may escape a serving thread silently
        try:
            self._run()
        except BaseException as exc:  # noqa: BLE001 — ferried, not swallowed
            log_error(f"serve-batcher crashed: {exc!r}")
            telemetry.count("dmlc_serve_batcher_crashes_total")
            # deregister + drain under the lock: a racing submit() either
            # lands before the drain (failed structurally here) or after
            # it, when _ensure_thread sees no thread and starts a fresh
            # batcher to consume it — nothing can strand in between.  The
            # popped requests are answered only after the deregistration,
            # so a client retrying on that answer starts a fresh batcher
            with self._thread_lock:
                self._crash = exc
                if self._thread is threading.current_thread():
                    self._thread = None
                popped, self._popped = self._popped, []
                if popped:
                    failure = PredictFailed(f"batch assembly failed: {exc}",
                                            retry_after=2.0)
                    telemetry.count("dmlc_serve_shed_total", len(popped),
                                    model=self.name, reason="predict_failed")
                    self.admission.release(sum(i.nbytes for i in popped))
                    for item in popped:
                        _fail_future(item.future, failure)
                self._drain_failed(PredictFailed(
                    f"scoring backend crashed: {exc}", retry_after=2.0),
                    reason="predict_failed")

    def _run(self) -> None:
        # the double buffer: at most ONE dispatched-but-unsynced batch.
        # Under load the loop dispatches batch N+1 (its transfer queues
        # behind N's compute) before syncing N; when the queue goes idle
        # the in-flight batch resolves immediately (wait=False returns
        # empty without blocking), so pipelining never delays a lone
        # request.
        inflight: Optional[_InFlight] = None
        try:
            while not self._stop.is_set():
                try:
                    batch = self._assemble(wait=inflight is None)
                except BaseException:
                    # the in-flight predict was already dispatched: sync
                    # and answer it before the crash ferries out
                    if inflight is not None:
                        self._resolve(inflight)
                        inflight = None
                    raise
                started = self._dispatch(batch) if batch else None
                if inflight is not None:
                    self._resolve(inflight)
                inflight = started
        finally:
            if inflight is not None:
                self._resolve(inflight)

    def _assemble(self, wait: bool = True) -> List[_Pending]:
        """Gather the next batch: seed from the carry or the queue, then
        keep gathering until full or the delay budget is spent.  An item
        that would overflow ``max_batch`` carries over as the seed of the
        next batch.  With ``wait=False`` (a batch is in flight) an empty
        queue returns immediately instead of blocking — the in-flight
        batch must resolve, not sit behind a poll timeout.

        Crash-safe: requests already popped when an assembly fault fires
        ferry out with the crash (``_popped``) and are failed structurally
        by its handler — a popped item whose future never resolves would
        hang its client until the request timeout for no reason.
        """
        batch: List[_Pending] = []
        try:
            with self._thread_lock:
                first, self._carry = self._carry, None
            if first is None:
                try:
                    if wait:
                        first = self._queue.get(timeout=0.05)
                    else:
                        first = self._queue.get_nowait()
                except queue.Empty:
                    return []
            batch.append(first)
            # a stalled consumer: the one fault that makes admission shed
            fault.inject("serve.queue", depth=self._queue.qsize())
            rows = first.rows.shape[0]
            deadline = clock.monotonic() + self.max_delay_s
            while rows < self.max_batch:
                remaining = deadline - clock.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if rows + item.rows.shape[0] > self.max_batch:
                    with self._thread_lock:
                        self._carry = item
                    break
                batch.append(item)
                rows += item.rows.shape[0]
        except BaseException:
            self._popped = batch
            raise
        telemetry.gauge_set("dmlc_serve_queue_depth", self._queue.qsize(),
                            model=self.name)
        return batch

    def _dispatch(self, batch: List[_Pending]) -> Optional[_InFlight]:
        """Assemble + pad one batch and dispatch its predict without
        syncing.  Returns the in-flight handle, or ``None`` when the
        dispatch itself failed (that batch is already failed
        structurally; the loop continues)."""
        # ONE runtime snapshot per batch: a concurrent set_runtime (hot
        # swap) lands either entirely before or entirely after this batch
        runtime = self.runtime
        n = sum(item.rows.shape[0] for item in batch)
        bucket = self.buckets[-1] if n >= self.max_batch \
            else next(b for b in self.buckets if b >= n)
        now = clock.monotonic()
        for item in batch:
            telemetry.observe("dmlc_serve_queue_seconds",
                              now - item.enqueued_at, model=self.name)
        try:
            with telemetry.span("serve.batch", model=self.name, rows=n,
                                bucket=bucket,
                                requests=len(batch)) as batch_span:
                ctx = tracecontext.current() if telemetry.enabled() else None
                if telemetry.enabled():
                    # the batch belongs to no single request: it LINKS the
                    # trace of every request it coalesced, so the assembler
                    # (and a human in Perfetto) can hop batch -> requests
                    linked = [item.ctx.trace_id for item in batch
                              if item.ctx is not None]
                    if linked:
                        batch_span.set(links=",".join(linked[:32]),
                                       linked_traces=len(linked))
                x = np.zeros((bucket, runtime.num_feature), np.float32)
                ofs = 0
                for item in batch:
                    x[ofs:ofs + item.rows.shape[0]] = item.rows
                    ofs += item.rows.shape[0]
                fault.inject("serve.predict", model=runtime.name,
                             slot=self.name, rows=n)
                t0 = clock.monotonic()
                handle = runtime.predict_async(x)
        except Exception as exc:
            self._fail_batch(batch, n, exc)
            return None
        return _InFlight(batch, handle, runtime, bucket, n, t0, ctx)

    def _resolve(self, f: _InFlight) -> None:
        """Sync the in-flight predict and answer its requests — the
        device round-trip this batch's transfer already overlapped."""
        try:
            # the device-to-host step: a failure on the device surfaces
            # here and fails this batch, as any predict failure does
            y = to_host(f.handle)
        except Exception as exc:
            self._fail_batch(f.batch, f.rows, exc)
            return
        t1 = clock.monotonic()
        telemetry.observe("dmlc_serve_predict_seconds", t1 - f.t_dispatch,
                          model=self.name)
        if telemetry.enabled():
            # the predict span (dispatch -> synced) parents under the
            # serve.batch span it was dispatched from, even though that
            # span closed when the double buffer moved on
            trace = ((f.ctx.trace_id, tracecontext.new_span_id(),
                      f.ctx.span_id) if f.ctx is not None else None)
            telemetry.record_span("serve.predict", f.t_dispatch, t1,
                                  trace=trace, model=self.name,
                                  bucket=f.bucket)
            # per-request attribution INTO each request's own trace: its
            # queue wait and its share of the shared predict call,
            # parented under the request's serve.request span — the two
            # stages the critical-path analysis splits a scored request
            # into
            for item in f.batch:
                ctx = item.ctx
                if ctx is None or not ctx.span_id:
                    continue
                telemetry.record_span(
                    "serve.queue.wait", item.enqueued_at, f.t_dispatch,
                    trace=(ctx.trace_id, tracecontext.new_span_id(),
                           ctx.span_id))
                telemetry.record_span(
                    "serve.predict", f.t_dispatch, t1,
                    trace=(ctx.trace_id, tracecontext.new_span_id(),
                           ctx.span_id),
                    bucket=f.bucket, rows=item.rows.shape[0],
                    shared_requests=len(f.batch))
        telemetry.count("dmlc_serve_batches_total", model=self.name)
        telemetry.count("dmlc_serve_rows_total", f.rows, model=self.name)
        telemetry.observe("dmlc_serve_batch_rows", f.rows,
                          buckets=_BATCH_ROW_BUCKETS, model=self.name)
        # one release per batch: the admission drain-rate estimate samples
        # real consumption, not the microsecond spacing of a per-item loop
        self.admission.release(sum(i.nbytes for i in f.batch))
        # which model build scored this batch: the runtime snapshot's
        # checkpoint version (stamped by the registry), annotated on the
        # future BEFORE the result lands so a reader of the result always
        # sees it — the transport reports it per response
        version = getattr(f.runtime, "version", None)
        ofs = 0
        for item in f.batch:
            k = item.rows.shape[0]
            item.future.dmlc_served_version = version
            _set_future(item.future, np.asarray(y[ofs:ofs + k]))
            ofs += k

    def _fail_batch(self, batch: List[_Pending], n: int,
                    exc: BaseException) -> None:
        """Shed one poisoned batch structurally; the loop continues."""
        telemetry.count("dmlc_serve_predict_errors_total", model=self.name)
        telemetry.count("dmlc_serve_shed_total", len(batch),
                        model=self.name, reason="predict_failed")
        log_error(f"serve: predict failed for a {n}-row batch: {exc!r}")
        failure = PredictFailed(f"predict failed: {exc}")
        self.admission.release(sum(i.nbytes for i in batch))
        for item in batch:
            _fail_future(item.future, failure)


def _set_future(future, value) -> None:
    try:
        future.set_result(value)
    except Exception:  # already cancelled/timed out: the answer has no taker
        pass


def _fail_future(future, exc: Exception) -> None:
    try:
        future.set_exception(exc)
    except Exception:
        pass
