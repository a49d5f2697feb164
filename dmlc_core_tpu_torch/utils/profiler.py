"""Tracing and profiling helpers (reference §5.1: timer.h + inline MB/s
logs).

Counterpart of ``dmlc_core_tpu/utils/profiler.py``:

- :class:`ThroughputMeter`: the input-pipeline "N MB read, X MB/sec" meter
  (reference src/data/basic_row_iter.h:70-75), reusable by any byte stage;
- :func:`trace`: a ``torch.profiler`` capture (CPU, and the card when
  there is one) written to a directory as a Chrome/TensorBoard trace, the
  counterpart of ``jax.profiler.start_trace``;
- :func:`annotate`: a named span in such a trace
  (``torch.profiler.record_function``, for ``TraceAnnotation``);
- :func:`device_timer`: seconds per call with warm-up calls first, from
  CUDA events once the card is in use (the card's queue waited for before
  the clock is read), else from the host clock.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Iterator, Tuple

import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.telemetry import clock
from dmlc_core_tpu_torch.utils.logging import log_info

__all__ = ["ThroughputMeter", "trace", "annotate", "device_timer"]


class ThroughputMeter:
    """Incremental byte/row throughput with periodic logging.

    A thin facade over the telemetry registry: the rolling state here only
    feeds :meth:`summary` / the periodic log line; when telemetry is enabled
    every :meth:`add` also lands in the ``dmlc_pipeline_bytes_total`` /
    ``dmlc_pipeline_rows_total`` counters (labeled ``meter=<name>``), so
    there is exactly one metering path and exporters see what the log says.
    """

    def __init__(self, name: str = "pipeline", log_every_bytes: int = 10 << 20):
        self.name = name
        self._log_every = log_every_bytes
        self.reset()

    def reset(self) -> None:
        self._start = clock.monotonic()
        self._bytes = 0
        self._rows = 0
        self._next_log = self._log_every

    def add(self, nbytes: int, nrows: int = 0) -> None:
        self._bytes += nbytes
        self._rows += nrows
        if telemetry.enabled():
            if nbytes:
                telemetry.count("dmlc_pipeline_bytes_total", nbytes,
                                meter=self.name)
            if nrows:
                telemetry.count("dmlc_pipeline_rows_total", nrows,
                                meter=self.name)
        if self._bytes >= self._next_log:
            self._next_log += self._log_every
            log_info(f"{self.name}: {self.mb:.0f} MB read, "
                     f"{self.mb_per_sec:.2f} MB/sec")

    @property
    def elapsed(self) -> float:
        return max(clock.elapsed(self._start), 1e-9)

    @property
    def mb(self) -> float:
        return self._bytes / (1 << 20)

    @property
    def mb_per_sec(self) -> float:
        return self.mb / self.elapsed

    @property
    def rows_per_sec(self) -> float:
        return self._rows / self.elapsed

    def summary(self) -> str:
        return (f"{self.name}: {self.mb:.2f} MB in {self.elapsed:.2f}s "
                f"({self.mb_per_sec:.2f} MB/sec, "
                f"{self.rows_per_sec:.0f} rows/sec)")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Any]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where the card is available) and write the trace into ``log_dir``
    (one ``*.pt.trace.json``, loadable by TensorBoard's profile plugin
    or ``chrome://tracing``).  Yields the profiler, whose
    ``key_averages()`` sums the spans."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span inside a :func:`trace`."""
    with torch.profiler.record_function(name):
        yield


def _card_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_timer(fn: Callable, *args: Any, iters: int = 1,
                 warmup: int = 1) -> Tuple[Any, float]:
    """``(result, seconds per call)`` of ``fn(*args)``: ``warmup``
    untimed calls, then ``iters`` timed ones, between CUDA events on the
    current stream when the card is in use (the end event waited for),
    else on the host clock.  PyTorch returns before the card finishes, so
    only a clock read after the queue drains is honest."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args)
    iters = max(iters, 1)
    if _card_in_use():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3 / iters
    begin = clock.monotonic()
    for _ in range(iters):
        out = fn(*args)
    return out, clock.elapsed(begin) / iters
