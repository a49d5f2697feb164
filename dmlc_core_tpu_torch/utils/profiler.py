"""Throughput metering (reference §5.1: timer.h + inline MB/s logs).

Counterpart of ``dmlc_core_tpu/utils/profiler.py``'s
:class:`ThroughputMeter`, the input-pipeline "N MB read, X MB/sec" meter
(reference src/data/basic_row_iter.h:70-75).  Device work is timed with
:func:`dmlc_core_tpu_torch.utils.timer.device_time`.
"""

from __future__ import annotations

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.telemetry import clock
from dmlc_core_tpu_torch.utils.logging import log_info

__all__ = ["ThroughputMeter"]


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
