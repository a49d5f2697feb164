"""Timers that wait for the card.

Counterpart of ``dmlc_core_tpu/utils/timer.py``.  PyTorch returns before
CUDA work finishes, so a host clock around device work must end in
``torch.cuda.synchronize()``; kernel times come from CUDA events over many
launches.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import torch

__all__ = ["get_time", "device_time", "cuda_event_ms"]


def get_time() -> float:
    """Seconds on a monotonic clock."""
    return time.perf_counter()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_time(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    """Run ``fn`` and wait for the card; return (result, elapsed seconds)."""
    _sync()
    start = get_time()
    out = fn(*args, **kwargs)
    _sync()
    return out, get_time() - start


def cuda_event_ms(fn: Callable[[], Any], iters: int = 10,
                  warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, from
    CUDA events around ``iters`` calls after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
