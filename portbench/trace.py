"""The traced run's instruments: spans around the port's layer entry points
and a device trace of a steady part of the window.

:class:`Spans` times named spans on the stream: CUDA events on the card
(read once the window has closed, so recording them costs no wait), the
host clock on the CPU.  :func:`profiled` runs a callable under
``torch.profiler`` with CPU and CUDA activity inside a ``portbench.window``
annotation that begins and ends with a synchronise, writes the Chrome trace
to a temporary file, and reduces it to:

- ``busy_s``: seconds in which a kernel, copy or set ran on the device
  (the union of their intervals), ``window_s`` the annotation's length;
- ``device_ops``: how many kernels, copies and sets ran;
- ``top_ops``: device seconds by operation name, most first;
- ``idle_gaps``: idle device seconds inside the window by what the host's
  main thread was doing at the gap's start (its innermost operator or
  runtime call, ``python`` where none), most first.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"


class Spans:
    """Named spans on the current stream; totals in milliseconds."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.open: Dict[str, object] = {}
        self.done: Dict[str, List] = defaultdict(list)

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self, name: str) -> None:
        self.open[name] = self._mark()

    def stop(self, name: str) -> None:
        self.done[name].append((self.open.pop(name), self._mark()))

    def wrap(self, name: str, fn: Callable) -> Callable:
        def spanned(*args, **kwargs):
            self.start(name)
            out = fn(*args, **kwargs)
            self.stop(name)
            return out
        return spanned

    def total_ms(self, name: str) -> float:
        """Summed milliseconds of the spans of ``name`` (synchronises)."""
        if self.cuda:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.done[name])
        return sum(b - a for a, b in self.done[name]) * 1e3

    def count(self, name: str) -> int:
        return len(self.done[name])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def profiled(fn: Callable, device) -> Dict:
    """Run ``fn()`` under the profiler; returns the reduced trace above
    (``window_s`` from the host clock when no annotation is found)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            start = time.perf_counter()
            fn()
            _sync(device)
            wall = time.perf_counter() - start
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out = reduce_trace(events)
    if out["window_s"] <= 0:
        out["window_s"] = wall
    return out


def _union_s(spans) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def reduce_trace(events: List[Dict]) -> Dict:
    """Busy and idle time, operations and gaps of a Chrome trace (times in
    microseconds) inside its ``portbench.window`` annotation."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        main = (win[0].get("pid"), win[0].get("tid"))
    else:
        w0, w1, main = -float("inf"), float("inf"), None
    dev = []
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e.get("name", "?")] += (b - a) / 1e6
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e.get("name", "?")) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                   and (main is None
                        or (e.get("pid"), e.get("tid")) == main)),
                  key=lambda h: (h[0], -h[1]))
    gaps = _idle_gaps(sorted(dev), w0, w1) if win and dev else []
    idle: Dict[str, float] = defaultdict(float)
    for (g0, g1), label in zip(gaps, _host_at(host, [g[0] for g in gaps])):
        idle[label] += (g1 - g0) / 1e6
    return {"busy_s": _union_s(dev),
            "window_s": (w1 - w0) / 1e6 if win else 0.0,
            "device_ops": len(dev),
            "top_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])}


def _idle_gaps(dev, w0: float, w1: float):
    gaps, end = [], w0
    for a, b in dev:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def _host_at(host, times):
    """The innermost host event covering each of the sorted ``times``."""
    starts = [h[0] for h in host]
    labels = []
    for t in times:
        i = bisect.bisect_right(starts, t)
        best = None
        # scan back over the events that began before t; the innermost
        # covering one began last
        j = i - 1
        while j >= 0 and i - j <= 4096:
            if host[j][1] > t:
                best = host[j][2]
                break
            j -= 1
        labels.append(best or "python")
    return labels
