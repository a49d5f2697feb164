#!/usr/bin/env python3
"""The port's program spans in a traced run of a cell.

The port's telemetry spans (``gbdt.round``, ``gbdt.hist``,
``gbdt.split_scan``, ``gbdt.route``, ``gbdt.leaf``, ``gbdt.draw``,
``gbdt.predict``) appear in a ``torch.profiler`` Chrome trace as
``user_annotation`` events of the thread that ran them.  :func:`reduce_spans`
reduces a trace by the innermost such span of the main thread
(``portbench.window`` aside; ``(outside)`` where none is open):

- ``span_device_ms``: device milliseconds of the kernels, copies and sets
  whose launch (the runtime call of the same ``correlation`` id) lay in the
  span: the span's self time on the device;
- ``span_idle_ms``: idle-gap milliseconds by the span open on the host when
  the gap began;
- ``span_idle_gaps``: idle seconds by ``<span>/<host op>`` (the host op
  alone where no span is open), most first;
- ``span_syncs``: ``cuda{Stream,Device,Event}Synchronize`` calls, with
  ``(inside gbdt.round)`` the count inside any boosting round;
- ``span_calls``: the number of spans by name.

:func:`readings` turns a traced training call's reduction into per-round
numbers.  Run as a command, from the checkout's root, it runs one cell once
as ``run.py --trace 1`` does, prints that run's result line, then one more
line with the spans' reduction and readings of the same traced call::

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

No metric of ``BENCHMARK.json`` reads these yet: the traced run's
reduction (``trace.reduce_trace``) keeps no events for them, so the command
adds this reduction to it in its own process.
"""

import time

T0 = time.perf_counter()    # set-up is timed from here, as in run.py

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Dict, List  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from portbench import trace  # noqa: E402

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
OUTSIDE = "(outside)"
ROUND = "gbdt.round"
IN_ROUND = "(inside gbdt.round)"
# per-round readings of a training call: device self time of a span, ms
PER_ROUND_MS = {"split_scan_ms": "gbdt.split_scan", "route_ms": "gbdt.route",
                "leaf_ms": "gbdt.leaf", "draw_ms": "gbdt.draw",
                "hist_self_ms": "gbdt.hist"}


def reduce_spans(events: List[Dict]) -> Dict:
    """Device time, idle time, idle gaps, syncs and calls of a Chrome trace
    (times in microseconds) by program span, inside its
    ``portbench.window`` annotation where it has one."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == trace.WINDOW
           and e.get("cat") == "user_annotation"]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        main = (win[0].get("pid"), win[0].get("tid"))
    else:
        w0, w1, main = -float("inf"), float("inf"), None

    def on_main(e):
        return main is None or (e.get("pid"), e.get("tid")) == main

    def interval(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    dev, dev_launch = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        a, b = interval(e)
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        # an op whose launch the trace lacks lies in no span
        dev_launch.append(launched.get(e.get("args", {}).get("correlation"),
                                       -float("inf")))
    host = sorted((interval(e) + (e.get("name", "?"),) for e in events
                   if e.get("ph") == "X" and e.get("cat") in trace.HOST_CATS
                   and on_main(e)), key=lambda h: (h[0], -h[1]))
    spans = sorted((interval(e) + (e["name"],) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") != trace.WINDOW and on_main(e)),
                   key=lambda h: (h[0], -h[1]))

    span_dev: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(dev, _innermost(spans, dev_launch)):
        span_dev[name or OUTSIDE] += (b - a) / 1e3
    gaps = trace._idle_gaps(sorted(dev), w0, w1) if win and dev else []
    starts = [g[0] for g in gaps]
    idle: Dict[str, float] = defaultdict(float)
    span_idle: Dict[str, float] = defaultdict(float)
    for (g0, g1), op, name in zip(gaps, trace._host_at(host, starts),
                                  _innermost(spans, starts)):
        idle[op if name is None else f"{name}/{op}"] += (g1 - g0) / 1e6
        span_idle[name or OUTSIDE] += (g1 - g0) / 1e3
    sync_ts = [h[0] for h in host if h[2] in SYNCS]
    syncs: Dict[str, int] = defaultdict(int)
    for name in _innermost(spans, sync_ts):
        syncs[name or OUTSIDE] += 1
    rounds = [sp for sp in spans if sp[2] == ROUND]
    syncs[IN_ROUND] = sum(name is not None
                          for name in _innermost(rounds, sync_ts))
    calls: Dict[str, int] = defaultdict(int)
    for sp in spans:
        calls[sp[2]] += 1
    return {"span_device_ms": dict(span_dev),
            "span_idle_ms": dict(span_idle),
            "span_idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
            "span_syncs": dict(syncs),
            "span_calls": dict(calls)}


def _innermost(spans, times):
    """The name of the innermost of ``spans`` covering each of ``times``,
    None where none does.  ``spans`` are (start, end, name) of one thread
    sorted by start, longest first, so they nest: one sweep with a stack."""
    out: List = [None] * len(times)
    stack: List = []
    i = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            stack.append(spans[i])
            i += 1
        # a span ended before t sits on top (or under one that did)
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def readings(ctx: Dict) -> Dict:
    """Per-round numbers of a traced training call's reduction (``ctx`` as
    the kinds leave it, with :func:`reduce_spans`'s keys): each span's
    device self time in ms, the syncs inside ``gbdt.round``, and the share
    of busy device time launched in no span (%).  Each is None where the
    program recorded no such span (a program without them, a scoring call)
    or the trace saw no device."""
    calls = ctx.get("span_calls", {})
    live = ctx.get("kind") == "train" and bool(ctx.get("device_ops"))
    out = {}
    for key, name in PER_ROUND_MS.items():
        out[key] = ctx["span_device_ms"].get(name, 0.0) / ctx["rounds"] \
            if live and calls.get(name) else None
    out["host_syncs_per_round"] = ctx["span_syncs"].get(IN_ROUND, 0) \
        / ctx["rounds"] if live and calls.get(ROUND) else None
    out["outside_pct"] = 100.0 * ctx["span_device_ms"].get(OUTSIDE, 0.0) \
        / (ctx["busy_s"] * 1e3) if live and calls.get(ROUND) else None
    return out


def main(argv, device=None) -> int:
    """Run a cell once traced (``device`` as in ``harness.main``) and print
    its result line, then the spans' line."""
    from portbench import harness

    seen = []
    plain = trace.reduce_trace

    def reduce_trace(events):
        out = plain(events)
        out.update(reduce_spans(events))
        seen.append(out)        # the kinds add their keys to this dict
        return out

    trace.reduce_trace = reduce_trace
    try:
        rc = harness.main(list(argv) + ["--trace", "1"], T0, device)
    finally:
        trace.reduce_trace = plain
    if rc == 0 and seen:
        ctx = seen[0]
        keys = ("span_device_ms", "span_idle_ms", "span_syncs", "span_calls",
                "busy_s", "window_s", "call_ms", "hist_ms", "rounds", "calls")
        print(json.dumps(dict({k: ctx[k] for k in keys if k in ctx},
                              span_idle_gaps=ctx["span_idle_gaps"][:12],
                              readings=readings(ctx))), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
