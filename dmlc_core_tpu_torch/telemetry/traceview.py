"""Cross-process trace assembly + critical-path analysis.

``python -m dmlc_core_tpu_torch.telemetry trace <dir>`` takes the per-process
span files a run left in its ``DMLC_TELEMETRY_DIR`` — ``trace-*.trace.json``
flushes plus ``flight-*.json`` crash dumps — and produces:

- **one merged Perfetto trace** (``--out``): every process' events on a
  shared time axis, aligned via each file's ``clock_sync`` wall-epoch
  anchor (per-process monotonic clocks mean nothing to each other; the
  wall clock is only used for this shift, never for measurement);
- **trace assembly**: events grouped by ``trace_id``, spans joined into
  parent/child trees across process boundaries; spans whose recorded
  parent is nowhere in the merged set are counted as **orphans** (the
  smoking gun for a process that never flushed, or buffer drops — the
  report says which);
- **critical-path analysis** per trace: each span's *exclusive* time
  (duration minus its children's), aggregated by span name — "which stage
  dominated this request" as a number, not a guess — and a slowest-traces
  table the serving SLO report's worst-p99 trace ids can be looked up in.

Flight dumps are merged like regular span files (overlapping events
deduplicated) and mark their process as **crashed** with the dump's
reason: a chaos-killed worker or a watchdog-SIGTERMed bench child shows
up in the merged timeline with its last recorded spans, not as silence.

Counterpart of ``dmlc_core_tpu/telemetry/traceview.py`` (a copy).  The
span and flight files of both packages share one format, so either
assembler reads the other's directories.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["load_sources", "assemble", "critical_path", "render_report",
           "main"]

# cap on how many stages the per-trace critical-path column names
_PATH_STAGES = 3


def _read_json(path: str) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None


def load_sources(dirpath: str) -> Dict[str, Any]:
    """Everything assembly needs from one telemetry dir.

    Returns ``{"files": [...], "flights": [...], "drops": [...]}`` where
    each ``files`` entry is a flushed trace file (events + wall anchor),
    each ``flights`` entry a crash dump, and ``drops`` the per-process
    span-drop counts reported by metrics snapshots (an assembled trace
    missing spans is attributable, not mysterious).
    """
    files: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(dirpath, "trace-*.trace.json"))):
        obj = _read_json(path)
        if not isinstance(obj, dict) or "traceEvents" not in obj:
            continue
        events = [e for e in obj["traceEvents"] if isinstance(e, dict)]
        wall = None
        meta: List[Dict[str, Any]] = []
        body: List[Dict[str, Any]] = []
        for ev in events:
            if ev.get("ph") == "M":
                if ev.get("name") == "clock_sync":
                    wall = ev.get("args", {}).get("wall_epoch_s")
                else:
                    meta.append(ev)
            else:
                body.append(ev)
        files.append({"path": path, "events": body, "meta": meta,
                      "wall_epoch_s": wall, "reason": None})
    flights: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(dirpath, "flight-*.json"))):
        obj = _read_json(path)
        if not isinstance(obj, dict) or "entries" not in obj:
            continue
        flights.append({"path": path,
                        "events": [e for e in obj["entries"]
                                   if isinstance(e, dict)],
                        "meta": [],
                        "wall_epoch_s": obj.get("wall_epoch_s"),
                        "reason": obj.get("reason", "unknown"),
                        "pid": obj.get("pid"), "rank": obj.get("rank"),
                        "spans_dropped": obj.get("spans_dropped", 0)})
    drops: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(dirpath, "metrics-*.json"))):
        snap = _read_json(path)
        if not isinstance(snap, dict):
            continue
        n = (snap.get("spans") or {}).get("dropped", 0)
        if n:
            drops.append({"rank": snap.get("rank", 0),
                          "pid": snap.get("pid"), "dropped": n})
    return {"files": files, "flights": flights, "drops": drops}


def _dedup_key(ev: Dict[str, Any]) -> Tuple:
    return (ev.get("pid"), ev.get("tid"), ev.get("name"), ev.get("ph"),
            ev.get("ts"), ev.get("span_id"))


def assemble(dirpath: str) -> Dict[str, Any]:
    """Merge every source under ``dirpath`` and analyze the traces.

    Returns a dict with ``events`` (time-aligned, deduplicated),
    ``meta`` (process/thread names for the merged Perfetto file),
    ``traces`` (per-trace stats incl. critical path), plus the global
    ``orphans`` / ``untraced`` / ``drops`` / ``crashed`` accounting.
    """
    src = load_sources(dirpath)
    sources = src["files"] + src["flights"]
    # pids that reached a final flush: a flight dump from one of these is
    # ring residue (e.g. the periodic interval writer, or a SIGTERM that
    # still unwound through atexit) — its events merge, but the process
    # did not die silently and must not be reported as crashed
    flushed_pids = set()
    for s in src["files"]:
        m = re.search(r"-p(\d+)\.trace\.json$", s["path"])
        if m:
            flushed_pids.add(int(m.group(1)))
        for ev in s["events"]:
            if isinstance(ev.get("pid"), int):
                flushed_pids.add(ev["pid"])
                break
    anchors = [s["wall_epoch_s"] for s in sources
               if isinstance(s.get("wall_epoch_s"), (int, float))]
    base = min(anchors) if anchors else None
    unaligned = 0
    merged: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    seen: set = set()
    seen_meta: set = set()
    crashed: List[Dict[str, Any]] = []
    for s in sources:
        wall = s.get("wall_epoch_s")
        if base is not None and isinstance(wall, (int, float)):
            offset = (wall - base) * 1e6
        else:
            offset = 0.0
            if base is not None:
                unaligned += 1
        recovered = 0
        for ev in s["events"]:
            key = _dedup_key(ev)
            if key in seen:
                continue
            seen.add(key)
            out = dict(ev)
            try:
                out["ts"] = round(float(ev.get("ts", 0.0)) + offset, 3)
            except (TypeError, ValueError):
                continue
            if s["reason"] is not None:
                out.setdefault("args", {})
                recovered += 1
            merged.append(out)
        for mv in s["meta"]:
            mkey = (mv.get("pid"), mv.get("tid"), mv.get("name"),
                    json.dumps(mv.get("args", {}), sort_keys=True))
            if mkey not in seen_meta:
                seen_meta.add(mkey)
                meta.append(mv)
        if s["reason"] is not None:
            crashed.append({"pid": s.get("pid"), "rank": s.get("rank"),
                            "reason": s["reason"],
                            "events_recovered": recovered,
                            "spans_dropped": s.get("spans_dropped", 0),
                            "final_flush": s.get("pid") in flushed_pids,
                            "path": s["path"]})
    merged.sort(key=lambda e: e.get("ts", 0.0))

    spans = [e for e in merged if e.get("ph") == "X"]
    instants = [e for e in merged if e.get("ph") == "i"]
    traced = [e for e in spans if e.get("trace_id")]
    span_ids = {(e["trace_id"], e.get("span_id")) for e in traced}
    traces: Dict[str, Dict[str, Any]] = {}
    orphan_total = 0
    for ev in traced:
        t = traces.setdefault(ev["trace_id"], {
            "spans": [], "pids": set(), "orphans": 0, "events": 0})
        t["spans"].append(ev)
        t["pids"].add(ev.get("pid"))
        parent = ev.get("parent_id")
        if parent and (ev["trace_id"], parent) not in span_ids:
            t["orphans"] += 1
            orphan_total += 1
    for ev in instants:
        if ev.get("trace_id") in traces:
            traces[ev["trace_id"]]["events"] += 1

    summaries: List[Dict[str, Any]] = []
    for trace_id, t in traces.items():
        ts0 = min(e["ts"] for e in t["spans"])
        ts1 = max(e["ts"] + e.get("dur", 0.0) for e in t["spans"])
        roots = [e for e in t["spans"] if not e.get("parent_id")]
        root = min(roots or t["spans"], key=lambda e: e["ts"])
        path = critical_path(t["spans"])
        summaries.append({
            "trace_id": trace_id,
            "root": root.get("name", "?"),
            "total_ms": round((ts1 - ts0) / 1e3, 3),
            "spans": len(t["spans"]),
            "instants": t["events"],
            "pids": sorted(p for p in t["pids"] if p is not None),
            "orphans": t["orphans"],
            "critical_path": path,
        })
    summaries.sort(key=lambda s: -s["total_ms"])

    return {
        "dir": dirpath,
        "events": merged,
        "meta": meta,
        "sources": len(src["files"]),
        "flights": crashed,
        "unaligned_sources": unaligned,
        "spans": len(spans),
        "instants": len(instants),
        "untraced": len(spans) - len(traced),
        "traces": summaries,
        "orphans": orphan_total,
        "drops": src["drops"] + [
            {"rank": c.get("rank"), "pid": c.get("pid"),
             "dropped": c["spans_dropped"]}
            for c in crashed if c.get("spans_dropped")],
    }


def critical_path(spans: List[Dict[str, Any]]) \
        -> List[Dict[str, Any]]:
    """Exclusive time per span name, largest first.

    A span's exclusive time is its duration minus the summed durations of
    its direct children (floored at 0 — children from other processes can
    overhang their parent by clock-alignment skew).  Aggregated by name,
    this answers "which stage actually spent the time": a request whose
    ``serve.request`` span is 100 ms with a 90 ms ``serve.predict`` child
    charges 90 ms to predict, 10 ms to the handler — not 100 to each.
    """
    children: Dict[Optional[str], float] = {}
    for ev in spans:
        parent = ev.get("parent_id")
        if parent:
            children[parent] = children.get(parent, 0.0) \
                + float(ev.get("dur", 0.0))
    by_name: Dict[str, float] = {}
    for ev in spans:
        dur = float(ev.get("dur", 0.0))
        exclusive = max(0.0, dur - children.get(ev.get("span_id"), 0.0))
        name = ev.get("name", "?")
        by_name[name] = by_name.get(name, 0.0) + exclusive
    total = sum(by_name.values()) or 1.0
    out = [{"stage": name, "exclusive_ms": round(us / 1e3, 3),
            "share": round(us / total, 3)}
           for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])]
    return out


def _fmt_path(path: List[Dict[str, Any]]) -> str:
    return " > ".join(f"{p['stage']} {p['share'] * 100:.0f}%"
                      for p in path[:_PATH_STAGES])


def render_report(asm: Dict[str, Any], top: int) -> str:
    lines: List[str] = []
    lines.append(
        f"merged {asm['spans']} span(s) + {asm['instants']} instant "
        f"event(s) from {asm['sources']} trace file(s) + "
        f"{len(asm['flights'])} flight dump(s) under {asm['dir']}")
    for c in asm["flights"]:
        who = f"p{c['pid']}" if c.get("pid") else os.path.basename(c["path"])
        if c.get("final_flush"):
            # ring residue next to a completed flush (interval writer, or
            # a SIGTERM that still unwound through atexit) — not a crash
            lines.append(f"  flight dump from {who} (reason={c['reason']}; "
                         "final flush present, process did not die "
                         "silently)")
        else:
            lines.append(f"  crashed process {who}: reason={c['reason']} "
                         f"({c['events_recovered']} event(s) recovered "
                         "from the flight ring)")
    if asm["unaligned_sources"]:
        lines.append(f"  note: {asm['unaligned_sources']} source(s) carry "
                     "no clock_sync anchor — their timestamps are NOT "
                     "aligned to the shared axis")
    for d in asm["drops"]:
        lines.append(
            f"WARNING: r{d.get('rank', 0)}-p{d.get('pid')} dropped "
            f"{d['dropped']} span(s) (buffer overflow) — assembled traces "
            "may be incomplete")
    lines.append(
        f"{len(asm['traces'])} trace(s) assembled; "
        f"{asm['untraced']} untraced span(s); "
        f"{asm['orphans']} orphan span(s)")
    if asm["traces"]:
        rows = [("trace_id", "root", "total_ms", "spans", "procs",
                 "critical path")]
        for t in asm["traces"][:top]:
            rows.append((t["trace_id"], t["root"], f"{t['total_ms']:.3f}",
                         str(t["spans"]), str(len(t["pids"])),
                         _fmt_path(t["critical_path"])))
        widths = [max(len(r[i]) for r in rows) for i in range(5)]
        lines.append("")
        lines.append(f"slowest {min(top, len(asm['traces']))} of "
                     f"{len(asm['traces'])} trace(s):")
        for i, row in enumerate(rows):
            lines.append("  ".join(
                [row[j].ljust(widths[j]) for j in range(5)] + [row[5]])
                .rstrip())
            if i == 0:
                lines.append("  ".join("-" * w for w in widths) + "  -----")
    return "\n".join(lines)


def main(dirpath: str, out: Optional[str] = None, as_json: bool = False,
         top: int = 10, fail_on_orphans: bool = False) -> int:
    asm = assemble(dirpath)
    if not asm["spans"] and not asm["instants"]:
        print(f"no trace-*.trace.json / flight-*.json events under "
              f"{dirpath!r}")
        return 1
    if out:
        payload = {"traceEvents": asm["meta"] + asm["events"],
                   "displayTimeUnit": "ms"}
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, out)
    if as_json:
        report = {k: v for k, v in asm.items()
                  if k not in ("events", "meta")}
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(render_report(asm, top))
        if out:
            print(f"\nmerged Perfetto trace written to {out} "
                  "(load at ui.perfetto.dev)")
    if fail_on_orphans and asm["orphans"]:
        # stderr, not stdout: `--json > report.json` must stay parseable
        # JSON even (especially) when the gate trips
        print(f"FAIL: {asm['orphans']} orphan span(s) — a recorded parent "
              "is missing from the merged set (unflushed process, or "
              "buffer drops; see warnings above)", file=sys.stderr)
        return 2
    return 0
