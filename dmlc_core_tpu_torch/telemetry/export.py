"""Exporters: Prometheus text format, JSON snapshot, directory flush.

Three interchange forms, one source of truth (the registry + tracer):

- :func:`prometheus_text` — the text exposition format, scrapeable or
  greppable (``# TYPE``/``# HELP`` headers, ``le``-cumulative histograms);
- :func:`json_snapshot` — a structured dict for programmatic use (this is
  what ``bench.py`` attaches to a BENCH round's ``detail``);
- :func:`flush` — write snapshot + Prometheus dump + Chrome trace + JSONL
  event log into a directory, filenames keyed by rank and pid so N ranks
  flushing into one shared ``DMLC_TELEMETRY_DIR`` never collide.  The
  multi-rank ``report`` CLI (:mod:`.report`) aggregates these back.

Counterpart of ``dmlc_core_tpu/telemetry/export.py`` (a copy).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from dmlc_core_tpu_torch.telemetry import clock
from dmlc_core_tpu_torch.telemetry.registry import Histogram, MetricRegistry
from dmlc_core_tpu_torch.telemetry.spans import SpanTracer

__all__ = ["prometheus_text", "json_snapshot", "flush", "rank_from_env"]


def rank_from_env() -> int:
    """This process' rank for snapshot filenames — the launcher env contract
    (same precedence as collective.api's task-id resolution; duplicated here
    because telemetry must import nothing heavier than the stdlib)."""
    for key in ("DMLC_TASK_ID", "OMPI_COMM_WORLD_RANK", "PMIX_RANK",
                "PMI_RANK", "SLURM_PROCID"):
        value = os.environ.get(key, "").strip()
        if value:
            try:
                return int(value)
            except ValueError:
                continue
    return 0


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"  # the text format's literals; int(v) would raise
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping (backslash first)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(label_key) -> str:
    if not label_key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in label_key)
    return "{" + inner + "}"


def _merge_labels(label_key, extra: str) -> str:
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in label_key)
    joined = ",".join(x for x in (inner, extra) if x)
    return "{" + joined + "}"


def prometheus_text(registry: MetricRegistry) -> str:
    """Render the registry in the Prometheus text exposition format."""
    out = []
    for fam in registry.families():
        if fam.help:
            out.append(f"# HELP {fam.name} {fam.help}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        for label_key, child in fam.samples():
            if isinstance(child, Histogram):
                cumulative = child.cumulative()
                bounds = [str(b) for b in fam.buckets] + ["+Inf"]
                for bound, count in zip(bounds, cumulative):
                    le = 'le="%s"' % bound
                    out.append(f"{fam.name}_bucket"
                               f"{_merge_labels(label_key, le)} {count}")
                out.append(f"{fam.name}_sum{_fmt_labels(label_key)} "
                           f"{_fmt_value(child.sum)}")
                out.append(f"{fam.name}_count{_fmt_labels(label_key)} "
                           f"{child.count}")
            else:
                out.append(f"{fam.name}{_fmt_labels(label_key)} "
                           f"{_fmt_value(child.value)}")
    return "\n".join(out) + ("\n" if out else "")


def json_snapshot(registry: MetricRegistry,
                  tracer: Optional[SpanTracer] = None) -> Dict[str, Any]:
    """Structured snapshot of every family (and span stats when given)."""
    families: Dict[str, Any] = {}
    for fam in registry.families():
        samples = []
        for label_key, child in fam.samples():
            entry: Dict[str, Any] = {"labels": dict(label_key)}
            if isinstance(child, Histogram):
                entry["buckets"] = list(fam.buckets)
                entry["counts"] = child.bucket_counts
                entry["sum"] = child.sum
                entry["count"] = child.count
            else:
                entry["value"] = child.value
            samples.append(entry)
        families[fam.name] = {"kind": fam.kind, "help": fam.help,
                              "samples": samples}
    snap: Dict[str, Any] = {
        "time": time.time(),
        "pid": os.getpid(),
        "rank": rank_from_env(),
        "wall_epoch_s": clock.wall_epoch(),
        "metrics": families,
    }
    if tracer is not None:
        snap["spans"] = {"recorded": len(tracer.events()),
                         "dropped": tracer.dropped}
    return snap


def flush(dirpath: str, registry: MetricRegistry,
          tracer: SpanTracer) -> Dict[str, str]:
    """Write all export forms into ``dirpath``; returns {kind: path}.

    Every file is written to a temp name and renamed, so a reader (or the
    ``report`` aggregator) never sees a half-written snapshot.
    """
    os.makedirs(dirpath, exist_ok=True)
    tag = f"r{rank_from_env()}-p{os.getpid()}"
    written: Dict[str, str] = {}

    def _write(name: str, text: str) -> None:
        path = os.path.join(dirpath, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
        written[name.split(".", 1)[1]] = path

    _write(f"metrics-{tag}.json",
           json.dumps(json_snapshot(registry, tracer), indent=1, sort_keys=True))
    _write(f"metrics-{tag}.prom", prometheus_text(registry))
    _write(f"trace-{tag}.trace.json", json.dumps(tracer.chrome_trace()))
    _write(f"events-{tag}.jsonl",
           "".join(line + "\n" for line in tracer.jsonl()))
    return written
