"""Multi-rank snapshot aggregation of telemetry snapshots.

Counterpart of ``dmlc_core_tpu/telemetry/report.py`` (a copy): ``python -m
dmlc_core_tpu_torch.telemetry report DIR`` calls :func:`main`.

Each rank flushing into a shared ``DMLC_TELEMETRY_DIR`` leaves one
``metrics-r<rank>-p<pid>.json`` snapshot.  This module folds them back into
one table: counters and histograms sum across ranks; gauges keep per-rank
spread (min/max) because summing queue depths across ranks is meaningless.

Histograms additionally get **quantile estimates** (p50/p95/p99) derived
from the merged fixed-bucket counts (:func:`estimate_quantiles`): serving
SLOs are stated as latency quantiles, and a report that only shows bucket
counts makes every reader redo the interpolation by hand.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["load_snapshots", "aggregate", "estimate_quantiles",
           "render_table", "main"]

# the quantiles every aggregated histogram reports (SLO vocabulary)
REPORT_QUANTILES: Tuple[Tuple[str, float], ...] = (
    ("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


def estimate_quantiles(buckets: Sequence[float], counts: Sequence[int],
                       qs: Sequence[float]) -> List[Optional[float]]:
    """Quantile estimates from fixed-bucket histogram counts.

    ``buckets`` are the finite inclusive upper bounds (ascending);
    ``counts`` are **non-cumulative** per-bucket counts with one extra
    trailing entry for the implicit +Inf bucket (the registry's
    ``bucket_counts`` layout).  Returns one estimate per ``q`` in ``qs``:

    - linear interpolation inside the bucket the quantile rank lands in,
      taking the previous bound (or 0.0 for the first bucket — observations
      here are non-negative latencies/sizes) as the lower edge;
    - a rank landing in the +Inf bucket reports the highest finite bound
      (the Prometheus ``histogram_quantile`` convention: the estimate is a
      floor, not an extrapolation past what the buckets can resolve);
    - ``None`` per quantile when the histogram is empty or the counts
      don't line up with the bounds (a cross-rank bucket clash).
    """
    bounds = [float(b) for b in buckets]
    if len(counts) != len(bounds) + 1 or not bounds:
        return [None] * len(qs)
    total = sum(counts)
    if total <= 0:
        return [None] * len(qs)
    out: List[Optional[float]] = []
    for q in qs:
        if not 0.0 <= q <= 1.0:
            out.append(None)
            continue
        rank = q * total
        running = 0.0
        est: Optional[float] = bounds[-1]  # +Inf bucket floors here
        for i, c in enumerate(counts[:-1]):
            if running + c >= rank:
                lo = 0.0 if i == 0 else bounds[i - 1]
                hi = bounds[i]
                # position within this bucket's count mass
                est = lo + (hi - lo) * ((rank - running) / c) if c else hi
                break
            running += c
        out.append(est)
    return out


def load_snapshots(dirpath: str) -> List[Dict[str, Any]]:
    """All rank snapshots in ``dirpath``, oldest first; bad files skipped."""
    out = []
    for path in sorted(glob.glob(os.path.join(dirpath, "metrics-*.json"))):
        try:
            with open(path) as f:
                snap = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(snap, dict) and isinstance(snap.get("metrics"), dict):
            snap["_path"] = path
            out.append(snap)
    return sorted(out, key=lambda s: (s.get("rank", 0), s.get("time", 0)))


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())) + "}"


def aggregate(snapshots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge rank snapshots; returns {series_name: merged_entry}.

    One series per (family, label set).  Entry fields:
    ``kind``, ``ranks`` (contributing rank list) and, by kind:
    counter -> ``total``; gauge -> ``min``/``max``/``last``;
    histogram -> ``count``/``sum``/``mean`` (+ merged ``buckets``/``counts``).
    """
    merged: Dict[str, Dict[str, Any]] = {}
    for snap in snapshots:
        rank = snap.get("rank", 0)
        for fam_name, fam in sorted(snap["metrics"].items()):
            kind = fam.get("kind", "counter")
            for sample in fam.get("samples", []):
                series = fam_name + _label_str(sample.get("labels", {}))
                entry = merged.setdefault(series, {
                    "kind": kind, "ranks": [],
                })
                if entry["kind"] != kind:
                    # same series name, different kind across ranks: keep the
                    # first and note the clash rather than corrupting the fold
                    entry["kind_clash"] = True
                    continue
                entry["ranks"].append(rank)
                if kind == "counter":
                    entry["total"] = entry.get("total", 0.0) + sample.get("value", 0.0)
                elif kind == "gauge":
                    v = sample.get("value", 0.0)
                    entry["min"] = min(entry.get("min", v), v)
                    entry["max"] = max(entry.get("max", v), v)
                    entry["last"] = v
                else:  # histogram
                    entry["count"] = entry.get("count", 0) + sample.get("count", 0)
                    entry["sum"] = entry.get("sum", 0.0) + sample.get("sum", 0.0)
                    counts = sample.get("counts")
                    if counts is not None:
                        prev = entry.get("counts")
                        if prev is None:
                            entry["counts"] = list(counts)
                            entry["buckets"] = sample.get("buckets")
                        elif len(prev) != len(counts):
                            # ranks registered different bucket lists: keep
                            # the first fold and mark the clash instead of
                            # silently dropping accumulated counts (the sum
                            # and count above still cover every rank)
                            entry["bucket_clash"] = True
                        else:
                            entry["counts"] = [a + b for a, b in zip(prev, counts)]
    # finalize histograms once per merged series, not once per folded
    # snapshot: mean + quantile estimates only make sense on the final fold
    for entry in merged.values():
        if entry["kind"] != "histogram":
            continue
        if entry.get("count"):
            entry["mean"] = entry["sum"] / entry["count"]
        if entry.get("counts") and entry.get("buckets"):
            # quantiles follow the merged bucket counts (on a bucket
            # clash they cover the folded ranks only — the clash marker
            # above says so)
            ests = estimate_quantiles(entry["buckets"], entry["counts"],
                                      [q for _, q in REPORT_QUANTILES])
            for (name, _), est in zip(REPORT_QUANTILES, ests):
                if est is not None:
                    entry[name] = est
    return merged


def _value_column(entry: Dict[str, Any], series: str = "") -> str:
    kind = entry["kind"]
    if kind == "counter":
        total = entry.get("total", 0.0)
        return str(int(total)) if total == int(total) else f"{total:.6g}"
    if kind == "gauge":
        lo, hi = entry.get("min", 0.0), entry.get("max", 0.0)
        if lo == hi:
            return f"{lo:.6g}"
        return f"min={lo:.6g} max={hi:.6g}"
    # the "s" unit suffix follows the catalog convention: only *_seconds
    # histograms measure durations (dmlc_serve_batch_rows is a count)
    unit = "s" if series.split("{", 1)[0].endswith("_seconds") else ""
    mean = entry.get("mean")
    mean_s = f" mean={mean:.6g}{unit}" if mean is not None else ""
    q_s = "".join(f" {name}={entry[name]:.6g}{unit}"
                  for name, _ in REPORT_QUANTILES if name in entry)
    # a clash fold is partial: say so next to the numbers it limits
    # (count/sum still cover every rank; counts-derived quantiles don't)
    flag = (" [bucket-clash: quantiles cover first-fold ranks only]"
            if entry.get("bucket_clash") else "")
    return (f"n={entry.get('count', 0)} sum={entry.get('sum', 0.0):.6g}"
            f"{mean_s}{q_s}{flag}")


def render_table(merged: Dict[str, Any]) -> str:
    rows: List[Tuple[str, str, str, str]] = [
        ("series", "kind", "ranks", "value")]
    for series in sorted(merged):
        entry = merged[series]
        ranks = sorted(set(entry.get("ranks", [])))
        rank_s = ",".join(map(str, ranks)) if len(ranks) <= 6 \
            else f"{len(ranks)} ranks"
        rows.append((series, entry["kind"], rank_s,
                     _value_column(entry, series)))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    lines = []
    for i, row in enumerate(rows):
        lines.append("  ".join([row[0].ljust(widths[0]),
                                row[1].ljust(widths[1]),
                                row[2].ljust(widths[2]), row[3]]).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths) + "  " + "-" * 5)
    return "\n".join(lines)


def main(dirpath: str, as_json: bool = False) -> int:
    snapshots = load_snapshots(dirpath)
    if not snapshots:
        print(f"no metrics-*.json snapshots under {dirpath!r}")
        return 1
    merged = aggregate(snapshots)
    if as_json:
        print(json.dumps(merged, indent=1, sort_keys=True))
    else:
        ranks = sorted({s.get("rank", 0) for s in snapshots})
        print(f"{len(snapshots)} snapshot(s) from rank(s) "
              f"{','.join(map(str, ranks))} under {dirpath}")
        dup_ranks = sorted({r for r in ranks
                            if sum(1 for s in snapshots
                                   if s.get("rank", 0) == r) > 1})
        if dup_ranks:
            # pid-keyed filenames mean a re-used dir accumulates snapshots
            # across runs; the fold sums them all, so say so rather than
            # silently reporting inflated totals
            print(f"note: rank(s) {','.join(map(str, dup_ranks))} have "
                  "multiple snapshots (multi-process rank, or a re-used "
                  "telemetry dir) — counters/histograms sum across all")
        print(render_table(merged))
    return 0
