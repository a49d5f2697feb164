"""The ratchet: committed findings are burn-down work, new findings fail.

``baseline.json`` (beside this module) maps finding keys
(``<file>:<rule>:<symbol>``) to one-line justifications.  Keys use symbols
rather than line numbers so unrelated edits above a finding don't
invalidate the baseline; ``syntax`` findings are never baselineable.
Regenerate with ``python -m dmlc_core_tpu_torch.analysis
--write-baseline`` — existing
justifications survive the rewrite, new keys get a TODO placeholder that
must be replaced by the reason before the change lands.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dmlc_core_tpu_torch.analysis.driver import Finding

__all__ = ["load", "save", "partition", "UNBASELINEABLE"]

UNBASELINEABLE = {"syntax"}

_PLACEHOLDER = "TODO: justify (why is this safe?) or fix"

_NOTE = ("dmlclint ratchet: every key here is a known finding being burned "
         "down, not an endorsement. New findings fail CI. Regenerate with "
         "`python -m dmlc_core_tpu_torch.analysis --write-baseline`; "
         "justify every entry. See dmlc_core_tpu_torch/analysis/CATALOG.md.")


def load(path: str) -> Dict[str, str]:
    """key -> justification; missing file means an empty baseline.
    A present-but-unparseable file raises ValueError: silently treating a
    truncated baseline as empty would report every finding as new."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        try:
            data = json.load(f)
        except json.JSONDecodeError as exc:
            raise ValueError(f"unreadable baseline {path}: {exc}") from exc
    if not isinstance(data, dict):
        raise ValueError(f"unreadable baseline {path}: expected an object, "
                         f"got {type(data).__name__}")
    findings = data.get("findings", {})
    if not isinstance(findings, dict):
        raise ValueError(f"unreadable baseline {path}: 'findings' must be "
                         f"an object, got {type(findings).__name__}")
    return {str(k): str(v) for k, v in findings.items()}


def save(path: str, findings: Sequence[Finding],
         previous: Dict[str, str],
         keep: Optional[Dict[str, str]] = None) -> None:
    """Write the baseline from ``findings``.  ``keep`` holds entries to
    carry over verbatim (files outside a path-scoped run — their findings
    were not recomputed, so their keys must survive the rewrite)."""
    entries: Dict[str, str] = dict(keep or {})
    counts: Dict[str, int] = {}
    for f in findings:
        if f.rule in UNBASELINEABLE:
            continue
        key = _instance_key(f.key, counts)
        entries.setdefault(key, previous.get(key, _PLACEHOLDER))
    data = {
        "version": 1,
        "tool": "dmlclint",
        "note": _NOTE,
        "findings": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


def _instance_key(key: str, counts: Dict[str, int]) -> str:
    """``key`` for the first finding with that key, ``key#2``/``key#3``...
    for repeats — so a SECOND violation of an already-baselined rule in
    the same symbol is a new key and still fails the ratchet."""
    counts[key] = counts.get(key, 0) + 1
    n = counts[key]
    return key if n == 1 else f"{key}#{n}"


def partition(findings: Sequence[Finding], baseline: Dict[str, str],
              ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """(new, baselined, stale-keys).  Stale keys are baseline entries no
    current finding matches — fixed (prune them) or renamed symbols."""
    new: List[Finding] = []
    baselined: List[Finding] = []
    hit: Set[str] = set()
    counts: Dict[str, int] = {}
    for f in findings:
        if f.rule in UNBASELINEABLE:
            new.append(f)
            continue
        key = _instance_key(f.key, counts)
        if key in baseline:
            baselined.append(f)
            hit.add(key)
        else:
            new.append(f)
    stale = sorted(set(baseline) - hit)
    return new, baselined, stale
