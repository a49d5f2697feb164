"""Contracts: code vs. catalog cross-artifact drift checking.

Four name families form the port's operational contract surface, and
each has a table in the port's own catalog,
``dmlc_core_tpu_torch/analysis/CATALOG.md``:

- ``DMLC_*`` **env knobs** read via ``os.environ``/``os.getenv``
  (the generated knob table);
- ``dmlc_*`` **metric names** registered through the telemetry helpers
  (the metric table, kept by hand);
- telemetry **span names** (the span table — generated, plus hand-kept
  wildcard rows for f-string names like ``collective.<op>``);
- fault **site names** (the ``fault.SITES`` registry — what
  ``python -m dmlc_core_tpu_torch.fault list-sites`` prints — vs. the site
  table, vs. the ``fault.inject(...)`` call sites).

The pass extracts each family from the AST (exact string-literal uses
only; f-strings can't be checked statically and are covered by wildcard
rows), parses every markdown table of the catalog, and diffs:

===============================  =============================================
rule                              meaning
===============================  =============================================
``contract-undocumented-knob``    env knob read in code, in no catalog table
``contract-undocumented-metric``  metric name in code, in no catalog table
``contract-undocumented-span``    span name in code, in no span-catalog table
``contract-undocumented-site``    fault site used but not registered in
                                  ``fault.SITES``, or registered but missing
                                  from the catalog's site table
``contract-stale-doc-entry``      a catalog row (first cell of a table)
                                  naming a knob/metric/span/site the code no
                                  longer has
===============================  =============================================

Doc-side convention: a **table row mention** (any cell) documents a name;
the **first cell** of a row creates the stale-check obligation.  Tables
are typed by their header: a table whose first header cell is ``site``
holds fault sites, ``span`` holds span names; knob/metric tokens are
recognized by shape anywhere.  Rows whose name contains ``<`` or ``*``
are wildcards: they satisfy prefix matches and are exempt from stale
checking (they exist precisely for dynamic names).

``--emit-knob-catalog`` / ``--emit-span-catalog`` on the analysis CLI
print the generated markdown tables this pass checks against, so the
committed catalogs are regenerated from code truth, never hand-drifted.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Mapping, Optional, Set, Tuple

from dmlc_core_tpu_torch.analysis.driver import Finding, dotted_name
from dmlc_core_tpu_torch.analysis.graph import ProjectGraph

__all__ = ["run_project", "load_docs", "render_knob_catalog",
           "render_span_catalog", "DOC_FILES"]

# the documentation surface the contract is checked against: the port's
# own catalog (the reference package's docs/ are neither read nor edited)
DOC_FILES = ("dmlc_core_tpu_torch/analysis/CATALOG.md",)

KNOB_RE = re.compile(r"^DMLC_[A-Z0-9]+(?:_[A-Z0-9]+)*$")
METRIC_RE = re.compile(r"^dmlc_[a-z0-9_]+$")
# dotted names: fault sites in code (`tracker.framed.recv`)
SPAN_RE = re.compile(r"^[a-z0-9_]+(?:\.[a-z0-9_<>]+)+$")
# doc-side span/site rows: the dot is NOT required — a span may be named
# `startup`; anything name-shaped in a span/site-typed table documents it
# (path-like tokens with `/` stay excluded)
NAME_RE = re.compile(r"^[a-z0-9_]+(?:\.[a-z0-9_<>*]+)*$")

# telemetry call surfaces, by the callee's final attribute name
_METRIC_CALLS = {"count", "gauge_set", "gauge_add", "observe",
                 "counter", "gauge", "histogram"}
_SPAN_CALLS = {"span", "record_span", "record_complete", "record_instant",
               "event"}
_ENV_READ_CALLS = {"get", "getenv", "get_env", "setdefault", "pop"}
_FAULT_CALLS = {"inject", "truncate", "http_response"}

# names that look like metrics but are native ABI symbols, not series
_NOT_METRICS = {"dmlc_core_tpu", "dmlc_core_tpu_torch",
                "dmlc_tpu_abi_version",
                "dmlc_tpu_parse_libsvm", "dmlc_tpu_parse_libfm",
                "dmlc_tpu_span_open", "dmlc_tpu_span_open2"}


@dataclasses.dataclass(frozen=True)
class _Occurrence:
    name: str
    relpath: str
    lineno: int


class CodeInventory:
    """Every contract-relevant name the code uses, with one witness site."""

    def __init__(self) -> None:
        self.knobs: Dict[str, List[_Occurrence]] = {}
        self.metrics: Dict[str, List[_Occurrence]] = {}
        self.spans: Dict[str, List[_Occurrence]] = {}
        self.sites_used: Dict[str, List[_Occurrence]] = {}
        # fault.SITES registry: site -> declaration occurrence
        self.sites_registered: Dict[str, _Occurrence] = {}

    @staticmethod
    def _add(store: Dict[str, List[_Occurrence]], occ: _Occurrence) -> None:
        store.setdefault(occ.name, []).append(occ)


def _is_environ_expr(expr: ast.AST) -> bool:
    name = dotted_name(expr) or ""
    return name in ("os.environ", "environ") or name.endswith(".environ")


def _const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _module_str_constants(project: ProjectGraph) -> Dict[str,
                                                         Dict[str, str]]:
    """modname -> {NAME: "literal"} for module-level string assignments —
    the ``ENV_PROC = "DMLC_PARSE_PROC"`` idiom; reads through such
    constants are still static and must count as contract uses."""
    out: Dict[str, Dict[str, str]] = {}
    for modname, mod in project.modules.items():
        consts: Dict[str, str] = {}
        for stmt in mod.ctx.tree.body:
            value: Optional[ast.AST] = None
            targets: List[ast.AST] = []
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            text = _const_str(value)
            if text is None:
                continue
            for target in targets:
                if isinstance(target, ast.Name):
                    consts[target.id] = text
        out[modname] = consts
    return out


def extract_code(project: ProjectGraph) -> CodeInventory:
    inv = CodeInventory()
    constants = _module_str_constants(project)

    def resolve_str(mod, node: Optional[ast.AST]) -> Optional[str]:
        """A string argument: literal, module constant, or a constant
        imported from a sibling module (one hop)."""
        text = _const_str(node)
        if text is not None:
            return text
        if isinstance(node, ast.Name):
            local = constants.get(mod.modname, {})
            if node.id in local:
                return local[node.id]
            if node.id in mod.import_syms:
                tm, sym = mod.import_syms[node.id]
                return constants.get(tm, {}).get(sym)
        if isinstance(node, ast.Attribute):
            name = dotted_name(node)
            if name and "." in name:
                root, attr = name.split(".", 1)
                if "." not in attr and root in mod.import_mods:
                    return constants.get(mod.import_mods[root],
                                         {}).get(attr)
        return None

    for mod in project.modules.values():
        relpath = mod.relpath
        for node in ast.walk(mod.ctx.tree):
            if isinstance(node, ast.Subscript):
                # os.environ["DMLC_X"] (read or write)
                if _is_environ_expr(node.value):
                    key = resolve_str(mod, node.slice)
                    if key and KNOB_RE.match(key):
                        inv._add(inv.knobs,
                                 _Occurrence(key, relpath, node.lineno))
                continue
            if isinstance(node, ast.Compare):
                # "DMLC_X" in os.environ
                if (len(node.ops) == 1 and isinstance(node.ops[0], (ast.In,
                                                                    ast.NotIn))
                        and any(_is_environ_expr(c)
                                for c in node.comparators)):
                    key = resolve_str(mod, node.left)
                    if key and KNOB_RE.match(key):
                        inv._add(inv.knobs,
                                 _Occurrence(key, relpath, node.lineno))
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            last = (func.attr if isinstance(func, ast.Attribute)
                    else func.id if isinstance(func, ast.Name) else None)
            if last is None:
                continue
            arg0 = resolve_str(mod, node.args[0]) if node.args else None
            # env reads: os.environ.get("X") / os.getenv("X") /
            # param.get_env("X", ...) / environ.pop — the DMLC_* key shape
            # is the filter, not the receiver (env mappings travel under
            # local names: `(environ or os.environ).get(ENV_NPROC)`)
            if last in _ENV_READ_CALLS and arg0 and KNOB_RE.match(arg0):
                inv._add(inv.knobs, _Occurrence(arg0, relpath, node.lineno))
                continue
            if last in _METRIC_CALLS and arg0 and METRIC_RE.match(arg0) \
                    and arg0 not in _NOT_METRICS:
                inv._add(inv.metrics, _Occurrence(arg0, relpath, node.lineno))
                continue
            if last in _SPAN_CALLS and arg0:
                inv._add(inv.spans, _Occurrence(arg0, relpath, node.lineno))
                continue
            if last in _FAULT_CALLS and arg0:
                # only calls through the fault API surface (fault.inject /
                # plan-internal helpers share the names but not first-arg
                # site strings outside fault code)
                recv = (dotted_name(func.value)
                        if isinstance(func, ast.Attribute) else None)
                if recv and recv.split(".")[-1] == "fault" or \
                        relpath.startswith("dmlc_core_tpu_torch/fault/"):
                    if SPAN_RE.match(arg0):
                        inv._add(inv.sites_used,
                                 _Occurrence(arg0, relpath, node.lineno))
        # the SITES registry itself (static parse; no runtime import)
        if relpath == "dmlc_core_tpu_torch/fault/__init__.py":
            for stmt in mod.ctx.tree.body:
                targets = []
                if isinstance(stmt, ast.Assign):
                    targets = stmt.targets
                    value = stmt.value
                elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    targets = [stmt.target]
                    value = stmt.value
                else:
                    continue
                if not any(isinstance(t, ast.Name) and t.id == "SITES"
                           for t in targets):
                    continue
                if isinstance(value, ast.Dict):
                    for key in value.keys:
                        site = _const_str(key)
                        if site:
                            inv.sites_registered[site] = _Occurrence(
                                site, relpath, key.lineno)
    return inv


# -- docs side ----------------------------------------------------------------

_BACKTICK_RE = re.compile(r"`([^`]+)`")


@dataclasses.dataclass(frozen=True)
class _DocEntry:
    name: str
    relpath: str
    lineno: int
    kind: str  # knob | metric | span | site

    @property
    def wildcard(self) -> bool:
        return "<" in self.name or "*" in self.name

    def prefix(self) -> str:
        cut = len(self.name)
        for ch in "<*":
            pos = self.name.find(ch)
            if pos != -1:
                cut = min(cut, pos)
        return self.name[:cut]


class DocInventory:
    def __init__(self) -> None:
        # names mentioned in ANY table cell (documentation credit)
        self.mentioned: Dict[str, Set[str]] = {
            "knob": set(), "metric": set(), "span": set(), "site": set()}
        self.wildcards: Dict[str, List[_DocEntry]] = {
            "span": [], "site": [], "metric": [], "knob": []}
        # first-cell entries (stale-check obligations)
        self.obligations: List[_DocEntry] = []

    def documents(self, kind: str, name: str) -> bool:
        if name in self.mentioned[kind]:
            return True
        return any(name.startswith(w.prefix())
                   for w in self.wildcards[kind] if w.prefix())


def _iter_tables(text: str):
    """Yield (header_cells, [(lineno, cells)]) for every markdown table."""
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].lstrip().startswith("|"):
            i += 1
            continue
        block: List[Tuple[int, str]] = []
        while i < len(lines) and lines[i].lstrip().startswith("|"):
            block.append((i + 1, lines[i]))
            i += 1
        if len(block) < 2:
            continue
        rows = []
        header: Optional[List[str]] = None
        for lineno, line in block:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if all(re.fullmatch(r":?-{2,}:?", c or "---") for c in cells):
                continue  # separator row
            if header is None:
                header = cells
            else:
                rows.append((lineno, cells))
        if header is not None:
            yield header, rows


def _strip_markup(token: str) -> str:
    # `DMLC_X` / `DMLC_X=1` / `DMLC_X=<dir>` / `dmlc_y_total{site,kind}` /
    # `knob (seconds)` usage forms all document the bare name
    for sep in ("{", "=", "(", " ", "["):
        token = token.split(sep)[0]
    return token.strip()


def extract_docs(docs: Mapping[str, str]) -> DocInventory:
    inv = DocInventory()
    for relpath, text in docs.items():
        for header, rows in _iter_tables(text):
            first = _BACKTICK_RE.sub(r"\1", header[0]).strip().lower() \
                if header else ""
            table_kind = {"site": "site", "span": "span"}.get(first)
            for lineno, cells in rows:
                for ci, cell in enumerate(cells):
                    for raw in _BACKTICK_RE.findall(cell):
                        token = _strip_markup(raw)
                        kinds = []
                        if KNOB_RE.match(token):
                            kinds.append("knob")
                        elif METRIC_RE.match(token) \
                                and token not in _NOT_METRICS:
                            kinds.append("metric")
                        elif table_kind and NAME_RE.match(token):
                            kinds.append(table_kind)
                        for kind in kinds:
                            entry = _DocEntry(token, relpath, lineno, kind)
                            if entry.wildcard:
                                inv.wildcards[kind].append(entry)
                            else:
                                inv.mentioned[kind].add(token)
                            if ci == 0 and not entry.wildcard:
                                inv.obligations.append(entry)
    return inv


def load_docs(root: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for rel in DOC_FILES:
        path = os.path.join(root, rel)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                out[rel] = f.read()
    return out


# -- the diff -----------------------------------------------------------------

def run_project(project: ProjectGraph,
                docs: Mapping[str, str]) -> List[Finding]:
    code = extract_code(project)
    doc = extract_docs(docs)
    findings: List[Finding] = []

    def first(occs: List[_Occurrence]) -> _Occurrence:
        return min(occs, key=lambda o: (o.relpath, o.lineno))

    for name in sorted(code.knobs):
        if not doc.documents("knob", name):
            occ = first(code.knobs[name])
            findings.append(Finding(
                "contract-undocumented-knob", occ.relpath, occ.lineno,
                name,
                f"env knob {name} is read here but appears in no catalog "
                "table — add it to the knob catalog (regenerate with "
                "--emit-knob-catalog) or delete the knob"))
    for name in sorted(code.metrics):
        if not doc.documents("metric", name):
            occ = first(code.metrics[name])
            findings.append(Finding(
                "contract-undocumented-metric", occ.relpath, occ.lineno,
                name,
                f"metric {name} is recorded here but appears in no catalog "
                "table — add a row to the metric catalog "
                "(CATALOG.md) or drop the series"))
    for name in sorted(code.spans):
        if not doc.documents("span", name):
            occ = first(code.spans[name])
            findings.append(Finding(
                "contract-undocumented-span", occ.relpath, occ.lineno,
                name,
                f"span/event name {name} is recorded here but appears in "
                "no span-catalog table (CATALOG.md; regenerate "
                "with --emit-span-catalog)"))
    for name in sorted(code.sites_used):
        if name not in code.sites_registered:
            occ = first(code.sites_used[name])
            findings.append(Finding(
                "contract-undocumented-site", occ.relpath, occ.lineno,
                name,
                f"fault site {name} is injected here but is not registered "
                "in fault.SITES — `fault list-sites` and plan validation "
                "will not know it exists"))
    for name, occ in sorted(code.sites_registered.items()):
        if not doc.documents("site", name):
            findings.append(Finding(
                "contract-undocumented-site", occ.relpath, occ.lineno,
                name,
                f"fault site {name} is registered in fault.SITES but "
                "missing from the site table in CATALOG.md"))

    # stale direction: docs first-cell entries with no code referent
    present = {
        "knob": set(code.knobs),
        "metric": set(code.metrics),
        "span": set(code.spans),
        "site": set(code.sites_registered) | set(code.sites_used),
    }
    seen_obligations: Set[Tuple[str, str]] = set()
    for entry in doc.obligations:
        key = (entry.kind, entry.name)
        if key in seen_obligations:
            continue
        seen_obligations.add(key)
        if entry.name not in present[entry.kind]:
            findings.append(Finding(
                "contract-stale-doc-entry", entry.relpath, entry.lineno,
                f"{entry.kind}:{entry.name}",
                f"catalog table names {entry.kind} `{entry.name}` but the "
                "code no longer has it — prune the row or restore the "
                f"{entry.kind}"))
    return findings


# -- generated catalogs -------------------------------------------------------

def _where(occs: Iterable[_Occurrence], limit: int = 3) -> str:
    paths = sorted({o.relpath for o in occs})
    shown = ", ".join(f"`{p}`" for p in paths[:limit])
    if len(paths) > limit:
        shown += f" (+{len(paths) - limit} more)"
    return shown


def render_knob_catalog(project: ProjectGraph) -> str:
    """The generated knob catalog table (committed into
    CATALOG.md; regenerating and diffing is the freshness check)."""
    inv = extract_code(project)
    lines = ["| knob | read at |", "| --- | --- |"]
    for name in sorted(inv.knobs):
        lines.append(f"| `{name}` | {_where(inv.knobs[name])} |")
    return "\n".join(lines)


def render_span_catalog(project: ProjectGraph) -> str:
    """The generated span catalog table (committed into
    CATALOG.md).  F-string span names cannot be extracted —
    cover those with hand-kept wildcard rows (`collective.<op>`)."""
    inv = extract_code(project)
    lines = ["| span | recorded at |", "| --- | --- |"]
    for name in sorted(inv.spans):
        lines.append(f"| `{name}` | {_where(inv.spans[name])} |")
    return "\n".join(lines)
