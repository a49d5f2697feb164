"""dmlclint driver: file walking, shared AST infra, suppressions, CLI.

The port's gate walks ``dmlc_core_tpu_torch/`` and ``chip_smoke.py``.
Findings are keyed ``<file>:<rule>:<symbol>`` and ratcheted against the
committed ``dmlc_core_tpu_torch/analysis/baseline.json`` (see
:mod:`.baseline`): a finding whose
key is baselined is burn-down work and does not fail the run; a finding with
a new key does.  ``# dmlclint: disable=<rule>`` on (or on a comment line
immediately above) the offending line suppresses it at the source.

Two kinds of passes run:

- **per-file passes** (lockset/purity/resources/protocol/transport) see one
  module at a time;
- **project passes** (deadlock/contracts/escape/torchbound/races/wiretaint)
  see the whole repo at once through the :mod:`.graph` call-graph core —
  they run on the default (unscoped) gate invocation, or whenever
  ``--pass`` selects them explicitly.

``--jobs N`` fans the per-file stage out over a process pool (findings
are reassembled in file order, so output is byte-identical to a serial
run); project passes stay sequential — they need the whole graph.

``--format github`` renders new findings as GitHub workflow annotations;
``--format sarif`` emits a SARIF 2.1.0 document (``--output`` writes it to
a file for artifact upload).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "FileContext", "analyze_source", "analyze_path",
           "iter_python_files", "main", "ALL_RULES", "ROOT",
           "PER_FILE_PASSES", "PROJECT_PASSES", "render_rule_catalog"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the port's package and its chip script (the tests are walked by the
# reference package's own gate)
TARGETS = ["dmlc_core_tpu_torch", "chip_smoke.py"]

PER_FILE_PASSES = ("lockset", "purity", "resources", "protocol", "transport")
PROJECT_PASSES = ("deadlock", "contracts", "escape", "torchbound", "races",
                  "wiretaint")

# non-library files that still get threading-discipline passes
# (chip_smoke.py drives fleets, load generators and worker processes from
# threads; its lock use is production code even though it lives at the
# repo root) and ride in the project graph for the whole-repo passes
EXTRA_DEEP: Dict[str, Tuple[str, ...]] = {"chip_smoke.py": ("lockset",)}

# modules whose job is talking to a terminal: exempt from style-no-print
# (every other pass still runs on them)
CLI_EXEMPT = {
    "dmlc_core_tpu_torch/tracker/submit.py",
    "dmlc_core_tpu_torch/tracker/launcher.py",
    "dmlc_core_tpu_torch/io/__main__.py",
    "dmlc_core_tpu_torch/analysis/driver.py",  # this CLI reports to stdout
    "dmlc_core_tpu_torch/telemetry/report.py",  # `telemetry report` table
    "dmlc_core_tpu_torch/telemetry/traceview.py",  # `telemetry trace`
    "dmlc_core_tpu_torch/telemetry/__main__.py",
    "dmlc_core_tpu_torch/fault/__main__.py",  # `fault validate` report
    "dmlc_core_tpu_torch/serve/__main__.py",  # the serving CLI
    "dmlc_core_tpu_torch/graft_entry.py",  # the dryrun's summary lines
}
# directories of terminal scripts: the example CLIs and the chip
# measurement tools print their results
CLI_EXEMPT_DIRS = ("dmlc_core_tpu_torch/examples/",
                   "dmlc_core_tpu_torch/tools/")


def is_cli_exempt(relpath: str) -> bool:
    return relpath in CLI_EXEMPT or relpath.startswith(CLI_EXEMPT_DIRS)

# the deep passes run on library code only; other files get syntax checks
LIBRARY_PREFIX = "dmlc_core_tpu_torch/"

# the port's ratchet file (never the reference package's baseline)
BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")

ALL_RULES = {
    "syntax": "file does not parse (never baselineable)",
    "lockset-unsync-write": (
        "attribute of a lock-owning class is written both under and outside "
        "the lock"),
    "lockset-thread-leak": (
        "Thread target can die with an un-ferried exception (no try/except "
        "in the target, a bare swallow, a lambda, or a library callable)"),
    "lockset-no-join": (
        "non-daemon Thread with no .join() on any destroy/exit path in its "
        "owning scope"),
    "purity-host-sync": (
        "host synchronization in hot device code (an autograd "
        "forward/backward, a compiled or graph-captured callable, or a "
        "device-layer loop): .item()/.tolist()/.cpu()/.numpy(), "
        "torch.cuda.synchronize()/<event>.synchronize(), or float()/int()/"
        "bool() of a tensor — the host waits for the card's queue to "
        "drain"),
    "purity-host-branch": (
        "Python if/while branches on a value synced from the card inside "
        "hot device code (a sync plus a host decision every iteration)"),
    "purity-np-call": (
        "numpy call on a tensor inside hot device code (copies the tensor "
        "to the host, or fails on a card tensor)"),
    "purity-impure-call": (
        "impure call inside an autograd, compiled or graph-captured "
        "callable: random/time/open/print/input (a compiled or captured "
        "graph runs it at capture only; in backward it runs on the "
        "autograd thread)"),
    "purity-telemetry-call": (
        "telemetry helper (span/count/gauge/observe) inside an autograd, "
        "compiled or graph-captured callable — host-side only: a capture "
        "records it once and replays nothing per execution"),
    "resource-unclosed": (
        "open()/socket/TemporaryFile handle neither used as a context "
        "manager nor closed/returned/handed off in its function"),
    "resource-tempdir": (
        "tempfile.mkdtemp() result has no shutil.rmtree in a finally block "
        "(leaks the dir on non-anticipated exceptions)"),
    "assert-in-protocol": (
        "bare assert validating wire/peer-supplied data in tracker/ or io/ "
        "(vanishes under python -O; crashes the serving thread instead of "
        "rejecting the peer — raise ProtocolError)"),
    "shm-no-pickle": (
        "pickle/marshal on the shared-memory parse transport path "
        "(data/parse_proc.py): array payloads must cross process "
        "boundaries as raw shm bytes, never pickled objects"),
    "style-no-print": "library code must log via utils.logging, not print()",
    "deadlock-lock-cycle": (
        "cycle in the global lock-order graph (interprocedural: holding A "
        "and calling code that takes B orders A before B) — two threads "
        "taking the locks in opposite order deadlock"),
    "deadlock-blocking-under-lock": (
        "unbounded blocking call (queue.get/.join()/.result()/.wait()/"
        "socket recv without timeout) while holding a lock, directly or "
        "through the call graph; every thread needing the lock wedges "
        "behind the wait"),
    "contract-undocumented-knob": (
        "DMLC_* env var read in code but absent from every catalog table — "
        "regenerate the knob catalog (--emit-knob-catalog) or delete the "
        "knob"),
    "contract-undocumented-metric": (
        "dmlc_* metric recorded in code but absent from the metric "
        "catalog table"),
    "contract-undocumented-span": (
        "telemetry span/event name recorded in code but absent from the "
        "span catalog table (--emit-span-catalog regenerates it)"),
    "contract-undocumented-site": (
        "fault site injected but not registered in fault.SITES, or "
        "registered but missing from the catalog's site table"),
    "contract-stale-doc-entry": (
        "a catalog row names a knob/metric/span/site the code no "
        "longer has — prune the row or restore the artifact"),
    "escape-leak-on-raise": (
        "a path from a resource acquisition (shm/socket/executor/mmap/fd/"
        "temp dir) to the function exit drops the last reference — "
        "typically the exception edge between the acquire and the "
        "finally/with that releases, a failed __init__ orphaning a "
        "self.-owned handle, or a class that never releases an attr it "
        "owns"),
    "escape-double-release": (
        "a non-idempotent release (unlink/rmtree/os.close) may run twice "
        "on one path — the second call raises or tears down a reused "
        "handle"),
    "torchbound-unaccounted-transfer": (
        "a copy to the card (.to(<device>)/.cuda()/torch.as_tensor or "
        "torch.tensor with device=/.copy_(..., non_blocking=)) in bridge/ "
        "outside the _accounted_place wrapper — bytes ship off the books "
        "of dmlc_transfer_bytes_total and the trace critical path"),
    "torchbound-wide-wire": (
        "binned (narrow-wire) data widened to float32/float64 before a "
        "copy to the card — re-inflates the uint8 wire ~4x; widen on the "
        "card instead"),
    "torchbound-rebuilt-per-call": (
        "torch.compile/torch.jit.script, a CUDA graph capture or "
        "ops/_build.load_library() rebuilt on every call of a function "
        "that is not construction-time code (module level, __init__, an "
        "lru_cache/cache/cached_property builder) — every call pays the "
        "compile, capture or load again"),
    "race-unlocked-shared-write": (
        "attribute reachable from a thread-entry root and another thread "
        "is written with no lock held at any write site (Eraser empty "
        "lockset) — guard every access with one lock, publish before "
        "thread start, or hand off via a queue"),
    "race-inconsistent-lockset": (
        "shared attribute's write sites hold locks, but no ONE lock is "
        "held at all of them (empty lockset intersection) — each site "
        "looks locked in isolation while the writes still race"),
    "taint-unbounded-wire-int": (
        "int decoded from the wire (FramedSocket recvint, struct.unpack, "
        "JSON off a received frame) sizes an allocation, range(), recv(n) "
        "or sequence repeat without a bounds guard — one hostile frame "
        "picks the allocation size"),
    "taint-wire-str-in-path": (
        "string decoded from the wire reaches open()/os.path.join()/"
        "Path()/remove() without an allowlist or basename() step — path "
        "traversal from a protocol frame"),
}

# which pass owns which rule (drives --pass filtering of stale-entry
# reporting and scoped baseline rewrites)
RULES_BY_PASS: Dict[str, Tuple[str, ...]] = {
    "lockset": ("lockset-unsync-write", "lockset-thread-leak",
                "lockset-no-join"),
    "purity": ("purity-host-sync", "purity-host-branch", "purity-np-call",
               "purity-impure-call", "purity-telemetry-call"),
    "resources": ("resource-unclosed", "resource-tempdir", "style-no-print"),
    "protocol": ("assert-in-protocol",),
    "transport": ("shm-no-pickle",),
    "deadlock": ("deadlock-lock-cycle", "deadlock-blocking-under-lock"),
    "contracts": ("contract-undocumented-knob", "contract-undocumented-metric",
                  "contract-undocumented-span", "contract-undocumented-site",
                  "contract-stale-doc-entry"),
    "escape": ("escape-leak-on-raise", "escape-double-release"),
    "torchbound": ("torchbound-unaccounted-transfer", "torchbound-wide-wire",
                   "torchbound-rebuilt-per-call"),
    "races": ("race-unlocked-shared-write", "race-inconsistent-lockset"),
    "wiretaint": ("taint-unbounded-wire-int", "taint-wire-str-in-path"),
}


def render_rule_catalog() -> str:
    """The generated rule-catalog table (committed into CATALOG.md;
    ``--emit-rule-catalog`` regenerates it, and
    ``test_committed_catalogs_match_code`` pins freshness — the analyzer
    now eats its own cross-artifact dog food)."""
    lines = ["| pass | rule | what it flags |", "| --- | --- | --- |",
             "| driver | `syntax` | " + ALL_RULES["syntax"] + " |"]
    for pass_name in PER_FILE_PASSES + PROJECT_PASSES:
        for rule in RULES_BY_PASS[pass_name]:
            desc = " ".join(ALL_RULES[rule].split()).replace("|", "\\|")
            lines.append(f"| {pass_name} | `{rule}` | {desc} |")
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    lineno: int
    symbol: str        # enclosing qualname / Class.attr — stable across moves
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}:{self.rule}:{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.lineno}: {self.rule} [{self.symbol}] {self.message}"


# -- shared AST helpers -------------------------------------------------------

def build_parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` for an Attribute/Name chain; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        return None
    return ".".join(reversed(parts))


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


class FileContext:
    """Everything a pass needs about one file, computed once."""

    def __init__(self, relpath: str, source: str, tree: ast.Module,
                 is_library: bool, cli_exempt: bool):
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.is_library = is_library
        self.cli_exempt = cli_exempt
        self.parents = build_parents(tree)
        self.module_aliases = self._collect_aliases(tree)
        self._defs_by_name: Optional[Dict[str, List[ast.AST]]] = None
        self._assign_aliases: Optional[Dict[str, ast.AST]] = None

    @staticmethod
    def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
        """Local name -> imported module path (``np`` -> ``numpy``)."""
        out: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    out[alias.asname or alias.name.split(".")[0]] = alias.name
        return out

    @property
    def defs_by_name(self) -> Dict[str, List[ast.AST]]:
        """Module function defs by short name — shared by the lockset
        (thread-target resolution) and purity (root/callee resolution)
        passes; computed once per file."""
        if self._defs_by_name is None:
            defs: Dict[str, List[ast.AST]] = {}
            for node in ast.walk(self.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs.setdefault(node.name, []).append(node)
            self._defs_by_name = defs
        return self._defs_by_name

    @property
    def assign_aliases(self) -> Dict[str, ast.AST]:
        """``name = f`` / ``name = functools.partial(f, ...)`` bindings
        anywhere in the module, so ``kernel = partial(_kernel, ...);
        pallas_call(kernel)`` resolves.  Collisions across scopes keep the
        first binding — acceptable for a lint pass."""
        if self._assign_aliases is None:
            aliases: Dict[str, ast.AST] = {}
            for node in ast.walk(self.tree):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                value = node.value
                if isinstance(value, ast.Call):
                    fname = dotted_name(value.func) or ""
                    if fname.rsplit(".", 1)[-1] == "partial" and value.args:
                        value = value.args[0]
                    else:
                        continue
                if isinstance(value, (ast.Name, ast.Attribute, ast.Lambda)):
                    aliases.setdefault(node.targets[0].id, value)
            self._assign_aliases = aliases
        return self._assign_aliases

    def enclosing(self, node: ast.AST, *types) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, types):
                return cur
            cur = self.parents.get(cur)
        return None

    def qualname(self, node: ast.AST) -> str:
        """Dotted path of enclosing defs/classes, for stable finding keys."""
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                parts.append("<lambda>")
            cur = self.parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def finding(self, rule: str, node: ast.AST, message: str,
                symbol: Optional[str] = None) -> Finding:
        return Finding(rule, self.relpath, getattr(node, "lineno", 0),
                       symbol if symbol is not None else self.qualname(node),
                       message)


# -- suppression comments -----------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*dmlclint:\s*disable=([A-Za-z0-9_,\- ]+)")


def suppressed_lines(source: str) -> Dict[int, Set[str]]:
    """line -> suppressed rule names.  A directive on a comment-only line
    also applies to the line below it, so rules can be silenced without
    pushing code past the line-length limit."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        match = _SUPPRESS_RE.search(line)
        if not match:
            continue
        rules = {r.strip() for r in match.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if line.lstrip().startswith("#"):
            out.setdefault(i + 1, set()).update(rules)
    return out


# -- per-file analysis --------------------------------------------------------

def default_passes(relpath: str) -> Tuple[str, ...]:
    """Per-file passes a path gets by default: the full set for library
    code, a named subset for EXTRA_DEEP files, syntax-only otherwise."""
    if relpath.startswith(LIBRARY_PREFIX):
        return PER_FILE_PASSES
    return EXTRA_DEEP.get(relpath, ())


def _pass_runners():
    from dmlc_core_tpu_torch.analysis import (lockset, protocol, purity,
                                              resources, transport)

    return {"lockset": lockset.run, "purity": purity.run,
            "resources": resources.run, "protocol": protocol.run,
            "transport": transport.run}


def _parse_tree(source: str,
                relpath: str) -> Tuple[Optional[ast.Module],
                                       Optional[Finding]]:
    try:
        return ast.parse(source, relpath), None
    except SyntaxError as exc:
        return None, Finding("syntax", relpath, exc.lineno or 0, "<module>",
                             f"syntax error: {exc.msg}")


def _apply_suppressions(findings: List[Finding],
                        supp: Dict[int, Set[str]]) -> List[Finding]:
    return [f for f in findings
            if not ({"all", f.rule} & supp.get(f.lineno, set()))]


def _analyze_context(ctx: FileContext,
                     passes: Sequence[str]) -> List[Finding]:
    """Per-file passes over an already-parsed context."""
    findings: List[Finding] = []
    if passes:
        runners = _pass_runners()
        for name in passes:
            findings += runners[name](ctx)
    findings = _apply_suppressions(findings, suppressed_lines(ctx.source))
    return sorted(findings, key=lambda f: (f.lineno, f.rule, f.symbol))


def analyze_source(source: str, relpath: str = "<string>",
                   is_library: Optional[bool] = None,
                   passes: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run per-file passes over one source blob; returns sorted,
    unsuppressed findings.  ``passes`` selects a subset; ``is_library``
    keeps the historical override (True = every per-file pass, False =
    syntax only); by default the path decides (deep passes on
    ``dmlc_core_tpu_torch/`` files and the EXTRA_DEEP subset on
    ``chip_smoke.py``)."""
    relpath = relpath.replace(os.sep, "/")
    if passes is None:
        if is_library is None:
            passes = default_passes(relpath)
        else:
            passes = PER_FILE_PASSES if is_library else ()
    tree, syntax = _parse_tree(source, relpath)
    if tree is None:
        return [syntax]
    lib = (is_library if is_library is not None
           else _project_scope(relpath))
    ctx = FileContext(relpath, source, tree, lib,
                      cli_exempt=is_cli_exempt(relpath))
    return _analyze_context(ctx, passes)


def repo_relpath(path: str, root: str = ROOT) -> str:
    """Repo-relative forward-slash path used in finding keys."""
    relpath = os.path.relpath(os.path.abspath(path), root)
    if relpath.startswith(".."):
        # out-of-tree file (e.g. a scratch checkout): anchor at the last
        # dmlc_core_tpu_torch path component so library rules still apply
        parts = os.path.abspath(path).split(os.sep)
        if LIBRARY_PREFIX.rstrip("/") in parts:
            idx = len(parts) - 1 - parts[::-1].index(LIBRARY_PREFIX.rstrip("/"))
            relpath = os.sep.join(parts[idx:])
        else:
            relpath = os.path.basename(path)
    return relpath.replace(os.sep, "/")


def analyze_path(path: str, root: str = ROOT) -> List[Finding]:
    relpath = repo_relpath(path, root)
    source, err = _read_source(path, relpath)
    if source is None:
        return [err]
    return analyze_source(source, relpath)


def iter_python_files(paths: Optional[Sequence[str]] = None,
                      root: str = ROOT) -> Iterable[str]:
    targets = list(paths) if paths else [os.path.join(root, t)
                                         for t in TARGETS]
    for target in targets:
        if not os.path.exists(target):
            # a typo'd/renamed target must not pass the gate as
            # "0 files, 0 findings"
            raise FileNotFoundError(f"no such file or directory: {target}")
        if os.path.isfile(target):
            yield target
            continue
        for dirpath, _, files in os.walk(target):
            if "__pycache__" in dirpath:
                continue
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


# -- project passes -----------------------------------------------------------

def _project_scope(relpath: str) -> bool:
    """Files that ride in the project graph (library code + EXTRA_DEEP)."""
    return relpath.startswith(LIBRARY_PREFIX) or relpath in EXTRA_DEEP


def _read_source(path: str, relpath: str) -> Tuple[Optional[str],
                                                   Optional[Finding]]:
    try:
        # tokenize.open honors a PEP 263 `# -*- coding: ... -*-` line,
        # which plain utf-8 open would reject on legacy files
        with tokenize.open(path) as f:
            return f.read(), None
    except (UnicodeDecodeError, LookupError, SyntaxError) as exc:
        # undecodable bytes / bogus coding cookie: one finding, not a
        # traceback that kills the whole gate
        return None, Finding("syntax", relpath, 0, "<module>",
                             f"cannot decode source: {exc}")


def _project_contexts(extra: Optional[Dict[str, "FileContext"]] = None
                      ) -> List["FileContext"]:
    """Parse every project-scope file under the default targets into
    FileContexts, reusing already-parsed ones from ``extra``."""
    extra = extra or {}
    out: List[FileContext] = []
    seen: Set[str] = set()
    for path in iter_python_files(None):
        relpath = repo_relpath(path)
        if not _project_scope(relpath) or relpath in seen:
            continue
        seen.add(relpath)
        if relpath in extra:
            out.append(extra[relpath])
            continue
        source, err = _read_source(path, relpath)
        if source is None:
            continue  # the per-file sweep reports the decode error
        tree, syntax = _parse_tree(source, relpath)
        if tree is None:
            continue
        out.append(FileContext(relpath, source, tree, True,
                               cli_exempt=is_cli_exempt(relpath)))
    return out


def _run_project_passes(selected: Set[str],
                        contexts: List["FileContext"]) -> List[Finding]:
    """Deadlock/contracts over the whole-project graph; suppression
    directives in the anchoring file apply exactly like per-file rules."""
    from dmlc_core_tpu_torch.analysis import contracts as contracts_mod
    from dmlc_core_tpu_torch.analysis import deadlock as deadlock_mod
    from dmlc_core_tpu_torch.analysis import escape as escape_mod
    from dmlc_core_tpu_torch.analysis import torchbound as torchbound_mod
    from dmlc_core_tpu_torch.analysis import races as races_mod
    from dmlc_core_tpu_torch.analysis import wiretaint as wiretaint_mod
    from dmlc_core_tpu_torch.analysis.graph import ProjectGraph

    graph = ProjectGraph(contexts)
    findings: List[Finding] = []
    if "deadlock" in selected:
        findings += deadlock_mod.run_project(graph)
    if "contracts" in selected:
        findings += contracts_mod.run_project(
            graph, contracts_mod.load_docs(ROOT))
    if "escape" in selected:
        findings += escape_mod.run_project(graph)
    if "torchbound" in selected:
        findings += torchbound_mod.run_project(graph)
    if "races" in selected:
        findings += races_mod.run_project(graph)
    if "wiretaint" in selected:
        findings += wiretaint_mod.run_project(graph)
    supp_by_file: Dict[str, Dict[int, Set[str]]] = {}
    for ctx in contexts:
        supp_by_file[ctx.relpath] = suppressed_lines(ctx.source)
    out: List[Finding] = []
    for f in findings:
        supp = supp_by_file.get(f.path)
        if supp and ({"all", f.rule} & supp.get(f.lineno, set())):
            continue
        out.append(f)
    return sorted(out, key=lambda f: (f.path, f.lineno, f.rule, f.symbol))


# -- output formats -----------------------------------------------------------

def _github_annotation(f: Finding) -> str:
    # '::error' annotations render inline on the PR diff; commas/newlines
    # in properties must be %-escaped per the workflow-command grammar
    msg = f.message.replace("%", "%25").replace("\r", "%0D") \
        .replace("\n", "%0A")
    return (f"::error file={f.path},line={f.lineno},"
            f"title=dmlclint {f.rule} [{f.symbol}]::{msg}")


def _sarif_document(findings: Sequence[Finding]) -> Dict:
    rules = [{"id": rule,
              "shortDescription": {"text": ALL_RULES[rule]}}
             for rule in sorted(ALL_RULES)]
    results = [{
        "ruleId": f.rule,
        "level": "error",
        "message": {"text": f"[{f.symbol}] {f.message}"},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path,
                                     "uriBaseId": "SRCROOT"},
                "region": {"startLine": max(f.lineno, 1)},
            },
        }],
    } for f in findings]
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                    "master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "dmlclint",
                "informationUri": "dmlc_core_tpu_torch/analysis/CATALOG.md",
                "rules": rules,
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
        }],
    }


# -- CLI ----------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    """The dmlclint argument parser (one definition, so every caller sees
    the same flags and argparse prefix abbreviations like ``--base`` for
    ``--baseline``)."""
    parser = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.analysis",
        description="dmlclint: lockset / torch-purity / resource / deadlock / "
                    "contract static analysis with a ratcheted baseline "
                    "(dmlc_core_tpu_torch/analysis/CATALOG.md)")
    parser.add_argument("paths", nargs="*",
                        help="files or directories (default: repo targets)")
    parser.add_argument("--baseline",
                        default=BASELINE,
                        help="baseline file (default: %(default)s)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding as new (ignore baseline)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline from current findings, "
                             "keeping existing justifications")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="also print baselined findings")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--pass", dest="passes", action="append",
                        metavar="PASS",
                        help="run only the named pass(es) "
                             f"({', '.join(PER_FILE_PASSES + PROJECT_PASSES)}"
                             "; repeat or comma-separate; default: all). "
                             "Project passes always analyze the whole repo")
    parser.add_argument("--format", dest="fmt", default="text",
                        choices=("text", "github", "sarif"),
                        help="finding output format: text (default), github "
                             "workflow annotations, or a SARIF 2.1.0 "
                             "document")
    parser.add_argument("--output", metavar="FILE",
                        help="also write the SARIF document here (works "
                             "with any --format; with --format sarif it "
                             "replaces stdout output)")
    parser.add_argument("--jobs", type=int, default=1, metavar="N",
                        help="fan the per-file passes out over N worker "
                             "processes (default: 1 = serial); findings "
                             "are reassembled in file order, so output "
                             "is byte-identical to a serial run. Project "
                             "passes always run sequentially")
    parser.add_argument("--emit-knob-catalog", action="store_true",
                        help="print the generated DMLC_* knob catalog "
                             "markdown table and exit")
    parser.add_argument("--emit-span-catalog", action="store_true",
                        help="print the generated telemetry span catalog "
                             "markdown table and exit")
    parser.add_argument("--emit-rule-catalog", action="store_true",
                        help="print the generated rule catalog markdown "
                             "table (committed in CATALOG.md) and "
                             "exit")
    return parser


def _selected_passes(args) -> Tuple[Set[str], bool]:
    """(selected pass names, was --pass given explicitly)."""
    every = set(PER_FILE_PASSES) | set(PROJECT_PASSES)
    if not args.passes:
        return every, False
    out: Set[str] = set()
    for spec in args.passes:
        for name in spec.split(","):
            name = name.strip()
            if not name:
                continue
            if name not in every:
                raise ValueError(
                    f"unknown pass {name!r} (choose from "
                    f"{', '.join(sorted(every))})")
            out.add(name)
    if not out:
        # `--pass ""` (an unset shell variable in CI) must not silently
        # disable every rule and green-light the gate
        raise ValueError("--pass given but names no pass (choose from "
                         f"{', '.join(sorted(every))})")
    return out, True


def _scan_file_job(job: Tuple[str, Set[str]]) -> Tuple[str, List[Finding]]:
    """One ``--jobs`` unit of work: read/parse a file and run its per-file
    passes.  Module-level (not a closure) so process pools can pickle it;
    Finding is a frozen dataclass of primitives, so results ship back
    cheaply.  ASTs never cross the process boundary — the project stage
    re-parses its own contexts."""
    path, selected = job
    relpath = repo_relpath(path)
    source, err = _read_source(path, relpath)
    if source is None:
        return relpath, [err]
    per_file = [p for p in default_passes(relpath) if p in selected]
    tree, syntax = _parse_tree(source, relpath)
    if tree is None:
        return relpath, [syntax]
    if not per_file:
        return relpath, []
    ctx = FileContext(relpath, source, tree, _project_scope(relpath),
                      cli_exempt=is_cli_exempt(relpath))
    return relpath, _analyze_context(ctx, per_file)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from dmlc_core_tpu_torch.analysis import baseline as baseline_mod

    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rule in sorted(ALL_RULES):
            print(f"{rule:32s} {ALL_RULES[rule]}")
        return 0

    try:
        selected, explicit_passes = _selected_passes(args)
    except ValueError as exc:
        print(f"dmlclint: {exc}", file=sys.stderr)
        return 2

    if args.emit_rule_catalog:
        # no graph needed: the rule catalog is pure registry truth
        print(render_rule_catalog())
        return 0

    if args.emit_knob_catalog or args.emit_span_catalog:
        from dmlc_core_tpu_torch.analysis import contracts as contracts_mod
        from dmlc_core_tpu_torch.analysis.graph import ProjectGraph

        graph = ProjectGraph(_project_contexts())
        if args.emit_knob_catalog:
            print(contracts_mod.render_knob_catalog(graph))
        if args.emit_span_catalog:
            print(contracts_mod.render_span_catalog(graph))
        return 0

    try:
        files = list(iter_python_files(args.paths or None))
    except FileNotFoundError as exc:
        print(f"dmlclint: {exc}", file=sys.stderr)
        return 2
    # project passes: on by default for the unscoped gate run; a scoped
    # (path-argument) run skips them unless --pass asks — and then the
    # graph is still built over the whole repo, because a partial call
    # graph would under-approximate held-lock sets and doc obligations
    project_selected = selected & set(PROJECT_PASSES)
    project_ran = bool(project_selected
                       and (not args.paths or explicit_passes))

    findings: List[Finding] = []
    project_findings: List[Finding] = []
    jobs = max(1, args.jobs or 1)
    if jobs > 1 and len(files) > 1:
        # fan the per-file stage out.  pool.map submits every file up
        # front and preserves input order, so the parent can run the
        # (sequential, graph-bound) project passes WHILE workers chew
        # the per-file passes, then drain results — same findings, same
        # order, byte-identical output to a serial run
        import concurrent.futures

        with concurrent.futures.ProcessPoolExecutor(
                max_workers=jobs) as pool:
            per_file_results = pool.map(
                _scan_file_job, [(p, selected) for p in files],
                chunksize=max(1, len(files) // (jobs * 4)))
            if project_ran:
                project_findings = _run_project_passes(
                    project_selected, _project_contexts())
            for _relpath, batch in per_file_results:
                findings += batch
    else:
        parsed: Dict[str, FileContext] = {}
        for path in files:
            relpath = repo_relpath(path)
            source, err = _read_source(path, relpath)
            if source is None:
                findings.append(err)
                continue
            per_file = [p for p in default_passes(relpath)
                        if p in selected]
            tree, syntax = _parse_tree(source, relpath)
            if tree is None:
                findings.append(syntax)
                continue
            if per_file or _project_scope(relpath):
                # context built once: shared by the per-file passes here
                # and the project passes below (no re-parse)
                ctx = FileContext(relpath, source, tree,
                                  _project_scope(relpath),
                                  cli_exempt=is_cli_exempt(relpath))
                findings += _analyze_context(ctx, per_file)
                if _project_scope(relpath):
                    parsed[relpath] = ctx
        if project_ran:
            project_findings = _run_project_passes(
                project_selected, _project_contexts(extra=parsed))
    findings += project_findings

    try:
        # --no-baseline only changes *reporting*; a rewrite still loads the
        # file, else justifications (and out-of-scope keys in a path-scoped
        # run) would be silently destroyed
        load_it = args.write_baseline or not args.no_baseline
        previous = baseline_mod.load(args.baseline) if load_it else {}
    except ValueError as exc:
        print(f"dmlclint: {exc}", file=sys.stderr)
        return 2
    # rules whose passes actually RAN this invocation: per-file passes in
    # the selection always run; project-pass rules only count when the
    # project passes ran (a plain scoped run skips them, so their baseline
    # entries were never recomputed and must survive untouched).  Project
    # passes, when they DO run, always analyze the whole repo — so their
    # entries are recomputed regardless of any path scope.
    ran_passes = {name for name in selected
                  if name in PER_FILE_PASSES
                  or (name in PROJECT_PASSES and project_ran)}
    ran_rules = {rule for name in ran_passes
                 for rule in RULES_BY_PASS[name]} | {"syntax"}
    project_ran_rules = {rule for name in ran_passes
                         if name in PROJECT_PASSES
                         for rule in RULES_BY_PASS[name]}
    analyzed = {repo_relpath(p) for p in files} if args.paths else None

    def _rule_of_key(key: str) -> str:
        parts = key.split(":")
        return parts[1] if len(parts) >= 3 else ""

    def _recomputed(key: str) -> bool:
        """Was this baseline entry's finding recomputed by THIS run?  An
        entry whose rule no longer exists belongs to no pass and counts
        as recomputed: the rewrite is the prune path for dead-rule
        garbage, and the stale report must keep naming it."""
        rule = _rule_of_key(key)
        if rule not in ALL_RULES:
            return True
        if rule not in ran_rules:
            return False
        if rule in project_ran_rules:
            return True  # whole-repo pass: path scope does not shield it
        return analyzed is None or key.split(":", 1)[0] in analyzed

    if args.write_baseline:
        # a rewrite regenerates only recomputed keys; everything else is
        # kept verbatim (files a path-scoped run never analyzed, passes
        # that never ran)
        keep = {k: v for k, v in previous.items() if not _recomputed(k)}
        baseline_mod.save(args.baseline, findings, previous, keep=keep)
        print(f"dmlclint: baseline written to {args.baseline} "
              f"({len(findings)} finding(s), {len(keep)} out-of-scope "
              f"entries kept)")
        return 0

    new, baselined, stale = baseline_mod.partition(findings, previous)
    # a non-recomputed entry is not "fixed or moved" — don't advise
    # pruning it; recomputed ones (incl. dead-rule garbage) stay reported
    stale = [k for k in stale if _recomputed(k)]

    summary = (f"dmlclint: {len(files)} files, {len(new)} new finding(s), "
               f"{len(baselined)} baselined, {len(stale)} stale")
    if args.output:
        # the SARIF artifact is writable from ANY format mode, so one gate
        # run can render annotations AND produce the machine-readable
        # record (the CI analysis job relies on this)
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(json.dumps(_sarif_document(new), indent=2) + "\n")
        print(f"dmlclint: SARIF written to {args.output}")
    if args.fmt == "sarif":
        if not args.output:
            # the document owns stdout; keep it parseable
            print(json.dumps(_sarif_document(new), indent=2))
            print(summary, file=sys.stderr)
    else:
        for f in new:
            if args.fmt == "github":
                print(_github_annotation(f))
            print(f.render())
        if args.verbose:
            counts: Dict[str, int] = {}
            for f in baselined:
                key = baseline_mod._instance_key(f.key, counts)
                note = previous.get(key, previous.get(f.key, ""))
                print(f"{f.render()}  (baselined: {note})")
    if stale:
        print(f"dmlclint: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (fixed or moved — prune "
              f"with --write-baseline):", file=sys.stderr)
        for key in stale:
            print(f"  {key}", file=sys.stderr)
    if args.fmt != "sarif" or args.output:
        print(summary)
    return 1 if new else 0
