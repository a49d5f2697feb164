"""Pass 6 — deadlock: interprocedural lock-order + blocking-under-lock.

The per-file lockset pass checks that a class is *consistent* with its own
lock; it cannot see that the scheduler's RLock, the flight recorder's dump
lock and the parse pool's module lock form an order — or a cycle — because
the acquisitions live in different files connected only by calls.  This
pass walks the :class:`~dmlc_core_tpu_torch.analysis.graph.ProjectGraph`:

``deadlock-lock-cycle``
    For every lock *declaration* (``self.X = threading.Lock()`` in a class,
    ``X = threading.Lock()`` at module level), every acquisition site
    (``with <lock>:``) records the set of locks already held there — both
    lexically and through the call graph (holding L and calling a function
    that transitively acquires M counts as an L→M ordering).  The global
    lock-order graph's cycles are deadlocks waiting for the right thread
    interleaving: thread 1 takes A then B, thread 2 takes B then A.  A
    single-lock cycle (re-acquiring a non-reentrant ``Lock`` you already
    hold) is the degenerate case and deadlocks *every* time; re-acquiring
    an ``RLock``/``Condition`` (reentrant by construction) is not flagged.

``deadlock-blocking-under-lock``
    An unbounded blocking call made while at least one lock is held — the
    other half of most real wedges: the lock holder parks forever, every
    other thread piles up behind the lock.  Flagged calls: ``queue.get()``
    / ``.join()`` / ``.result()`` / ``.wait()`` without a timeout, and
    socket-style ``.recv*()``/``.accept()``.  ``Condition.wait()`` under
    its *own* condition is the documented idiom (wait releases the lock it
    guards) and is exempt — but holding any *other* lock across the wait
    still blocks, and is flagged.  The check is interprocedural: holding a
    lock and calling a function whose transitive body blocks is the same
    bug one hop removed (`pool.submit(...).result()` under the pool lock
    was a live example in this repo).

Lock identity is **per class attribute / per module global**, not per
instance — the RacerX convention: two instances of one class map to one
order node.  That direction of unsoundness (a "cycle" between two distinct
instances cannot actually deadlock) is what the suppression machinery is
for; the converse (instance-blind analysis still catches every same-
instance inversion) is why it pays rent.  Acquisitions the pass can see
are ``with`` statements; bare ``.acquire()`` calls are out of scope (the
codebase uses ``with`` exclusively — keep it that way).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from dmlc_core_tpu_torch.analysis.driver import (Finding, dotted_name,
                                                 keyword_arg)
from dmlc_core_tpu_torch.analysis.graph import (FunctionInfo, ModuleInfo,
                                                ProjectGraph, walk_in_scope)
from dmlc_core_tpu_torch.analysis.lockset import LOCK_TYPES

__all__ = ["run_project", "BLOCKING_METHODS"]

# lock factories whose self-re-acquisition is NOT an unconditional
# deadlock, so self-edges in the order graph are skipped: RLock and
# Condition (default inner lock is an RLock) are reentrant for the holding
# thread; counting Semaphores legitimately acquire more than once while
# the count allows (the initial value is invisible statically).  Edges
# between *distinct* locks keep full cycle analysis for all kinds.
_REENTRANT_FACTORIES = {"RLock", "Condition", "Semaphore",
                        "BoundedSemaphore"}

# method name -> index of the positional timeout parameter (None = the call
# has no timeout form and is always unbounded)
BLOCKING_METHODS: Dict[str, Optional[int]] = {
    "get": 1,       # queue.Queue.get(block, timeout)
    "join": 0,      # Thread.join(timeout) / Process.join(timeout)
    "wait": 0,      # Condition/Event.wait(timeout), Popen.wait(timeout)
    "result": 0,    # Future.result(timeout)
    "recv": None, "recvall": None, "recvint": None, "recvstr": None,
    "recv_into": None, "accept": None,
}

# join() receivers that are never threads (mirrors lockset._has_join)
_NON_THREAD_RECEIVERS = {"os.path", "posixpath", "ntpath", "str"}


@dataclasses.dataclass(frozen=True)
class LockDecl:
    lock_id: str       # "mod.Class.attr" / "mod.name"
    relpath: str
    lineno: int
    reentrant: bool


@dataclasses.dataclass(frozen=True)
class _Acquire:
    lock: str
    held: FrozenSet[str]
    lineno: int


@dataclasses.dataclass(frozen=True)
class _Blocking:
    desc: str          # "queue.get() with no timeout" etc.
    relpath: str
    lineno: int
    qualname: str
    receiver_lock: Optional[str]  # lock id when the receiver IS a lock


@dataclasses.dataclass
class _Summary:
    fn: FunctionInfo
    acquires: List[_Acquire]
    blocking: List[Tuple[ast.Call, _Blocking, FrozenSet[str]]]
    calls: List[Tuple[ast.Call, FunctionInfo, FrozenSet[str]]]


# -- lock declaration / expression recognition --------------------------------

def _lock_factory_kind(value: ast.AST) -> Optional[str]:
    """``Lock``/``RLock``/... when ``value`` constructs a threading lock."""
    if not isinstance(value, ast.Call):
        return None
    name = dotted_name(value.func) or ""
    short = name.rsplit(".", 1)[-1]
    if short in LOCK_TYPES and (name == short or name == f"threading.{short}"):
        return short
    return None


def _collect_locks(project: ProjectGraph) -> Dict[str, LockDecl]:
    """Every lock declaration in the project, keyed by lock id."""
    decls: Dict[str, LockDecl] = {}

    def add(lock_id: str, mod: ModuleInfo, node: ast.AST,
            kind: str) -> None:
        decls.setdefault(lock_id, LockDecl(
            lock_id, mod.relpath, getattr(node, "lineno", 0),
            kind in _REENTRANT_FACTORIES))

    for mod in project.modules.values():
        for stmt in mod.ctx.tree.body:  # module-level locks
            if not isinstance(stmt, ast.Assign):
                continue
            kind = _lock_factory_kind(stmt.value)
            if kind is None:
                continue
            for target in stmt.targets:
                if isinstance(target, ast.Name):
                    add(f"{mod.modname}.{target.id}", mod, stmt, kind)
        for cls in mod.classes.values():  # self.X = threading.Lock()
            for node in ast.walk(cls.node):
                if not isinstance(node, ast.Assign):
                    continue
                kind = _lock_factory_kind(node.value)
                if kind is None:
                    continue
                for target in node.targets:
                    if (isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id in ("self", "cls")):
                        add(f"{mod.modname}.{cls.name}.{target.attr}",
                            mod, node, kind)
                    elif isinstance(target, ast.Name):
                        add(f"{mod.modname}.{cls.name}.{target.id}",
                            mod, node, kind)
    return decls


def _lock_of_expr(expr: ast.AST, fn: FunctionInfo,
                  decls: Dict[str, LockDecl]) -> Optional[str]:
    """Lock id an expression refers to, seen from inside ``fn``."""
    name = dotted_name(expr)
    if not name:
        return None
    mod = fn.module
    parts = name.split(".")
    if parts[0] in ("self", "cls") and len(parts) == 2 and fn.cls is not None:
        lock_id = f"{mod.modname}.{fn.cls.name}.{parts[1]}"
        return lock_id if lock_id in decls else None
    if len(parts) == 1:  # module-level lock by bare name
        lock_id = f"{mod.modname}.{parts[0]}"
        return lock_id if lock_id in decls else None
    # mod_alias._lock / pkg.mod._lock via imports
    if parts[0] in mod.import_mods:
        base = mod.import_mods[parts[0]]
        lock_id = ".".join([base] + parts[1:])
        return lock_id if lock_id in decls else None
    return None


# -- per-function scan --------------------------------------------------------

def _timeout_given(call: ast.Call, positional_idx: Optional[int]) -> bool:
    timeout = keyword_arg(call, "timeout")
    if timeout is not None:
        return not (isinstance(timeout, ast.Constant)
                    and timeout.value is None)
    if positional_idx is not None and len(call.args) > positional_idx:
        return True
    return False


def _classify_blocking(call: ast.Call, fn: FunctionInfo,
                       decls: Dict[str, LockDecl]) -> Optional[_Blocking]:
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    method = func.attr
    if method not in BLOCKING_METHODS:
        return None
    receiver = dotted_name(func.value)
    if method == "join":
        # ",".join(xs) / os.path.join(...): an argument-taking join is the
        # string/path form, a thread join's only argument is a timeout
        if call.args or isinstance(func.value, ast.Constant):
            return None
        if receiver in _NON_THREAD_RECEIVERS:
            return None
    if method == "get" and (call.args or call.keywords):
        # dict.get(key[, default]) takes positionals; queue.get's only
        # useful arguments are block/timeout — treat any argument form
        # other than a bare timeout as bounded/not-a-queue
        if not _timeout_given(call, 1):
            return None
    if _timeout_given(call, BLOCKING_METHODS[method]):
        return None
    receiver_lock = (_lock_of_expr(func.value, fn, decls)
                     if method == "wait" else None)
    what = f".{method}()"
    if receiver:
        what = f"{receiver}.{method}()"
    return _Blocking(f"{what} with no timeout", fn.module.relpath,
                     call.lineno, fn.qualname, receiver_lock)


def _scan_function(project: ProjectGraph, fn: FunctionInfo,
                   decls: Dict[str, LockDecl]) -> _Summary:
    acquires: List[_Acquire] = []
    blocking: List[Tuple[ast.Call, _Blocking, FrozenSet[str]]] = []
    calls: List[Tuple[ast.Call, FunctionInfo, FrozenSet[str]]] = []

    def visit_expr(node: ast.AST, held: FrozenSet[str]) -> None:
        # walk_in_scope yields descendants only and treats the root as a
        # scope boundary, so check the root Call (the common context_expr
        # shape) and skip a root lambda outright
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(node, ast.Call):
            on_call(node, held)
        for sub in walk_in_scope(node):
            if isinstance(sub, ast.Call):
                on_call(sub, held)

    def on_call(call: ast.Call, held: FrozenSet[str]) -> None:
        b = _classify_blocking(call, fn, decls)
        if b is not None:
            blocking.append((call, b, held))
        for callee in project.resolve_call(fn, call.func):
            calls.append((call, callee, held))

    def visit_stmt(node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return  # nested scope: runs at its own call time
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # items acquire LEFT TO RIGHT: `with a, b:` orders a before b
            # exactly like the nested form, so each item's held-set
            # includes the items already entered in this same statement
            newly: List[str] = []
            for item in node.items:
                entered = held.union(newly)
                visit_expr(item.context_expr, entered)
                lock = _lock_of_expr(item.context_expr, fn, decls)
                if lock is not None:
                    acquires.append(_Acquire(lock, entered, node.lineno))
                    newly.append(lock)
            inner = held.union(newly)
            for stmt in node.body:
                visit_stmt(stmt, inner)
            return
        if isinstance(node, ast.Call):
            on_call(node, held)
        for child in ast.iter_child_nodes(node):
            visit_stmt(child, held)

    for stmt in ast.iter_child_nodes(fn.node):
        visit_stmt(stmt, frozenset())
    return _Summary(fn, acquires, blocking, calls)


# -- interprocedural summaries ------------------------------------------------

class _Propagator:
    """Transitive-effect computation over the call graph, by fixpoint.

    A memoized DFS is tempting but WRONG here: with mutual recursion
    (f <-> g), whichever function is reached first while its partner is
    on the recursion stack gets a partial result cached permanently —
    order-dependent false negatives.  The call graphs are small (a few
    hundred functions), so a plain iterate-until-stable propagation is
    both simple and exact for this monotone join."""

    def __init__(self, summaries: Dict[str, _Summary]):
        self.summaries = summaries
        # fq -> lock id -> (relpath, lineno) of one acquisition site
        self._acquired: Dict[str, Dict[str, Tuple[str, int]]] = {}
        # fq -> (relpath, lineno) -> _Blocking, insertion-ordered
        self._blocking: Dict[str, Dict[Tuple[str, int], _Blocking]] = {}
        for fq, summary in summaries.items():
            acq: Dict[str, Tuple[str, int]] = {}
            for a in summary.acquires:
                acq.setdefault(a.lock,
                               (summary.fn.module.relpath, a.lineno))
            self._acquired[fq] = acq
            blk: Dict[Tuple[str, int], _Blocking] = {}
            for _, b, _ in summary.blocking:
                blk.setdefault((b.relpath, b.lineno), b)
            self._blocking[fq] = blk
        changed = True
        while changed:
            changed = False
            for fq, summary in summaries.items():
                acq = self._acquired[fq]
                blk = self._blocking[fq]
                for _, callee, _ in summary.calls:
                    for lock, site in self._acquired.get(callee.fq,
                                                         {}).items():
                        if lock not in acq:
                            acq[lock] = site
                            changed = True
                    for key, b in self._blocking.get(callee.fq,
                                                     {}).items():
                        if key not in blk:
                            blk[key] = b
                            changed = True

    def acquired(self, fq: str) -> Dict[str, Tuple[str, int]]:
        """lock id -> (relpath, lineno) of one acquisition site reachable
        from ``fq`` (its own body or any transitive project callee)."""
        return self._acquired.get(fq, {})

    def blocking(self, fq: str) -> List[_Blocking]:
        """Unbounded blocking sites reachable from ``fq``."""
        return list(self._blocking.get(fq, {}).values())


# -- the pass -----------------------------------------------------------------

def run_project(project: ProjectGraph) -> List[Finding]:
    decls = _collect_locks(project)
    if not decls:
        return []
    summaries: Dict[str, _Summary] = {}
    for fn in project.functions():
        summaries[fn.fq] = _scan_function(project, fn, decls)
    prop = _Propagator(summaries)

    findings: List[Finding] = []
    # edge (held -> acquired) -> witness (relpath, lineno, description)
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add_edge(held: str, lock: str, relpath: str, lineno: int,
                 how: str) -> None:
        if held == lock:
            if decls[lock].reentrant:
                return  # RLock/Condition re-entry is fine by construction
            edges.setdefault((held, lock), (relpath, lineno, how))
            return
        edges.setdefault((held, lock), (relpath, lineno, how))

    for summary in summaries.values():
        fn = summary.fn
        relpath = fn.module.relpath
        for acq in summary.acquires:
            for held in acq.held:
                add_edge(held, acq.lock, relpath, acq.lineno,
                         f"{fn.qualname} acquires {_short(acq.lock)} while "
                         f"holding {_short(held)}")
        for call, callee, held in summary.calls:
            if not held:
                continue
            for lock, site in prop.acquired(callee.fq).items():
                for h in held:
                    add_edge(h, lock, relpath, call.lineno,
                             f"{fn.qualname} calls {callee.qualname} "
                             f"(acquires {_short(lock)} at {site[0]}:"
                             f"{site[1]}) while holding {_short(h)}")
        # blocking-under-lock, local sites
        for call, b, held in summary.blocking:
            effective = held - ({b.receiver_lock} if b.receiver_lock else
                                set())
            if not effective:
                continue
            note = ("" if b.receiver_lock is None else
                    f" (the wait releases only {_short(b.receiver_lock)})")
            findings.append(Finding(
                "deadlock-blocking-under-lock", relpath, call.lineno,
                fn.qualname,
                f"{b.desc} while holding {_held_str(effective)}{note}; "
                "every thread needing the lock wedges behind this wait — "
                "bound it with a timeout or move it outside the lock"))
        # blocking-under-lock, one call-graph hop or more away
        reported: Set[int] = set()
        for call, callee, held in summary.calls:
            if not held or id(call) in reported:
                continue
            inherited = [b for b in prop.blocking(callee.fq)
                         if not (b.receiver_lock is not None
                                 and held == {b.receiver_lock})]
            if not inherited:
                continue
            reported.add(id(call))
            b = inherited[0]
            findings.append(Finding(
                "deadlock-blocking-under-lock", relpath, call.lineno,
                fn.qualname,
                f"call to {callee.qualname} while holding "
                f"{_held_str(held)} reaches {b.desc} "
                f"({b.relpath}:{b.lineno} in {b.qualname}); the lock is "
                "held across an unbounded wait"))

    findings.extend(_cycle_findings(edges, decls))
    return findings


def _short(lock_id: str) -> str:
    """Human form: the last two components (`Class.attr` / `mod._lock`)."""
    parts = lock_id.split(".")
    return ".".join(parts[-2:]) if len(parts) >= 2 else lock_id


def _held_str(held) -> str:
    return " + ".join(sorted(_short(h) for h in held))


def _cycle_findings(edges: Dict[Tuple[str, str], Tuple[str, int, str]],
                    decls: Dict[str, LockDecl]) -> List[Finding]:
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    findings: List[Finding] = []
    for cycle in _find_cycles(graph):
        # witness every edge of the cycle in the message; anchor the
        # finding at the first edge's site
        pairs = list(zip(cycle, cycle[1:] + cycle[:1]))
        witnesses = [edges[pair] for pair in pairs if pair in edges]
        if not witnesses:
            continue
        relpath, lineno, _ = witnesses[0]
        chain = " -> ".join(_short(l) for l in cycle + cycle[:1])
        detail = "; ".join(f"{w[2]} [{w[0]}:{w[1]}]" for w in witnesses)
        if len(cycle) == 1:
            msg = (f"non-reentrant lock {_short(cycle[0])} is re-acquired "
                   f"while already held — this deadlocks unconditionally: "
                   f"{detail}")
        else:
            msg = (f"lock-order cycle {chain}: two threads taking these "
                   f"locks in opposite order deadlock; {detail}")
        findings.append(Finding("deadlock-lock-cycle", relpath, lineno,
                                chain, msg))
    return findings


def _find_cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Cycles of the lock-order graph: one canonical simple cycle per
    strongly connected component with a cycle (plus self-loops)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    cycles: List[List[str]] = []
    for comp in sccs:
        comp_set = set(comp)
        if len(comp) == 1:
            v = comp[0]
            if v in graph.get(v, ()):  # self-loop
                cycles.append([v])
            continue
        cycles.append(_trace_cycle(graph, comp_set))
    return cycles


def _trace_cycle(graph: Dict[str, Set[str]],
                 comp: Set[str]) -> List[str]:
    """One simple cycle through an SCC, starting at its smallest node."""
    start = min(comp)
    path = [start]
    seen = {start}
    cur = start
    while True:
        nxt = None
        for cand in sorted(graph.get(cur, ())):
            if cand == start and len(path) > 1:
                return path
            if cand in comp and cand not in seen:
                nxt = cand
                break
        if nxt is None:
            # dead end inside the SCC (possible with the greedy walk):
            # back up; the SCC guarantees a cycle exists
            path.pop()
            if not path:
                return sorted(comp)  # defensive: report the whole SCC
            cur = path[-1]
            continue
        path.append(nxt)
        seen.add(nxt)
        cur = nxt
