"""Pass 10 — races: Eraser-style data-race detection over thread roots.

The per-file lockset pass answers "is this class consistent with its own
lock?" — it is blind to classes that own *no* lock (the CheckpointWatcher
odometers), to attributes of one class written by another (the registry
stamping ``slot.version``), and to lock context inherited through the
call graph (a ``*_locked`` helper whose callers hold the Condition).
This pass runs the classic Eraser lockset algorithm over the
:class:`~dmlc_core_tpu_torch.analysis.graph.ProjectGraph`:

1. **Thread-entry roots**: every ``threading.Thread(target=f)`` /
   ``executor.submit(f)`` whose target resolves statically, plus the
   ``do_*``/``handle*`` methods of HTTP/socketserver handler classes
   (each request runs on a server thread).
2. **Reachability**: functions reachable from a root run on that root's
   thread; public functions/methods (and everything they call) can run
   on the caller's ("main") thread.  One function can be both — a public
   ``poll_once`` that the watcher loop also drives IS the race.
3. **Locksets**: every attribute access site records the locks held
   lexically (``with`` statements, the deadlock pass's lock identity)
   PLUS the locks guaranteed at function entry — the intersection over
   all known call sites, iterated to fixpoint, which is how a private
   helper inherits the lock every caller wraps around it.
4. **Sharing + rules**: an attribute accessed from two distinct thread
   contexts (two roots, or a root and the main side) is *shared*.  If
   every write site's lockset is empty -> ``race-unlocked-shared-write``;
   if the sites hold locks but their intersection is empty ->
   ``race-inconsistent-lockset``.  Findings anchor at the offending
   WRITE site (thread-side preferred), never at the thread entry.

Eraser-style exemptions (the near-zero-noise contract):

- **init-before-start publication**: writes in ``__init__``/``__new__``,
  and writes lexically before the ``.start()`` call in the function that
  spawns the thread — the classic publish-then-start idiom.
- **read-only-after-publish**: an attribute never written outside
  construction has no write sites left and cannot fire.
- **queue/Future/Event-mediated handoff**: attributes whose inferred
  type is a synchronization object (Queue, Event, Lock, Thread, Future,
  executors) are lifecycle plumbing, not shared data — and values that
  travel *through* a queue arrive untyped, so the handoff pattern is
  structurally invisible to the sharing test.
- **join-mediated reads**: a read lexically after a ``.join(...)`` call
  in the same function observes a dead thread (the RabitTracker
  ``join()`` summary) and does not establish sharing.
- **per-request handler classes**: HTTP handler instances live for one
  request on one thread; their own attributes are thread-local.

Soundness caveats (CATALOG.md): nested ``def`` thread targets are
invisible (launcher ferrying closures), module-level globals are out of
scope, attribute writes through untyped locals cannot be attributed, and
lock identity is per class attribute, not per instance — all shared with
the deadlock pass, all documented, all why the baseline/suppression
machinery backs this pass like every other.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from dmlc_core_tpu_torch.analysis.deadlock import (LockDecl, _collect_locks,
                                                   _lock_of_expr)
from dmlc_core_tpu_torch.analysis.driver import (Finding, dotted_name,
                                                 keyword_arg)
from dmlc_core_tpu_torch.analysis.graph import (ClassInfo, FunctionInfo,
                                                ProjectGraph, _annotation_ref,
                                                walk_in_scope)

__all__ = ["run_project"]

_CONSTRUCTORS = {"__init__", "__new__"}

# attribute value types that ARE synchronization/handoff machinery:
# reassigning them is lifecycle management, not a shared-data write
_SYNC_TYPES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
               "Barrier", "Event", "Thread", "Timer", "Queue", "LifoQueue",
               "PriorityQueue", "SimpleQueue", "Future",
               "ThreadPoolExecutor", "ProcessPoolExecutor", "local"}

# stdlib bases whose subclasses run one instance per request/connection
# on a server thread: their methods are thread roots, their own
# attributes are per-request (thread-local)
_HANDLER_BASES = {"BaseHTTPRequestHandler", "SimpleHTTPRequestHandler",
                  "StreamRequestHandler", "BaseRequestHandler",
                  "ThreadingHTTPServer", "HTTPServer", "TCPServer",
                  "ThreadingMixIn"}

_HANDLER_METHOD_PREFIXES = ("do_", "handle")

# method calls that mutate their receiver container in place — a write
# to the attribute they are called on (Eraser tracks the memory, not
# just the binding)
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
             "add", "discard", "remove", "pop", "popleft", "popitem",
             "update", "setdefault", "clear", "sort", "reverse"}

# dunders that are public API despite the underscores (context managers,
# iteration, GC hooks — all driven by outside code); __init__/__new__
# stay listed: ctor self-writes are exempt anyway, but a ctor that pokes
# ANOTHER object's attributes runs on the constructing thread
_PUBLIC_DUNDERS = {"__call__", "__iter__", "__next__", "__enter__",
                   "__exit__", "__del__", "__len__", "__getitem__",
                   "__setitem__", "__contains__", "__bool__", "__repr__",
                   "__str__", "__eq__", "__hash__"}

_JOIN_NON_THREAD_ROOTS = {"os", "posixpath", "ntpath", "str"}


@dataclasses.dataclass(frozen=True)
class _Access:
    cls_key: str            # "modname:ClassName"
    attr: str
    fn_fq: str
    relpath: str
    lineno: int
    held: FrozenSet[str]    # lexical locks at the site
    is_write: bool
    self_base: bool         # via self./cls. (vs a typed local/param)


@dataclasses.dataclass
class _FnScan:
    fn: FunctionInfo
    accesses: List[_Access]
    calls: List[Tuple[str, FrozenSet[str]]]   # (callee fq, held at site)
    spawn_targets: List[str]                  # root fqs spawned here
    constructs: List[str]                     # cls_keys constructed here
    start_boundary: Optional[int]             # first thread .start() line
    join_line: Optional[int]                  # first thread .join() line


def _cls_key(cls: ClassInfo) -> str:
    return f"{cls.module.modname}:{cls.name}"


def _is_handler_class(cls: ClassInfo, graph: ProjectGraph,
                      hops: int = 0) -> bool:
    if hops > 4:
        return False
    for base in cls.bases:
        if base.rsplit(".", 1)[-1] in _HANDLER_BASES:
            return True
        resolved = graph.resolve_class(cls.module, base)
        if resolved is not None and resolved is not cls \
                and _is_handler_class(resolved, graph, hops + 1):
            return True
    return False


def _sync_attrs(cls: ClassInfo) -> Set[str]:
    """Attributes of ``cls`` whose value type is synchronization/handoff
    machinery (from ctor-call assignments and annotations)."""
    out: Set[str] = set()
    for attr, ref in cls.attr_types.items():
        if ref.rsplit(".", 1)[-1] in _SYNC_TYPES:
            out.add(attr)
    for node in ast.walk(cls.node):
        target = value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
            # Optional[threading.Thread] and friends: any sync type
            # named anywhere in the annotation marks the attribute
            for sub in ast.walk(node.annotation):
                name = None
                if isinstance(sub, ast.Name):
                    name = sub.id
                elif isinstance(sub, ast.Attribute):
                    name = sub.attr
                elif isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    name = sub.value.rsplit(".", 1)[-1].rsplit("]", 1)[0]
                if name in _SYNC_TYPES and _self_attr(target):
                    out.add(target.attr)
        if target is not None and _self_attr(target) \
                and isinstance(value, ast.Call):
            name = dotted_name(value.func) or ""
            if name.rsplit(".", 1)[-1] in _SYNC_TYPES:
                out.add(target.attr)
    return out


def _self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("self", "cls"))


def _is_property(fn_node: ast.AST) -> bool:
    for dec in getattr(fn_node, "decorator_list", ()):
        name = dotted_name(dec) or ""
        if name.rsplit(".", 1)[-1] in ("property", "cached_property"):
            return True
    return False


def _local_types(graph: ProjectGraph,
                 fn: FunctionInfo) -> Dict[str, ClassInfo]:
    """name -> project ClassInfo for typed locals visible inside ``fn``:
    annotated parameters, ``v = Cls(...)`` constructions, ``v = self.attr``
    through inferred attribute types / property return annotations, and
    ``v = obj.meth(...)`` through the callee's return annotation."""
    mod = fn.module
    out: Dict[str, ClassInfo] = {}
    for pname, ref in fn.param_types.items():
        cls = graph.resolve_class(mod, ref)
        if cls is not None:
            out[pname] = cls
    for node in walk_in_scope(fn.node):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        value = node.value
        cls: Optional[ClassInfo] = None
        if isinstance(value, ast.Call):
            ref = dotted_name(value.func)
            cls = graph.resolve_class(mod, ref)
            if cls is None:
                for callee in graph.resolve_call(fn, value.func):
                    ret = _annotation_ref(getattr(callee.node, "returns",
                                                  None))
                    cls = graph.resolve_class(callee.module, ret)
                    if cls is not None:
                        break
        elif _self_attr(value) and fn.cls is not None:
            ref = fn.cls.attr_types.get(value.attr)
            if ref is not None:
                cls = graph.resolve_class(mod, ref)
            else:
                prop = fn.cls.methods.get(value.attr)
                if prop is not None and _is_property(prop.node):
                    ret = _annotation_ref(getattr(prop.node, "returns",
                                                  None))
                    cls = graph.resolve_class(mod, ret)
        if cls is not None:
            out.setdefault(name, cls)
    return out


# -- per-function scan --------------------------------------------------------

def _scan_function(graph: ProjectGraph, fn: FunctionInfo,
                   decls: Dict[str, LockDecl]) -> _FnScan:
    locals_ = _local_types(graph, fn)
    accesses: List[_Access] = []
    calls: List[Tuple[str, FrozenSet[str]]] = []
    spawn_targets: List[str] = []
    constructs: List[str] = []
    state = {"boundary": None, "join": None}
    thread_locals: Set[str] = set()
    fresh_locals: Set[str] = set()
    relpath = fn.module.relpath

    def base_cls(node: ast.AST) -> Optional[Tuple[ClassInfo, bool]]:
        """(owning class, via-self) for an attribute base expression."""
        if isinstance(node, ast.Name):
            if node.id in ("self", "cls"):
                return (fn.cls, True) if fn.cls is not None else None
            if node.id in fresh_locals:
                # constructed in this very function: nobody else can see
                # it yet (init-before-publish, the URI.copy shape)
                return None
            cls = locals_.get(node.id)
            return (cls, False) if cls is not None else None
        return None

    def record(attr_node: ast.Attribute, is_write: bool,
               held: FrozenSet[str]) -> None:
        owner = base_cls(attr_node.value)
        if owner is None:
            return
        cls, via_self = owner
        accesses.append(_Access(_cls_key(cls), attr_node.attr, fn.fq,
                                relpath, attr_node.lineno,
                                held, is_write, via_self))

    def record_write_target(target: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(target, ast.Attribute):
            record(target, True, held)
        elif isinstance(target, ast.Subscript) \
                and isinstance(target.value, ast.Attribute):
            # self.X[k] = v mutates the container self.X holds
            record(target.value, True, held)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                record_write_target(elt, held)
        elif isinstance(target, ast.Starred):
            record_write_target(target.value, held)

    def threadish_receiver(recv: ast.AST) -> bool:
        if isinstance(recv, ast.Name):
            return recv.id in thread_locals
        if _self_attr(recv) and fn.cls is not None:
            return recv.attr in _sync_attrs_cached(fn.cls)
        if isinstance(recv, ast.Call):
            name = dotted_name(recv.func) or ""
            return name.rsplit(".", 1)[-1] == "Thread"
        return False

    def on_call(call: ast.Call, held: FrozenSet[str]) -> None:
        name = dotted_name(call.func) or ""
        short = name.rsplit(".", 1)[-1]
        if name:
            made = graph.resolve_class(fn.module, name)
            if made is not None:
                constructs.append(_cls_key(made))
        if short == "Thread" and name in ("Thread", "threading.Thread"):
            target = keyword_arg(call, "target")
            for root in graph.resolve_call(fn, target):
                spawn_targets.append(root.fq)
        if isinstance(call.func, ast.Attribute):
            meth = call.func.attr
            if meth == "submit" and call.args:
                for root in graph.resolve_call(fn, call.args[0]):
                    spawn_targets.append(root.fq)
            elif meth == "start" and not call.args \
                    and threadish_receiver(call.func.value):
                if state["boundary"] is None \
                        or call.lineno < state["boundary"]:
                    state["boundary"] = call.lineno
            elif meth == "join" and len(call.args) <= 1 \
                    and not isinstance(call.func.value, ast.Constant):
                recv = dotted_name(call.func.value) or ""
                if recv.split(".")[0] not in _JOIN_NON_THREAD_ROOTS:
                    if state["join"] is None \
                            or call.lineno < state["join"]:
                        state["join"] = call.lineno
            elif meth in _MUTATORS \
                    and isinstance(call.func.value, ast.Attribute):
                record(call.func.value, True, held)
        for callee in graph.resolve_call(fn, call.func):
            calls.append((callee.fq, held))

    def visit(node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return  # nested scope: runs at its own call time
        if isinstance(node, (ast.With, ast.AsyncWith)):
            newly: List[str] = []
            for item in node.items:
                entered = held.union(newly)
                visit(item.context_expr, entered)
                lock = _lock_of_expr(item.context_expr, fn, decls)
                if lock is not None:
                    newly.append(lock)
            inner = held.union(newly)
            for stmt in node.body:
                visit(stmt, inner)
            return
        if isinstance(node, ast.Assign):
            for target in node.targets:
                record_write_target(target, held)
            if len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                vname = dotted_name(node.value.func) or ""
                if vname.rsplit(".", 1)[-1] == "Thread":
                    thread_locals.add(node.targets[0].id)
                if graph.resolve_class(fn.module, vname) is not None:
                    fresh_locals.add(node.targets[0].id)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            record_write_target(node.target, held)
        elif isinstance(node, ast.Call):
            on_call(node, held)
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load):
            record(node, False, held)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in ast.iter_child_nodes(fn.node):
        visit(stmt, frozenset())
    return _FnScan(fn, accesses, calls, spawn_targets, constructs,
                   state["boundary"], state["join"])


_SYNC_CACHE: Dict[int, Set[str]] = {}


def _sync_attrs_cached(cls: ClassInfo) -> Set[str]:
    key = id(cls)
    if key not in _SYNC_CACHE:
        _SYNC_CACHE[key] = _sync_attrs(cls)
    return _SYNC_CACHE[key]


# -- reachability -------------------------------------------------------------

def _discover_roots(graph: ProjectGraph,
                    scans: Dict[str, _FnScan]
                    ) -> Tuple[Set[str], Set[str]]:
    """(root fqs, handler class keys)."""
    roots: Set[str] = set()
    handler_classes: Set[str] = set()
    for scan in scans.values():
        roots.update(scan.spawn_targets)
    for mod in graph.modules.values():
        for cls in mod.classes.values():
            if not _is_handler_class(cls, graph):
                continue
            handler_classes.add(_cls_key(cls))
            for name, meth in cls.methods.items():
                if name.startswith(_HANDLER_METHOD_PREFIXES):
                    roots.add(meth.fq)
    return roots, handler_classes


def _propagate(seeds: Dict[str, FrozenSet[str]],
               scans: Dict[str, _FnScan]) -> Dict[str, FrozenSet[str]]:
    """Monotone label propagation over call edges, to fixpoint (the
    deadlock pass's iterate-until-stable discipline: memoized DFS is
    order-dependent under mutual recursion)."""
    labels: Dict[str, FrozenSet[str]] = dict(seeds)
    changed = True
    while changed:
        changed = False
        for fq, scan in scans.items():
            mine = labels.get(fq)
            if not mine:
                continue
            for callee_fq, _ in scan.calls:
                if callee_fq not in scans:
                    continue
                cur = labels.get(callee_fq, frozenset())
                new = cur | mine
                if new != cur:
                    labels[callee_fq] = new
                    changed = True
    return labels


def _is_public_entry(fn: FunctionInfo, handler_classes: Set[str]) -> bool:
    """Callable from user ("main-thread") code: public names and public
    dunders — excluding per-request handler methods, which only ever run
    on server threads."""
    if fn.cls is not None and _cls_key(fn.cls) in handler_classes:
        return False
    name = fn.name
    if name in _PUBLIC_DUNDERS:
        return True
    if name in _CONSTRUCTORS:
        return True
    return not name.startswith("_")


def _entry_held(scans: Dict[str, _FnScan],
                seeds: Set[str]) -> Dict[str, FrozenSet[str]]:
    """Locks guaranteed held at each function's entry: the intersection
    over all known call sites of (caller entry ∪ lexical held at the
    site); public entries and thread roots start at the empty set.
    Iterated to fixpoint (values only shrink once set)."""
    entry: Dict[str, Optional[FrozenSet[str]]] = {fq: None for fq in scans}
    for fq in seeds:
        if fq in entry:
            entry[fq] = frozenset()
    changed = True
    while changed:
        changed = False
        for fq, scan in scans.items():
            base = entry[fq]
            if base is None:
                continue  # context unknown (unreached so far)
            for callee_fq, held in scan.calls:
                if callee_fq not in entry:
                    continue
                eff = held | base
                cur = entry[callee_fq]
                new = eff if cur is None else (cur & eff)
                if new != cur:
                    entry[callee_fq] = new
                    changed = True
    return {fq: (held or frozenset()) for fq, held in entry.items()}


# -- the pass -----------------------------------------------------------------

def _short_lock(lock_id: str) -> str:
    return ".".join(lock_id.rsplit(".", 2)[-2:])


def run_project(graph: ProjectGraph) -> List[Finding]:
    _SYNC_CACHE.clear()
    decls = _collect_locks(graph)
    scans: Dict[str, _FnScan] = {}
    fns: Dict[str, FunctionInfo] = {}
    for fn in graph.functions():
        fns[fn.fq] = fn
        scans[fn.fq] = _scan_function(graph, fn, decls)
    roots, handler_classes = _discover_roots(graph, scans)
    if not roots:
        return []

    thread_side = _propagate({fq: frozenset([fq]) for fq in roots
                              if fq in scans}, scans)
    main_seeds = {fq for fq, fn in fns.items()
                  if _is_public_entry(fn, handler_classes)
                  and fq not in roots}
    main_side = _propagate({fq: frozenset(["<main>"]) for fq in main_seeds},
                           scans)
    entry = _entry_held(scans, roots | main_seeds)

    classes: Dict[str, ClassInfo] = {}
    for mod in graph.modules.values():
        for cls in mod.classes.values():
            classes[_cls_key(cls)] = cls

    # thread-confined classes: every known construction site runs only
    # on worker threads (the tracker's WorkerEntry) — instances never
    # escape to the main side, so their attributes are not shared data.
    # No known site -> NOT confined (conservative).
    ctor_sites: Dict[str, List[str]] = {}
    for fq, scan in scans.items():
        for cls_key in scan.constructs:
            ctor_sites.setdefault(cls_key, []).append(fq)
    confined = {cls_key for cls_key, sites in ctor_sites.items()
                if sites and all(thread_side.get(site)
                                 and not main_side.get(site)
                                 for site in sites)}

    # group accesses per (class, attr), applying site-level exemptions
    grouped: Dict[Tuple[str, str], List[_Access]] = {}
    for fq in sorted(scans):
        scan = scans[fq]
        fn = scan.fn
        is_ctor = fn.name in _CONSTRUCTORS
        for acc in scan.accesses:
            cls = classes.get(acc.cls_key)
            if cls is None or acc.cls_key in handler_classes \
                    or acc.cls_key in confined:
                continue
            if acc.attr in _sync_attrs_cached(cls):
                continue  # queue/Future/Event/Thread handoff machinery
            if is_ctor:
                # init-before-start publication: a constructor wires up
                # the instance AND the collaborators handed to it (the
                # ModelSlot ctor stamping runtime.version) before any
                # thread can observe either
                continue
            if acc.is_write and scan.start_boundary is not None \
                    and acc.lineno < scan.start_boundary:
                continue  # published before the thread starts
            if not acc.is_write and scan.join_line is not None \
                    and acc.lineno > scan.join_line:
                continue  # join-mediated handoff: the thread is dead
            grouped.setdefault((acc.cls_key, acc.attr), []).append(acc)

    findings: List[Finding] = []
    for (cls_key, attr) in sorted(grouped):
        accs = grouped[(cls_key, attr)]
        writes = [a for a in accs if a.is_write]
        if not writes:
            continue  # read-only-after-publish

        def eff(a: _Access) -> FrozenSet[str]:
            return a.held | entry.get(a.fn_fq, frozenset())

        # sharing: two distinct thread contexts must touch the attribute
        root_union: Set[str] = set()
        threaded_any = main_any = both_sided = False
        for a in accs:
            tr = thread_side.get(a.fn_fq, frozenset())
            mn = bool(main_side.get(a.fn_fq))
            root_union |= tr
            threaded_any = threaded_any or bool(tr)
            main_any = main_any or mn
            both_sided = both_sided or (bool(tr) and mn)
        shared = threaded_any and (main_any or len(root_union) >= 2
                                   or both_sided)
        if not shared:
            continue

        locksets = [eff(a) for a in writes]
        common = frozenset.intersection(*locksets)
        if common:
            continue  # a consistent lockset protects every write
        cls_name = cls_key.split(":", 1)[1]
        symbol = f"{cls_name}.{attr}"
        writes.sort(key=lambda a: (not thread_side.get(a.fn_fq),
                                   a.relpath, a.lineno))
        anchor = next((a for a in writes if not eff(a)), writes[0])
        anchor_fn = fns[anchor.fn_fq]
        roots_here = sorted(thread_side.get(anchor.fn_fq, frozenset()))
        where = (f"thread root {roots_here[0].split(':', 1)[1]}"
                 if roots_here else "the calling thread")
        others = sorted({f"{a.relpath}:{a.lineno}" for a in accs
                         if (a.relpath, a.lineno)
                         != (anchor.relpath, anchor.lineno)})
        context = f"; also accessed at {', '.join(others[:3])}" \
            if others else ""
        if any(locksets):
            held_desc = ", ".join(
                sorted({_short_lock(lk) for ls in locksets for lk in ls})
                ) or "nothing"
            findings.append(Finding(
                "race-inconsistent-lockset", anchor.relpath, anchor.lineno,
                symbol,
                f"{symbol} is written under inconsistent locksets (no "
                f"common lock; sites variously hold {held_desc}): this "
                f"write in {anchor_fn.qualname} runs on {where} holding "
                f"{{{', '.join(sorted(_short_lock(lk) for lk in eff(anchor))) or ''}}}"
                f"{context} — every write must hold one common lock"))
        else:
            findings.append(Finding(
                "race-unlocked-shared-write", anchor.relpath, anchor.lineno,
                symbol,
                f"{symbol} is shared across threads but written with no "
                f"lock held: this write in {anchor_fn.qualname} runs on "
                f"{where}{context} — guard every access with one lock, or "
                f"publish before start / hand off via a queue"))
    return findings
