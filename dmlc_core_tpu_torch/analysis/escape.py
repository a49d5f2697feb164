"""Pass 8 — escape: interprocedural resource-escape on exception paths.

The per-file resources pass asks "does a release exist *somewhere* in this
function"; it is path-blind and module-local by design.  This pass asks
the question that has actually cost review rounds (the shm-lease,
warmup-executor and dump-lock fixes were all hand-found): does
**every** path from an acquisition to the function exit — including the
exception edge out of every statement between the acquire and the
``finally``/``with``/handler that releases — either release the resource
or transfer its ownership?

Built on the :mod:`.dataflow` CFG engine and the :mod:`.graph` call graph:

``escape-leak-on-raise``
    A path exists on which the last reference to an acquired resource
    (the shared acquisition table in ``resources.ACQUISITIONS``:
    SharedMemory segments, sockets, executors, mmaps, fds, temp dirs) is
    dropped: released/transferred on some paths but live on an exception
    edge (release only in ``except ValueError`` leaks every other type;
    cleanup in a nested ``def`` that may never run counts for nothing),
    live at the exceptional exit of ``__init__`` after a ``self.X =``
    acquisition (the caller never sees the instance, so its ``close`` is
    unreachable), or — for the ownership-structured kinds (shm/executor/
    mmap) and helper-returned resources the per-file pass cannot see —
    live on every path.  A ``self.X`` acquisition also creates a **class
    obligation**: some method of the class must visibly release the attr.

``escape-double-release``
    The inverse: a non-idempotent release (``unlink``/``rmtree``/
    ``os.close``/``rmdir``) reached on a path where the same release
    already happened (the close-in-except-and-finally shape).

Ownership model (how a resource stops being this function's problem):

- ``return x`` (incl. a tuple element) — the caller owns it, and callers
  of this function are analyzed as acquirers (**interprocedural
  acquire-through-return**);
- ``self.X = x`` — the instance owns it (checked per the class
  obligation above); assigning to a subscript/attribute/global or
  appending to a container parks it beyond tracking;
- passing ``x`` to a call: an **unresolved** callee is assumed to take
  ownership (the ``Reader(open(...))`` wrapping idiom); a
  **project-resolved** callee is consulted — if its parameter summary
  releases or stores the argument the resource is released/transferred,
  otherwise the caller still owns it (that is the "leak through helper"
  case the per-file pass calls a hand-off).

Soundness caveats (CATALOG.md): no aliasing through containers or
attribute round-trips (simple ``y = x`` aliases are honored,
flow-insensitively); the raise model is syntactic (logging-family calls
are non-raising by contract); ``except Exception`` counts as a catch-all
(async exceptions between acquire and handler are out of scope); static
call resolution limits are inherited from the graph core.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from dmlc_core_tpu_torch.analysis import dataflow
from dmlc_core_tpu_torch.analysis.driver import Finding, dotted_name
from dmlc_core_tpu_torch.analysis.graph import (FunctionInfo, ProjectGraph,
                                                walk_in_scope)
from dmlc_core_tpu_torch.analysis.resources import (RELEASE_FUNCS,
                                                    RELEASE_METHODS,
                                                    acquisition_kind)

__all__ = ["run_project", "NON_IDEMPOTENT_RELEASES"]

# releases that blow up (or corrupt another handle) when repeated
NON_IDEMPOTENT_RELEASES = {"unlink", "rmtree", "rmdir", "os.close"}

# may-states of one acquisition; released states carry the method
# ("released:close") so close-then-unlink — the correct full shm release —
# is distinguishable from the same non-idempotent method repeating
_LIVE = "live"
_REL = "released"        # prefix; full form "released:<how>"
_XFER = "transferred"    # ownership moved (returned/stored/handed off)


def _released(how: str) -> str:
    return f"{_REL}:{how}"


def _is_done(status: str) -> bool:
    return status == _XFER or status.startswith(_REL)

_State = FrozenSet[Tuple[str, str]]  # {(acq_id, status), ...}


def _release_methods_for(kind: str) -> Set[str]:
    out = set(RELEASE_METHODS[None])
    out |= RELEASE_METHODS.get(kind, set())
    return out


# -- per-function acquisition discovery ---------------------------------------

@dataclasses.dataclass
class _Acq:
    acq_id: str            # unique per function: "name@lineno"
    name: str              # local variable name ("x") or "self.X"
    kind: str
    lineno: int
    stmt: ast.AST          # the acquiring statement
    self_attr: Optional[str]  # attr name when bound to self.X
    via_helper: bool       # acquired through a project helper's return


def _call_acquires(graph: ProjectGraph, fn: FunctionInfo, call: ast.Call,
                   summaries: "_Summaries") -> Optional[Tuple[str, Optional[int], bool]]:
    """(kind, tuple_index_of_resource, via_helper) when ``call`` acquires."""
    name = dotted_name(call.func) or ""
    kind = acquisition_kind(name)
    if kind is not None:
        return kind, None, False
    for callee in graph.resolve_call(fn, call.func):
        ret = summaries.returns_resource.get(callee.fq)
        if ret is not None:
            return ret[0], ret[1], True
    return None


def _binding_of(stmt: ast.AST, call: ast.Call,
                idx: Optional[int]) -> Optional[Tuple[str, Optional[str]]]:
    """(local name or 'self.X', self attr) the acquisition binds to, given
    the acquiring statement shapes this pass tracks."""
    if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
        return None
    target = stmt.targets[0]
    value = stmt.value
    # unwrap `x = ACQ() if cond else None` / `x = y or ACQ()`
    if isinstance(value, ast.IfExp):
        value = (value.body if _contains(value.body, call)
                 else value.orelse)
    if isinstance(value, ast.BoolOp):
        for operand in value.values:
            if _contains(operand, call):
                value = operand
                break
    if value is call and idx is None:
        return _target_name(target)
    # tuple unpack of a helper that returns the resource at a known index:
    # `sock, port = bind_free_port(...)`
    if (idx is not None and value is call
            and isinstance(target, ast.Tuple)
            and idx < len(target.elts)):
        return _target_name(target.elts[idx])
    return None


def _target_name(target: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
    if isinstance(target, ast.Name):
        return target.id, None
    if (isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"):
        return f"self.{target.attr}", target.attr
    return None


def _contains(root: ast.AST, needle: ast.AST) -> bool:
    return any(n is needle for n in ast.walk(root))


def _direct_owner(value: ast.AST, is_res_name) -> bool:
    """Does ``value`` own the resource directly — the bare name, a tuple/
    list of names, a wrapper call taking it as a direct argument, or a
    conditional of those?  ``self._mm = mmap.mmap(self._fd.fileno(), 0)``
    merely READS ``_fd`` and must not count as storing it."""
    if is_res_name(value):
        return True
    if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
        return any(_direct_owner(e, is_res_name) for e in value.elts)
    if isinstance(value, ast.Call):
        return any(is_res_name(a) for a in
                   list(value.args) + [kw.value for kw in value.keywords])
    if isinstance(value, ast.IfExp):
        return (_direct_owner(value.body, is_res_name)
                or _direct_owner(value.orelse, is_res_name))
    if isinstance(value, ast.BoolOp):
        return any(_direct_owner(v, is_res_name) for v in value.values)
    if isinstance(value, ast.Starred):
        return _direct_owner(value.value, is_res_name)
    return False


def _find_acquisitions(graph: ProjectGraph, fn: FunctionInfo,
                       summaries: "_Summaries") -> List[_Acq]:
    out: List[_Acq] = []
    stmts = _stmts_by_call(fn.node)
    for call, stmt in stmts:
        acq = _call_acquires(graph, fn, call, summaries)
        if acq is None:
            continue
        kind, idx, via_helper = acq
        # a `with ACQ() as x:` acquisition is safe by construction
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            continue
        # `return ACQ()` / `Reader(ACQ())` / bare-expression: ownership
        # transfers at birth (or is the per-file pass's business)
        binding = _binding_of(stmt, call, idx)
        if binding is None:
            continue
        name, self_attr = binding
        out.append(_Acq(f"{name}@{call.lineno}", name, kind, call.lineno,
                        stmt, self_attr, via_helper))
    return out


def _stmts_by_call(fn_node: ast.AST) -> List[Tuple[ast.Call, ast.AST]]:
    """(call, enclosing simple statement) for every in-scope call."""
    out: List[Tuple[ast.Call, ast.AST]] = []

    def visit(stmt: ast.AST) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(stmt, (ast.If, ast.While)):
            for sub in ast.walk(stmt.test):
                if isinstance(sub, ast.Call):
                    out.append((sub, stmt))
            for child in stmt.body + getattr(stmt, "orelse", []):
                visit(child)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            for sub in ast.walk(stmt.iter):
                if isinstance(sub, ast.Call):
                    out.append((sub, stmt))
            for child in stmt.body + stmt.orelse:
                visit(child)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Call):
                        out.append((sub, stmt))
            for child in stmt.body:
                visit(child)
            return
        if isinstance(stmt, ast.Try):
            for child in (stmt.body + stmt.orelse + stmt.finalbody):
                visit(child)
            for handler in stmt.handlers:
                for child in handler.body:
                    visit(child)
            return
        for sub in walk_in_scope(stmt):
            if isinstance(sub, ast.Call):
                out.append((sub, stmt))

    body = fn_node.body if isinstance(fn_node.body, list) else [fn_node.body]
    for stmt in body:
        visit(stmt)
    return out


# -- interprocedural summaries ------------------------------------------------

class _Summaries:
    """Fixpoint summaries over the project graph.

    - ``returns_resource[fq] = (kind, tuple_index or None)`` — the
      function's return value is (or contains, at a fixed tuple index) a
      fresh acquisition;
    - ``param_effects[fq][i]`` in {"releases", "owns"} — what the callee
      does with its i-th positional parameter (absent = reads only);
    - ``attr_releases[fq]`` — ``self.X`` attrs this method (transitively
      through same-class calls) visibly releases.
    """

    def __init__(self, graph: ProjectGraph):
        self.graph = graph
        self.returns_resource: Dict[str, Tuple[str, Optional[int]]] = {}
        self.param_effects: Dict[str, Dict[int, str]] = {}
        self.attr_releases: Dict[str, Set[str]] = {}
        fns = graph.functions()
        for fn in fns:
            self.param_effects[fn.fq] = self._scan_params(fn)
            self.attr_releases[fn.fq] = self._scan_attr_releases(fn)
        # returns_resource + transitive attr releases need a fixpoint
        # (helper chains: `def a(): return b()`; `close()` calling
        # `self._teardown()`)
        changed = True
        while changed:
            changed = False
            for fn in fns:
                ret = self._scan_returns(fn)
                if ret is not None and self.returns_resource.get(fn.fq) != ret:
                    self.returns_resource[fn.fq] = ret
                    changed = True
                if fn.cls is not None:
                    mine = self.attr_releases[fn.fq]
                    before = len(mine)
                    for node in walk_in_scope(fn.node):
                        if not isinstance(node, ast.Call):
                            continue
                        name = dotted_name(node.func) or ""
                        if name.startswith("self.") and name.count(".") == 1:
                            callee = fn.cls.methods.get(name.split(".")[1])
                            if callee is not None:
                                mine |= self.attr_releases.get(callee.fq,
                                                               set())
                    if len(mine) != before:
                        changed = True

    # -- param effects --------------------------------------------------------

    def _scan_params(self, fn: FunctionInfo) -> Dict[int, str]:
        args = fn.node.args
        names = [a.arg for a in (list(args.posonlyargs) + list(args.args))]
        if fn.cls is not None and names and names[0] in ("self", "cls"):
            names = names[1:]
        effects: Dict[int, str] = {}
        for i, pname in enumerate(names):
            eff = self._param_effect(fn, pname)
            if eff is not None:
                effects[i] = eff
        return effects

    def _param_effect(self, fn: FunctionInfo, pname: str) -> Optional[str]:
        owns = False
        any_release = set().union(*RELEASE_METHODS.values())
        # a CamelCase call that is the operand of `raise` is an exception
        # constructor formatting the param into a message, not a wrapper
        # taking ownership of it
        raised_calls = {id(n.exc) for n in walk_in_scope(fn.node)
                        if isinstance(n, ast.Raise) and n.exc is not None}
        for node in walk_in_scope(fn.node):
            if isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and isinstance(func.value, ast.Name)
                        and func.value.id == pname
                        and func.attr in any_release):
                    return "releases"
                called = dotted_name(func) or ""
                short = called.rsplit(".", 1)[-1]
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id == pname:
                        if short in RELEASE_FUNCS or called == "os.close":
                            return "releases"
                        # wrapper/ctor or re-owning container op
                        if (short[:1].isupper()
                                and id(node) not in raised_calls) \
                                or short in ("append", "add", "register"):
                            owns = True
            elif isinstance(node, ast.Return) and node.value is not None:
                if _direct_owner(node.value,
                                 lambda e: isinstance(e, ast.Name)
                                 and e.id == pname):
                    owns = True
            elif isinstance(node, ast.Assign):
                stores = any(isinstance(t, (ast.Attribute, ast.Subscript))
                             for t in node.targets)
                if stores and _direct_owner(
                        node.value, lambda e: isinstance(e, ast.Name)
                        and e.id == pname):
                    owns = True
            elif isinstance(node, ast.withitem):
                if (isinstance(node.context_expr, ast.Name)
                        and node.context_expr.id == pname):
                    return "releases"
        return "owns" if owns else None

    # -- attr releases --------------------------------------------------------

    def _scan_attr_releases(self, fn: FunctionInfo) -> Set[str]:
        if fn.cls is None:
            return set()
        out: Set[str] = set()
        any_release = set().union(*RELEASE_METHODS.values())
        for node in walk_in_scope(fn.node):
            if isinstance(node, ast.Call):
                func = node.func
                # self.X.close() / self.X.shutdown(...)
                if (isinstance(func, ast.Attribute)
                        and func.attr in any_release
                        and isinstance(func.value, ast.Attribute)
                        and isinstance(func.value.value, ast.Name)
                        and func.value.value.id == "self"):
                    out.add(func.value.attr)
                    continue
                called = dotted_name(func) or ""
                short = called.rsplit(".", 1)[-1]
                if short in RELEASE_FUNCS or called == "os.close":
                    for arg in node.args:
                        base = arg
                        # rmtree(self.X) / os.close(self.X)
                        if (isinstance(base, ast.Attribute)
                                and isinstance(base.value, ast.Name)
                                and base.value.id == "self"):
                            out.add(base.attr)
                # self.X handed to any call transfers the obligation
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    if (isinstance(arg, ast.Attribute)
                            and isinstance(arg.value, ast.Name)
                            and arg.value.id == "self"):
                        out.add(arg.attr)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        out.add(t.attr)
            elif isinstance(node, ast.withitem):
                ce = node.context_expr
                if (isinstance(ce, ast.Attribute)
                        and isinstance(ce.value, ast.Name)
                        and ce.value.id == "self"):
                    out.add(ce.attr)
        return out

    # -- returns --------------------------------------------------------------

    def _scan_returns(self, fn: FunctionInfo) -> Optional[Tuple[str,
                                                                Optional[int]]]:
        """Does ``fn`` return a fresh acquisition (directly, via a live
        local, or at a fixed tuple index)?"""
        local_kinds: Dict[str, str] = {}
        for node in walk_in_scope(fn.node):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                kind = self._expr_kind(fn, node.value)
                if kind:
                    local_kinds[node.targets[0].id] = kind
        for node in walk_in_scope(fn.node):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            value = node.value
            kind = self._expr_kind_or_local(fn, value, local_kinds)
            if kind:
                return kind, None
            if isinstance(value, ast.Tuple):
                for i, elt in enumerate(value.elts):
                    kind = self._expr_kind_or_local(fn, elt, local_kinds)
                    if kind:
                        return kind, i
        return None

    def _expr_kind(self, fn: FunctionInfo, expr: ast.AST) -> Optional[str]:
        if not isinstance(expr, ast.Call):
            return None
        kind = acquisition_kind(dotted_name(expr.func) or "")
        if kind:
            return kind
        for callee in self.graph.resolve_call(fn, expr.func):
            ret = self.returns_resource.get(callee.fq)
            if ret is not None and ret[1] is None:
                return ret[0]
        return None

    def _expr_kind_or_local(self, fn: FunctionInfo, expr: ast.AST,
                            local_kinds: Dict[str, str]) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return local_kinds.get(expr.id)
        return self._expr_kind(fn, expr)


# -- the per-function dataflow ------------------------------------------------

class _FnChecker:
    def __init__(self, graph: ProjectGraph, summaries: _Summaries,
                 fn: FunctionInfo, acqs: List[_Acq]):
        self.graph = graph
        self.summaries = summaries
        self.fn = fn
        self.acqs = {a.acq_id: a for a in acqs}
        self.is_init = fn.name == "__init__"
        # flow-insensitive alias sets: y = x makes y an alias of x's
        # resource (release via either name counts)
        self.aliases: Dict[str, Set[str]] = {a.acq_id: {a.name}
                                             for a in acqs}
        self._collect_aliases(acqs)
        self.findings: List[Finding] = []
        self._double_reported: Set[Tuple[str, int]] = set()
        # global names declared in this function body
        self.globals: Set[str] = set()
        for node in walk_in_scope(fn.node):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                self.globals.update(node.names)

    def _collect_aliases(self, acqs: List[_Acq]) -> None:
        for node in walk_in_scope(self.fn.node):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Name)):
                for a in acqs:
                    if node.value.id in self.aliases[a.acq_id]:
                        self.aliases[a.acq_id].add(node.targets[0].id)

    # -- state helpers --------------------------------------------------------

    @staticmethod
    def _set(state: _State, acq_id: str, status: str) -> _State:
        return frozenset({(i, s) for i, s in state if i != acq_id}
                         | {(acq_id, status)})

    @staticmethod
    def _statuses(state: _State, acq_id: str) -> Set[str]:
        return {s for i, s in state if i == acq_id}

    # -- the transfer function ------------------------------------------------

    @staticmethod
    def _effect_nodes(stmt: ast.AST) -> Iterable[ast.AST]:
        """The AST region whose effects belong to this CFG node: compound
        statements contribute only their header expression (their bodies
        are separate CFG nodes)."""
        if isinstance(stmt, (ast.If, ast.While)):
            return ast.walk(stmt.test)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return ast.walk(stmt.iter)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            def gen():
                for item in stmt.items:
                    yield from ast.walk(item.context_expr)
            return gen()
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return ()  # a def/class statement only binds a name

        def simple():
            yield stmt
            yield from walk_in_scope(stmt)
        return simple()

    def transfer(self, node: dataflow.Node,
                 state: _State) -> Tuple[_State, _State]:
        stmt = node.stmt
        if stmt is None:
            return state, state
        if isinstance(stmt, tuple) and stmt[0] == dataflow.WITH_EXIT:
            out = state
            for item in stmt[1].items:
                out = self._apply_with_release(out, item.context_expr)
            return out, out
        pre = state
        out = state
        acquired_here: Set[str] = set()
        for a in self.acqs.values():
            if a.stmt is stmt:
                out = self._set(out, a.acq_id, _LIVE)
                acquired_here.add(a.acq_id)
        out = self._apply_effects(stmt, out)
        # exception edge: acquisitions have NOT happened (a failing
        # open() binds nothing) but releases count as done (a failing
        # close() is still a release attempt) — so the exc-state drops
        # this statement's acquisitions and keeps its releases
        exc = out
        for acq_id in acquired_here:
            prev = self._statuses(pre, acq_id)
            exc = frozenset({(i, s) for i, s in exc if i != acq_id}
                            | {(acq_id, s) for s in prev})
        return out, exc

    def _apply_with_release(self, state: _State, expr: ast.AST) -> _State:
        name = dotted_name(expr)
        if name is None and isinstance(expr, ast.Call):
            # contextlib.closing(x) / suppress(...)-style wrappers
            for arg in expr.args:
                state = self._apply_with_release(state, arg)
            return state
        if name is None:
            return state
        for acq_id, names in self.aliases.items():
            if name in names:
                state = self._set(state, acq_id, _released("exit"))
        return state

    def _apply_effects(self, stmt: ast.AST, state: _State) -> _State:
        for acq_id, acq in self.acqs.items():
            statuses = self._statuses(state, acq_id)
            if not statuses:
                continue  # not acquired on this path (or untracked)
            effect = self._stmt_effect(stmt, acq, self.aliases[acq_id])
            if effect is None:
                continue
            kind, method = effect
            if kind == "release":
                if (method in NON_IDEMPOTENT_RELEASES
                        and _released(method) in statuses
                        and (acq_id, stmt.lineno) not in
                        self._double_reported):
                    self._double_reported.add((acq_id, stmt.lineno))
                    self.findings.append(Finding(
                        "escape-double-release", self.fn.module.relpath,
                        stmt.lineno, self.fn.qualname,
                        f"{acq.name!r} ({acq.kind}, acquired at line "
                        f"{acq.lineno}) may already be released via "
                        f"{method} when this {method}() runs — a repeated "
                        f"{method} raises (or tears down a reused handle); "
                        "gate it or restructure the cleanup"))
                state = self._set(state, acq_id, _released(method))
            elif kind == "transfer":
                state = self._set(state, acq_id, _XFER)
            elif kind == "drop":
                state = frozenset((i, s) for i, s in state if i != acq_id)
        return state

    def _stmt_effect(self, stmt: ast.AST, acq: _Acq,
                     names: Set[str]) -> Optional[Tuple[str, str]]:
        """("release"|"transfer"|"drop", how) for one CFG node's effect
        on one resource, or None."""

        def is_res_name(expr: ast.AST) -> bool:
            if isinstance(expr, ast.Name) and expr.id in names:
                return True
            return (acq.self_attr is not None
                    and isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"
                    and expr.attr == acq.self_attr)

        release_methods = _release_methods_for(acq.kind)
        result: Optional[Tuple[str, str]] = None
        for node in self._effect_nodes(stmt):
            if isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and func.attr in release_methods
                        and is_res_name(func.value)):
                    return "release", func.attr
                called = dotted_name(func) or ""
                short = called.rsplit(".", 1)[-1]
                # self.m() where m transitively releases the tracked attr
                if (acq.self_attr is not None and self.fn.cls is not None
                        and called.startswith("self.")
                        and called.count(".") == 1):
                    meth = self.fn.cls.methods.get(short)
                    if meth is not None and acq.self_attr in \
                            self.summaries.attr_releases.get(meth.fq, set()):
                        return "release", short
                for pos, arg in enumerate(
                        list(node.args)
                        + [kw.value for kw in node.keywords]):
                    if not is_res_name(arg):
                        continue
                    if short in RELEASE_FUNCS or called == "os.close":
                        return ("release", short if short in RELEASE_FUNCS
                                else "os.close")
                    if self._call_takes_ownership(node, pos):
                        result = result or ("transfer", "arg")
                    # else: a resolved project callee that only READS the
                    # parameter — the caller still owns the resource
            elif isinstance(node, ast.Return) and node.value is not None:
                if _direct_owner(node.value, is_res_name):
                    return "transfer", "return"
            elif isinstance(node, ast.Assign) and node is not acq.stmt:
                # stored beyond this frame: attr/subscript target, or a
                # module-global rebound under a `global` declaration
                stores = any(
                    isinstance(t, (ast.Attribute, ast.Subscript))
                    or (isinstance(t, ast.Name) and t.id in self.globals)
                    or (isinstance(t, ast.Tuple)
                        and any(isinstance(e, (ast.Attribute, ast.Subscript))
                                or (isinstance(e, ast.Name)
                                    and e.id in self.globals)
                                for e in t.elts))
                    for t in node.targets)
                if stores and _direct_owner(node.value, is_res_name):
                    return "transfer", "store"
                # rebinding the tracked name drops tracking
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == acq.name:
                        return "drop", "rebind"
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id in names:
                        return "drop", "del"
            elif isinstance(node, ast.Expr) and isinstance(node.value,
                                                           ast.Yield):
                if node.value.value is not None and \
                        any(is_res_name(n)
                            for n in ast.walk(node.value.value)):
                    return "transfer", "yield"
        return result

    def _call_takes_ownership(self, call: ast.Call, arg_pos: int) -> bool:
        """Does passing the resource as this call's ``arg_pos``-th
        argument transfer ownership?  Unresolved callees: yes (the
        ``Reader(open(...))`` wrapping idiom).  Project-resolved callees:
        only if their parameter summary releases or stores that
        parameter — a helper that merely reads leaves the caller owning
        the resource (the leak-through-helper case)."""
        callees = self.graph.resolve_call(self.fn, call.func)
        if not callees:
            return True
        if arg_pos >= len(call.args):
            return True  # keyword-passed: positional summary can't see it
        for callee in callees:
            if self.summaries.param_effects.get(callee.fq,
                                                {}).get(arg_pos):
                return True
        return False

    # -- verdicts -------------------------------------------------------------

    def check(self) -> List[Finding]:
        if not self.acqs:
            return self.findings
        cfg = dataflow.build_cfg(self.fn.node)
        init: _State = frozenset()
        states = dataflow.run_forward(cfg, init, self.transfer,
                                      lambda a, b: a | b)
        normal = states.get(cfg.exit, frozenset())
        raised = states.get(cfg.raise_exit, frozenset())
        for acq_id, acq in self.acqs.items():
            self._verdict(acq, self._statuses(normal, acq_id),
                          self._statuses(raised, acq_id))
        return self.findings

    def _verdict(self, acq: _Acq, normal: Set[str],
                 raised: Set[str]) -> None:
        live_on_raise = _LIVE in raised
        live_on_normal = _LIVE in normal
        done_somewhere = any(_is_done(s) for s in (normal | raised))
        if acq.self_attr is not None:
            # instance ownership: the dataflow only checks the __init__
            # window (a failed constructor orphans the resource); outside
            # __init__ the instance owns it from birth
            if self.is_init and live_on_raise:
                self.findings.append(Finding(
                    "escape-leak-on-raise", self.fn.module.relpath,
                    acq.lineno, self.fn.qualname,
                    f"self.{acq.self_attr} ({acq.kind}) leaks when a later "
                    "statement in __init__ raises: the caller never "
                    "receives the instance, so no close() can reach it — "
                    "release it in a try/except around the rest of "
                    "__init__ (and re-raise)"))
            return
        if live_on_raise and done_somewhere:
            self.findings.append(Finding(
                "escape-leak-on-raise", self.fn.module.relpath,
                acq.lineno, self.fn.qualname,
                f"{acq.name!r} ({acq.kind}) is released on the normal "
                "path but stays live on an exception path out of this "
                "function — move the release into a finally/with (or a "
                "catch-all handler that re-raises)"))
            return
        if (live_on_normal or live_on_raise) and not done_somewhere:
            # live on EVERY path: the per-file resource pass owns the
            # direct file/socket/tempdir cases; report the kinds (and the
            # helper-returned acquisitions) it cannot see
            if acq.via_helper or acq.kind in ("shm", "executor", "mmap"):
                self.findings.append(Finding(
                    "escape-leak-on-raise", self.fn.module.relpath,
                    acq.lineno, self.fn.qualname,
                    f"{acq.name!r} ({acq.kind}"
                    + (", acquired through a helper's return"
                       if acq.via_helper else "")
                    + ") is never released or handed off on any path "
                    "through this function"))


# -- class-ownership obligations ----------------------------------------------

def _class_obligations(graph: ProjectGraph, summaries: _Summaries,
                       per_fn_acqs: Dict[str, List[_Acq]]) -> List[Finding]:
    findings: List[Finding] = []
    for fn in graph.functions():
        if fn.cls is None:
            continue
        for acq in per_fn_acqs.get(fn.fq, []):
            if acq.self_attr is None:
                continue
            released = set()
            for method in fn.cls.methods.values():
                released |= summaries.attr_releases.get(method.fq, set())
            if acq.self_attr not in released:
                findings.append(Finding(
                    "escape-leak-on-raise", fn.module.relpath, acq.lineno,
                    f"{fn.cls.name}.{acq.self_attr}",
                    f"self.{acq.self_attr} owns a {acq.kind} but no method "
                    f"of {fn.cls.name} ever releases it — add (or route "
                    "through) a close()/shutdown() so the owner has a "
                    "destroy path"))
    return findings


# -- the pass -----------------------------------------------------------------

def run_project(graph: ProjectGraph) -> List[Finding]:
    summaries = _Summaries(graph)
    findings: List[Finding] = []
    per_fn_acqs: Dict[str, List[_Acq]] = {}
    for fn in graph.functions():
        acqs = _find_acquisitions(graph, fn, summaries)
        if not acqs:
            continue
        per_fn_acqs[fn.fq] = acqs
        findings += _FnChecker(graph, summaries, fn, acqs).check()
    findings += _class_obligations(graph, summaries, per_fn_acqs)
    return findings
