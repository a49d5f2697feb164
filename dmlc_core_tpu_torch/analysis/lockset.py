"""Pass 1 — lockset: hand-rolled ``threading`` discipline.

Three rules over every class/function in a library module:

``lockset-unsync-write``
    For a class that owns a ``threading.Lock``/``RLock``/``Condition``/
    ``Semaphore`` attribute, every write to ``self.X`` is classified as
    under-lock (lexically inside ``with self._lock:``) or bare.  An
    attribute written both ways is a data race by the class's own
    convention: the lock announces that concurrent access is expected, so a
    bare write elsewhere bypasses it.  ``__init__``/``__new__`` writes are
    construction (no concurrency yet) and don't count as bare.

``lockset-thread-leak``
    A ``threading.Thread`` target whose body cannot ferry exceptions back to
    a consumer: no ``try`` anywhere in a locally-defined target, a lambda
    target (can't contain ``try``), or a library callable
    (``subprocess.check_call``) used directly as target.  Exceptions raised
    there die in ``Thread.run`` — the spawner's ``join()`` returns success.

``lockset-no-join``
    A non-daemon thread whose owning scope (the class, when stored on
    ``self``; the enclosing function otherwise) never calls ``.join()``:
    interpreter shutdown blocks on it and no destroy path exists.

Lexical lock tracking is deliberately unsound in both directions (a method
may be single-threaded by protocol; a lock can be taken by a caller) — the
baseline/suppression machinery exists precisely to record those verdicts.

This pass stays per-file by design; the *cross*-module half of threading
discipline (lock-order cycles, blocking calls made while holding a lock
through the call graph) lives in :mod:`.deadlock`, which reuses this
module's :data:`LOCK_TYPES` as the single definition of what constructs a
lock.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from dmlc_core_tpu_torch.analysis.driver import (FileContext, Finding,
                                                 dotted_name, keyword_arg)

__all__ = ["run", "LOCK_TYPES"]

LOCK_TYPES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

_CONSTRUCTORS = {"__init__", "__new__"}


def run(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            findings += _check_class_lockset(ctx, node)
    findings += _check_threads(ctx)
    return findings


# -- lockset-unsync-write -----------------------------------------------------

def _is_lock_factory(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = dotted_name(value.func) or ""
    short = name.rsplit(".", 1)[-1]
    return short in LOCK_TYPES and (name == short
                                    or name == f"threading.{short}")


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attribute names holding locks: ``self.X = threading.Lock()`` in any
    method, or ``X = threading.Lock()`` at class level."""
    attrs: Set[str] = set()
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign) and _is_lock_factory(node.value)):
            continue
        for target in node.targets:
            if (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id in ("self", "cls")):
                attrs.add(target.attr)
            elif isinstance(target, ast.Name):
                attrs.add(target.id)
    return attrs


class _WriteCollector(ast.NodeVisitor):
    """Classify self-attribute writes in one method as locked or bare."""

    def __init__(self, lock_attrs: Set[str]):
        self.lock_attrs = lock_attrs
        self.depth = 0
        # attr -> [(lineno, under_lock)]
        self.writes: List[Tuple[str, int, bool]] = []

    def _is_lock_expr(self, expr: ast.AST) -> bool:
        name = dotted_name(expr)
        if not name or "." not in name:
            return False
        return name.rsplit(".", 1)[-1] in self.lock_attrs

    def visit_With(self, node: ast.With) -> None:
        locked = any(self._is_lock_expr(item.context_expr)
                     for item in node.items)
        self.depth += locked
        self.generic_visit(node)
        self.depth -= locked

    def _record(self, target: ast.AST) -> None:
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
                and target.attr not in self.lock_attrs):
            self.writes.append((target.attr, target.lineno, self.depth > 0))

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._record(target)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(node.target)
        self.generic_visit(node)


def _check_class_lockset(ctx: FileContext, cls: ast.ClassDef) -> List[Finding]:
    lock_attrs = _lock_attrs(cls)
    if not lock_attrs:
        return []
    locked_at: Dict[str, int] = {}
    bare_at: Dict[str, int] = {}
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        collector = _WriteCollector(lock_attrs)
        collector.visit(method)
        in_ctor = method.name in _CONSTRUCTORS
        for attr, lineno, under_lock in collector.writes:
            if under_lock:
                locked_at.setdefault(attr, lineno)
            elif not in_ctor:
                bare_at.setdefault(attr, lineno)
    findings = []
    for attr in sorted(set(locked_at) & set(bare_at)):
        findings.append(Finding(
            "lockset-unsync-write", ctx.relpath, bare_at[attr],
            f"{cls.name}.{attr}",
            f"self.{attr} is written under {cls.name}'s lock (line "
            f"{locked_at[attr]}) and without it (line {bare_at[attr]})"))
    return findings


# -- lockset-thread-leak / lockset-no-join ------------------------------------

def _resolve_target(ctx: FileContext, target: ast.AST,
                    defs: Dict[str, List[ast.AST]]) -> Optional[ast.AST]:
    """The local def a Thread target refers to, the Lambda node itself, or
    None for callables we can't see into (imported / bound elsewhere)."""
    if isinstance(target, ast.Lambda):
        return target
    name = dotted_name(target)
    if name is None:
        return None
    short = name.rsplit(".", 1)[-1]
    candidates = defs.get(short, [])
    if isinstance(target, ast.Name) or name.startswith(("self.", "cls.")):
        return candidates[0] if candidates else None
    return None


def _ferries(target_def: ast.AST) -> bool:
    """A target ferries exceptions iff it contains a try that isn't a bare
    swallow (``except: pass`` without re-raising or recording)."""
    for node in ast.walk(target_def):
        if isinstance(node, ast.Try):
            for handler in node.handlers:
                body = handler.body
                if not all(isinstance(stmt, (ast.Pass, ast.Continue))
                           for stmt in body):
                    return True
    return False


def _check_threads(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    defs = ctx.defs_by_name
    for call in ast.walk(ctx.tree):
        if not isinstance(call, ast.Call):
            continue
        name = dotted_name(call.func)
        if name not in ("threading.Thread", "Thread"):
            continue
        symbol = ctx.qualname(call)
        target = keyword_arg(call, "target")
        if target is not None:
            target_def = _resolve_target(ctx, target, defs)
            target_name = dotted_name(target) or "<lambda>"
            if target_def is None and not isinstance(target, ast.Lambda):
                findings.append(ctx.finding(
                    "lockset-thread-leak", call,
                    f"thread target {target_name} is a non-local callable; "
                    "an exception it raises dies in Thread.run and join() "
                    "reports success — wrap it and ferry errors",
                    symbol=f"{symbol}.{target_name}"))
            elif target_def is not None and not _ferries(target_def):
                findings.append(ctx.finding(
                    "lockset-thread-leak", call,
                    f"thread target {target_name} has no exception "
                    "ferrying (no try/except, or only a bare swallow); "
                    "errors in the thread are lost",
                    symbol=f"{symbol}.{target_name}"))
        daemon = keyword_arg(call, "daemon")
        is_daemon = (isinstance(daemon, ast.Constant)
                     and daemon.value is True)
        if not is_daemon:
            scope = _join_scope(ctx, call)
            if scope is not None and not _has_join(scope):
                findings.append(ctx.finding(
                    "lockset-no-join", call,
                    "non-daemon thread is never join()ed in its owning "
                    "scope; give the owner a destroy/join path or make it "
                    "a ferried daemon",
                    symbol=symbol))
    return findings


def _join_scope(ctx: FileContext, call: ast.Call) -> Optional[ast.AST]:
    """Where a join() for this thread would have to live: the whole class
    when the Thread is stored on self, else the enclosing function."""
    parent = ctx.parents.get(call)
    stored_on_self = (isinstance(parent, ast.Assign) and any(
        isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
        and t.value.id == "self" for t in parent.targets))
    if stored_on_self:
        cls = ctx.enclosing(call, ast.ClassDef)
        if cls is not None:
            return cls
    return ctx.enclosing(call, ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda) or ctx.tree


# join() receivers that are never threads (string seps, path modules)
_NON_THREAD_JOIN = {"os.path", "posixpath", "ntpath", "str"}


def _has_join(scope: ast.AST) -> bool:
    for node in ast.walk(scope):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and not isinstance(node.func.value, ast.Constant)
                and dotted_name(node.func.value) not in _NON_THREAD_JOIN):
            return True
    return False
