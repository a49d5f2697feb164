"""Pass 3 — resources: handle lifetimes in the io layer + the style rules.

``resource-unclosed``
    A call that acquires an OS handle (``open``, ``socket.socket``,
    ``tempfile.TemporaryFile``...) whose result is neither (a) a ``with``
    context manager, (b) returned (ownership transfers to the caller — the
    filesystem-factory idiom), (c) handed to another call (wrapping, e.g.
    ``BufferedReader(open(...))``), (d) stored on ``self`` (class-owned
    lifecycle, closed by the owner's ``close``), nor (e) a local that the
    enclosing function visibly ``close``s / returns / hands off.  A bare
    ``open(p)`` expression or a never-closed local leaks the fd on any
    exception path.

``resource-tempdir``
    ``tempfile.mkdtemp()`` whose path never reaches ``shutil.rmtree`` inside
    a ``finally`` block of the enclosing function.  Cleanup in an ``except
    SomeError`` arm is exactly the bug this rule exists for: any *other*
    exception type leaks the dir (tracker/filecache.py shipped this).

``style-no-print``
    Library code logs through ``utils.logging``; ``print`` is reserved for
    the CLI-exempt modules and script directories.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from dmlc_core_tpu_torch.analysis.driver import (FileContext, Finding,
                                                 dotted_name)

__all__ = ["run", "OPENER_CALLS", "ACQUISITIONS", "RELEASE_METHODS",
           "RELEASE_FUNCS", "acquisition_kind"]

# -- the shared acquisition table ---------------------------------------------
#
# ONE extensible table of "this call acquires an OS resource" knowledge,
# consumed by two passes: this per-file pass checks the file/socket/temp
# subset with its lexical heuristics, and the interprocedural escape pass
# (pass 8, escape.py) tracks EVERY kind through def-use chains with
# exception edges.  Keys are dotted-name patterns matched against the
# full dotted call name and its one/two-component suffixes; values are
# the resource kind (drives per-kind release vocabulary and messages).
ACQUISITIONS = {
    "open": "file", "io.open": "file", "gzip.open": "file",
    "bz2.open": "file", "lzma.open": "file", "os.fdopen": "file",
    "tempfile.TemporaryFile": "file", "tempfile.NamedTemporaryFile": "file",
    "socket.socket": "socket", "socket.create_connection": "socket",
    "tempfile.mkdtemp": "tempdir", "mkdtemp": "tempdir",
    "os.open": "fd",
    "SharedMemory": "shm", "shared_memory.SharedMemory": "shm",
    "ThreadPoolExecutor": "executor", "ProcessPoolExecutor": "executor",
    "futures.ThreadPoolExecutor": "executor",
    "futures.ProcessPoolExecutor": "executor",
    "mmap.mmap": "mmap",
}

# method names that release a resource, by kind (None key = any kind)
RELEASE_METHODS = {
    None: {"close", "detach"},
    "socket": {"close"},
    "executor": {"shutdown"},
    "shm": {"close", "unlink"},
    "mmap": {"close"},
}

# function-style releases: shutil.rmtree(x) / os.close(fd) — matched on
# the call's last dotted component
RELEASE_FUNCS = {"rmtree", "rmdir"}


def acquisition_kind(name: str) -> "str | None":
    """Resource kind for a dotted call name, or None.  Matches the full
    name, then its two- and one-component suffixes, so both
    ``multiprocessing.shared_memory.SharedMemory`` and a bare
    ``SharedMemory`` import resolve."""
    if not name:
        return None
    if name in ACQUISITIONS:
        return ACQUISITIONS[name]
    parts = name.split(".")
    if len(parts) >= 2 and ".".join(parts[-2:]) in ACQUISITIONS:
        return ACQUISITIONS[".".join(parts[-2:])]
    # bare-suffix matches are restricted to unambiguous class names —
    # a one-component "open" suffix would match every `x.open()` method
    if parts[-1] in ("SharedMemory", "ThreadPoolExecutor",
                     "ProcessPoolExecutor", "mkdtemp"):
        return ACQUISITIONS[parts[-1]]
    return None


# the per-file rule keeps its historical scope: short-lifetime handle
# kinds whose "handed to a call / stored on self" heuristics are sound.
# The executor/shm/mmap kinds have ownership-structured lifetimes that
# only the escape pass's dataflow models without false positives.
OPENER_CALLS = {name for name, kind in ACQUISITIONS.items()
                if kind in ("file", "socket")}

_TEMPDIR_CALLS = {"tempfile.mkdtemp", "mkdtemp"}

_CLOSE_METHODS = {"close", "shutdown", "release", "detach"}


def run(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name in OPENER_CALLS:
            findings.extend(_check_opener(ctx, node, name))
        elif name in _TEMPDIR_CALLS:
            findings.extend(_check_tempdir(ctx, node, name))
        elif name == "print" and ctx.is_library and not ctx.cli_exempt:
            findings.append(ctx.finding(
                "style-no-print", node,
                "use utils.logging, not print()"))
    return findings


# -- resource-unclosed --------------------------------------------------------

def _check_opener(ctx: FileContext, call: ast.Call,
                  name: str) -> Iterable[Finding]:
    parent = ctx.parents.get(call)
    # with open(...) as f:  — direct context manager
    if isinstance(parent, ast.withitem) and parent.context_expr is call:
        return
    # return open(...)  — ownership transfers to the caller
    if isinstance(parent, ast.Return):
        return
    # wrapped / handed straight to another call: Reader(open(...))
    if isinstance(parent, ast.Call):
        return
    if isinstance(parent, ast.keyword):
        return
    # self._f = open(...)  — class-owned lifecycle
    if isinstance(parent, ast.Assign):
        if all(isinstance(t, ast.Attribute) for t in parent.targets):
            return
        if (len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)):
            local = parent.targets[0].id
            func = ctx.enclosing(call, ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda) or ctx.tree
            if _name_released(func, local, parent):
                return
            yield ctx.finding(
                "resource-unclosed", call,
                f"{name}() result {local!r} is never closed, returned, or "
                "handed off in this function; use `with` or try/finally")
            return
    yield ctx.finding(
        "resource-unclosed", call,
        f"{name}() result is discarded without a `with` block; the handle "
        "leaks until GC (and immediately on exception paths)")


def _name_released(func: ast.AST, name: str, assign: ast.Assign) -> bool:
    """Does ``func`` visibly pass ownership of local ``name`` on: close it,
    return it, store it, use it as a context manager, or hand it to a call?"""
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id == name and f.attr in _CLOSE_METHODS):
                return True
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id == name:
                    return True
        elif isinstance(node, ast.Return) and node.value is not None:
            if any(isinstance(n, ast.Name) and n.id == name
                   for n in ast.walk(node.value)):
                return True
        elif isinstance(node, ast.withitem):
            if any(isinstance(n, ast.Name) and n.id == name
                   for n in ast.walk(node.context_expr)):
                return True
        elif isinstance(node, ast.Assign) and node is not assign:
            if (any(isinstance(t, ast.Attribute) for t in node.targets)
                    and any(isinstance(n, ast.Name) and n.id == name
                            for n in ast.walk(node.value))):
                return True
    return False


# -- resource-tempdir ---------------------------------------------------------

def _check_tempdir(ctx: FileContext, call: ast.Call,
                   name: str) -> Iterable[Finding]:
    parent = ctx.parents.get(call)
    if isinstance(parent, (ast.Return, ast.Call, ast.keyword)):
        return  # ownership transferred
    if isinstance(parent, ast.Assign):
        if all(isinstance(t, ast.Attribute) for t in parent.targets):
            return  # class-owned
        if (len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)):
            local = parent.targets[0].id
            func = ctx.enclosing(call, ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda) or ctx.tree
            if _rmtree_in_finally(func, local) or _returned(func, local):
                return
            yield ctx.finding(
                "resource-tempdir", call,
                f"mkdtemp() dir {local!r} has no shutil.rmtree in a "
                "`finally`; cleanup in an `except <Type>` arm leaks the dir "
                "for every other exception type")
            return
    yield ctx.finding(
        "resource-tempdir", call,
        "mkdtemp() result is not bound to a cleanup path")


def _rmtree_in_finally(func: ast.AST, name: str) -> bool:
    for node in ast.walk(func):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        for stmt in node.finalbody:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                called = dotted_name(sub.func) or ""
                if called.rsplit(".", 1)[-1] not in ("rmtree", "rmdir"):
                    continue
                for arg in sub.args:
                    if any(isinstance(n, ast.Name) and n.id == name
                           for n in ast.walk(arg)):
                        return True
    return False


def _returned(func: ast.AST, name: str) -> bool:
    for node in ast.walk(func):
        if (isinstance(node, ast.Return) and node.value is not None
                and any(isinstance(n, ast.Name) and n.id == name
                        for n in ast.walk(node.value))):
            return True
    return False
