"""torchbound: host<->card boundary discipline of the port.

The counterpart of the reference package's ``jaxbound.py`` pass, for
torch.  The feed pipeline ships the binned features on a narrow (uint8)
wire and routes every copy to the card through ONE accounting wrapper
(``_accounted_place``, bridge/loader.py), so the trace CLI's critical path
can split transfer from compute and the ``dmlc_transfer_bytes_total``
contract stays truthful.  A stray ``.to(device)`` in bridge code ships
bytes off the books, a ``.float()`` on the binned payload silently
re-inflates the wire 4x, and a ``torch.compile`` rebuilt per call
recompiles on every request.

``torchbound-unaccounted-transfer``
    A copy to the card inside ``dmlc_core_tpu_torch/bridge/`` whose
    enclosing function is neither passed to ``_accounted_place`` nor
    defined inside it.  A copy to the card is ``.to(<device>)`` (not
    ``.to("cpu")``, not a dtype-only ``.to``), ``.cuda()``,
    ``torch.as_tensor``/``torch.tensor`` with a ``device=`` other than
    the CPU, or ``.copy_(..., non_blocking=...)`` (the pinned-buffer to
    device-tensor copy).  What ``_accounted_place`` wraps may be a
    function, a method, or a callable object: ``self._placer`` whose type
    the class constructs (``self._placer = Placer(...)``) accounts for that
    class's ``__call__``.

``torchbound-wide-wire``
    A value produced by the narrow-wire binning path (``.transform()`` /
    ``apply_bins`` / ``binned_batches``) that is widened to float32/float64
    (``.float()``, ``.double()``, ``.to(torch.float32)``,
    ``.astype(np.float32)``, ``torch.as_tensor(..., dtype=...)``,
    ``np.asarray(..., dtype=...)``) and then reaches a copy to the card
    (or an accounted place function) within one function.  Ship the narrow
    dtype and widen on the card (``ops/histogram.py kernel_bins``).

``torchbound-rebuilt-per-call``
    The counterpart of ``jit-in-hot-path``: ``torch.compile``,
    ``torch.jit.script``/``trace``, ``torch.cuda.make_graphed_callables``
    or ``ops/_build.load_library()`` (unless every definition of the
    loader memoizes its library) that is immediately invoked or bound
    to a local that is only ever called, or a ``torch.cuda.CUDAGraph``
    captured into a local that nothing keeps, inside a function that is
    not construction-time code (module level, ``__init__``, an
    ``lru_cache``/``cache``/``cached_property``-decorated builder).  The
    compile cache, the captured graph or the loaded library then lives
    for one call: every call pays it again.

Scope: ``unaccounted-transfer`` and ``wide-wire`` apply to
``dmlc_core_tpu_torch/bridge/`` (the feed pipeline owns the wire diet;
models legitimately take float input).  ``rebuilt-per-call`` applies
project-wide.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from dmlc_core_tpu_torch.analysis.driver import (FileContext, Finding,
                                                 dotted_name, keyword_arg)
from dmlc_core_tpu_torch.analysis.graph import (ModuleInfo, ProjectGraph,
                                                resolve_callable,
                                                walk_in_scope)
from dmlc_core_tpu_torch.analysis.purity import _is_cpu, _Names

__all__ = ["run_project", "BRIDGE_PREFIX", "ACCOUNTED_WRAPPER"]

BRIDGE_PREFIX = "dmlc_core_tpu_torch/bridge/"
ACCOUNTED_WRAPPER = "_accounted_place"

_WIDE_DTYPES = {"float32", "float64", "float", "double", "float_"}
_DTYPE_NAMES = _WIDE_DTYPES | {
    "float16", "half", "bfloat16", "uint8", "int8", "int16", "short",
    "int32", "int", "int64", "long", "bool", "complex64", "complex128",
    "uint16", "uint32", "uint64"}
_NARROW_SOURCES = {"transform", "apply_bins", "binned_batches"}
_MEMO_DECORATORS = {"lru_cache", "cache", "cached_property"}
_REBUILT = {"torch.compile", "torch.jit.script", "torch.jit.trace",
            "torch.cuda.make_graphed_callables"}
_LOADERS = {"load_library"}
_GRAPH_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}


# -- what a copy to the card looks like ---------------------------------------

def _is_dtype(expr: Optional[ast.AST]) -> bool:
    if expr is None:
        return False
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value in _DTYPE_NAMES
    name = dotted_name(expr) or ""
    short = name.rsplit(".", 1)[-1]
    return short in _DTYPE_NAMES or "dtype" in short.lower()


def _transfer(names: _Names, call: ast.Call) -> Optional[str]:
    """A short description when ``call`` copies host bytes to the card."""
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr == "cuda":
            return ".cuda()"
        if func.attr == "to":
            dev = keyword_arg(call, "device")
            if dev is None and call.args and not _is_dtype(call.args[0]):
                dev = call.args[0]
            if dev is not None and not _is_cpu(dev):
                return ".to(<device>)"
            return None
        if func.attr == "copy_" and \
                keyword_arg(call, "non_blocking") is not None:
            return ".copy_(..., non_blocking=...)"
    full = names.full(func)
    if full in ("torch.as_tensor", "torch.tensor"):
        dev = keyword_arg(call, "device")
        if dev is not None and not _is_cpu(dev):
            return f"{full}(..., device=)"
    return None


# -- accounted-function discovery ---------------------------------------------

def _enclosing_chain(ctx: FileContext, node: ast.AST) -> Iterable[ast.AST]:
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            yield cur
        cur = ctx.parents.get(cur)


def _callable_object_calls(graph: ProjectGraph, mod: ModuleInfo,
                           call: ast.Call, expr: ast.AST) -> List[ast.AST]:
    """``__call__`` of the object an accounted expression names:
    ``self.attr`` (or a local aliasing it) whose type the class
    constructs, or an inline ``Cls(...)``."""
    ctx = mod.ctx
    if isinstance(expr, ast.Name):
        alias = ctx.assign_aliases.get(expr.id)
        if alias is not None:
            expr = alias
    refs: List[str] = []
    if isinstance(expr, ast.Call):
        refs.append(dotted_name(expr.func) or "")
    elif isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                        ast.Name) \
            and expr.value.id == "self":
        owner = ctx.enclosing(call, ast.ClassDef)
        if owner is not None:
            refs += _self_attr_types(owner, expr.attr)
    out: List[ast.AST] = []
    for ref in refs:
        cls = graph.resolve_class(mod, ref)
        method = cls.methods.get("__call__") if cls is not None else None
        if method is not None:
            out.append(method.node)
    return out


def _self_attr_types(owner: ast.ClassDef, attr: str) -> List[str]:
    """Class refs ``self.<attr>`` may hold: every ``self.attr = Cls(...)``
    of the class, and ``self.attr: Optional[Cls]`` annotations."""
    refs: List[str] = []
    for node in ast.walk(owner):
        if isinstance(node, ast.Assign):
            targets, value, ann = node.targets, node.value, None
        elif isinstance(node, ast.AnnAssign):
            targets, value, ann = [node.target], node.value, node.annotation
        else:
            continue
        if not any(isinstance(t, ast.Attribute) and t.attr == attr
                   and isinstance(t.value, ast.Name) and t.value.id == "self"
                   for t in targets):
            continue
        if isinstance(value, ast.Call):
            refs.append(dotted_name(value.func) or "")
        while isinstance(ann, ast.Subscript):     # Optional[Cls]
            ann = ann.slice
        if ann is not None:
            refs.append(dotted_name(ann) or "")
    return [r for r in refs if r]


def _accounted_functions(graph: ProjectGraph, mod: ModuleInfo) -> Set[int]:
    """id()s of function nodes whose transfers are accounted: callables
    passed to ``_accounted_place`` and functions defined inside it."""
    ctx = mod.ctx
    out: Set[int] = set()
    defs = ctx.defs_by_name
    aliases = ctx.assign_aliases
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name.rsplit(".", 1)[-1] == ACCOUNTED_WRAPPER and node.args:
                arg = node.args[0]
                for fn in resolve_callable(ctx, arg, defs, aliases):
                    out.add(id(fn))
                for fn in _callable_object_calls(graph, mod, node, arg):
                    out.add(id(fn))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == ACCOUNTED_WRAPPER:
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)) and sub is not node:
                    out.add(id(sub))
    return out


def _check_bridge_file(graph: ProjectGraph,
                       mod: ModuleInfo) -> List[Finding]:
    ctx = mod.ctx
    names = _Names(ctx)
    findings: List[Finding] = []
    accounted = _accounted_functions(graph, mod)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        hit = _transfer(names, node)
        if hit is None or any(id(fn) in accounted
                              for fn in _enclosing_chain(ctx, node)):
            continue
        findings.append(Finding(
            "torchbound-unaccounted-transfer", ctx.relpath, node.lineno,
            ctx.qualname(node),
            f"{hit} moves host bytes to the card outside the "
            "_accounted_place wrapper (bridge/loader.py) — this transfer "
            "is invisible to dmlc_transfer_bytes_total and the trace "
            "critical path; route it through the wrapper"))
    findings += _check_wide_wire(ctx, names, accounted)
    return findings


# -- wide-wire def-use --------------------------------------------------------

def _dtype_token(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    name = dotted_name(node)
    return name.rsplit(".", 1)[-1] if name else None


def _is_wide_cast(call: ast.Call) -> bool:
    name = dotted_name(call.func) or ""
    short = name.rsplit(".", 1)[-1]
    if short in ("float", "double") and isinstance(call.func, ast.Attribute):
        return not call.args            # t.float() / t.double()
    if short in ("astype", "to", "type") and call.args:
        return _dtype_token(call.args[0]) in _WIDE_DTYPES
    if short == "to":
        return _dtype_token(keyword_arg(call, "dtype")) in _WIDE_DTYPES
    if short in ("asarray", "array", "ascontiguousarray", "as_tensor",
                 "tensor", "from_numpy"):
        return _dtype_token(keyword_arg(call, "dtype")) in _WIDE_DTYPES
    return short in ("float32", "float64")  # np.float32(x) constructor


def _operands(call: ast.Call) -> List[Optional[str]]:
    out = [dotted_name(a) for a in call.args]
    if isinstance(call.func, ast.Attribute):
        out.append(dotted_name(call.func.value))
    return out


def _mentions(names: List[Optional[str]], bound: Set[str]) -> Optional[str]:
    for name in names:
        if name and name.split(".")[0] in bound:
            return name
    return None


def _check_wide_wire(ctx: FileContext, names: _Names,
                     accounted: Set[int]) -> List[Finding]:
    findings: List[Finding] = []
    accounted_names: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and id(node) in accounted:
            accounted_names.add(node.name)
    for fn in [n for n in ast.walk(ctx.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        narrow: Set[str] = set()
        widened: Set[str] = set()
        # two passes over the straight-line def-use so chains that span
        # assignments resolve regardless of walk order
        for _ in range(2):
            for node in walk_in_scope(fn):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                target = node.targets[0].id
                value = node.value
                if isinstance(value, ast.Call):
                    short = (dotted_name(value.func) or "").rsplit(".", 1)[-1]
                    if short in _NARROW_SOURCES:
                        narrow.add(target)
                    elif _is_wide_cast(value) and _mentions(
                            _operands(value), narrow):
                        widened.add(target)
                elif isinstance(value, ast.Name):
                    if value.id in narrow:
                        narrow.add(target)
                    if value.id in widened:
                        widened.add(target)
        for node in walk_in_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            short = (dotted_name(node.func) or "").rsplit(".", 1)[-1]
            if _transfer(names, node) is None and \
                    short not in accounted_names:
                continue
            carried = _mentions([dotted_name(a) for a in node.args],
                                widened)
            recv = node.func.value if isinstance(node.func,
                                                 ast.Attribute) else None
            if carried is None and recv is not None:
                # w.to(dev) on a widened name, or bins.float().to(dev) in
                # one expression
                carried = _mentions([dotted_name(recv)], widened)
                if carried is None and isinstance(recv, ast.Call) \
                        and _is_wide_cast(recv):
                    carried = _mentions(_operands(recv), narrow)
            if carried is None:
                continue
            findings.append(Finding(
                "torchbound-wide-wire", ctx.relpath, node.lineno,
                ctx.qualname(node),
                f"{carried} carries binned (narrow-wire) data widened to "
                "a float dtype before the copy to the card — this "
                "re-inflates the wire ~4x; ship the narrow dtype and widen "
                "on the card (ops/histogram.py kernel_bins)"))
    return findings


# -- rebuilt-per-call ---------------------------------------------------------

def _decorator_names(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for dec in getattr(fn, "decorator_list", []):
        base = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(base) or ""
        out.add(name.rsplit(".", 1)[-1])
    return out


def _construction_time(ctx: FileContext, node: ast.AST) -> bool:
    """Module level, ``__init__`` or a memoized builder: runs once."""
    chain = list(_enclosing_chain(ctx, node))
    if not chain:
        return True
    for fn in chain:
        if getattr(fn, "name", "") == "__init__":
            return True
        if _decorator_names(fn) & _MEMO_DECORATORS:
            return True
    return False


def _local_stored(fn: ast.AST, name: str, binding: ast.AST,
                  skip=lambda call: False) -> bool:
    """Is the object bound to ``name`` parked anywhere that outlives the
    call (returned / attr / subscript / container / passed on)?  Merely
    CALLING it (``fn(x)``) or replaying it (``g.replay()``) parks
    nothing — that is exactly the rebuilt-per-call shape.  Calls for
    which ``skip`` holds (a graph's own capture context) hand nothing
    on."""
    from dmlc_core_tpu_torch.analysis.escape import _direct_owner

    def is_it(expr: ast.AST) -> bool:
        return isinstance(expr, ast.Name) and expr.id == name

    for node in walk_in_scope(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            if _direct_owner(node.value, is_it):
                return True
        elif isinstance(node, ast.Assign) and node is not binding:
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in node.targets) and \
                    _direct_owner(node.value, is_it):
                return True
        elif isinstance(node, ast.Call) and not skip(node):
            if any(is_it(arg) for arg in
                   list(node.args) + [kw.value for kw in node.keywords]):
                return True
    return False


def _graph_captured(names: _Names, fn: ast.AST, name: str) -> bool:
    for node in walk_in_scope(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and \
                        names.full(expr.func) in _GRAPH_CONTEXTS and \
                        expr.args and isinstance(expr.args[0], ast.Name) \
                        and expr.args[0].id == name:
                    return True
    return False


def _memoized_loaders(graph: ProjectGraph) -> Set[str]:
    """Loader names whose every project definition memoizes its result
    (a memo decorator, or a module-level cache through ``global``): a
    call to one returns the one library, it rebuilds nothing."""
    defs: dict = {}
    for fn in graph.functions():
        if fn.name in _LOADERS:
            memo = bool(_decorator_names(fn.node) & _MEMO_DECORATORS) or \
                any(isinstance(n, ast.Global) for n in ast.walk(fn.node))
            defs[fn.name] = defs.get(fn.name, True) and memo
    return {name for name, memo in defs.items() if memo}


def _check_rebuilt(ctx: FileContext, memoized: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    names = _Names(ctx)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        full = names.full(node.func)
        short = full.rsplit(".", 1)[-1]
        graph_obj = full == "torch.cuda.CUDAGraph"
        loader = short in _LOADERS and short not in memoized
        if not (full in _REBUILT or loader or graph_obj):
            continue
        if _construction_time(ctx, node):
            continue
        parent = ctx.parents.get(node)
        rebuilt = None
        fn = ctx.enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda)
        bound = (isinstance(parent, ast.Assign) and len(parent.targets) == 1
                 and isinstance(parent.targets[0], ast.Name))
        if graph_obj:
            if bound and fn is not None and _graph_captured(
                    names, fn, parent.targets[0].id) and not _local_stored(
                    fn, parent.targets[0].id, parent,
                    skip=lambda c: names.full(c.func) in _GRAPH_CONTEXTS):
                rebuilt = "captured into a local that nothing keeps"
        elif isinstance(parent, ast.Call) and parent.func is node:
            rebuilt = "immediately invoked"
        elif isinstance(parent, ast.Attribute) and parent.value is node:
            rebuilt = "used once"          # load_library().fn(...)
        elif bound and fn is not None and not _local_stored(
                fn, parent.targets[0].id, parent):
            rebuilt = "bound to a local that is only called"
        if rebuilt is None:
            continue
        what = "a CUDA graph" if graph_obj else f"{full or short}(...)"
        findings.append(Finding(
            "torchbound-rebuilt-per-call", ctx.relpath, node.lineno,
            ctx.qualname(node),
            f"{what} is {rebuilt}: it is rebuilt on every call of the "
            "enclosing function, so every call pays the compile, capture "
            "or load again; keep it on the instance or module, or build "
            "it under a memoizing decorator"))
    return findings


# -- the pass -----------------------------------------------------------------

def run_project(graph: ProjectGraph) -> List[Finding]:
    findings: List[Finding] = []
    memoized = _memoized_loaders(graph)
    for mod in graph.modules.values():
        if mod.relpath.startswith(BRIDGE_PREFIX):
            findings += _check_bridge_file(graph, mod)
        findings += _check_rebuilt(mod.ctx, memoized)
    return findings
