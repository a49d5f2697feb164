"""Purity: host syncs and impurity in the port's hot device code.

The port launches every device op from Python, asynchronously: the host
queues work and runs ahead while the card computes.  A single host sync in
a hot loop (``.item()``, ``.cpu()``, ``torch.cuda.synchronize()``, a
``bool()`` of a card tensor) drains that queue every iteration, so the
card idles while Python catches up; inside a compiled or graph-captured
callable the same sync breaks the graph or fails the capture.  Neither
crashes, which is exactly why a static pass pays rent.

Mechanics, per module:

1. **Roots** — the code that runs hot:

   - ``forward`` and ``backward`` of ``torch.autograd.Function``
     subclasses;
   - callables passed to (or decorated with) ``torch.compile``,
     ``torch.jit.script``/``trace`` or ``torch.cuda.make_graphed_callables``,
     and the body of a ``with torch.cuda.graph(...)`` capture;
   - the bodies of ``for`` and ``while`` loops (and a ``while`` test) in
     functions of the device layers (:data:`DEVICE_LAYERS`: ``models/``,
     ``ops/``, ``parallel/``, ``collective/`` and
     ``serve/model_runtime.py``).

   The first two kinds are *strict* roots (autograd, compile, graph); the
   third are *loop* roots.  Lambdas are analyzed inline;
   ``functools.partial(f, ...)`` and simple ``name = f`` aliases are
   followed.
2. **Reachability** — from the roots, calls to same-module functions
   (bare names, ``self.``/``cls.`` methods) are walked transitively, and a
   reached function is checked whole.  The walk is module-local by
   design, as in the reference package's pass; the gate's baseline covers
   the remainder.
3. **Checks** inside reachable code:

   - ``purity-host-sync``: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
     ``.numpy()`` / ``.to("cpu")``; ``torch.cuda.synchronize()`` and
     ``<event or stream>.synchronize()``; ops whose output size depends
     on the data, which the card must report to the host before the
     caller can go on (``nonzero``, ``unique``, ``masked_select``,
     ``bincount``, one-argument ``torch.where``, ``repeat_interleave``
     without ``output_size``); ``float()``/``int()``/``bool()`` of a
     tensor-valued expression.  A name is tensor-valued when it is bound
     in the same function from a ``torch.*`` call, a method of a tensor,
     an index or arithmetic of one, or is a parameter annotated
     ``torch.Tensor`` (for strict roots, every parameter but the first
     that is not annotated ``int``/``bool``/``str``/``float``).
     ``.item()``/``.tolist()`` of a name bound from a numpy call are host
     work and exempt.
   - ``purity-host-branch``: an ``if``/``while`` test containing one of
     those syncs, or testing a tensor-valued expression itself (an
     implicit ``bool()``).
   - ``purity-np-call``: a ``numpy`` call taking a tensor-valued name.
   - ``purity-impure-call``: ``random.*`` / ``np.random.*`` / ``time.*`` /
     ``open`` / ``print`` / ``input`` in code reached from a strict root.
     A host loop may time and count.
   - ``purity-telemetry-call``: a :mod:`dmlc_core_tpu_torch.telemetry`
     helper in code reached from a strict root: a captured graph replays
     none of it, and an autograd ``backward`` runs on autograd's thread.

:func:`hot_regions` exposes the same roots to callers that check the rule
against the card (``chip_smoke.py`` phase 17 asks whether a sync the card
reported lies inside a root).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from dmlc_core_tpu_torch.analysis.driver import (FileContext, Finding,
                                                 dotted_name, keyword_arg)
from dmlc_core_tpu_torch.analysis.graph import resolve_callable

__all__ = ["run", "hot_regions", "DEVICE_LAYERS", "COMPILE_WRAPPERS"]

# where a library function's loops are hot roots
DEVICE_LAYERS = ("dmlc_core_tpu_torch/models/", "dmlc_core_tpu_torch/ops/",
                 "dmlc_core_tpu_torch/parallel/",
                 "dmlc_core_tpu_torch/collective/",
                 "dmlc_core_tpu_torch/serve/model_runtime.py")

# canonical wrapper name -> indices of the compiled/captured callable(s)
COMPILE_WRAPPERS: Dict[str, Tuple[int, ...]] = {
    "torch.compile": (0,), "torch.jit.script": (0,),
    "torch.jit.trace": (0,), "torch.cuda.make_graphed_callables": (0,),
    "torch.cuda.graphs.make_graphed_callables": (0,),
}
_GRAPH_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
_AUTOGRAD_BASES = {"torch.autograd.Function",
                   "torch.autograd.function.Function"}
_AUTOGRAD_METHODS = {"forward", "backward"}

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_OK_METHODS = {"item", "tolist"}   # also numpy's: exempt on host arrays
# ops whose output size the card must report to the host
_DATA_SIZED = {"nonzero", "unique", "unique_consecutive", "masked_select",
               "bincount", "argwhere"}
# torch calls that return a host bool computed on the card
_HOST_RESULT = {"equal", "allclose", "is_nonzero"}
_CAST_BUILTINS = {"float", "int", "bool", "complex"}
_STATIC_ANNOTATIONS = {"int", "bool", "str", "float"}
_IMPURE_ROOTS = {"random", "time"}
_IMPURE_CALLS = {"open", "print", "input"}
_TELEMETRY_MODULES = {"dmlc_core_tpu_torch.telemetry",
                      "dmlc_core_tpu_torch.io.fs_metrics"}
_TELEMETRY_HELPERS = {"span", "count", "gauge_set", "gauge_add", "observe",
                      "record_span", "note_request", "request_start"}
# torch calls that do not return a tensor
_NON_TENSOR_TORCH = {"device", "Size", "dtype", "Generator", "is_tensor",
                     "is_floating_point", "is_complex", "numel",
                     "get_default_dtype", "is_grad_enabled", "no_grad",
                     "enable_grad", "inference_mode", "set_grad_enabled",
                     "manual_seed", "is_available", "finfo", "iinfo",
                     "broadcast_shapes", "result_type", "promote_types",
                     "can_cast", "get_rng_state", "compile",
                     "get_num_threads", "set_num_threads", "typename",
                     "use_deterministic_algorithms",
                     "are_deterministic_algorithms_enabled"} | _HOST_RESULT
# tensor methods that return host values (sizes, pointers, flags)
_NON_TENSOR_METHODS = {"size", "dim", "numel", "nelement", "ndimension",
                       "data_ptr", "element_size", "stride",
                       "is_contiguous", "get_device", "storage_offset",
                       "item", "tolist", "numpy", "is_floating_point",
                       "untyped_storage", "type", "__len__"}
_TORCH_SUBMODULES = {"nn", "linalg", "fft", "special"}

_FuncNode = ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
_STRICT = ("autograd", "compile", "graph")


class _Region:
    """Hot code: the nodes to check, the function they belong to (for
    tensor inference and symbols) and the kind of root that reached it."""

    __slots__ = ("kind", "fn", "nodes", "tests", "whole")

    def __init__(self, kind: str, fn: Optional[_FuncNode],
                 nodes: List[ast.AST], tests: Iterable[ast.AST] = (),
                 whole: bool = False):
        self.kind = kind
        self.fn = fn
        self.nodes = nodes
        self.tests = list(tests)   # loop tests that decide each iteration
        self.whole = whole         # the region is ``fn``'s whole body


def run(ctx: FileContext) -> List[Finding]:
    regions = _all_regions(ctx)
    if not regions:
        return []
    names = _Names(ctx)
    findings: List[Finding] = []
    seen: Set[Tuple[str, int, str]] = set()
    for region in regions:
        for f in _check_region(ctx, region, names):
            dedup = (f.rule, f.lineno, f.symbol)
            if dedup not in seen:
                seen.add(dedup)
                findings.append(f)
    return findings


def hot_regions(ctx: FileContext) -> List[Tuple[str, int, int]]:
    """(kind, first line, last line) of every statement the pass checks:
    the roots and the functions reached from them."""
    out: List[Tuple[str, int, int]] = []
    for region in _all_regions(ctx):
        for node in region.nodes + region.tests:
            out.append((region.kind, node.lineno,
                        getattr(node, "end_lineno", node.lineno)))
    return out


# -- names this module binds to torch, numpy and telemetry --------------------

class _Names:
    """What the module's imports bind: torch and numpy aliases and their
    ``from``-imported names, canonicalized to dotted module paths."""

    def __init__(self, ctx: FileContext):
        self.canon: Dict[str, str] = {}
        for alias, mod in ctx.module_aliases.items():
            self.canon[alias] = mod
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for alias in node.names:
                    self.canon.setdefault(alias.asname or alias.name,
                                          f"{node.module}.{alias.name}")
        self.numpy = {a for a, m in self.canon.items()
                      if m == "numpy" or m.startswith("numpy.")}
        self.impure = {a for a, m in ctx.module_aliases.items()
                       if m.split(".")[0] in _IMPURE_ROOTS}
        self.telemetry = _telemetry_names(ctx)

    def full(self, expr: ast.AST) -> str:
        """``torch.cuda.synchronize`` for ``cuda.synchronize`` under
        ``from torch import cuda``; the dotted name itself otherwise."""
        name = dotted_name(expr) or ""
        root, _, rest = name.partition(".")
        mod = self.canon.get(root)
        if mod is None:
            return name
        return f"{mod}.{rest}" if rest else mod

    def is_torch_call(self, call: ast.Call) -> bool:
        return self.full(call.func).split(".")[0] == "torch"

    def is_numpy_call(self, call: ast.Call) -> bool:
        return self.full(call.func).split(".")[0] == "numpy"


# -- root discovery -----------------------------------------------------------

def _in_device_layer(relpath: str) -> bool:
    return relpath.startswith(DEVICE_LAYERS)


def _all_regions(ctx: FileContext) -> List[_Region]:
    names = _Names(ctx)
    roots = _roots(ctx, names)
    return roots + _reachable(ctx, roots)


def _roots(ctx: FileContext, names: _Names) -> List[_Region]:
    defs = ctx.defs_by_name
    aliases = ctx.assign_aliases
    out: List[_Region] = []

    def add_callable(kind: str, expr: ast.AST) -> None:
        if isinstance(expr, (ast.Tuple, ast.List)):
            for elt in expr.elts:
                add_callable(kind, elt)
            return
        for fn in resolve_callable(ctx, expr, defs, aliases):
            out.append(_function_region(kind, fn))

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef) and any(
                names.full(b) in _AUTOGRAD_BASES for b in node.bases):
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and stmt.name in _AUTOGRAD_METHODS:
                    out.append(_function_region("autograd", stmt))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                base = dec.func if isinstance(dec, ast.Call) else dec
                if names.full(base) in COMPILE_WRAPPERS:
                    out.append(_function_region("compile", node))
                    break
        elif isinstance(node, ast.Call):
            for idx in COMPILE_WRAPPERS.get(names.full(node.func), ()):
                if idx < len(node.args):
                    add_callable("compile", node.args[idx])
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(item.context_expr, ast.Call)
                   and names.full(item.context_expr.func) in _GRAPH_CONTEXTS
                   for item in node.items):
                fn = ctx.enclosing(node, ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.Lambda)
                out.append(_Region("graph", fn, list(node.body)))
    if _in_device_layer(ctx.relpath):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                continue
            fn = ctx.enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)
            if fn is None:
                continue  # module-level loops run once, at import
            tests = [node.test] if isinstance(node, ast.While) else []
            out.append(_Region("loop", fn, list(node.body), tests))
    return out


def _function_region(kind: str, fn: _FuncNode) -> _Region:
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    return _Region(kind, fn, list(body), whole=True)


def _reachable(ctx: FileContext, roots: List[_Region]) -> List[_Region]:
    """Functions called from the roots, transitively within the module;
    a function reached from a strict root is checked as strict."""
    defs = ctx.defs_by_name
    aliases = ctx.assign_aliases
    kinds: Dict[int, str] = {}
    order: List[_FuncNode] = []
    work: List[Tuple[str, ast.AST]] = []
    for region in roots:
        if region.whole:
            kinds[id(region.fn)] = region.kind
        for node in region.nodes + region.tests:
            work.append((region.kind, node))
    while work:
        kind, start = work.pop()
        for node in ast.walk(start):
            if not isinstance(node, ast.Call):
                continue
            for fn in resolve_callable(ctx, node.func, defs, aliases):
                old = kinds.get(id(fn))
                if old is not None and (old in _STRICT or kind == "loop"):
                    continue
                if old is None:
                    order.append(fn)
                kinds[id(fn)] = kind
                work.append((kind, fn))
    return [_function_region(kinds[id(fn)], fn) for fn in order]


# -- tensor-valued names ------------------------------------------------------

def _annotation_is_tensor(ann: Optional[ast.AST], names: _Names) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Subscript):    # Optional[torch.Tensor]
        return _annotation_is_tensor(ann.slice, names)
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip("'\"").rsplit(".", 1)[-1] == "Tensor"
    return names.full(ann) in ("torch.Tensor", "Tensor")


def _params(fn: _FuncNode) -> List[ast.arg]:
    args = fn.args
    return list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)


def _tensor_names(fn: Optional[_FuncNode], strict: bool,
                  names: _Names) -> Tuple[Set[str], Set[str]]:
    """(tensor-valued names, numpy-valued names) of one function."""
    tensors: Set[str] = set()
    host: Set[str] = set()
    if fn is None:
        return tensors, host
    params = _params(fn)
    for i, arg in enumerate(params):
        ann = arg.annotation
        if _annotation_is_tensor(ann, names):
            tensors.add(arg.arg)
        elif strict and i > 0 and arg.arg not in ("self", "cls", "ctx") \
                and not (isinstance(ann, ast.Name)
                         and ann.id in _STATIC_ANNOTATIONS):
            tensors.add(arg.arg)
    scope = list(_scope_nodes(fn))
    # two passes over the flow-insensitive def-use, so chains that span
    # assignments resolve regardless of walk order
    for _ in range(2):
        for node in scope:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                    and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            if _is_tensor_expr(value, tensors, names):
                bucket = tensors
            elif isinstance(value, ast.Call) and \
                    (dotted_name(value.func) or "").split(".")[0] \
                    in names.numpy:
                bucket = host
            else:
                continue
            for target in targets:
                for sub in ast.walk(target):
                    if isinstance(sub, ast.Name):
                        bucket.add(sub.id)
    return tensors, host


def _scope_nodes(fn: _FuncNode):
    """The function's own nodes: nested defs and classes excluded, as
    their bodies bind their own names."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _is_tensor_expr(expr: ast.AST, tensors: Set[str], names: _Names) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in tensors
    if isinstance(expr, ast.Subscript):
        return _is_tensor_expr(expr.value, tensors, names)
    if isinstance(expr, ast.BinOp):
        return (_is_tensor_expr(expr.left, tensors, names)
                or _is_tensor_expr(expr.right, tensors, names))
    if isinstance(expr, ast.UnaryOp) and not isinstance(expr.op, ast.Not):
        return _is_tensor_expr(expr.operand, tensors, names)
    if isinstance(expr, ast.Compare):
        return any(_is_tensor_expr(e, tensors, names)
                   for e in [expr.left] + list(expr.comparators)) \
            and not any(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                        ast.NotIn)) for op in expr.ops)
    if not isinstance(expr, ast.Call):
        return False
    func = expr.func
    if names.is_torch_call(expr):
        parts = names.full(func).split(".")
        if parts[-1] in _NON_TENSOR_TORCH or parts[-1][:1].isupper():
            return False
        return len(parts) == 2 or parts[1] in _TORCH_SUBMODULES
    if isinstance(func, ast.Attribute) and func.attr not in \
            _NON_TENSOR_METHODS:
        return _is_tensor_expr(func.value, tensors, names)
    return False


# -- checks -------------------------------------------------------------------

def _receiver(call: ast.Call) -> Optional[ast.AST]:
    return call.func.value if isinstance(call.func, ast.Attribute) else None


def _is_host_receiver(call: ast.Call, host: Set[str]) -> bool:
    recv = _receiver(call)
    name = dotted_name(recv) if recv is not None else None
    return bool(name) and name.split(".")[0] in host


def _is_cpu(expr: Optional[ast.AST]) -> bool:
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    if isinstance(expr, ast.Call) and expr.args:
        return (dotted_name(expr.func) or "").endswith("device") \
            and _is_cpu(expr.args[0])
    return False


def _sync_call(call: ast.Call, tensors: Set[str], host: Set[str],
               names: _Names) -> Optional[str]:
    """Message when ``call`` makes the host wait for the card, else None."""
    func = call.func
    full = names.full(func)
    if isinstance(func, ast.Attribute):
        attr = func.attr
        if attr in _SYNC_METHODS and not call.args and not (
                attr in _HOST_OK_METHODS and _is_host_receiver(call, host)):
            return (f".{attr}() copies a card tensor to the host: the host "
                    "waits for every queued kernel")
        if attr == "to" and (_is_cpu(call.args[0] if call.args else None)
                             or _is_cpu(keyword_arg(call, "device"))):
            return ('.to("cpu") copies a card tensor to the host: the host '
                    "waits for every queued kernel")
        if attr == "synchronize":
            return (f"{full or attr}() blocks the host until the card "
                    "drains its queue")
        on_card = not (names.is_numpy_call(call)
                       or _is_host_receiver(call, host))
        if attr in _DATA_SIZED and on_card:
            return (f"{full or attr}() has a data-dependent output size: "
                    "the card reports it to the host before the caller "
                    "goes on")
        if attr == "repeat_interleave" and on_card and \
                keyword_arg(call, "output_size") is None:
            return ("repeat_interleave() without output_size= sizes its "
                    "output from the data: a host sync")
        if full == "torch.where" and len(call.args) == 1:
            return ("one-argument torch.where() is nonzero(): its output "
                    "size is data-dependent, a host sync")
        if attr in _HOST_RESULT and (
                names.is_torch_call(call)
                or _is_tensor_expr(func.value, tensors, names)):
            return (f"{full or attr}() returns a host bool computed on the "
                    "card: the host waits for every queued kernel")
    name = dotted_name(func) or ""
    if name in _CAST_BUILTINS and len(call.args) == 1 \
            and _is_tensor_expr(call.args[0], tensors, names):
        return (f"{name}() of a tensor copies it to the host: the host "
                "waits for every queued kernel")
    return None


def _np_call_on_tensor(call: ast.Call, tensors: Set[str],
                       names: _Names) -> Optional[str]:
    name = dotted_name(call.func)
    if not name or name.split(".")[0] not in names.numpy:
        return None
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(arg, ast.Name) and arg.id in tensors:
            return (f"{name}() on tensor {arg.id!r} runs on the host (a "
                    "copy and a sync, or an error for a card tensor) — "
                    "use the torch op")
    return None


def _is_telemetry_module(path: str) -> bool:
    return (path in _TELEMETRY_MODULES
            or path.startswith("dmlc_core_tpu_torch.telemetry."))


def _telemetry_names(ctx: FileContext) -> Tuple[Set[str], Set[str]]:
    """(module-alias names, directly-imported helper names) bound to the
    telemetry package in this file.  ``module_aliases`` only sees plain
    ``import X`` forms, but telemetry's documented idiom is
    ``from dmlc_core_tpu_torch import telemetry`` — so scan ImportFrom."""
    mods = {alias for alias, mod in ctx.module_aliases.items()
            if _is_telemetry_module(mod)}
    funcs: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ImportFrom) or node.module is None:
            continue
        for alias in node.names:
            bound = alias.asname or alias.name
            full = f"{node.module}.{alias.name}"
            if _is_telemetry_module(full):
                mods.add(bound)
            elif _is_telemetry_module(node.module) \
                    and alias.name in _TELEMETRY_HELPERS:
                funcs.add(bound)
    return mods, funcs


def _telemetry_call(call: ast.Call,
                    telemetry_names: Tuple[Set[str], Set[str]]
                    ) -> Optional[str]:
    name = dotted_name(call.func)
    if not name:
        return None
    mods, funcs = telemetry_names
    root = name.split(".")[0]
    if not (root in mods or name in funcs
            or name.startswith("dmlc_core_tpu_torch.telemetry.")):
        return None
    return (f"{name}() is host-side telemetry inside an autograd, compiled "
            "or graph-captured callable — a capture records it once and "
            "replays none of it; meter outside the captured code")


def _enabled_gated(ctx: FileContext, node: ast.AST,
                   telemetry_names: Tuple[Set[str], Set[str]]) -> bool:
    """Is ``node`` inside an ``if telemetry.enabled():`` block?  Host-side
    metering deliberately gated on the telemetry switch documents its
    intent and is a no-op when disabled — such calls need no
    suppression comment."""
    mods, funcs = telemetry_names
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.If):
            for sub in ast.walk(cur.test):
                if not isinstance(sub, ast.Call):
                    continue
                name = dotted_name(sub.func) or ""
                if name.rsplit(".", 1)[-1] != "enabled":
                    continue
                root = name.split(".")[0]
                if (root in mods or "enabled" in funcs
                        or name.startswith("dmlc_core_tpu_torch.telemetry.")):
                    return True
        cur = ctx.parents.get(cur)
    return False


def _impure_call(call: ast.Call, names: _Names) -> Optional[str]:
    name = dotted_name(call.func)
    if not name:
        return None
    root = name.split(".")[0]
    if root in names.impure or (root in names.numpy
                                and ".random." in f".{name}."):
        return (f"{name}() in an autograd, compiled or graph-captured "
                "callable: a capture runs it once and replays its value — "
                "draw with a torch generator on the card instead")
    if name in _IMPURE_CALLS:
        return (f"{name}() is a side effect inside an autograd, compiled "
                "or graph-captured callable (it runs at capture only, or "
                "on autograd's thread)")
    return None


def _check_region(ctx: FileContext, region: _Region,
                  names: _Names) -> Iterable[Finding]:
    strict = region.kind in _STRICT
    tensors, host = _tensor_names(region.fn, strict, names)
    branch_tests: Set[int] = set()
    implicit: List[ast.AST] = []
    tests = list(region.tests)
    for stmt in region.nodes:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.If, ast.While)):
                tests.append(node.test)
    for test in tests:
        for sub in ast.walk(test):
            branch_tests.add(id(sub))
        parts = test.values if isinstance(test, ast.BoolOp) else [test]
        for part in parts:
            if isinstance(part, ast.UnaryOp) and isinstance(part.op, ast.Not):
                part = part.operand
            if _is_tensor_expr(part, tensors, names):
                implicit.append(part)
    for part in implicit:
        yield ctx.finding(
            "purity-host-branch", part,
            "Python control flow tests a tensor (an implicit bool(): the "
            "host waits for the card, then decides)")
    for stmt in region.nodes + region.tests:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            sync = _sync_call(node, tensors, host, names)
            if sync is not None:
                if id(node) in branch_tests:
                    yield ctx.finding(
                        "purity-host-branch", node,
                        "Python control flow branches on a value synced "
                        f"from the card ({sync.strip()})")
                else:
                    yield ctx.finding("purity-host-sync", node, sync)
                continue
            np_msg = _np_call_on_tensor(node, tensors, names)
            if np_msg is not None:
                yield ctx.finding("purity-np-call", node, np_msg)
                continue
            if not strict:
                continue
            tel_msg = _telemetry_call(node, names.telemetry)
            if tel_msg is not None:
                if not _enabled_gated(ctx, node, names.telemetry):
                    yield ctx.finding("purity-telemetry-call", node, tel_msg)
                continue
            impure = _impure_call(node, names)
            if impure is not None:
                yield ctx.finding("purity-impure-call", node, impure)
