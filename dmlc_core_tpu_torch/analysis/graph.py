"""Project graph: the shared module/call-graph core for whole-repo passes.

The per-file passes (lockset, purity, resources...) deliberately stop at
the module boundary; the deadlock and contract passes cannot — a lock-order
inversion lives precisely in the interaction *between* modules (the
scheduler's RLock calling into admission's Lock calling into telemetry's),
and a config knob is read in one file and documented in another.  This
module builds, once per run:

- a **module table**: every analyzed file keyed by its dotted module name
  (``dmlc_core_tpu_torch/serve/scheduler.py`` ->
  ``dmlc_core_tpu_torch.serve.scheduler``), with import maps resolving
  local names to project modules/symbols (absolute and relative
  ``import``/``from`` forms);
- a **symbol table** per module: top-level functions, classes with their
  methods, and per-class attribute types inferred from ``self.X = Cls(...)``
  constructor assignments (so ``self.admission.release()`` resolves to
  ``AdmissionController.release``);
- **call resolution**: given a function and a call expression, the project
  function(s) it may invoke — bare names, ``self.``/``cls.`` methods,
  imported symbols, ``module.func`` attribute chains, ``Class.method``,
  typed ``self.attr.method``, with ``functools.partial(f, ...)`` and
  ``name = f`` aliases followed (the resolver hoisted out of ``purity.py``
  so every pass shares one notion of "what does this expression call").

Soundness caveats (documented in CATALOG.md): resolution is static
and best-effort — dynamic dispatch through registries, monkey-patching,
and callables passed as arguments are invisible; nested ``def`` bodies
belong to their enclosing function's module scan, not the graph.  The
passes built on top inherit these caveats and pair with the baseline/
suppression machinery exactly like the per-file passes do.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from dmlc_core_tpu_torch.analysis.driver import FileContext, dotted_name

__all__ = ["ProjectGraph", "ModuleInfo", "ClassInfo", "FunctionInfo",
           "resolve_callable", "module_name_of"]

_MAX_HOPS = 4


def resolve_callable(ctx: FileContext, expr: ast.AST,
                     defs: Dict[str, List[ast.AST]],
                     aliases: Dict[str, ast.AST],
                     hops: int = 0) -> List[ast.AST]:
    """Module-local callable resolution (shared with the purity pass).

    Returns the function defs / lambda nodes ``expr`` may refer to within
    one file: lambdas inline, ``functools.partial(f, ...)`` unwrapped,
    ``name = f`` assignment aliases followed, bare names and
    ``self.``/``cls.`` methods looked up in ``defs``.
    """
    if hops > _MAX_HOPS or expr is None:
        return []
    if isinstance(expr, ast.Lambda):
        return [expr]
    if isinstance(expr, ast.Call):  # functools.partial(f, ...) inline
        fname = dotted_name(expr.func) or ""
        if fname.rsplit(".", 1)[-1] == "partial" and expr.args:
            return resolve_callable(ctx, expr.args[0], defs, aliases,
                                    hops + 1)
        return []
    name = dotted_name(expr)
    if name is None:
        return []
    short = name.rsplit(".", 1)[-1]
    if isinstance(expr, ast.Name):
        alias = aliases.get(short)
        if alias is not None and alias is not expr:
            resolved = resolve_callable(ctx, alias, defs, aliases, hops + 1)
            if resolved:
                return resolved
        return defs.get(short, [])
    if name.startswith(("self.", "cls.")):
        return defs.get(short, [])
    return []


def module_name_of(relpath: str) -> str:
    """Dotted module name for a repo-relative path.

    ``dmlc_core_tpu_torch/io/stream.py`` ->
    ``dmlc_core_tpu_torch.io.stream``; a package ``__init__.py`` names the
    package itself; a top-level file (``chip_smoke.py``) names its stem.
    """
    path = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = path.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class FunctionInfo:
    """One module-level function or class method in the project."""

    __slots__ = ("node", "module", "cls", "name", "qualname", "fq",
                 "_param_types")

    def __init__(self, node: ast.AST, module: "ModuleInfo",
                 cls: Optional["ClassInfo"]):
        self.node = node
        self.module = module
        self.cls = cls
        self.name = node.name
        self.qualname = f"{cls.name}.{node.name}" if cls else node.name
        self.fq = f"{module.modname}:{self.qualname}"
        self._param_types: Optional[Dict[str, str]] = None

    @property
    def param_types(self) -> Dict[str, str]:
        """param name -> dotted class ref from its annotation (``x: Foo``,
        ``x: mod.Foo``, forward-ref strings; ``Optional[Foo]`` unwraps)."""
        if self._param_types is None:
            out: Dict[str, str] = {}
            args = self.node.args
            for arg in (list(args.posonlyargs) + list(args.args)
                        + list(args.kwonlyargs)):
                ref = _annotation_ref(arg.annotation)
                if ref:
                    out[arg.arg] = ref
            self._param_types = out
        return self._param_types

    def __repr__(self) -> str:  # debugging aid only
        return f"<fn {self.fq}>"


def _annotation_ref(ann: Optional[ast.AST]) -> Optional[str]:
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        ref = ann.value.strip().strip("'\"")
        return ref or None
    if isinstance(ann, ast.Subscript):  # Optional[Foo] / "Foo | None" parts
        return _annotation_ref(ann.slice)
    name = dotted_name(ann)
    return name


class ClassInfo:
    """A class: its methods plus inferred attribute types."""

    __slots__ = ("node", "module", "name", "methods", "bases", "attr_types")

    def __init__(self, node: ast.ClassDef, module: "ModuleInfo"):
        self.node = node
        self.module = module
        self.name = node.name
        self.methods: Dict[str, FunctionInfo] = {}
        self.bases: List[str] = [dotted_name(b) for b in node.bases
                                 if dotted_name(b)]
        # attr -> dotted constructor ref ("AdmissionController",
        # "mod.Cls"), from `self.X = Cls(...)` (incl. `self.X = x or
        # Cls()`); first assignment wins
        self.attr_types: Dict[str, str] = {}

    def _collect(self) -> None:
        for stmt in self.node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = FunctionInfo(stmt, self.module,
                                                       self)
        for method in self.methods.values():
            for node in ast.walk(method.node):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Attribute)
                        and isinstance(node.targets[0].value, ast.Name)
                        and node.targets[0].value.id == "self"):
                    continue
                ref = _ctor_ref(node.value)
                if ref is None and isinstance(node.value, ast.Name):
                    # `self.registry = registry` with an annotated param
                    # (`registry: ModelRegistry`): the annotation is the
                    # ctor the caller ran
                    ref = method.param_types.get(node.value.id)
                if ref:
                    self.attr_types.setdefault(node.targets[0].attr, ref)


def _ctor_ref(value: ast.AST) -> Optional[str]:
    """Dotted class ref when ``value`` looks like a constructor call."""
    if isinstance(value, ast.BoolOp):  # x = arg or Default()
        for operand in value.values:
            ref = _ctor_ref(operand)
            if ref:
                return ref
        return None
    if isinstance(value, ast.Call):
        name = dotted_name(value.func)
        # heuristic: constructors are CamelCase in this codebase
        if name and name.rsplit(".", 1)[-1][:1].isupper():
            return name
    return None


class ModuleInfo:
    """One analyzed file: symbol tables + import maps."""

    __slots__ = ("ctx", "modname", "relpath", "top_defs", "classes",
                 "import_mods", "import_syms")

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.relpath = ctx.relpath
        self.modname = module_name_of(ctx.relpath)
        self.top_defs: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        # local name -> project module it is bound to
        self.import_mods: Dict[str, str] = {}
        # local name -> (module, symbol) for `from mod import f`
        self.import_syms: Dict[str, Tuple[str, str]] = {}
        for stmt in ctx.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.top_defs[stmt.name] = FunctionInfo(stmt, self, None)
            elif isinstance(stmt, ast.ClassDef):
                cls = ClassInfo(stmt, self)
                cls._collect()
                self.classes[stmt.name] = cls

    @property
    def package(self) -> str:
        """The package this module lives in (itself, for ``__init__``)."""
        if self.ctx.relpath.endswith("/__init__.py"):
            return self.modname
        return self.modname.rsplit(".", 1)[0] if "." in self.modname else ""

    def functions(self) -> List[FunctionInfo]:
        out = list(self.top_defs.values())
        for cls in self.classes.values():
            out.extend(cls.methods.values())
        return out

    def _resolve_import_base(self, node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module
        base = self.package
        for _ in range(node.level - 1):
            if "." not in base:
                base = ""
                break
            base = base.rsplit(".", 1)[0]
        if not base and node.level > 1:
            return None
        return f"{base}.{node.module}" if node.module else (base or None)

    def collect_imports(self, known_modules) -> None:
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.import_mods[alias.asname] = alias.name
                    else:
                        root = alias.name.split(".")[0]
                        self.import_mods.setdefault(root, root)
            elif isinstance(node, ast.ImportFrom):
                base = self._resolve_import_base(node)
                if base is None:
                    continue
                for alias in node.names:
                    local = alias.asname or alias.name
                    full = f"{base}.{alias.name}"
                    if full in known_modules:
                        self.import_mods[local] = full
                    else:
                        self.import_syms[local] = (base, alias.name)


class ProjectGraph:
    """All analyzed modules + cross-module call resolution."""

    def __init__(self, contexts) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_relpath: Dict[str, ModuleInfo] = {}
        for ctx in contexts:
            mod = ModuleInfo(ctx)
            self.modules[mod.modname] = mod
            self.by_relpath[mod.relpath] = mod
        for mod in self.modules.values():
            mod.collect_imports(self.modules)
        self._callee_cache: Dict[str, List[Tuple[ast.Call, FunctionInfo]]] = {}

    # -- lookup helpers -------------------------------------------------------

    def functions(self) -> List[FunctionInfo]:
        out: List[FunctionInfo] = []
        for mod in self.modules.values():
            out.extend(mod.functions())
        return out

    def _symbol_in(self, modname: str, symbol: str,
                   hops: int = 0) -> List[FunctionInfo]:
        """``symbol`` looked up in ``modname``: a function, a class (its
        constructor), or a package ``__init__`` re-export (one hop)."""
        mod = self.modules.get(modname)
        if mod is None or hops > _MAX_HOPS:
            return []
        if symbol in mod.top_defs:
            return [mod.top_defs[symbol]]
        if symbol in mod.classes:
            ctor = mod.classes[symbol].methods.get("__init__")
            return [ctor] if ctor else []
        if symbol in mod.import_syms:  # re-export chain
            tm, sym = mod.import_syms[symbol]
            return self._symbol_in(tm, sym, hops + 1)
        if symbol in mod.import_mods:
            return []  # a module object, not a callable
        return []

    def resolve_class(self, mod: ModuleInfo,
                      ref: Optional[str]) -> Optional[ClassInfo]:
        """A dotted class ref as seen from ``mod`` -> its ClassInfo."""
        if not ref:
            return None
        parts = ref.split(".")
        if len(parts) == 1:
            if parts[0] in mod.classes:
                return mod.classes[parts[0]]
            if parts[0] in mod.import_syms:
                tm, sym = mod.import_syms[parts[0]]
                target = self.modules.get(tm)
                if target:
                    return target.classes.get(sym)
            return None
        root, rest = parts[0], parts[1:]
        if root in mod.import_mods:
            target = self.modules.get(
                ".".join([mod.import_mods[root]] + rest[:-1]))
            if target:
                return target.classes.get(rest[-1])
        return None

    # -- call resolution ------------------------------------------------------

    def resolve_call(self, fn: FunctionInfo, expr: ast.AST,
                     hops: int = 0) -> List[FunctionInfo]:
        """Project functions a call expression may invoke, from inside
        ``fn``.  Best-effort static resolution; unknown -> []."""
        if hops > _MAX_HOPS or expr is None:
            return []
        mod = fn.module
        if isinstance(expr, ast.Call):  # functools.partial(f, ...) inline
            fname = dotted_name(expr.func) or ""
            if fname.rsplit(".", 1)[-1] == "partial" and expr.args:
                return self.resolve_call(fn, expr.args[0], hops + 1)
            return []
        name = dotted_name(expr)
        if name is None:
            return []
        parts = name.split(".")
        if len(parts) == 1:
            n = parts[0]
            alias = mod.ctx.assign_aliases.get(n)
            if alias is not None and alias is not expr:
                resolved = self.resolve_call(fn, alias, hops + 1)
                if resolved:
                    return resolved
            if n in mod.top_defs:
                return [mod.top_defs[n]]
            if n in mod.classes:
                ctor = mod.classes[n].methods.get("__init__")
                return [ctor] if ctor else []
            if n in mod.import_syms:
                return self._symbol_in(*mod.import_syms[n])
            return []
        root, rest = parts[0], parts[1:]
        if root in ("self", "cls") and fn.cls is not None:
            if len(rest) == 1:
                meth = self._method_of(fn.cls, rest[0])
                return [meth] if meth else []
            if len(rest) == 2:  # self.attr.method() via inferred attr type
                cls = self.resolve_class(mod, fn.cls.attr_types.get(rest[0]))
                if cls is not None:
                    meth = self._method_of(cls, rest[1])
                    return [meth] if meth else []
            return []
        if root in fn.param_types and len(rest) == 1:
            # annotated parameter: worker(batcher: MicroBatcher) ->
            # batcher.submit() resolves through the annotation
            cls = self.resolve_class(mod, fn.param_types[root])
            if cls is not None:
                meth = self._method_of(cls, rest[0])
                return [meth] if meth else []
            return []
        if root in mod.classes and len(rest) == 1:  # Class.method
            meth = mod.classes[root].methods.get(rest[0])
            return [meth] if meth else []
        if root in mod.import_syms and len(rest) == 1:
            # ImportedClass.method
            tm, sym = mod.import_syms[root]
            target = self.modules.get(tm)
            if target and sym in target.classes:
                meth = target.classes[sym].methods.get(rest[0])
                return [meth] if meth else []
            return []
        if root in mod.import_mods:
            base = mod.import_mods[root]
            # mod.func / pkg.sub.func: longest prefix naming a module wins
            for split in range(len(rest) - 1, -1, -1):
                cand = ".".join([base] + rest[:split])
                target = self.modules.get(cand)
                if target is None:
                    continue
                tail = rest[split:]
                if len(tail) == 1:
                    return self._symbol_in(cand, tail[0])
                if len(tail) == 2 and tail[0] in target.classes:
                    meth = target.classes[tail[0]].methods.get(tail[1])
                    return [meth] if meth else []
                return []
        return []

    def _method_of(self, cls: ClassInfo,
                   name: str, hops: int = 0) -> Optional[FunctionInfo]:
        """Method lookup in ``cls``, walking project-resolvable bases."""
        if name in cls.methods:
            return cls.methods[name]
        if hops > _MAX_HOPS:
            return None
        for base_ref in cls.bases:
            base = self.resolve_class(cls.module, base_ref)
            if base is not None and base is not cls:
                found = self._method_of(base, name, hops + 1)
                if found:
                    return found
        return None

    def callees(self, fn: FunctionInfo) -> List[Tuple[ast.Call, FunctionInfo]]:
        """(call node, resolved project function) pairs inside ``fn``,
        nested scopes excluded (they run at their own call time)."""
        cached = self._callee_cache.get(fn.fq)
        if cached is not None:
            return cached
        out: List[Tuple[ast.Call, FunctionInfo]] = []
        for node in walk_in_scope(fn.node):
            if isinstance(node, ast.Call):
                for callee in self.resolve_call(fn, node.func):
                    out.append((node, callee))
        self._callee_cache[fn.fq] = out
        return out


def walk_in_scope(fn_node: ast.AST):
    """Yield every AST node of a function body, excluding nested
    function/class scopes (their bodies execute at their own call time,
    not while the enclosing function runs)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
