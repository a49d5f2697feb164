"""Pass 11 — wiretaint: untrusted-wire values flowing into dangerous sinks.

The protocol hardening bounded every length prefix the rendezvous
protocol reads (``MAX_FRAME``, ``MAX_PEERS``) — by hand, after the bugs
shipped.  This pass is the static twin: any int or string decoded from
the wire (``FramedSocket.recvint``/``recvstr``/``recv``/``recvall``,
``struct.unpack``, JSON parsed from a received frame) is *tainted*, and
a tainted value reaching a sink without an intervening bound or
allowlist guard is a finding:

- ``taint-unbounded-wire-int`` — a wire-decoded int used as an
  allocation or iteration size: ``range(n)``, ``bytearray(n)``/
  ``bytes(n)``, ``sock.recv(n)``/``recvall(n)``, list/str/bytes
  multiplication, ``np.zeros/empty/ones/full(n)``.  One hostile frame
  makes the peer allocate gigabytes or spin forever.
- ``taint-wire-str-in-path`` — a wire-decoded string used in a
  filesystem path operation (``open``, ``os.path.join``, ``Path(...)``,
  ``os.remove``/``makedirs``/``rmtree``) without sanitization: classic
  path traversal from a protocol frame.

Taint is killed by the guard shapes the hardened code actually uses:

- a bounds check that bails out — ``if n < 0 or n > MAX_FRAME: raise``
  (or ``return``/``continue``/``break``) lexically before the use;
- using the value *inside* an ``if`` whose test compares/allowlists it;
- wrapping in ``min(...)`` (upper bound), ``%``/``&`` (modulus/mask),
  or ``len(...)``;
- ``os.path.basename(...)`` for path strings (strips traversal).

Scope is deliberately function-local (the torchbound def-use discipline):
taint does not cross function boundaries, attribute stores, or returns.
A parameter is trusted — callers are in-project and the coordinator side
of a protocol is not the attacker.  That keeps the lease/fleet clients
clean (their ``recvint`` results are only compared) and is documented as
a soundness caveat in CATALOG.md; the seeded-bug tests pin down
what the pass *does* catch so the gate can ratchet from there.

Findings anchor at the sink line with the enclosing function's qualname
as the symbol — two sinks in one function share a key and exercise the
baseline's ``#2`` instance-key discipline.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from dmlc_core_tpu_torch.analysis.driver import Finding, dotted_name
from dmlc_core_tpu_torch.analysis.graph import ProjectGraph, walk_in_scope

__all__ = ["run_project"]

# receiver methods that read raw frames off a socket
_INT_SOURCES = {"recvint"}
_STR_SOURCES = {"recvstr"}
_BYTES_SOURCES = {"recv", "recvall", "recv_into", "recvframe"}

# calls whose result keeps the argument's taint (identity-ish wrappers)
_PASSTHROUGH = {"int", "float", "str", "bytes", "abs", "bool"}

# calls that bound/sanitize their argument
_INT_SANITIZERS = {"min", "len"}
_PATH_SANITIZERS = {"basename", "os.path.basename", "posixpath.basename",
                    "secure_filename"}

_INT_SINK_CALLS = {"range", "bytearray", "bytes", "memoryview"}
_INT_SINK_METHODS = {"recv", "recvall", "recv_into", "read"}
_NP_ALLOC = {"zeros", "empty", "ones", "full"}

_PATH_SINK_CALLS = {"open", "os.remove", "os.unlink", "os.rmdir",
                    "os.makedirs", "os.mkdir", "os.rename", "os.replace",
                    "shutil.rmtree", "pathlib.Path", "Path"}
_PATH_JOIN_CALLS = {"os.path.join", "posixpath.join", "ntpath.join"}

_INT = "int"
_STR = "str"
_ANY = "any"


def _short(name: str) -> str:
    return name.rsplit(".", 1)[-1]


class _FunctionTaint:
    """Two-pass def-use over one function body (nested scopes excluded),
    mirroring torchbound's ``_check_wide_wire``: pass 1 computes the
    tainted-name environment to fixpoint; pass 2 walks statements in
    lexical order, retiring names as guards kill them and flagging
    sinks."""

    def __init__(self, relpath: str, qualname: str,
                 body: List[ast.stmt]) -> None:
        self.relpath = relpath
        self.qualname = qualname
        self.body = body
        self.tainted: Dict[str, str] = {}   # name -> _INT/_STR/_ANY
        self.guarded: Set[str] = set()      # names a bailout guard cleared
        self.findings: List[Finding] = []

    # -- taint classification -------------------------------------------------

    def _taint_of(self, node: ast.AST) -> Optional[str]:
        """Taint kind carried by an expression, or None."""
        if isinstance(node, ast.Name):
            if node.id in self.guarded:
                return None
            return self.tainted.get(node.id)
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            short = _short(name)
            if isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if meth in _INT_SOURCES:
                    return _INT
                if meth in _STR_SOURCES:
                    return _STR
                if meth in _BYTES_SOURCES:
                    return _ANY
                if meth == "decode":
                    inner = self._taint_of(node.func.value)
                    return _STR if inner else None
                if meth in ("strip", "lstrip", "rstrip", "lower", "upper",
                            "split", "rsplit", "partition", "format"):
                    inner = self._taint_of(node.func.value)
                    return _STR if inner else None
            if short == "unpack" or short == "unpack_from":
                return _ANY  # struct.unpack of wire bytes
            if short == "loads" and node.args \
                    and self._taint_of(node.args[0]):
                return _ANY  # json.loads of a received frame
            if short in _INT_SANITIZERS or name in _PATH_SANITIZERS \
                    or short in _PATH_SANITIZERS:
                return None
            if short in _PASSTHROUGH:
                kinds = [self._taint_of(a) for a in node.args]
                if any(kinds):
                    if short in ("int", "abs"):
                        return _INT
                    if short == "str":
                        return _STR
                    return _ANY
                return None
            if short == "max":
                # max() preserves the UPPER-unbounded hazard
                kinds = [self._taint_of(a) for a in node.args]
                return _INT if any(kinds) else None
            return None
        if isinstance(node, ast.Subscript):
            inner = self._taint_of(node.value)
            if inner:
                # element of a tainted tuple/dict/list: kind unknown
                return _ANY if inner == _ANY else inner
            return None
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, (ast.Mod, ast.BitAnd)):
                return None  # modulus / mask bounds the value
            left = self._taint_of(node.left)
            right = self._taint_of(node.right)
            return left or right
        if isinstance(node, ast.UnaryOp):
            return self._taint_of(node.operand)
        if isinstance(node, ast.IfExp):
            return self._taint_of(node.body) or self._taint_of(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                kind = self._taint_of(elt)
                if kind:
                    return kind
            return None
        if isinstance(node, ast.JoinedStr):
            for value in node.values:
                if isinstance(value, ast.FormattedValue) \
                        and self._taint_of(value.value):
                    return _STR
            return None
        return None

    # -- pass 1: propagate assignments to fixpoint ----------------------------

    def _propagate(self) -> None:
        for _ in range(8):  # bounded fixpoint; real chains are short
            changed = False
            for node in self._walk():
                targets: List[Tuple[ast.AST, ast.AST]] = []
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        targets.append((t, node.value))
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None:
                    targets.append((node.target, node.value))
                elif isinstance(node, ast.AugAssign):
                    targets.append((node.target, node.value))
                for target, value in targets:
                    changed |= self._assign(target, value)
            if not changed:
                return

    def _assign(self, target: ast.AST, value: ast.AST) -> bool:
        if isinstance(target, (ast.Tuple, ast.List)):
            kind = self._taint_of(value)
            # a, b = unpack(...) / tainted tuple: every binding tainted
            changed = False
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    changed |= self._assign(t, v)
                return changed
            if kind:
                for t in target.elts:
                    if isinstance(t, ast.Name):
                        changed |= self._mark(t.id, _ANY)
            return changed
        if isinstance(target, ast.Name):
            kind = self._taint_of(value)
            if kind:
                return self._mark(target.id, kind)
        return False

    def _mark(self, name: str, kind: str) -> bool:
        prev = self.tainted.get(name)
        new = kind if prev in (None, kind) else _ANY
        if prev != new:
            self.tainted[name] = new
            return True
        return False

    def _walk(self):
        for stmt in self.body:
            yield stmt
            yield from walk_in_scope(stmt)

    # -- pass 2: lexical walk, guards retire names, sinks flag ----------------

    def run(self) -> List[Finding]:
        self._propagate()
        if self.tainted:
            for stmt in self.body:
                self._visit(stmt)
        return self.findings

    def _guard_names(self, test: ast.AST) -> Set[str]:
        """Tainted names a comparison test bounds (Compare or BoolOp of
        Compares; membership counts as an allowlist check)."""
        names: Set[str] = set()
        for node in ast.walk(test):
            if isinstance(node, ast.Compare):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) \
                            and sub.id in self.tainted:
                        names.add(sub.id)
        return names

    def _bails(self, body: List[ast.stmt]) -> bool:
        return any(isinstance(s, (ast.Raise, ast.Return, ast.Continue,
                                  ast.Break)) for s in body)

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.If):
            bounded = self._guard_names(node.test)
            if bounded and self._bails(node.body):
                # if n < 0 or n > MAX: raise — n is clean afterwards
                for stmt in node.body:
                    self._visit(stmt)
                self.guarded |= bounded
                for stmt in node.orelse:
                    self._visit(stmt)
                return
            if bounded:
                # uses INSIDE `if 0 <= n <= MAX:` are bounded
                saved = set(self.guarded)
                self.guarded |= bounded
                for stmt in node.body:
                    self._visit(stmt)
                self.guarded = saved
                for stmt in node.orelse:
                    self._visit(stmt)
                return
        if isinstance(node, ast.Assert):
            bounded = self._guard_names(node.test)
            if bounded:
                self.guarded |= bounded
            return
        if isinstance(node, ast.Call):
            self._check_sink(node)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            self._check_multiply(node)
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _is_live(self, node: ast.AST, kinds: Tuple[str, ...]) -> bool:
        kind = self._taint_of(node)
        return kind is not None and (kind == _ANY or kind in kinds)

    def _check_sink(self, call: ast.Call) -> None:
        name = dotted_name(call.func) or ""
        short = _short(name)
        args = call.args
        if not args:
            return
        # int sinks: allocation / iteration sized by the wire
        if (short in _INT_SINK_CALLS or name in _INT_SINK_CALLS
                or (short in _NP_ALLOC and "." in name)):
            for arg in args[:2]:
                if self._is_live(arg, (_INT,)):
                    self._flag_int(call, arg)
                    return
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _INT_SINK_METHODS:
            if self._is_live(args[0], (_INT,)):
                self._flag_int(call, args[0])
                return
        # path sinks
        if name in _PATH_SINK_CALLS or short in ("Path",):
            if self._is_live(args[0], (_STR,)):
                self._flag_path(call, args[0])
                return
        if name in _PATH_JOIN_CALLS:
            for arg in args:
                if self._is_live(arg, (_STR,)):
                    self._flag_path(call, arg)
                    return

    def _check_multiply(self, binop: ast.BinOp) -> None:
        # [0] * n / b"\0" * n with a wire-sized n
        pairs = ((binop.left, binop.right), (binop.right, binop.left))
        for seq, count in pairs:
            literal_seq = isinstance(seq, (ast.List, ast.Tuple)) or (
                isinstance(seq, ast.Constant)
                and isinstance(seq.value, (str, bytes)))
            if literal_seq and self._is_live(count, (_INT,)):
                hint = _describe(count)
                self.findings.append(Finding(
                    "taint-unbounded-wire-int", self.relpath, binop.lineno,
                    self.qualname,
                    f"sequence repeat sized by unvalidated wire int "
                    f"{hint} in {self.qualname}: a hostile frame "
                    f"chooses the allocation size — bound it first "
                    f"(compare against a MAX_* cap and bail out)"))
                return

    def _flag_int(self, call: ast.Call, arg: ast.AST) -> None:
        sink = dotted_name(call.func) or "<call>"
        self.findings.append(Finding(
            "taint-unbounded-wire-int", self.relpath, call.lineno,
            self.qualname,
            f"{sink}({_describe(arg)}) sized by an unvalidated wire int "
            f"in {self.qualname}: a hostile frame chooses the "
            f"allocation/iteration size — bound it first (compare "
            f"against a MAX_* cap and bail out)"))

    def _flag_path(self, call: ast.Call, arg: ast.AST) -> None:
        sink = dotted_name(call.func) or "<call>"
        self.findings.append(Finding(
            "taint-wire-str-in-path", self.relpath, call.lineno,
            self.qualname,
            f"{sink}(...{_describe(arg)}...) builds a filesystem path "
            f"from an unvalidated wire string in {self.qualname}: a "
            f"hostile frame traverses the filesystem — allowlist or "
            f"os.path.basename() it first"))


def _describe(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    name = dotted_name(node)
    return name if name else "<expr>"


def run_project(graph: ProjectGraph) -> List[Finding]:
    findings: List[Finding] = []
    for fn in graph.functions():
        body = list(getattr(fn.node, "body", []))
        if not body:
            continue
        checker = _FunctionTaint(fn.module.relpath, fn.qualname, body)
        findings.extend(checker.run())
    return findings
