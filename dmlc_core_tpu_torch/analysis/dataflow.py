"""The dataflow engine under the interprocedural passes (pass 8+).

The graph core answers "who calls whom"; this module answers "what
happens to a value along every path through one function" — including the
paths the per-file passes cannot see: the exception edge out of every
statement that can raise.  A resource acquired on line 10 and released on
line 14 is leak-free only if nothing between them can raise, or the raise
lands in a handler/``finally``/``with`` that still releases — exactly the
property a statement-level CFG with exception edges makes checkable.

What is built, per function:

- a **statement-level CFG**: one node per simple statement, with normal
  edges (sequence, branch, loop) and **exception edges** from every
  statement that can raise to the innermost handler — or to the
  function's exceptional exit when no catch-all handler encloses it;
- ``try``/``finally`` and ``with`` are modeled with their real edge
  semantics: a ``finally`` body is instantiated once per entry mode
  (normal fall-through, exception propagation, ``return``/``break``/
  ``continue`` jump), so states never smear between modes; a ``with``
  statement contributes a synthetic exit node on both the normal and the
  exception edge (that is what makes ``with`` safe by construction);
- a generic **forward may-analysis** (:func:`run_forward`): the client
  pass supplies per-statement transfer functions returning separate
  normal-edge and exception-edge output states; the engine iterates to a
  fixpoint and exposes the joined state at every node and at the three
  exits (normal return, exceptional, and each node's contribution).

Soundness caveats (inherited by every pass built on top; see
CATALOG.md): the raise model is syntactic — a statement "can raise"
when it contains a call (logging-family calls exempt), subscript, raise,
or assert; ``except Exception``/``BaseException``/bare are treated as
catch-alls (an async ``KeyboardInterrupt`` between acquire and handler is
out of scope); aliasing through containers and attribute round-trips is
invisible.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from dmlc_core_tpu_torch.analysis.driver import dotted_name

__all__ = ["CFG", "Node", "build_cfg", "run_forward", "stmt_can_raise",
           "WITH_EXIT"]

# marker object: a node whose ``stmt`` is (WITH_EXIT, with_node) runs the
# __exit__ of every context manager of ``with_node`` — the client's
# transfer function applies the releases there
WITH_EXIT = "with-exit"

# calls that are contractually non-raising for the purposes of the raise
# model: the logging family swallows handler errors by design, and
# treating every ``logger.info`` between acquire and release as a leak
# edge would drown the signal (documented soundness tradeoff)
_NONRAISING_ROOTS = {"logger", "logging", "warnings"}
_NONRAISING_PREFIXES = ("log_",)


class Node:
    """One CFG node.  ``stmt`` is the AST statement (or a (WITH_EXIT, n)
    pair, or None for entry/exit); ``succ`` are normal-edge successor ids,
    ``exc_succ`` exception-edge successor ids."""

    __slots__ = ("idx", "stmt", "succ", "exc_succ")

    def __init__(self, idx: int, stmt) -> None:
        self.idx = idx
        self.stmt = stmt
        self.succ: List[int] = []
        self.exc_succ: List[int] = []


class CFG:
    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.entry = self._new(None)
        self.exit = self._new(None)        # normal return / fall-off
        self.raise_exit = self._new(None)  # an exception leaves the function

    def _new(self, stmt) -> int:
        node = Node(len(self.nodes), stmt)
        self.nodes.append(node)
        return node.idx

    def add(self, stmt) -> int:
        return self._new(stmt)

    def edge(self, a: int, b: int) -> None:
        if b not in self.nodes[a].succ:
            self.nodes[a].succ.append(b)

    def exc_edge(self, a: int, b: int) -> None:
        if b not in self.nodes[a].exc_succ:
            self.nodes[a].exc_succ.append(b)


def _call_is_nonraising(call: ast.Call) -> bool:
    name = dotted_name(call.func) or ""
    root = name.split(".")[0]
    short = name.rsplit(".", 1)[-1]
    return (root in _NONRAISING_ROOTS
            or any(short.startswith(p) for p in _NONRAISING_PREFIXES))


def stmt_can_raise(stmt: ast.AST) -> bool:
    """Syntactic raise model: calls (minus the logging family), explicit
    raise/assert, and subscripts can raise; plain name/attribute moves and
    type annotations cannot.  Nested function/class bodies execute at
    their own call time — a ``def`` statement only evaluates its
    decorators and argument defaults."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        roots: List[ast.AST] = list(getattr(stmt, "decorator_list", []))
        args = getattr(stmt, "args", None)
        if args is not None:
            roots += list(args.defaults) + [d for d in args.kw_defaults
                                            if d is not None]
        roots += list(getattr(stmt, "bases", []))
        return any(stmt_can_raise(r) for r in roots)
    stack = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)) and node is not stmt:
            continue
        if isinstance(node, ast.AnnAssign):
            # the annotation itself never runs user code worth modeling
            stack.append(node.target)
            if node.value is not None:
                stack.append(node.value)
            continue
        if isinstance(node, (ast.Raise, ast.Assert, ast.Subscript,
                             ast.Await)):
            return True
        if isinstance(node, ast.Call) and not _call_is_nonraising(node):
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


def _is_catch_all(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    names: List[str] = []
    if isinstance(handler.type, ast.Tuple):
        names = [dotted_name(e) or "" for e in handler.type.elts]
    else:
        names = [dotted_name(handler.type) or ""]
    return any(n.rsplit(".", 1)[-1] in ("Exception", "BaseException")
               for n in names)


class _Frame:
    """One enclosing ``try``-with-``finally`` or ``with`` an abrupt jump
    (return/break/continue) must run on its way out."""

    __slots__ = ("kind", "payload", "exc_target")

    def __init__(self, kind: str, payload, exc_target: int) -> None:
        self.kind = kind          # "finally" | "with"
        self.payload = payload    # stmt list | With node
        self.exc_target = exc_target  # exc target OUTSIDE this frame


class _Builder:
    def __init__(self, cfg: CFG, can_raise: Callable[[ast.AST], bool]):
        self.cfg = cfg
        self.can_raise = can_raise

    # -- plumbing -------------------------------------------------------------

    def _link(self, preds: Sequence[int], node: int) -> None:
        for p in preds:
            self.cfg.edge(p, node)

    def _unwind(self, preds: List[int], frames: List[_Frame],
                upto: int) -> List[int]:
        """Run the finally/with frames above depth ``upto`` (innermost
        first) for an abrupt jump; returns the preds after the unwind."""
        for frame in reversed(frames[upto:]):
            if frame.kind == "with":
                node = self.cfg.add((WITH_EXIT, frame.payload))
                self._link(preds, node)
                preds = [node]
            else:
                preds = self._emit_block(frame.payload, preds,
                                         frame.exc_target, None, [],
                                         frames_base=0)
        return preds

    # -- statement emission ---------------------------------------------------

    def _emit_stmt(self, stmt: ast.AST, preds: List[int], exc: int,
                   loop: Optional[Tuple[int, int, int]],
                   frames: List[_Frame], frames_base: int) -> List[int]:
        cfg = self.cfg
        if isinstance(stmt, ast.Return):
            node = cfg.add(stmt)
            self._link(preds, node)
            if self.can_raise(stmt):
                cfg.exc_edge(node, exc)
            out = self._unwind([node], frames, frames_base)
            self._link(out, cfg.exit)
            return []
        if isinstance(stmt, ast.Raise):
            node = cfg.add(stmt)
            self._link(preds, node)
            cfg.exc_edge(node, exc)
            return []
        if isinstance(stmt, (ast.Break, ast.Continue)):
            node = cfg.add(stmt)
            self._link(preds, node)
            if loop is not None:
                head, after, loop_base = loop
                out = self._unwind([node], frames, loop_base)
                self._link(out, after if isinstance(stmt, ast.Break)
                           else head)
            return []
        if isinstance(stmt, (ast.If,)):
            test = cfg.add(stmt)  # the test expression evaluates here
            self._link(preds, test)
            if self.can_raise(stmt.test):
                cfg.exc_edge(test, exc)
            out = self._emit_block(stmt.body, [test], exc, loop, frames,
                                   frames_base)
            if stmt.orelse:
                out += self._emit_block(stmt.orelse, [test], exc, loop,
                                        frames, frames_base)
            else:
                out += [test]
            return out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            head = cfg.add(stmt)  # test / next(iter) evaluates here
            self._link(preds, head)
            header_raises = (self.can_raise(stmt.test)
                             if isinstance(stmt, ast.While)
                             else True)  # iteration can always raise
            if header_raises:
                cfg.exc_edge(head, exc)
            after = cfg.add(None)  # loop exit join point
            body_out = self._emit_block(
                stmt.body, [head], exc,
                (head, after, len(frames)), frames, frames_base)
            self._link(body_out, head)  # back edge
            self._link([head], after)   # loop condition false / exhausted
            if stmt.orelse:
                return self._emit_block(stmt.orelse, [after], exc, loop,
                                        frames, frames_base)
            return [after]
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            # context expressions evaluate unprotected, left to right
            node = cfg.add(stmt)
            self._link(preds, node)
            if any(self.can_raise(item.context_expr)
                   for item in stmt.items):
                cfg.exc_edge(node, exc)
            # exception inside the body runs __exit__ then propagates
            exc_exit = cfg.add((WITH_EXIT, stmt))
            cfg.edge(exc_exit, exc)
            frames.append(_Frame("with", stmt, exc))
            body_out = self._emit_block(stmt.body, [node], exc_exit, loop,
                                        frames, frames_base)
            frames.pop()
            norm_exit = cfg.add((WITH_EXIT, stmt))
            self._link(body_out, norm_exit)
            return [norm_exit]
        if isinstance(stmt, ast.Try):
            return self._emit_try(stmt, preds, exc, loop, frames,
                                  frames_base)
        # simple statement (incl. nested def/class: binding only)
        node = cfg.add(stmt)
        self._link(preds, node)
        if self.can_raise(stmt):
            cfg.exc_edge(node, exc)
        return [node]

    def _emit_try(self, stmt: ast.Try, preds: List[int], exc: int,
                  loop: Optional[Tuple[int, int, int]],
                  frames: List[_Frame], frames_base: int) -> List[int]:
        cfg = self.cfg
        has_finally = bool(stmt.finalbody)
        # where an exception that the handlers do not catch goes: through
        # the finally (exceptional instance) to the outer target
        if has_finally:
            fin_exc_entry = cfg.add(None)
            fin_exc_out = self._emit_block(stmt.finalbody, [fin_exc_entry],
                                           exc, None, [], 0)
            self._link(fin_exc_out, exc)
            unhandled = fin_exc_entry
            frames.append(_Frame("finally", stmt.finalbody, exc))
        else:
            unhandled = exc

        # exception dispatch point for the body: every handler may match,
        # and unless one is a catch-all the exception may also escape
        dispatch = cfg.add(None)
        if any(_is_catch_all(h) for h in stmt.handlers):
            pass
        else:
            cfg.edge(dispatch, unhandled)

        body_out = self._emit_block(stmt.body, preds, dispatch, loop,
                                    frames, frames_base)
        if stmt.orelse:
            body_out = self._emit_block(stmt.orelse, body_out, dispatch,
                                        loop, frames, frames_base)

        handler_outs: List[int] = []
        for handler in stmt.handlers:
            # the handler body's own exceptions go through the finally to
            # the OUTER target
            handler_outs += self._emit_block(handler.body, [dispatch],
                                             unhandled, loop, frames,
                                             frames_base)
        if has_finally:
            frames.pop()
            fin_entry = cfg.add(None)
            self._link(body_out, fin_entry)
            self._link(handler_outs, fin_entry)
            return self._emit_block(stmt.finalbody, [fin_entry], exc,
                                    loop, frames, frames_base)
        return body_out + handler_outs

    def _emit_block(self, stmts: Sequence[ast.AST], preds: List[int],
                    exc: int, loop, frames: List[_Frame],
                    frames_base: int) -> List[int]:
        for stmt in stmts:
            preds = self._emit_stmt(stmt, list(preds), exc, loop, frames,
                                    frames_base)
            if not preds:
                break  # return/raise/break/continue ended the block
        return preds


def build_cfg(fn_node: ast.AST,
              can_raise: Callable[[ast.AST], bool] = stmt_can_raise) -> CFG:
    """CFG for one function body.  ``can_raise`` is the raise model —
    override to tighten/loosen which statements get exception edges."""
    cfg = CFG()
    builder = _Builder(cfg, can_raise)
    body = fn_node.body if isinstance(fn_node.body, list) else [fn_node.body]
    out = builder._emit_block(body, [cfg.entry], cfg.raise_exit, None,
                              [], 0)
    builder._link(out, cfg.exit)
    return cfg


def run_forward(cfg: CFG, init, transfer, join):
    """Forward may-analysis to fixpoint.

    ``init`` is the entry state; ``transfer(node, state) -> (normal_out,
    exc_out)`` applies one node's effect (exc_out flows along exception
    edges — release statements report their post-state there, acquisitions
    their pre-state, so a failing ``close()`` still counts as released and
    a failing ``open()`` never counts as acquired); ``join(a, b) -> state``
    merges states at join points.  Returns ``{node_idx: in_state}``.
    """
    in_states: Dict[int, object] = {cfg.entry: init}
    work: List[int] = [cfg.entry]
    seen_order: Set[int] = {cfg.entry}
    while work:
        idx = work.pop(0)
        seen_order.discard(idx)
        node = cfg.nodes[idx]
        state = in_states.get(idx)
        if state is None:
            continue
        normal_out, exc_out = transfer(node, state)
        for succ, out in ([(s, normal_out) for s in node.succ]
                          + [(s, exc_out) for s in node.exc_succ]):
            prev = in_states.get(succ)
            merged = out if prev is None else join(prev, out)
            if prev is None or merged != prev:
                in_states[succ] = merged
                if succ not in seen_order:
                    seen_order.add(succ)
                    work.append(succ)
    return in_states
