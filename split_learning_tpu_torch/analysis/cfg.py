"""Statement-level intraprocedural CFG for slt-lint (rule SLT002).

Small on purpose: the one question the claim-pairing rule asks is "from
the statement that claims a replay slot, can control reach function
exit without passing a resolve/fail/wait barrier?" — so the graph only
needs the control constructs the runtime actually uses:

* ``if``/``while``/``for`` with branch edges labeled by their test
  expression (the rule prunes infeasible ``claim is None`` branches),
* ``try``/``except``: every statement lexically inside a try body gets
  an exceptional edge to each handler; an exception is assumed
  contained iff some handler is bare / ``Exception`` / ``BaseException``,
  otherwise it also escapes past the try,
* ``finally``: duplicated per exit class (normal completion and each
  abrupt exit routes through its own copy of the finally subgraph, then
  continues to wherever it was going) — the textbook way to keep "the
  finally runs on every path" without interprocedural machinery,
* ``return`` / ``raise`` / ``break`` / ``continue`` routed through
  enclosing finallies to their targets.

Calls are assumed non-raising unless lexically inside a ``try`` — the
rule wants "did you *write* the exception path", not a whole-program
exception analysis.

Edges carry a tag: ``None`` for plain flow, ``("branch", test, taken)``
out of a conditional, ``("exc",)`` for exceptional flow.
"""

from __future__ import annotations

import ast
from typing import Any, List, Optional, Tuple

Edge = Tuple["Node", Optional[Tuple[Any, ...]]]


class Node:
    """One statement (or a synthetic entry/exit point)."""

    __slots__ = ("stmt", "succs", "label")

    def __init__(self, stmt: Optional[ast.stmt], label: str = "") -> None:
        self.stmt = stmt
        self.succs: List[Edge] = []
        self.label = label

    def __repr__(self) -> str:
        what = self.label or (type(self.stmt).__name__ if self.stmt else "?")
        line = getattr(self.stmt, "lineno", "-")
        return f"<Node {what}@{line}>"


class CFG:
    __slots__ = ("entry", "exit", "nodes")

    def __init__(self, entry: Node, exit_node: Node,
                 nodes: List[Node]) -> None:
        self.entry = entry
        self.exit = exit_node
        self.nodes = nodes

    def nodes_for(self, stmt: ast.stmt) -> List[Node]:
        """All nodes carrying ``stmt`` (finally duplication means a
        statement can appear more than once)."""
        return [n for n in self.nodes if n.stmt is stmt]


_CONTAINS_ALL = ("Exception", "BaseException")
_TRY_TYPES = (ast.Try, ast.TryStar) if hasattr(ast, "TryStar") else (ast.Try,)


def _catches_all(handlers: List[ast.ExceptHandler]) -> bool:
    for h in handlers:
        if h.type is None:
            return True
        t = h.type
        if isinstance(t, ast.Name) and t.id in _CONTAINS_ALL:
            return True
        if isinstance(t, ast.Attribute) and t.attr in _CONTAINS_ALL:
            return True
    return False


class _Frame:
    """Base context frame: routing for abrupt exits and the may-raise
    edges of ordinary statements."""

    def __init__(self, parent: Optional["_Frame"]) -> None:
        self.parent = parent

    def route(self, kind: str, ends: List[Tuple[Node, Any]],
              b: "_Builder") -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def may_raise_targets(self) -> bool:
        """Whether a plain statement under this frame chain should get
        exceptional out-edges at all."""
        f: Optional[_Frame] = self
        while f is not None:
            if isinstance(f, (_TryFrame, _FinallyFrame)):
                return True
            f = f.parent
        return False


class _RootFrame(_Frame):
    def __init__(self, exit_node: Node) -> None:
        super().__init__(None)
        self._exit = exit_node

    def route(self, kind, ends, b):
        for node, cond in ends:
            b.edge(node, self._exit, cond)


class _TryFrame(_Frame):
    """Routes ``raise`` into the handlers (and past them when no
    handler is guaranteed to match)."""

    def __init__(self, parent: _Frame, handler_entries: List[Node],
                 contains: bool) -> None:
        super().__init__(parent)
        self._handlers = handler_entries
        self._contains = contains

    def route(self, kind, ends, b):
        if kind != "raise":
            self.parent.route(kind, ends, b)
            return
        for node, _cond in ends:
            for h in self._handlers:
                b.edge(node, h, ("exc",))
        if not self._contains:
            self.parent.route(kind, ends, b)


class _FinallyFrame(_Frame):
    """Every exit class through this frame executes its own duplicate
    of the finally body, then resumes the original exit."""

    def __init__(self, parent: _Frame, finalbody: List[ast.stmt]) -> None:
        super().__init__(parent)
        self._finalbody = finalbody

    def route(self, kind, ends, b):
        ends = [e for e in ends if e[0] is not None]
        if not ends:
            return
        entry, fin_ends = b.seq(self._finalbody, self.parent)
        if entry is None:  # empty finally (can't happen in valid python)
            self.parent.route(kind, ends, b)
            return
        for node, cond in ends:
            b.edge(node, entry, cond)
        self.parent.route(kind, fin_ends, b)


class _LoopFrame(_Frame):
    def __init__(self, parent: _Frame, head: Node) -> None:
        super().__init__(parent)
        self.head = head
        self.breaks: List[Tuple[Node, Any]] = []

    def route(self, kind, ends, b):
        if kind == "continue":
            for node, cond in ends:
                b.edge(node, self.head, cond)
        elif kind == "break":
            self.breaks.extend(ends)
        else:
            self.parent.route(kind, ends, b)


def _is_true_const(test: ast.expr) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value) is True


class _Builder:
    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.exit = self.new(None, "EXIT")

    def new(self, stmt: Optional[ast.stmt], label: str = "") -> Node:
        n = Node(stmt, label)
        self.nodes.append(n)
        return n

    def edge(self, a: Node, b_node: Node, cond: Any = None) -> None:
        a.succs.append((b_node, cond))

    # ------------------------------------------------------------------ #

    def seq(self, stmts: List[ast.stmt], frame: _Frame
            ) -> Tuple[Optional[Node], List[Tuple[Node, Any]]]:
        """Build a statement sequence; returns (entry, normal ends)
        where ends are (node, pending-edge-condition) pairs awaiting
        their successor."""
        entry: Optional[Node] = None
        ends: List[Tuple[Node, Any]] = []
        for stmt in stmts:
            s_entry, s_ends = self.stmt(stmt, frame)
            if s_entry is None:
                continue
            if entry is None:
                entry = s_entry
            for node, cond in ends:
                self.edge(node, s_entry, cond)
            ends = s_ends
        return entry, ends

    def stmt(self, stmt: ast.stmt, frame: _Frame
             ) -> Tuple[Optional[Node], List[Tuple[Node, Any]]]:
        if isinstance(stmt, ast.If):
            return self._if(stmt, frame)
        if isinstance(stmt, (ast.While,)):
            return self._while(stmt, frame)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._for(stmt, frame)
        if isinstance(stmt, _TRY_TYPES):
            return self._try(stmt, frame)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._with(stmt, frame)
        if isinstance(stmt, ast.Return):
            node = self.new(stmt)
            frame.route("return", [(node, None)], self)
            return node, []
        if isinstance(stmt, ast.Raise):
            node = self.new(stmt)
            frame.route("raise", [(node, None)], self)
            return node, []
        if isinstance(stmt, ast.Break):
            node = self.new(stmt)
            frame.route("break", [(node, None)], self)
            return node, []
        if isinstance(stmt, ast.Continue):
            node = self.new(stmt)
            frame.route("continue", [(node, None)], self)
            return node, []
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # nested defs don't execute their bodies here
            node = self.new(stmt)
            return node, [(node, None)]
        # simple statement
        node = self.new(stmt)
        if frame.may_raise_targets():
            frame.route("raise", [(node, None)], self)
        return node, [(node, None)]

    # ------------------------------------------------------------------ #

    def _if(self, stmt: ast.If, frame: _Frame):
        head = self.new(stmt, "if")
        if frame.may_raise_targets():
            frame.route("raise", [(head, None)], self)
        ends: List[Tuple[Node, Any]] = []
        t_entry, t_ends = self.seq(stmt.body, frame)
        if t_entry is not None:
            self.edge(head, t_entry, ("branch", stmt.test, True))
            ends.extend(t_ends)
        else:
            ends.append((head, ("branch", stmt.test, True)))
        f_entry, f_ends = self.seq(stmt.orelse, frame)
        if f_entry is not None:
            self.edge(head, f_entry, ("branch", stmt.test, False))
            ends.extend(f_ends)
        else:
            ends.append((head, ("branch", stmt.test, False)))
        return head, ends

    def _while(self, stmt: ast.While, frame: _Frame):
        head = self.new(stmt, "while")
        if frame.may_raise_targets():
            frame.route("raise", [(head, None)], self)
        loop = _LoopFrame(frame, head)
        b_entry, b_ends = self.seq(stmt.body, loop)
        if b_entry is not None:
            self.edge(head, b_entry, ("branch", stmt.test, True))
            for node, cond in b_ends:
                self.edge(node, head, cond)
        ends: List[Tuple[Node, Any]] = list(loop.breaks)
        if not _is_true_const(stmt.test):
            ends.append((head, ("branch", stmt.test, False)))
        e_entry, e_ends = self.seq(stmt.orelse, frame)
        if e_entry is not None:
            # normal loop exit runs the else clause first
            exit_ends = [e for e in ends if e[0] is head]
            ends = [e for e in ends if e[0] is not head] + list(e_ends)
            for node, cond in exit_ends:
                self.edge(node, e_entry, cond)
        return head, ends

    def _for(self, stmt, frame: _Frame):
        head = self.new(stmt, "for")
        if frame.may_raise_targets():
            frame.route("raise", [(head, None)], self)
        loop = _LoopFrame(frame, head)
        b_entry, b_ends = self.seq(stmt.body, loop)
        if b_entry is not None:
            self.edge(head, b_entry, None)
            for node, cond in b_ends:
                self.edge(node, head, cond)
        ends: List[Tuple[Node, Any]] = list(loop.breaks)
        ends.append((head, None))  # iterator exhausted
        e_entry, e_ends = self.seq(stmt.orelse, frame)
        if e_entry is not None:
            exhausted = [e for e in ends if e[0] is head]
            ends = [e for e in ends if e[0] is not head] + list(e_ends)
            for node, cond in exhausted:
                self.edge(node, e_entry, cond)
        return head, ends

    def _with(self, stmt, frame: _Frame):
        head = self.new(stmt, "with")
        if frame.may_raise_targets():
            frame.route("raise", [(head, None)], self)
        b_entry, b_ends = self.seq(stmt.body, frame)
        if b_entry is not None:
            self.edge(head, b_entry, None)
            return head, b_ends
        return head, [(head, None)]

    def _try(self, stmt, frame: _Frame):
        if stmt.finalbody:
            frame = _FinallyFrame(frame, stmt.finalbody)

        handler_entries: List[Node] = []
        handler_ends: List[Tuple[Node, Any]] = []
        for h in stmt.handlers:
            h_node = self.new(h, "except")  # binding/matching point
            h_entry, h_ends = self.seq(h.body, frame)
            if h_entry is not None:
                self.edge(h_node, h_entry, None)
                handler_ends.extend(h_ends)
            else:
                handler_ends.append((h_node, None))
            handler_entries.append(h_node)

        body_frame = _TryFrame(frame, handler_entries,
                               _catches_all(stmt.handlers))
        b_entry, b_ends = self.seq(stmt.body, body_frame)
        e_entry, e_ends = self.seq(stmt.orelse, frame)
        if e_entry is not None:
            for node, cond in b_ends:
                self.edge(node, e_entry, cond)
            b_ends = e_ends

        normal_ends = list(b_ends) + list(handler_ends)
        head = b_entry
        if head is None:  # empty try body
            head = self.new(None, "try")
            normal_ends.append((head, None))

        if stmt.finalbody:
            # normal completion path gets its own copy of the finally
            f_entry, f_ends = self.seq(stmt.finalbody, frame.parent)
            if f_entry is not None:
                for node, cond in normal_ends:
                    self.edge(node, f_entry, cond)
                normal_ends = f_ends
        return head, normal_ends


def build(fn: ast.AST) -> CFG:
    """CFG for one ``FunctionDef``/``AsyncFunctionDef`` body."""
    b = _Builder()
    root = _RootFrame(b.exit)
    entry, ends = b.seq(list(fn.body), root)
    if entry is None:
        entry = b.exit
    root.route("fall", ends, b)
    return CFG(entry, b.exit, b.nodes)
