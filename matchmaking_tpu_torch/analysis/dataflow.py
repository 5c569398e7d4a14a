"""Per-function control-flow graphs + a fixed-point dataflow engine.

matchlint's first rules are lexical AST scans: they can say "this call
sits inside that ``with`` block" but not "this call happens AFTER that one
on SOME path".  The exactly-once settlement typestate (lifecycle.py) and
the donated-buffer audit (device_audit.py) need real path reasoning —
"an exception edge between admission and ``_ack`` leaks a credit" is a
statement about a PATH, not a position.  This module is the shared
substrate: a statement-level CFG for (async) Python plus a small worklist
fixed-point engine over a client-supplied abstract domain.

CFG shape
---------

One node per simple statement (plus synthetic ENTRY / EXIT / RAISE nodes).
Compound statements contribute their header expression as a node and
structure the edges:

- ``if`` / ``while`` headers fork with ``true`` / ``false`` edge labels
  (clients may refine state per branch — the settlement rule uses the
  ``if not window: return`` emptiness shape);
- ``for`` headers fork ``iter`` (into the body, binding the target each
  iteration) / ``exhausted``; ``break`` / ``continue`` / ``else`` wired;
- ``try``: body statements get an exception edge to the handler-dispatch
  point; dispatch fans out to every handler entry and — when no handler
  is broad (bare / ``Exception`` / ``BaseException``) — onward to the
  enclosing handler or the RAISE exit.  ``finally`` bodies are built once
  and exit both ways (normal continuation + exception propagation): a
  conservative merge, never a dropped path;
- every statement containing a ``Call``, ``Await`` or ``Raise`` "may
  raise" and gets an exception edge to the innermost enclosing handler
  (``await`` is an implicit exception edge by construction —
  ``CancelledError`` can surface at any suspension point);
- ``return`` edges to EXIT, ``raise`` to the handler chain / RAISE.

The engine is a standard forward worklist solver: states live on EDGES
into nodes, the client's transfer function maps (node, in-state) →
out-state per edge kind, and join is the client's lattice join.  States
are dicts var→value; functions here are small (tens of statements), so
convergence is a handful of passes.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Callable, Iterable

# Edge kinds.
NORM = "norm"        # ordinary fallthrough / branch
EXC = "exc"          # exception raised by the source node
TRUE = "true"        # branch taken (if/while test is truthy)
FALSE = "false"      # branch not taken
ITER = "iter"        # for-loop: another element, target (re)bound
EXHAUSTED = "exhausted"  # for-loop: iterator empty

#: Handler breadth classes for exception-edge routing.
_BROAD_HANDLERS = {"Exception", "BaseException"}


@dataclasses.dataclass
class Node:
    """One CFG node: an AST statement (or header expression), or a
    synthetic marker for entry/exit."""

    idx: int
    stmt: ast.AST | None          # None for synthetic nodes
    kind: str                     # "stmt" | "entry" | "exit" | "raise"
    succ: list[tuple[int, str]] = dataclasses.field(default_factory=list)

    @property
    def lineno(self) -> int:
        return getattr(self.stmt, "lineno", 0)


class CFG:
    """Control-flow graph of one function body."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.nodes: list[Node] = []
        self.entry = self._new(None, "entry")
        self.exit = self._new(None, "exit")
        self.raise_exit = self._new(None, "raise")
        builder = _Builder(self)
        last = builder.build_body(list(fn.body), self.entry.idx)
        for n in last:
            self._edge(n, self.exit.idx, NORM)

    # ---- construction helpers ---------------------------------------------

    def _new(self, stmt: ast.AST | None, kind: str = "stmt") -> Node:
        node = Node(len(self.nodes), stmt, kind)
        self.nodes.append(node)
        return node

    def _edge(self, src: int, dst: int, kind: str) -> None:
        e = (dst, kind)
        if e not in self.nodes[src].succ:
            self.nodes[src].succ.append(e)

    # ---- queries ----------------------------------------------------------

    def preds(self) -> dict[int, list[tuple[int, str]]]:
        out: dict[int, list[tuple[int, str]]] = {n.idx: [] for n in self.nodes}
        for n in self.nodes:
            for dst, kind in n.succ:
                out[dst].append((n.idx, kind))
        return out


def header_exprs(stmt: ast.AST) -> list[ast.AST]:
    """The sub-expressions a CFG node for ``stmt`` actually evaluates
    (compound statements contribute their HEADER only — their bodies are
    separate nodes; nested defs/classes are opaque).  Shared by every
    client transfer function so event extraction and the exception-edge
    model agree on what a node executes."""
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    return [stmt]


def iter_functions(tree: ast.Module):
    """(class name or '', function node) for every def, outermost only
    (nested defs are opaque to the CFG)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield "", node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield node.name, item


def may_raise(stmt: ast.AST) -> bool:
    """Could executing THIS NODE surface an exception?  Only the
    statement's header expressions count (a branch whose BODY contains a
    call must not get an exception edge at the header — the body nodes
    carry their own).  Any call or suspension point can raise (``await``
    is where CancelledError lands); so can an explicit ``raise`` and
    ``assert``.  Plain name/constant plumbing cannot, for our purposes —
    attribute/subscript reads are treated as non-raising to keep the
    exception graph focused on the edges that matter (the credit leak
    comments all name calls)."""
    for expr in header_exprs(stmt):
        for sub in ast.walk(expr):
            if isinstance(sub, (ast.Call, ast.Await, ast.Raise, ast.Assert,
                                ast.Yield, ast.YieldFrom)):
                return True
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break  # opaque nested scope: runs when called, not here
    return False


class _Frame:
    """One enclosing construct the builder threads break/continue/raise
    targets through."""

    __slots__ = ("kind", "exc_target", "break_targets", "continue_target")

    def __init__(self, kind: str, exc_target: int | None = None,
                 continue_target: int | None = None):
        self.kind = kind                      # "try" | "loop"
        self.exc_target = exc_target          # handler-dispatch node idx
        self.break_targets: list[int] = []    # nodes that break (to after)
        self.continue_target = continue_target


class _Builder:
    def __init__(self, cfg: CFG):
        self.cfg = cfg
        self._frames: list[_Frame] = []

    # The node an exception raised "here" flows to.
    def _exc_target(self) -> int:
        for fr in reversed(self._frames):
            if fr.kind == "try" and fr.exc_target is not None:
                return fr.exc_target
        return self.cfg.raise_exit.idx

    def _loop(self) -> _Frame | None:
        for fr in reversed(self._frames):
            if fr.kind == "loop":
                return fr
        return None

    def build_body(self, body: list[ast.stmt],
                   *preds: int) -> list[int]:
        """Wire ``body`` after ``preds``; returns the open (fallthrough)
        node ids."""
        current = list(preds)
        for stmt in body:
            current = self._build_stmt(stmt, current)
            if not current:
                break  # unreachable rest (return/raise/continue/break)
        return current

    def _link(self, preds: Iterable[int], node: Node,
              kind: str = NORM) -> None:
        for p in preds:
            self.cfg._edge(p, node.idx, kind)

    def _stmt_node(self, stmt: ast.AST, preds: Iterable[int],
                   kind: str = NORM) -> Node:
        node = self.cfg._new(stmt)
        self._link(preds, node, kind)
        if may_raise(stmt):
            self.cfg._edge(node.idx, self._exc_target(), EXC)
        return node

    def _build_stmt(self, stmt: ast.stmt, preds: list[int]) -> list[int]:
        if not preds:
            return []
        if isinstance(stmt, (ast.If,)):
            return self._build_if(stmt, preds)
        if isinstance(stmt, (ast.While,)):
            return self._build_while(stmt, preds)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._build_for(stmt, preds)
        if isinstance(stmt, ast.Try):
            return self._build_try(stmt, preds)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            node = self._stmt_node(stmt, preds)  # item setup may raise
            return self.build_body(list(stmt.body), node.idx)
        if isinstance(stmt, ast.Return):
            node = self._stmt_node(stmt, preds)
            self.cfg._edge(node.idx, self.cfg.exit.idx, NORM)
            return []
        if isinstance(stmt, ast.Raise):
            node = self.cfg._new(stmt)
            self._link(preds, node)
            self.cfg._edge(node.idx, self._exc_target(), EXC)
            return []
        if isinstance(stmt, ast.Break):
            node = self.cfg._new(stmt)
            self._link(preds, node)
            loop = self._loop()
            if loop is not None:
                loop.break_targets.append(node.idx)
            return []
        if isinstance(stmt, ast.Continue):
            node = self.cfg._new(stmt)
            self._link(preds, node)
            loop = self._loop()
            if loop is not None and loop.continue_target is not None:
                self.cfg._edge(node.idx, loop.continue_target, NORM)
            return []
        # Nested defs/classes: opaque single nodes (their bodies run when
        # CALLED; the enclosing function's flow just binds a name).
        return [self._stmt_node(stmt, preds).idx]

    def _build_if(self, stmt: ast.If, preds: list[int]) -> list[int]:
        head = self._stmt_node(stmt, preds)
        after: list[int] = []
        body_open = self.build_body(list(stmt.body), head.idx)
        # Re-kind the edge into the first body node as TRUE for branch
        # refinement (the edge was created NORM by build_body's link).
        self._rekind(head.idx, stmt.body, TRUE)
        after.extend(body_open)
        if stmt.orelse:
            else_open = self.build_body(list(stmt.orelse), head.idx)
            self._rekind(head.idx, stmt.orelse, FALSE)
            after.extend(else_open)
        else:
            # Fallthrough when the test is false: label it so refiners see
            # the polarity (a synthetic join node keeps labels per edge).
            join = self.cfg._new(None, "stmt")
            self.cfg._edge(head.idx, join.idx, FALSE)
            after.append(join.idx)
        return after

    def _rekind(self, head: int, body: list[ast.stmt], kind: str) -> None:
        """Rewrite the head→first-body-node edge kind (build_body linked it
        NORM)."""
        if not body:
            return
        first_line = body[0]
        for i, (dst, k) in enumerate(self.cfg.nodes[head].succ):
            if (k == NORM and self.cfg.nodes[dst].stmt is first_line):
                self.cfg.nodes[head].succ[i] = (dst, kind)
                return
            # Compound first statements create their own node wrapping the
            # same AST object, so identity match still holds.

    def _build_while(self, stmt: ast.While, preds: list[int]) -> list[int]:
        head = self._stmt_node(stmt, preds)
        frame = _Frame("loop", continue_target=head.idx)
        self._frames.append(frame)
        body_open = self.build_body(list(stmt.body), head.idx)
        self._rekind(head.idx, stmt.body, TRUE)
        self._frames.pop()
        for n in body_open:
            self.cfg._edge(n, head.idx, NORM)   # loop back
        after: list[int] = []
        if stmt.orelse:
            after.extend(self.build_body(list(stmt.orelse), head.idx))
            self._rekind(head.idx, stmt.orelse, FALSE)
        else:
            join = self.cfg._new(None, "stmt")
            self.cfg._edge(head.idx, join.idx, FALSE)
            after.append(join.idx)
        after.extend(frame.break_targets)
        return after

    def _build_for(self, stmt: ast.For | ast.AsyncFor,
                   preds: list[int]) -> list[int]:
        head = self._stmt_node(stmt, preds)   # iterator setup may raise
        frame = _Frame("loop", continue_target=head.idx)
        self._frames.append(frame)
        body_open = self.build_body(list(stmt.body), head.idx)
        self._rekind(head.idx, stmt.body, ITER)
        self._frames.pop()
        for n in body_open:
            self.cfg._edge(n, head.idx, NORM)   # next iteration
        after: list[int] = []
        if stmt.orelse:
            after.extend(self.build_body(list(stmt.orelse), head.idx))
            self._rekind(head.idx, stmt.orelse, EXHAUSTED)
        else:
            join = self.cfg._new(None, "stmt")
            self.cfg._edge(head.idx, join.idx, EXHAUSTED)
            after.append(join.idx)
        after.extend(frame.break_targets)
        return after

    def _build_try(self, stmt: ast.Try, preds: list[int]) -> list[int]:
        # Handler-dispatch point: body exceptions land here, then fan out.
        dispatch = self.cfg._new(None, "stmt")
        # finally entry exists BEFORE the handlers are built: an exception
        # raised INSIDE a handler (including a bare ``raise``) must route
        # through the finally, not past it — try/except-reraise/finally
        # with the release in the finally is the canonical balanced shape.
        fin_entry = (self.cfg._new(None, "stmt") if stmt.finalbody
                     else None)
        frame = _Frame("try", exc_target=dispatch.idx)
        self._frames.append(frame)
        body_open = self.build_body(list(stmt.body), *preds)
        self._frames.pop()
        # else runs only after a no-exception body.
        if stmt.orelse:
            body_open = self.build_body(list(stmt.orelse), *body_open)

        after: list[int] = []
        broad = False
        if fin_entry is not None:
            self._frames.append(_Frame("try", exc_target=fin_entry.idx))
        for handler in stmt.handlers:
            names = _handler_names(handler)
            if not names or names & _BROAD_HANDLERS:
                broad = True
            h_open = self.build_body(list(handler.body), dispatch.idx)
            after.extend(h_open)
        if fin_entry is not None:
            self._frames.pop()
        if not stmt.handlers:
            broad = False
        # Unmatched exceptions propagate outward (only certain when no
        # broad handler exists; a typed-handlers-only try keeps the edge —
        # the raised type is unknowable statically).
        propagate = not broad

        if stmt.finalbody:
            # The finally body is built TWICE (the textbook duplication):
            # a NORMAL-entry copy that falls through to the code after the
            # try, and an EXCEPTIONAL-entry copy — reached from handler
            # raises and the unmatched-propagate path — that can only
            # propagate outward.  Without the split, an exception path
            # would appear to "return normally" after the finally and
            # every settle-in-finally shape would read as conditionally
            # settled.
            if propagate:
                self.cfg._edge(dispatch.idx, fin_entry.idx, EXC)
            exc_open = self.build_body(list(stmt.finalbody), fin_entry.idx)
            if exc_open:
                # Synthetic re-raise point: the exception propagates AFTER
                # the finally body completed, so the outgoing EXC edge must
                # carry the finally's post-state (a release inside the
                # finally has already happened).
                reraise = self.cfg._new(None, "stmt")
                for n in exc_open:
                    self.cfg._edge(n, reraise.idx, NORM)
                self.cfg._edge(reraise.idx, self._exc_target(), EXC)
            norm_preds = list(body_open) + list(after)
            if not norm_preds:
                return []  # try/handlers never complete normally
            return self.build_body(list(stmt.finalbody), *norm_preds)
        if propagate:
            self.cfg._edge(dispatch.idx, self._exc_target(), EXC)
        return list(body_open) + after


def _handler_names(handler: ast.ExceptHandler) -> set[str]:
    """Leaf exception-class names a handler catches (empty = bare)."""
    t = handler.type
    if t is None:
        return set()
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    names = set()
    for e in elts:
        if isinstance(e, ast.Attribute):
            names.add(e.attr)
        elif isinstance(e, ast.Name):
            names.add(e.id)
    return names


# ---- fixed-point engine -----------------------------------------------------

class Analysis:
    """Client contract for :func:`solve`.

    - ``initial()`` — the entry state (a dict var→value; the engine copies
      before mutating).
    - ``transfer(node, state, cfg)`` — mutate/return the state AFTER
      executing ``node`` normally (called per visit; deterministic).
    - ``edge(node, kind, pre, post, cfg)`` — the state to propagate along
      one out-edge of ``node``, given the state BEFORE (``pre``) and AFTER
      (``post``) the node's transfer; both are private copies.  Default:
      ``post`` on normal/branch edges, ``pre`` on exception edges (the
      statement's effect did not complete when it raised).  Return None to
      kill the edge (branch-condition refinement).
    - ``join(a, b)`` — lattice join of two values (per var).
    """

    def initial(self) -> dict[str, Any]:
        return {}

    def transfer(self, node: Node, state: dict[str, Any],
                 cfg: CFG) -> dict[str, Any]:
        return state

    def edge(self, node: Node, kind: str, pre: dict[str, Any],
             post: dict[str, Any], cfg: CFG) -> dict[str, Any] | None:
        return pre if kind == EXC else post

    def join(self, a: Any, b: Any) -> Any:
        return a if a == b else None


def join_states(analysis: Analysis, a: dict[str, Any] | None,
                b: dict[str, Any]) -> tuple[dict[str, Any], bool]:
    """Join two var→value states; returns (joined, changed-vs-a)."""
    if a is None:
        return dict(b), True
    out = dict(a)
    changed = False
    for k, v in b.items():
        if k not in out:
            out[k] = v
            changed = True
        elif out[k] != v:
            j = analysis.join(out[k], v)
            if j != out[k]:
                out[k] = j
                changed = True
    return out, changed


def solve_and_report(cfg: CFG, analysis: Analysis) -> None:
    """Run ``solve`` to its fixed point, then replay transfer+edge once
    over the converged in-states with ``analysis.report = True`` — the
    shared two-phase runner for rules that must not report transient
    states mid-iteration (the client dedups via its own ``_seen`` set)."""
    in_states = solve(cfg, analysis)
    analysis.report = True  # type: ignore[attr-defined]
    for node in cfg.nodes:
        pre = in_states.get(node.idx)
        if pre is None:
            continue
        post = analysis.transfer(node, dict(pre), cfg)
        for dst, kind in node.succ:
            analysis.edge(node, kind, dict(pre), dict(post), cfg)


def solve(cfg: CFG, analysis: Analysis,
          max_passes: int = 64) -> dict[int, dict[str, Any]]:
    """Forward worklist fixed point.  Returns the IN-state per node idx
    (the join over incoming edges, before the node's transfer)."""
    in_states: dict[int, dict[str, Any]] = {cfg.entry.idx: analysis.initial()}
    work = [cfg.entry.idx]
    passes: dict[int, int] = {}
    while work:
        idx = work.pop(0)
        passes[idx] = passes.get(idx, 0) + 1
        if passes[idx] > max_passes:  # pragma: no cover - lattice is finite
            continue
        node = cfg.nodes[idx]
        pre = in_states.get(idx, analysis.initial())
        out = analysis.transfer(node, dict(pre), cfg)
        for dst, kind in node.succ:
            flowed = analysis.edge(node, kind, dict(pre), dict(out), cfg)
            if flowed is None:
                continue
            joined, changed = join_states(analysis, in_states.get(dst),
                                          flowed)
            if changed:
                in_states[dst] = joined
                if dst not in work:
                    work.append(dst)
    return in_states
