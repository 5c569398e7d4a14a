"""``settlement`` + ``lock-pairing``: flow-sensitive lifecycle typestates.

**settlement** — the exactly-once settlement contract on the request
lifecycle (service/app.py): every ``Delivery`` that takes an admission
credit must reach exactly one settlement — ``_ack`` / ``_nack`` / shed /
expired / batch settle — on EVERY path, including the exception edges the
comments could only warn about ("a leaked credit would tighten
admission forever").  Built on the dataflow CFG, so an exception raised
between ``admission.admit`` and the release handler IS a reported path,
and a second ``_ack`` reached through a helper call is a double-settle.

Per-variable abstract states::

    pend     bound, no obligation yet (no credit; broker-level requeue
             recovers a crash, so unsettled exception exits are fine)
    held     admission credit taken (``admission.admit(..tag..)``) —
             MUST settle before any exit, INCLUDING exception edges
    settled  reached a settlement
    escaped  ownership transferred (batcher submit, stored into window
             meta, appended into a caller-owned container, returned)
    handled  settled on some paths, escaped on others (fine)
    mix      settled/escaped on some paths, still pending on others —
             conditionally settled (reported at joins that leave the
             variable's scope: loop-back rebinds and function exits)

Annotation vocabulary (comment on or above a ``def`` / assignment):

- ``# settles: delivery`` — calling this function settles the named
  parameter exactly once (the call site transition; inside the function
  the normal-exit contract is checked).  On the call's EXCEPTION edge the
  argument stays unsettled — the callee only promises settlement when it
  returns (so ``_flush``'s except-handler nack after a half-settled
  ``_flush_inner`` is NOT a double-settle).
- ``# settles: *deliveries`` — collection form: the function settles
  every element of the named iterable before a normal return.
- ``# settles-some: pairs`` — partial contract: the function settles an
  input-dependent subset (dedup replays, debt victims).  Documents the
  seam and suppresses conditional-settlement reports for the parameter
  inside the function; call sites get no transition (the caller still
  owns the rest).
- ``# owns: deliveries`` — on an assignment: arms a LOCAL collection
  (e.g. window meta popped back out of ``_inflight_meta``) with the same
  settle-before-return obligation as ``settles: *``.

Raw settlement primitives — ``*.broker.ack/nack(.., var.delivery_tag ..)``
and ``*.admission.release(var.delivery_tag)`` — settle without the
double-settle check (release is idempotent BY DESIGN: every settle path
calls it blindly), and ``*.admission.admit(var.delivery_tag ..)`` is the
credit acquire that arms the ``held`` obligation.

Collections: aliases are grouped syntactically (filter comprehensions,
``sorted(...)``, appends of loop elements), a ``for`` loop whose target is
settled on every path settles the collection, and the ``if not window:
return`` emptiness shape is recognized as a vacuous settle on the true
branch.

**lock-pairing** — the same acquire/release machinery generalized to
explicit lock calls: within a function using ``X.acquire()`` /
``X.release()`` on a lock-named object, every path must balance —
acquire-while-held, release-while-free, and any exit (including exception
edges) while holding are reported.  ``with``-statement locks never hit
this rule (the context manager balances by construction); it exists for
the hand-rolled pairings a future migration/retry path would add.
"""

from __future__ import annotations

import ast
import copy
import re
from typing import Any

from matchmaking_tpu_torch.analysis import dataflow as df
from matchmaking_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    dotted_name,
    in_package,
)

RULE = "settlement"
LOCK_RULE = "lock-pairing"

_SETTLES_RE = re.compile(r"#\s*settles:\s*([\w\s,*]+)")
_SETTLES_SOME_RE = re.compile(r"#\s*settles-some:\s*(\w+)")
_OWNS_RE = re.compile(r"#\s*owns:\s*(\w+)")

#: Mutating container methods that transfer an element to the receiver.
_ESCAPE_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "put",
    "put_nowait", "submit",
})

#: (receiver-leaf, method) pairs for the raw settle/acquire primitives.
_RAW_SETTLE = {("broker", "ack"), ("broker", "nack"),
               ("admission", "release")}
_RAW_ACQUIRE = {("admission", "admit")}

# Abstract states.
PEND, HELD, SETTLED, ESCAPED, HANDLED, MIX = (
    "pend", "held", "settled", "escaped", "handled", "mix")
_OK_EXIT = {SETTLED, ESCAPED, HANDLED}


def _comment_above(sf: SourceFile, lineno: int, rx: re.Pattern):
    """Match on the line itself or a contiguous comment block above it
    (settlement annotations stack with holds-lock / guarded-by ones)."""
    m = rx.search(sf.line_at(lineno))
    if m:
        return m
    ln = lineno - 1
    while ln > 0 and sf.line_at(ln).strip().startswith("#"):
        m = rx.search(sf.line_at(ln))
        if m:
            return m
        ln -= 1
    return None


class _FnContract:
    """One function's settlement annotations."""

    __slots__ = ("node", "settles", "settles_coll", "settles_some")

    def __init__(self, node: ast.AST):
        self.node = node
        self.settles: dict[str, int] = {}       # param -> position
        self.settles_coll: dict[str, int] = {}  # collection param -> pos
        self.settles_some: set[str] = set()


def _collect_contracts(sf: SourceFile) -> dict[str, _FnContract]:
    """qualname (Class.method or function) → contract, same-file only (the
    settlement seams all live inside service/app.py by design)."""
    out: dict[str, _FnContract] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for item in ast.iter_child_nodes(node):
            if isinstance(item, ast.ClassDef):
                visit(item, item.name + ".")
            elif isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c = _FnContract(item)
                params = [a.arg for a in (*item.args.posonlyargs,
                                          *item.args.args)]
                m = _comment_above(sf, item.lineno, _SETTLES_RE)
                if m:
                    for raw in m.group(1).split(","):
                        raw = raw.strip()
                        if not raw:
                            continue
                        coll = raw.startswith("*")
                        name = raw.lstrip("*").strip()
                        if name in params:
                            pos = params.index(name)
                            (c.settles_coll if coll
                             else c.settles)[name] = pos
                m = _comment_above(sf, item.lineno, _SETTLES_SOME_RE)
                if m and m.group(1) in params:
                    c.settles_some.add(m.group(1))
                out[prefix + item.name] = c
                visit(item, prefix)  # nested defs keep the outer prefix
    visit(sf.tree, "")
    return out


def _leaf_pair(call: ast.Call) -> tuple[str, str] | None:
    """Last two components of a dotted callee (``self.app.broker.ack`` →
    ``("broker", "ack")``)."""
    name = dotted_name(call.func)
    parts = name.split(".") if name else []
    if len(parts) >= 2:
        return parts[-2], parts[-1]
    return None


def _callee_name(call: ast.Call) -> str:
    """Leaf method/function name of the callee ('' when not a chain)."""
    name = dotted_name(call.func)
    return name.rsplit(".", 1)[-1] if name else ""


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _bare_names(node: ast.AST) -> set[str]:
    """Names mentioned as VALUES (the object itself or an element of it),
    not as the base of a field read: ``(req, delivery)`` hands
    ``delivery`` off and ``x[k] = deliveries[s]`` hands an element off,
    while ``delivery.tier`` / ``deliveries[s].tier`` only read a field
    and transfer nothing."""
    shielded: set[int] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            base = sub.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name):
                shielded.add(id(base))
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and id(n) not in shielded}


def _alias_sources(value: ast.AST) -> set[str]:
    """Collection names a Name-assignment RHS aliases: a bare name, a
    ``sorted``/``list``/``tuple``/``reversed`` of one, or a comprehension
    whose iteration source (or subscripted element, the ``deliveries[s]``
    view shape) is one.  Deliberately narrow — arbitrary expressions do
    NOT join the alias group, or every scratch local would."""
    if isinstance(value, ast.Name):
        return {value.id}
    if (isinstance(value, ast.Call)
            and _callee_name(value) in ("sorted", "list", "tuple",
                                        "reversed")
            and value.args and isinstance(value.args[0], ast.Name)):
        return {value.args[0].id}
    if isinstance(value, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
        out: set[str] = set()
        for gen in value.generators:
            if isinstance(gen.iter, ast.Name):
                out.add(gen.iter.id)
        for sub in ast.walk(value.elt):
            if (isinstance(sub, ast.Subscript)
                    and isinstance(sub.value, ast.Name)):
                out.add(sub.value.id)
        return out
    return set()


def _filter_predicates(value: ast.AST) -> set[str]:
    """Normalized (``ast.dump``) filter predicates applied by
    comprehensions inside an assignment RHS — the inputs to the
    collection-length value-flow refinement. Two
    shapes produce a predicate:

    - a generator ``if`` condition (``[d for ... in ... if pid not in
      drop]``), and
    - the boolean MASK-VECTOR element (no ``if``s, a bare Compare/BoolOp
      element — the ``np.fromiter((pid not in drop for pid in ...),
      bool, n)`` idiom whose result feeds ``.take(mask)``).

    Predicates that reference no name beyond the comprehension's own
    targets are dropped: an unanchored filter (``if x`` over the loop
    variable alone) identifies nothing across assignments."""
    out: set[str] = set()
    for sub in ast.walk(value):
        if not isinstance(sub, (ast.ListComp, ast.GeneratorExp,
                                ast.SetComp)):
            continue
        bound: set[str] = set()
        conds: list[ast.AST] = []
        for gen in sub.generators:
            bound |= set(_binding_names(gen.target))
            conds.extend(gen.ifs)
        if not conds and isinstance(sub.elt, (ast.Compare, ast.BoolOp)):
            conds = [sub.elt]
        for cond in conds:
            if _names_in(cond) - bound:
                out.add(ast.dump(cond))
    return out


def _binding_names(target: ast.AST) -> list[str]:
    """Plain Name targets bound by an assignment/loop target."""
    out = []
    for t in ast.walk(target):
        if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
            out.append(t.id)
    return out


def _calls_in_header(stmt: ast.AST) -> list[ast.Call]:
    calls: list[ast.Call] = []
    for expr in df.header_exprs(stmt):
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                calls.append(sub)
            elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                break  # opaque nested scope
    return calls


def _mentions_tag(call: ast.Call, var: str) -> bool:
    """Does any argument read ``var.delivery_tag``?"""
    for arg in (*call.args, *(kw.value for kw in call.keywords)):
        for sub in ast.walk(arg):
            if (isinstance(sub, ast.Attribute)
                    and sub.attr == "delivery_tag"
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == var):
                return True
    return False


class _Groups:
    """Union-find over collection-variable names (one function)."""

    def __init__(self) -> None:
        self._parent: dict[str, str] = {}

    def find(self, name: str) -> str:
        p = self._parent.setdefault(name, name)
        if p != name:
            p = self._parent[name] = self.find(p)
        return p

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self._parent[ra] = rb


class _FnScan:
    """Syntactic pre-pass over one function: alias groups, tracked vars,
    loop metadata."""

    def __init__(self, fn: ast.AST, contract: _FnContract,
                 contracts: dict[str, _FnContract], cls: str):
        self.fn = fn
        self.contract = contract
        self.contracts = contracts
        self.cls = cls
        self.groups = _Groups()
        #: Names armed as owned collections (annotated params + # owns:
        #: locals), by group root after unioning.
        self.owned_seeds: set[str] = set(contract.settles_coll)
        self.partial_seeds: set[str] = set(contract.settles_some)
        self.tracked: set[str] = set()       # scalar vars under analysis
        self.partial_loops: set[int] = set() # For linenos that keep rows
        self._loop_src: dict[str, str] = {}  # loop target -> iterated name
        #: Guard flags (path-sensitive refinement):
        #: flag name -> the group ROOT whose hand-off it mirrors.  A
        #: qualifying flag is a bool local whose ONLY ``flag = True``
        #: assignment is the statement IMMEDIATELY after a hand-off of an
        #: owned collection (subscript/attribute store), with at least one
        #: ``flag = False`` elsewhere and no other assignments — so
        #: ``flag`` being truthy IMPLIES the group escaped, on every path.
        self.guard_flags: dict[str, str] = {}
        self._scan()

    # A call's contract, resolved same-file: self.helper → Class.helper,
    # bare helper → module function.
    def resolve(self, call: ast.Call) -> _FnContract | None:
        name = dotted_name(call.func)
        if not name:
            return None
        parts = name.split(".")
        if parts[0] == "self" and len(parts) == 2 and self.cls:
            return self.contracts.get(f"{self.cls}.{parts[1]}")
        if len(parts) == 1:
            return self.contracts.get(parts[0])
        return None

    def _arg_exprs(self, call: ast.Call,
                   contract: _FnContract) -> dict[int, ast.AST]:
        """Position → argument expression, with kwargs mapped through the
        callee's parameter names (self-calls shift positions by one)."""
        params = [a.arg for a in (*contract.node.args.posonlyargs,
                                  *contract.node.args.args)]
        shift = 1 if (params and params[0] == "self"
                      and isinstance(call.func, ast.Attribute)) else 0
        out: dict[int, ast.AST] = {}
        for i, arg in enumerate(call.args):
            out[i + shift] = arg
        for kw in call.keywords:
            if kw.arg and kw.arg in params:
                out[params.index(kw.arg)] = kw.value
        return out

    @staticmethod
    def _loop_source(node: "ast.For | ast.AsyncFor") -> str | None:
        it = node.iter
        if isinstance(it, ast.Name):
            return it.id
        if (isinstance(it, ast.Call)
                and _callee_name(it) in ("enumerate", "sorted", "reversed",
                                         "list", "zip")
                and it.args and isinstance(it.args[0], ast.Name)):
            return it.args[0].id
        return None

    def _scan(self) -> None:
        fn = self.fn
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                src = self._loop_source(node)
                if src is None:
                    continue
                targets = set(_binding_names(node.target))
                for t in targets:
                    self._loop_src[t] = src
                # Loop-LOCAL element hand-off: appending an expression
                # mentioning this loop's own target joins the container to
                # the iterated collection's alias group.  Must be scoped to
                # this loop — a later loop may rebind the same target name
                # from a different source.
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Call)
                            and _callee_name(sub) in _ESCAPE_METHODS
                            and isinstance(sub.func, ast.Attribute)
                            and isinstance(sub.func.value, ast.Name)):
                        container = sub.func.value.id
                        if any(n in targets for arg in sub.args
                               for n in _names_in(arg)):
                            self.groups.union(container, src)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    for n in _alias_sources(node.value):
                        if n != tgt.id:
                            self.groups.union(tgt.id, n)
            elif isinstance(node, ast.Call):
                # Settle / acquire / raw events arm scalar tracking.
                contract = self.resolve(node)
                if contract is not None and (contract.settles
                                             or contract.settles_coll):
                    args = self._arg_exprs(node, contract)
                    for pos in contract.settles.values():
                        if pos in args:
                            self.tracked.update(_names_in(args[pos]))
                pair = _leaf_pair(node)
                if pair in _RAW_SETTLE or pair in _RAW_ACQUIRE:
                    for arg in (*node.args,
                                *(kw.value for kw in node.keywords)):
                        for sub in ast.walk(arg):
                            if (isinstance(sub, ast.Attribute)
                                    and sub.attr == "delivery_tag"
                                    and isinstance(sub.value, ast.Name)):
                                self.tracked.add(sub.value.id)
        # Loop targets over owned groups are tracked (the collection-settle
        # check reads their state at loop exhaustion).
        owned_roots = {self.groups.find(n) for n in self.owned_seeds}
        for t, src in self._loop_src.items():
            if self.groups.find(src) in owned_roots:
                self.tracked.add(t)
        # Partial loops: the body re-appends the loop element into the SAME
        # group it iterates (dedup keeps, debt survivors) — such a loop can
        # never fully settle its collection.
        for node in ast.walk(fn):
            if not isinstance(node, (ast.For, ast.AsyncFor)):
                continue
            it_names = _names_in(node.iter)
            roots = {self.groups.find(n) for n in it_names}
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and _callee_name(sub) in _ESCAPE_METHODS
                        and isinstance(sub.func, ast.Attribute)
                        and isinstance(sub.func.value, ast.Name)
                        and self.groups.find(sub.func.value.id) in roots):
                    self.partial_loops.add(node.lineno)
        # Guard flags: scan statement SEQUENCES for the hand-off/flag
        # adjacency, then validate the flag's full assignment set.
        bool_assigns: dict[str, list[ast.Assign]] = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, bool)):
                bool_assigns.setdefault(node.targets[0].id,
                                        []).append(node)
        candidates: dict[str, tuple[str, ast.Assign]] = {}
        for node in ast.walk(fn):
            for field in ("body", "orelse", "finalbody"):
                body = getattr(node, field, None)
                if not isinstance(body, list):
                    continue
                for prev, cur in zip(body, body[1:]):
                    if not (isinstance(cur, ast.Assign)
                            and len(cur.targets) == 1
                            and isinstance(cur.targets[0], ast.Name)
                            and isinstance(cur.value, ast.Constant)
                            and cur.value.value is True):
                        continue
                    root = self._handoff_root(prev)
                    if root is not None:
                        candidates[cur.targets[0].id] = (root, cur)
        for flag, (root, true_stmt) in candidates.items():
            stmts = bool_assigns.get(flag, [])
            trues = [a for a in stmts if a.value.value is True]
            falses = [a for a in stmts if a.value.value is False]
            # Any OTHER write to the flag (non-constant, augmented, tuple
            # target, loop binding) disqualifies it — the correlation
            # must be total.
            def _target_nodes(n: ast.AST) -> list[ast.AST]:
                if isinstance(n, ast.Assign):
                    return list(n.targets)
                return [n.target]

            others = [
                n for n in ast.walk(fn)
                if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                  ast.For, ast.AsyncFor))
                and any(flag in _binding_names(t)
                        for t in _target_nodes(n))
                and n not in stmts
            ]
            if len(trues) == 1 and trues[0] is true_stmt and falses \
                    and not others:
                self.guard_flags[flag] = root
        # Collection-length value-flow refinement:
        # locals assigned as FILTERED VIEWS driven by the same predicate
        # have pairwise-equal lengths — `mask = (pid not in drop for pid
        # in X)` → `cols = cols.take(mask)` in one column plane, and
        # `deliveries_in = [deliveries[s] ... if pid not in drop]` in the
        # object plane, keep row-parallel residues by construction. So an
        # emptiness test on ONE of them (`if not len(cols): return`)
        # vacuously settles the PARTNERS' groups too: every row the
        # filter removed was settled by whoever produced `drop`
        # (settles-some), and zero residue on the tested side means zero
        # residue on the partner side. This retired the last
        # `ignore[settlement]` in _flush_columnar. Deliberately narrow:
        # predicates compare by exact ast.dump, must be anchored in a
        # free name, and `.take(mask)` inherits only a Name mask's
        # predicates.
        # ``pred_of``: name → its live filter-predicate dumps; ``takes``:
        # the subset of names whose predicates arrived through a
        # ``.take(mask)`` (a mask-filtered COLUMN view, not a list).
        # Linking is restricted to take-view ↔ comprehension pairs: two
        # plain comprehensions over different base collections can share
        # a predicate text without sharing a length, but a mask built
        # over the column view's own rows and a comprehension filtered by
        # the same anchored test are the paired-plane idiom this exists
        # for. A later REBIND of either name to an unfiltered value
        # clears its predicates — the contract follows the binding, not
        # the name.
        pred_of: dict[str, set[str]] = {}
        takes: set[str] = set()
        assigns = sorted(
            (n for n in ast.walk(fn)
             if isinstance(n, ast.Assign) and len(n.targets) == 1
             and isinstance(n.targets[0], ast.Name)),
            key=lambda n: (n.lineno, n.col_offset))
        for node in assigns:
            tgt = node.targets[0].id
            preds = _filter_predicates(node.value)
            v = node.value
            is_take = (isinstance(v, ast.Call)
                       and isinstance(v.func, ast.Attribute)
                       and v.func.attr == "take" and v.args
                       and isinstance(v.args[0], ast.Name))
            if is_take:
                # X = X.take(mask): the filtered view inherits the mask's
                # predicate identity.
                preds = preds | pred_of.get(v.args[0].id, set())
            if preds:
                pred_of[tgt] = pred_of.get(tgt, set()) | preds
                if is_take:
                    takes.add(tgt)
            else:
                # Rebound to something unfiltered: drop the stale
                # identity (and take-ness) or a fresh unsettled binding
                # would inherit the old emptiness correlation.
                pred_of.pop(tgt, None)
                takes.discard(tgt)
        self.len_partners: dict[str, set[str]] = {}
        for a, pa in pred_of.items():
            for b, pb in pred_of.items():
                if a == b or not (pa & pb):
                    continue
                if (a in takes) == (b in takes):
                    continue  # same plane: lengths not provably parallel
                self.len_partners.setdefault(a, set()).add(b)
        #: For linenos whose body settles/hands-off the loop target on
        #: EVERY path — computed per loop over a sub-CFG of the body alone
        #: so stale bindings from earlier loops cannot join in.  Filled by
        #: check() once the SourceFile is attached.
        self.settling_loops: set[int] = set()

    def _handoff_root(self, stmt: ast.AST) -> str | None:
        """The owned-group root ``stmt`` hands off, when it is a
        subscript/attribute store of an owned collection (the window-meta
        shape: ``self._inflight_meta[tok] = (dict(pairs), deliveries)``)."""
        if not (isinstance(stmt, ast.Assign) and stmt.targets
                and all(isinstance(t, (ast.Subscript, ast.Attribute))
                        for t in stmt.targets)):
            return None
        owned = {self.groups.find(n) for n in self.owned_seeds}
        for n in _bare_names(stmt.value):
            r = self.groups.find(n)
            if r in owned:
                return r
        return None

    def group_key(self, name: str) -> str:
        return "&" + self.groups.find(name)

    def owned_groups(self) -> set[str]:
        return {self.group_key(n) for n in self.owned_seeds}

    def partial_names(self) -> set[str]:
        """Names whose conditional settlement is contractual (settles-some
        params, their aliases, and loop targets over them)."""
        roots = {self.groups.find(n) for n in self.partial_seeds}
        out = set(roots) | set(self.partial_seeds)
        for n in self.tracked:
            if self.groups.find(n) in roots:
                out.add(n)
        for t, src in self._loop_src.items():
            if self.groups.find(src) in roots:
                out.add(t)
        return out


def _join_val(a: str, b: str) -> str:
    if a == b:
        return a
    if HELD in (a, b):
        return HELD
    pair = {a, b}
    if pair <= _OK_EXIT:
        return HANDLED
    return MIX


class _SettlementAnalysis(df.Analysis):
    """The typestate transfer over one function's CFG."""

    def __init__(self, scan: _FnScan, sf: SourceFile, qual: str):
        self.scan = scan
        self.sf = sf
        self.qual = qual
        self.findings: list[Finding] = []
        self.report = False
        self._seen: set[tuple] = set()
        #: Sub-CFG mode (per-loop body verdicts): replaces the entry state.
        self.entry_override: dict[str, str] | None = None

    # ---- reporting ---------------------------------------------------------

    def _flag(self, line: int, key: tuple, msg: str) -> None:
        if not self.report or key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(RULE, self.sf.path, line, msg,
                                     self.qual))

    # ---- lattice -----------------------------------------------------------

    def initial(self) -> dict[str, str]:
        if self.entry_override is not None:
            return dict(self.entry_override)
        state: dict[str, str] = {}
        params = [a.arg for a in (*self.scan.fn.args.posonlyargs,
                                  *self.scan.fn.args.args,
                                  *self.scan.fn.args.kwonlyargs)]
        for p in params:
            if p in self.scan.tracked:
                state[p] = PEND
        for key in self.scan.owned_groups():
            # Annotated collection params arm at entry; # owns: locals arm
            # at their assignment (absent until then).
            if key.lstrip("&") in params or any(
                    self.scan.groups.find(p) == key.lstrip("&")
                    for p in params):
                state[key] = PEND
        return state

    def join(self, a: str, b: str) -> str:
        return _join_val(a, b)

    # ---- events ------------------------------------------------------------

    def _settle(self, state: dict[str, str], var: str, line: int,
                check_double: bool, what: str) -> None:
        cur = state.get(var)
        if cur is None:
            return
        pretty = var.lstrip("&")
        if check_double and cur in (SETTLED, HANDLED):
            self._flag(line, ("double", var, line),
                       f"double-settle of {pretty!r}: already settled on "
                       f"every path reaching this {what} — the second "
                       f"settlement acks a delivery this function no longer "
                       f"owns")
        elif check_double and cur == MIX:
            self._flag(line, ("double-may", var, line),
                       f"possible double-settle of {pretty!r}: settled on "
                       f"SOME paths reaching this {what}")
        elif check_double and cur == ESCAPED:
            self._flag(line, ("double-esc", var, line),
                       f"settlement of {pretty!r} after ownership transfer: "
                       f"the new owner settles it again")
        state[var] = SETTLED

    def _escape(self, state: dict[str, str], var: str) -> None:
        if var in state:
            state[var] = ESCAPED

    def _apply_calls(self, stmt: ast.AST, state: dict[str, str]) -> None:
        for call in _calls_in_header(stmt):
            contract = self.scan.resolve(call)
            if contract is not None:
                args = self.scan._arg_exprs(call, contract)
                for pname, pos in contract.settles.items():
                    if pos not in args:
                        continue
                    for var in _names_in(args[pos]) & set(state):
                        if not var.startswith("&"):
                            self._settle(state, var, call.lineno, True,
                                         f"call to {_callee_name(call)}()")
                for pname, pos in contract.settles_coll.items():
                    if pos not in args:
                        continue
                    if self._settle_correlated(args[pos], state):
                        continue
                    hit = {self.scan.group_key(n)
                           for n in _names_in(args[pos])}
                    for key in hit & set(state):
                        self._settle(state, key, call.lineno, True,
                                     f"call to {_callee_name(call)}()")
            pair = _leaf_pair(call)
            if pair in _RAW_ACQUIRE:
                for var in list(state):
                    if not var.startswith("&") and _mentions_tag(call, var):
                        state[var] = HELD
            elif pair in _RAW_SETTLE:
                for var in list(state):
                    if not var.startswith("&") and _mentions_tag(call, var):
                        self._settle(state, var, call.lineno, False,
                                     "raw settle")
            # Container hand-off: append/submit of an expression mentioning
            # a tracked var transfers ownership — EXCEPT into the var's own
            # alias group (dedup keeps stay owned by the window).
            leaf = _callee_name(call)
            if leaf in _ESCAPE_METHODS:
                container = None
                if (isinstance(call.func, ast.Attribute)
                        and isinstance(call.func.value, ast.Name)):
                    container = call.func.value.id
                for arg in call.args:
                    for var in _bare_names(arg) & set(state):
                        if var.startswith("&"):
                            continue
                        if (container is not None
                                and self.scan.groups.find(container)
                                == self.scan.groups.find(
                                    self.scan._loop_src.get(var, var))):
                            continue  # kept within its own window group
                        self._escape(state, var)

    def _settle_correlated(self, arg: ast.AST,
                           state: dict[str, str]) -> bool:
        """Path-sensitive guard refinement: a
        ``settles: *`` argument of the shape ``None if flag else group``
        (or ``group if not flag else None``) where ``flag`` is a guard
        flag correlated with ``group``'s hand-off.  The correlation is
        exact by construction — ``flag`` is True iff the group escaped
        (its only True-assignment immediately follows the hand-off, with
        no raise edge in between since a constant store cannot raise) and
        the callee settles the collection exactly on the flag-False
        paths — so every path ends settled-or-escaped: HANDLED, with no
        conditional-settlement report.  Returns True when refined."""
        if not isinstance(arg, ast.IfExp):
            return False
        test, neg = arg.test, False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test, neg = test.operand, True
        if not isinstance(test, ast.Name):
            return False
        root = self.scan.guard_flags.get(test.id)
        if root is None:
            return False
        key = "&" + root
        if key not in state:
            return False
        escaped_branch = arg.orelse if neg else arg.body  # flag True value
        settle_branch = arg.body if neg else arg.orelse   # flag False value
        if not (isinstance(escaped_branch, ast.Constant)
                and escaped_branch.value is None):
            return False
        names = _names_in(settle_branch)
        if not names or any(self.scan.groups.find(n) != root
                            for n in names):
            return False
        state[key] = HANDLED
        return True

    def _check_leaves(self, state: dict[str, str], var: str, line: int,
                      where: str) -> None:
        """A variable's binding scope ends here (rebind or function exit):
        its obligations come due."""
        cur = state.get(var)
        if cur == HELD:
            self._flag(line, ("leak", var, line, where),
                       f"admission credit leak: {var.lstrip('&')!r} holds "
                       f"a credit "
                       f"(admission.admit) on a path that reaches {where} "
                       f"without ack/nack/shed/expire or release — the "
                       f"limiter tightens forever")
        elif (cur == MIX
              and var.lstrip("&") not in self.scan.partial_names()
              and var not in self.scan._loop_src):
            # Loop targets are exempt from MIX (their post-loop binding is
            # stale by construction); the collection-level checks own the
            # partial-settlement story for them.
            pretty = var.lstrip("&")
            self._flag(line, ("mix", var, line, where),
                       f"{pretty!r} is settled on some paths but not on a "
                       f"path reaching {where}: settle, hand off, or mark "
                       f"the helper '# settles-some:' if partial "
                       f"settlement is its contract")

    def _check_exit(self, node: df.Node, kind: str,
                    state: dict[str, str], cfg: df.CFG, dst: int) -> None:
        line = node.lineno or self.scan.fn.lineno
        if dst == cfg.raise_exit.idx:
            for var, cur in state.items():
                if cur == HELD:
                    self._flag(line, ("leak-exc", var, line),
                               f"admission credit leak on an exception "
                               f"path: {var!r} holds a credit when this "
                               f"statement raises — release it in a "
                               f"BaseException handler before the broker-"
                               f"level crash handler nacks")
            return
        if dst == cfg.exit.idx:
            for var in list(state):
                if var.startswith("&"):
                    if state[var] not in _OK_EXIT | {PEND}:
                        self._check_leaves(state, var, line, "a return")
                    if (state[var] == PEND
                            and var in self.scan.owned_groups()):
                        pretty = var.lstrip("&")
                        self._flag(line, ("coll-leak", var, line),
                                   f"window leak: collection {pretty!r} is "
                                   f"annotated settled-by-this-function "
                                   f"but a normal return is reached "
                                   f"without settling it")
                else:
                    self._check_leaves(state, var, line, "a return")

    # ---- dataflow hooks ----------------------------------------------------

    def transfer(self, node: df.Node, state: dict[str, str],
                 cfg: df.CFG) -> dict[str, str]:
        stmt = node.stmt
        if stmt is None:
            return state
        self._apply_calls(stmt, state)
        # Subscript/attribute stores hand the value off (window meta).
        if isinstance(stmt, ast.Assign):
            store_targets = [t for t in stmt.targets
                             if isinstance(t, (ast.Subscript, ast.Attribute))]
            if store_targets:
                for var in _bare_names(stmt.value):
                    if var in state:
                        self._escape(state, var)
                    key = self.scan.group_key(var)
                    if key in state:
                        state[key] = ESCAPED
            for t in stmt.targets:
                for var in _binding_names(t):
                    if var in self.scan.tracked:
                        self._check_leaves(state, var, stmt.lineno,
                                           "a rebind")
                        state[var] = PEND
                    gk = "&" + self.scan.groups.find(var)
                    if gk in self.scan.owned_groups():
                        # Local # owns: arming / alias rebind.
                        m = _comment_above(self.sf, stmt.lineno, _OWNS_RE)
                        if m and m.group(1) == var:
                            state.setdefault(gk, PEND)
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            for var in _bare_names(stmt.value) & set(state):
                state[var] = ESCAPED
        return state

    def edge(self, node: df.Node, kind: str, pre: dict[str, str],
             post: dict[str, str], cfg: df.CFG) -> dict[str, str] | None:
        stmt = node.stmt
        out = pre if kind == df.EXC else post
        if kind == df.EXC and stmt is not None:
            # Raw settle primitives are atomic for our purposes: an ack /
            # release that raises still discharged the obligation (both
            # are idempotent bookkeeping, and flagging them would turn
            # every settle loop into noise).  Annotated HELPERS stay
            # unsettled on their exception edge — they only promise
            # settlement when they return.
            for call in _calls_in_header(stmt):
                if _leaf_pair(call) in _RAW_SETTLE:
                    for var in list(out):
                        if (not var.startswith("&")
                                and _mentions_tag(call, var)):
                            out[var] = SETTLED
        dst = None
        for d, k in node.succ:
            if k == kind:
                dst = d  # any same-kind edge shares the state below
        if kind == df.ITER and isinstance(stmt, (ast.For, ast.AsyncFor)):
            for var in _binding_names(stmt.target):
                if var in self.scan.tracked:
                    # Only the HELD obligation survives a loop rebind check:
                    # MIX here is usually a stale binding from an earlier
                    # loop over the same name joining in — collection-level
                    # checks cover partial settlement.
                    if out.get(var) == HELD:
                        self._check_leaves(out, var, stmt.lineno,
                                           "the next loop iteration")
                    out[var] = PEND
        if kind == df.EXHAUSTED and isinstance(stmt, (ast.For,
                                                      ast.AsyncFor)):
            # Collection settle: a loop whose body settles its target on
            # every path (per-loop sub-CFG verdict, so stale joins from
            # earlier loops over the same name cannot pollute it) settles
            # the iterated collection.
            it_names = _names_in(stmt.iter)
            keys = {self.scan.group_key(n) for n in it_names} & set(out)
            if (keys and stmt.lineno not in self.scan.partial_loops
                    and stmt.lineno in self.scan.settling_loops):
                for key in keys:
                    self._settle(out, key, stmt.lineno, True,
                                 "settling loop")
        # Emptiness refinement: `if not window: return` — nothing left to
        # settle on the true branch.
        if isinstance(stmt, (ast.If, ast.While)):
            test = stmt.test
            neg = False
            if isinstance(test, ast.UnaryOp) and isinstance(test.op,
                                                            ast.Not):
                test = test.operand
                neg = True
            names = set()
            if isinstance(test, ast.Name):
                names = {test.id}
            elif (isinstance(test, ast.Call)
                  and _callee_name(test) == "len" and test.args):
                names = _names_in(test.args[0])
            empty_kind = df.TRUE if neg else df.FALSE
            if kind == empty_kind:
                # Length-parallel partners: an
                # emptiness test on a filtered view also empties every
                # same-predicate filtered partner — see the scan's
                # len_partners construction for the value-flow argument.
                expanded = set(names)
                for n in names:
                    expanded |= self.scan.len_partners.get(n, set())
                for n in expanded:
                    key = self.scan.group_key(n)
                    if key in out and out[key] in (PEND, MIX):
                        out[key] = SETTLED  # vacuously: it is empty
        # Exit obligations.
        if dst is not None:
            self._check_exit(node, kind, out, cfg, dst)
        return out


def _loop_settles(scan: _FnScan, sf: SourceFile, qual: str,
                  stmt: "ast.For | ast.AsyncFor") -> bool:
    """Does this loop's body settle (or hand off) its target on every path
    that completes an iteration?  Solved over a sub-CFG of the body alone
    with a fresh target binding, so stale states from earlier loops over
    the same name cannot join in.  ``continue`` paths are dead ends in the
    sub-CFG (optimistic); exception paths exit the loop and are the
    enclosing function's business."""
    targets = [v for v in _binding_names(stmt.target) if v in scan.tracked]
    if not targets:
        return False
    fake = ast.parse("def _loop_body():\n    pass").body[0]
    fake.body = list(stmt.body)
    cfg = df.CFG(fake)
    analysis = _SettlementAnalysis(scan, sf, qual)
    analysis.entry_override = {t: PEND for t in targets}
    exit_state = df.solve(cfg, analysis).get(cfg.exit.idx)
    if exit_state is None:
        return False
    # Tuple targets carry companions that never settle (the (pid, d) /
    # (d, tr) shapes): the loop settles its collection when the DELIVERY
    # member does on every completing path — at least one target fully
    # settled, none left mid-obligation or conditionally settled.
    vals = [exit_state.get(t) for t in targets]
    return (any(v in _OK_EXIT for v in vals)
            and not any(v in (HELD, MIX) for v in vals))


# ---- flush() return-contract refinement ----------------
#
# The engine contract behind the non-pipelined columnar flush: a closure
# that DISPATCHES a window (``search_columns_async`` / ``search_async``)
# and returns ``engine.flush()`` yields exactly the windows in flight —
# here exactly ONE, because the dispatch immediately precedes the flush
# under the same lock.  So ``outs = await asyncio.to_thread(run_engine)``
# is a depth-1, never-empty sequence, and ``for tok, out in outs:`` runs
# its body exactly once.  Without that value-flow fact the typestate sees
# two false paths: a second iteration double-settling the window's
# deliveries, and a zero-iteration path leaving them unsettled.  The
# refinement DESUGARS such loops to their bodies (execute exactly once)
# before the CFG is built — the two inline ignores this replaces were
# retired.  Deliberately narrow: the iterated name must be assigned
# exactly once, from ``to_thread(<closure>)`` where the closure both
# dispatches and returns a ``.flush()`` call, and the loop must have no
# break/continue/else.

_DISPATCH_LEAVES = frozenset({"search_columns_async", "search_async"})


def _flush_closure_names(fn: ast.AST) -> set[str]:
    """Local defs that dispatch a window and return ``engine.flush()``."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if (not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                or node is fn):
            continue
        dispatches = returns_flush = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                leaf = (dotted_name(sub.func) or "").rsplit(".", 1)[-1]
                if leaf in _DISPATCH_LEAVES:
                    dispatches = True
            elif (isinstance(sub, ast.Return)
                  and isinstance(sub.value, ast.Call)
                  and (dotted_name(sub.value.func) or "").endswith("flush")):
                returns_flush = True
        if dispatches and returns_flush:
            out.add(node.name)
    return out


def _singleton_flush_vars(fn: ast.AST, closures: set[str]) -> set[str]:
    """Names bound EXACTLY ONCE — by a plain ``(await) asyncio.to_thread(f)``
    assignment with ``f`` a dispatch-then-flush closure — and by NOTHING
    else (any other binding construct — loop target, with-item, walrus,
    aug/ann assignment — disqualifies: a rebound name no longer carries
    the flush() return contract)."""
    assigned: dict[str, int] = {}
    singles: set[str] = set()
    for node in ast.walk(fn):
        # Every binding construct counts against "exactly once".
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                               ast.AsyncFor, ast.NamedExpr)):
            targets = [node.target]
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            targets = [item.optional_vars for item in node.items
                       if item.optional_vars is not None]
        for tgt in targets:
            for name in _binding_names(tgt):
                assigned[name] = assigned.get(name, 0) + 1
        if (not isinstance(node, ast.Assign) or len(node.targets) != 1
                or not isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        if isinstance(value, ast.Await):
            value = value.value
        if (isinstance(value, ast.Call)
                and (dotted_name(value.func) or "").rsplit(".", 1)[-1]
                == "to_thread"
                and value.args and isinstance(value.args[0], ast.Name)
                and value.args[0].id in closures):
            singles.add(node.targets[0].id)
    return {name for name in singles if assigned.get(name) == 1}


class _SingletonLoopDesugar(ast.NodeTransformer):
    """Replace ``for … in <singleton-var>:`` with its body (runs once)."""

    def __init__(self, names: set[str]):
        self.names = names

    def _qualifies(self, node: "ast.For | ast.AsyncFor") -> bool:
        if not (isinstance(node.iter, ast.Name)
                and node.iter.id in self.names and not node.orelse):
            return False
        return not any(isinstance(sub, (ast.Break, ast.Continue))
                       for sub in ast.walk(node))

    def visit_For(self, node: ast.For):
        self.generic_visit(node)
        if self._qualifies(node):
            return node.body
        return node

    visit_AsyncFor = visit_For


def _refine_flush_loops(fn: ast.AST) -> ast.AST:
    """The depth-1/never-empty flush() refinement: desugar qualifying
    loops on a COPY of the function (the shared tree must stay pristine
    for the other rules)."""
    closures = _flush_closure_names(fn)
    if not closures:
        return fn
    names = _singleton_flush_vars(fn, closures)
    if not names:
        return fn
    return _SingletonLoopDesugar(names).visit(copy.deepcopy(fn))


def check(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in sources:
        # The settlement seams live in service/ by design; control/ joined
        # them with the control plane — its executor/controller own engine
        # hand-offs and explicit lock pairings the same rules must prove.
        if not in_package(sf) or not any(
                seg in "/" + sf.path for seg in ("/service/", "/control/")):
            continue
        contracts = _collect_contracts(sf)
        for cls, fn in _iter_functions(sf.tree):
            qual = f"{cls}.{fn.name}" if cls else fn.name
            contract = contracts.get(qual) or _FnContract(fn)
            # Depth-1/never-empty flush() return contract:
            # loops over a dispatch-then-flush closure's result execute
            # exactly once — desugared before the CFG is built.
            fn = _refine_flush_loops(fn)
            scan = _FnScan(fn, contract, contracts, cls)
            scan._sf = sf
            # Re-scan # owns: locals now that the source is attached.
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], (ast.Name,
                                                         ast.Tuple))):
                    m = _comment_above(sf, node.lineno, _OWNS_RE)
                    if m:
                        name = m.group(1)
                        if name in _binding_names(node.targets[0]):
                            scan.owned_seeds.add(name)
            if not (scan.tracked or scan.owned_seeds):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, (ast.For, ast.AsyncFor))
                        and _loop_settles(scan, sf, qual, node)):
                    scan.settling_loops.add(node.lineno)
            cfg = df.CFG(fn)
            analysis = _SettlementAnalysis(scan, sf, qual)
            df.solve_and_report(cfg, analysis)
            findings.extend(analysis.findings)
        findings.extend(_check_lock_pairing(sf))
    return findings


_iter_functions = df.iter_functions


# ---- lock-pairing -----------------------------------------------------------

def _lock_leaf(call: ast.Call) -> str | None:
    """The lock name when ``call`` is ``<...lock>.acquire()`` or
    ``.release()``."""
    if not isinstance(call.func, ast.Attribute):
        return None
    if call.func.attr not in ("acquire", "release"):
        return None
    name = dotted_name(call.func.value)
    leaf = name.rsplit(".", 1)[-1] if name else ""
    return leaf if leaf.lower().endswith("lock") else None


class _LockAnalysis(df.Analysis):
    def __init__(self, sf: SourceFile, qual: str):
        self.sf = sf
        self.qual = qual
        self.findings: list[Finding] = []
        self.report = False
        self._seen: set[tuple] = set()

    def _flag(self, line: int, key: tuple, msg: str) -> None:
        if not self.report or key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(LOCK_RULE, self.sf.path, line, msg,
                                     self.qual))

    def join(self, a: int | str, b: int | str):
        return a if a == b else "mix"

    def transfer(self, node: df.Node, state, cfg):
        stmt = node.stmt
        if stmt is None:
            return state
        for call in _calls_in_header(stmt):
            lock = _lock_leaf(call)
            if lock is None:
                continue
            held = state.get(lock, 0)
            if call.func.attr == "acquire":
                if held == 1:
                    self._flag(call.lineno, ("re", lock, call.lineno),
                               f"{lock}.acquire() while already held on "
                               f"every path here: asyncio/threading locks "
                               f"are not reentrant — this deadlocks")
                elif held == "mix":
                    self._flag(call.lineno, ("re?", lock, call.lineno),
                               f"{lock}.acquire() while held on SOME "
                               f"paths: a schedule exists that deadlocks")
                state[lock] = 1
            else:
                if held == 0:
                    self._flag(call.lineno, ("free", lock, call.lineno),
                               f"{lock}.release() without a matching "
                               f"acquire on every path here")
                state[lock] = 0
        return state

    def edge(self, node: df.Node, kind, pre, post, cfg):
        out = pre if kind == df.EXC else post
        if kind == df.EXC and node.stmt is not None:
            # release() is atomic for pairing purposes: even when the call
            # raises, the lock is no longer this path's to balance.
            for call in _calls_in_header(node.stmt):
                lock = _lock_leaf(call)
                if lock is not None and call.func.attr == "release":
                    out[lock] = 0
        for dst, k in node.succ:
            if k != kind:
                continue
            if dst == cfg.exit.idx or dst == cfg.raise_exit.idx:
                where = ("an exception path" if dst == cfg.raise_exit.idx
                         else "a return")
                for lock, held in out.items():
                    if held == 1:
                        self._flag(node.lineno or 0,
                                   ("exit", lock, node.lineno, where),
                                   f"{lock} still held on {where}: "
                                   f"release in a finally (or use "
                                   f"`async with`) so the pairing "
                                   f"balances on every path")
                    elif held == "mix":
                        self._flag(node.lineno or 0,
                                   ("exit?", lock, node.lineno, where),
                                   f"{lock} held on SOME paths reaching "
                                   f"{where}: the pairing is path-"
                                   f"dependent")
        return out


def _check_lock_pairing(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for cls, fn in _iter_functions(sf.tree):
        uses = any(_lock_leaf(c) for n in ast.walk(fn)
                   for c in ([n] if isinstance(n, ast.Call) else []))
        if not uses:
            continue
        qual = f"{cls}.{fn.name}" if cls else fn.name
        cfg = df.CFG(fn)
        analysis = _LockAnalysis(sf, qual)
        df.solve_and_report(cfg, analysis)
        findings.extend(analysis.findings)
    return findings
