"""``protocol`` — declarative conformance contracts for the lease /
replication / failover protocol.

The fenced-failover machinery (service/replication.py, utils/journal.py,
the publish seams in service/app.py) is correct only while three
disciplines hold: every epoch-bearing side effect is *dominated* by a
fence/epoch check on every path (including exception edges), epoch/seq
watermarks only ever advance, and the replication record-type vocabulary
agrees between sender, applier and the offline ``journal_dump`` tool.
Today those disciplines live in hand-placed ``is_current`` checks; this
rule makes them declared contracts, verified flow-sensitively on the
``dataflow`` CFG the way ``settlement`` verifies exactly-once.

Annotation grammar (mirrors ``# settles:`` / ``# guarded-by:``)::

    # protocol-role: primary -> fenced
    class QueueReplication:               # role-state machine on the class

    # protocol-effect: journal_append requires-fence fence
    def _append(self, ...):               # effect contract on a def

    # protocol-effect: standby_ack bounded-by applied_seq
    # protocol-effect: lease_renewal requires-check renew

    # protocol-monotone: sent_seq, acked_seq
    class QueueReplication:               # monotone watermarks (file-wide
                                          # by attribute leaf name)

    self.applied_seq = seq  # protocol-rebase: pump admits contiguous seqs

Sub-checks
----------

- **role**: ``self.role`` stores in an annotated class must be literal
  declared states; ``__init__`` must bind the start state; any later
  method re-binding the start state is a role regression (un-fencing).
- **requires-fence** (dataflow): every effect site in the annotated
  function must be reached with the named guard checked on ALL paths —
  the guard appearing (with polarity) in a dominating ``if``/``while``
  test or ``assert``.  Exception edges carry the *pre*-check state, so a
  site reachable from a handler entered before the check still flags.
- **bounded-by**: ack-style call arguments may only mention the declared
  watermark (ack past the applied horizon is unrepresentable).
- **requires-check**: the effect call's boolean result must not be
  discarded as a bare expression statement (a refused renewal must fall
  through to the fence check).
- **monotone** (dataflow): stores to declared watermark leaves must be
  ``+=``, ``max(self.x, ...)``, ``self.x + k``, guarded by a dominating
  ``>``/``>=`` comparison against the stored value (directly or through
  a single boolean guard flag, the ``progress = a > self.acked_seq``
  shape), ``__init__``, or carry an explicit ``# protocol-rebase:``.
- **undeclared effect**: inside a class that declares an effect on some
  method, any OTHER method containing a site of that effect without its
  own annotation flags — new seams cannot bypass the contract silently.
- **vocabulary** (cross-file): ``RT_*`` record-type constants must agree
  by name and value across the tree; an ``RT_NAMES`` rendering map must
  cover every defined type; an ``*Applier`` class must reference every
  streamed type; files using ``FORMAT_VERSION`` must not re-hardcode the
  schema version as a ``{"version": <int>}`` literal.

Scope: package files (minus analysis/) plus ``scripts/`` — the contracts
only arm on files that carry ``protocol-`` annotations, the vocabulary
check on files that define ``RT_*`` constants.
"""

from __future__ import annotations

import ast
import collections
import hashlib
import json
import re

from matchmaking_tpu_torch.analysis import dataflow as df
from matchmaking_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    dotted_name,
    in_package,
)

RULE = "protocol"

_ANN_RE = re.compile(r"#\s*protocol-([a-z][\w-]*):\s*(.*?)\s*$")
_KNOWN_KINDS = ("role", "effect", "monotone", "rebase")
_EFFECT_RE = re.compile(
    r"^(\w+)\s+(requires-fence|bounded-by|requires-check)\s+([\w.]+)$")
_IDENT_RE = re.compile(r"^\w+$")
_RT_RE = re.compile(r"^RT_[A-Z0-9_]+$")

#: Effect name -> what counts as a site (the registry a typo'd effect
#: name is validated against; messages quote the description).
EFFECTS = {
    "journal_append": "a store advancing a journal 'seq' watermark",
    "response_publish": "a broker publish/publish_batch call",
    "standby_ack": "a replication-link ack call",
    "lease_renewal": "a lease-authority renew call",
}

#: The one streamed-vocabulary name an applier never sees (segment
#: headers are a disk framing artifact, not a replication record).
_VOCAB_APPLIER_EXEMPT = ("RT_SEGMENT",)


def _in_scope(sf: SourceFile) -> bool:
    return in_package(sf) or sf.path.startswith("scripts/")


# ---- annotation collection --------------------------------------------------

class _Ann:
    __slots__ = ("lineno", "kind", "payload")

    def __init__(self, lineno: int, kind: str, payload: str):
        self.lineno = lineno
        self.kind = kind
        self.payload = payload


class _FileProto:
    """Every protocol annotation in one file, resolved to constructs."""

    def __init__(self) -> None:
        self.anns: list[_Ann] = []
        self.consumed: set[int] = set()
        #: class name -> (state chain, lineno)
        self.roles: dict[str, tuple[list[str], int]] = {}
        #: (class name, fn node, effect, verb, arg, lineno)
        self.effects: list[tuple[str, ast.AST, str, str, str, int]] = []
        #: watermark attribute leaves (file-wide union) -> decl lineno
        self.monotone: dict[str, int] = {}
        #: lineno -> reason (covers a store on the same or next line)
        self.rebase: dict[int, str] = {}
        self.rebase_used: set[int] = set()


def _block_anns(sf: SourceFile, lineno: int,
                ann_at: dict[int, _Ann]) -> list[_Ann]:
    """Annotations on ``lineno`` or its contiguous comment block above
    (protocol annotations stack with holds-lock / guarded-by ones)."""
    out = []
    if lineno in ann_at:
        out.append(ann_at[lineno])
    ln = lineno - 1
    while ln > 0 and sf.line_at(ln).strip().startswith("#"):
        if ln in ann_at:
            out.append(ann_at[ln])
        ln -= 1
    return out


def _collect(sf: SourceFile, findings: list[Finding]) -> _FileProto:
    fp = _FileProto()
    for i, line in enumerate(sf.lines, 1):
        m = _ANN_RE.search(line)
        if m:
            fp.anns.append(_Ann(i, m.group(1), m.group(2)))
    if not fp.anns:
        return fp
    ann_at = {a.lineno: a for a in fp.anns}

    def bad(a: _Ann, why: str, ctx: str) -> None:
        fp.consumed.add(a.lineno)
        findings.append(Finding(
            RULE, sf.path, a.lineno,
            f"protocol annotation parse error: {why}", ctx))

    def visit(node: ast.AST, cls: str) -> None:
        for item in ast.iter_child_nodes(node):
            if isinstance(item, ast.ClassDef):
                ctx = item.name
                for a in _block_anns(sf, item.lineno, ann_at):
                    if a.kind == "role":
                        states = [s.strip() for s in a.payload.split("->")]
                        if (len(states) < 2
                                or not all(_IDENT_RE.match(s)
                                           for s in states)):
                            bad(a, f"'protocol-role: {a.payload}' wants "
                                   f"'state -> state [-> ...]'", ctx)
                        else:
                            fp.consumed.add(a.lineno)
                            fp.roles[item.name] = (states, a.lineno)
                    elif a.kind == "monotone":
                        names = [s.strip() for s in a.payload.split(",")
                                 if s.strip()]
                        if not names or not all(_IDENT_RE.match(s)
                                                for s in names):
                            bad(a, f"'protocol-monotone: {a.payload}' wants "
                                   f"a comma-separated attribute list", ctx)
                        else:
                            fp.consumed.add(a.lineno)
                            for s in names:
                                fp.monotone.setdefault(s, a.lineno)
                visit(item, item.name)
            elif isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ctx = f"{cls}.{item.name}" if cls else item.name
                for a in _block_anns(sf, item.lineno, ann_at):
                    if a.kind != "effect":
                        continue
                    m = _EFFECT_RE.match(a.payload)
                    if m is None:
                        bad(a, f"'protocol-effect: {a.payload}' wants "
                               f"'<effect> <requires-fence|bounded-by|"
                               f"requires-check> <name>'", ctx)
                        continue
                    effect, verb, arg = m.groups()
                    if effect not in EFFECTS:
                        bad(a, f"unknown effect {effect!r} (known: "
                               f"{', '.join(sorted(EFFECTS))})", ctx)
                        continue
                    fp.consumed.add(a.lineno)
                    fp.effects.append((cls, item, effect, verb, arg,
                                       a.lineno))
                visit(item, cls)

    visit(sf.tree, "")
    for a in fp.anns:
        if a.kind == "rebase":
            if not a.payload.strip():
                bad(a, "'protocol-rebase:' wants a reason", "<module>")
            else:
                fp.consumed.add(a.lineno)
                fp.rebase[a.lineno] = a.payload.strip()
    return fp


def _flag_unconsumed(sf: SourceFile, fp: _FileProto,
                     findings: list[Finding]) -> None:
    for a in fp.anns:
        if a.lineno in fp.consumed:
            continue
        if a.kind not in _KNOWN_KINDS:
            findings.append(Finding(
                RULE, sf.path, a.lineno,
                f"unknown protocol annotation 'protocol-{a.kind}:' "
                f"(known: {', '.join(_KNOWN_KINDS)})", "<module>"))
        else:
            findings.append(Finding(
                RULE, sf.path, a.lineno,
                f"protocol-{a.kind} annotation not attached to a "
                f"{'class' if a.kind in ('role', 'monotone') else 'def'} "
                f"(put it on or directly above the line it governs)",
                "<module>"))
    for ln, reason in fp.rebase.items():
        if ln not in fp.rebase_used:
            findings.append(Finding(
                RULE, sf.path, ln,
                f"stale protocol-rebase ({reason!r}): no tracked watermark "
                f"store on this or the next line", "<module>"))


# ---- effect sites -----------------------------------------------------------

def _store_attr_targets(stmt: ast.AST) -> list[ast.Attribute]:
    """Attribute targets a statement stores to."""
    out: list[ast.Attribute] = []
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                else [tgt]
            out.extend(e for e in elts if isinstance(e, ast.Attribute))
    elif isinstance(stmt, ast.AugAssign):
        if isinstance(stmt.target, ast.Attribute):
            out.append(stmt.target)
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        if isinstance(stmt.target, ast.Attribute):
            out.append(stmt.target)
    return out


def _is_site_call(effect: str, sub: ast.AST) -> bool:
    """``sub`` is a call that is a site of a call-shaped effect."""
    if not (isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)):
        return False
    leaf = sub.func.attr
    recv = dotted_name(sub.func.value)
    if effect == "response_publish":
        return (leaf in ("publish", "publish_batch", "basic_publish")
                and "broker" in recv)
    if effect == "standby_ack":
        return leaf == "ack" and "link" in recv
    if effect == "lease_renewal":
        return leaf == "renew"
    return False


def _site_calls(effect: str, expr: ast.AST) -> list[ast.Call]:
    """Calls within ``expr`` that are sites of a call-shaped effect."""
    return [sub for sub in ast.walk(expr) if _is_site_call(effect, sub)]


def _sites_in_stmt(effect: str, stmt: ast.AST) -> list[int]:
    """Line numbers of effect sites THIS CFG node executes (headers only
    for compound statements, matching the dataflow exception model)."""
    if effect == "journal_append":
        return [stmt.lineno for tgt in _store_attr_targets(stmt)
                if tgt.attr == "seq"]
    out = []
    for expr in df.header_exprs(stmt):
        out.extend(c.lineno for c in _site_calls(effect, expr))
    return out


def _walk_skipping(fn: ast.AST, skip: "frozenset[int]"):
    """``ast.walk(fn)`` (same order) minus the subtrees of nested defs in
    ``skip``."""
    todo = collections.deque([fn])
    while todo:
        node = todo.popleft()
        todo.extend(c for c in ast.iter_child_nodes(node)
                    if id(c) not in skip)
        yield node


def _sites_in_fn(effect: str, fn: ast.AST,
                 skip: "frozenset[int]" = frozenset()) -> list[int]:
    """Effect sites anywhere in ``fn``, nested defs included — except the
    nested defs in ``skip`` (ids), which carry their own contract for the
    effect and are checked as functions of their own."""
    if effect == "journal_append":
        out = []
        for node in _walk_skipping(fn, skip):
            out.extend(tgt.lineno for tgt in _store_attr_targets(node)
                       if tgt.attr == "seq")
        return out
    return [n.lineno for n in _walk_skipping(fn, skip)
            if _is_site_call(effect, n)]


# ---- role state machine -----------------------------------------------------

def _check_roles(sf: SourceFile, fp: _FileProto,
                 findings: list[Finding]) -> None:
    if not fp.roles:
        return
    for cls in ast.walk(sf.tree):
        if not isinstance(cls, ast.ClassDef) or cls.name not in fp.roles:
            continue
        states, _ = fp.roles[cls.name]
        start = states[0]
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            ctx = f"{cls.name}.{fn.name}"
            for node in ast.walk(fn):
                if isinstance(node, ast.AugAssign) and (
                        isinstance(node.target, ast.Attribute)
                        and node.target.attr == "role"):
                    findings.append(Finding(
                        RULE, sf.path, node.lineno,
                        f"role must be assigned a literal declared state, "
                        f"not arithmetically mutated", ctx))
                    continue
                if not isinstance(node, ast.Assign):
                    continue
                tgts = [t for t in node.targets
                        if isinstance(t, ast.Attribute) and t.attr == "role"
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"]
                if not tgts:
                    continue
                val = node.value
                if not (isinstance(val, ast.Constant)
                        and isinstance(val.value, str)):
                    findings.append(Finding(
                        RULE, sf.path, node.lineno,
                        f"role must be a literal state name from the "
                        f"declared machine ({' -> '.join(states)})", ctx))
                    continue
                if val.value not in states:
                    findings.append(Finding(
                        RULE, sf.path, node.lineno,
                        f"undeclared role state {val.value!r} (declared: "
                        f"{' -> '.join(states)})", ctx))
                elif fn.name == "__init__" and val.value != start:
                    findings.append(Finding(
                        RULE, sf.path, node.lineno,
                        f"__init__ must bind the start state {start!r}, "
                        f"not {val.value!r}", ctx))
                elif fn.name != "__init__" and val.value == start:
                    findings.append(Finding(
                        RULE, sf.path, node.lineno,
                        f"role regression: re-binding the start state "
                        f"{start!r} outside __init__ un-fences a fenced "
                        f"instance (roles only advance along "
                        f"{' -> '.join(states)})", ctx))


# ---- fence dominance (dataflow) ---------------------------------------------

def _mentions_guard(expr: ast.AST, guard: str) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute) and sub.attr == guard:
            return True
        if isinstance(sub, ast.Name) and sub.id == guard:
            return True
    return False


def _guard_polarity(test: ast.AST, guard: str) -> str:
    """'neg' when any guard occurrence sits under a ``not`` (the TRUE
    branch is then the refusal path and the FALSE edge is fence-checked),
    else 'pos' (the TRUE edge is checked)."""
    neg = [False]

    def walk(n: ast.AST, inverted: bool) -> None:
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
            walk(n.operand, not inverted)
            return
        if ((isinstance(n, ast.Attribute) and n.attr == guard)
                or (isinstance(n, ast.Name) and n.id == guard)):
            if inverted:
                neg[0] = True
        for c in ast.iter_child_nodes(n):
            walk(c, inverted)

    walk(test, False)
    return "neg" if neg[0] else "pos"


class _FenceAnalysis(df.Analysis):
    """Typestate {un, ok, mix} for 'the fence guard has been checked on
    every path reaching here'. Branch edges on tests mentioning the guard
    refine to ok with the test's polarity; exception edges keep the
    pre-check state (a raise INSIDE the check never checked anything)."""

    def __init__(self, sf: SourceFile, guard: str, effect: str,
                 ctx: str, findings: list[Finding]):
        self.sf = sf
        self.guard = guard
        self.effect = effect
        self.ctx = ctx
        self.findings = findings
        self.report = False
        self._seen: set[int] = set()

    def initial(self):
        return {"#fence": "un"}

    def transfer(self, node, state, cfg):
        stmt = node.stmt
        if stmt is None:
            return state
        if self.report and state.get("#fence") != "ok":
            some = state.get("#fence") == "mix"
            for ln in _sites_in_stmt(self.effect, stmt):
                if ln in self._seen:
                    continue
                self._seen.add(ln)
                self.findings.append(Finding(
                    RULE, self.sf.path, ln,
                    f"{self.effect} site not fence-dominated: reachable "
                    f"{'on some paths' if some else ''} without a "
                    f"{self.guard!r} check "
                    f"({EFFECTS[self.effect]} must be refused once "
                    f"superseded — check {self.guard} first, on every "
                    f"path including exception edges)".replace("  ", " "),
                    self.ctx))
        if (isinstance(stmt, ast.Assert)
                and _mentions_guard(stmt.test, self.guard)
                and _guard_polarity(stmt.test, self.guard) == "pos"):
            state["#fence"] = "ok"
        return state

    def edge(self, node, kind, pre, post, cfg):
        if kind == df.EXC:
            return pre
        stmt = node.stmt
        if (isinstance(stmt, (ast.If, ast.While))
                and _mentions_guard(stmt.test, self.guard)):
            ok_kind = (df.FALSE
                       if _guard_polarity(stmt.test, self.guard) == "neg"
                       else df.TRUE)
            if kind == ok_kind:
                post = dict(post)
                post["#fence"] = "ok"
        return post

    def join(self, a, b):
        return a if a == b else "mix"


# ---- effect contracts -------------------------------------------------------

def _leaf_tokens(expr: ast.AST) -> set[str]:
    """Leaf identifiers an expression mentions: the final attribute of
    each dotted chain plus bare names (chain bases excluded)."""
    out: set[str] = set()
    bases: set[int] = set()
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute):
            if id(sub) not in bases:
                out.add(sub.attr)
            bases.add(id(sub.value))
        elif isinstance(sub, ast.Name):
            if id(sub) not in bases and sub.id != "self":
                out.add(sub.id)
    return out


def _check_effects(sf: SourceFile, fp: _FileProto,
                   findings: list[Finding]) -> None:
    for cls, fn, effect, verb, arg, ln in fp.effects:
        ctx = f"{cls}.{fn.name}" if cls else fn.name
        sites = _sites_in_fn(effect, fn)
        if not sites:
            findings.append(Finding(
                RULE, sf.path, ln,
                f"stale protocol-effect: {fn.name} contains no "
                f"{effect} site ({EFFECTS[effect]})", ctx))
            continue
        if verb == "requires-fence":
            cfg = df.CFG(fn)
            df.solve_and_report(
                cfg, _FenceAnalysis(sf, arg, effect, ctx, findings))
        elif verb == "bounded-by":
            for call in _site_calls(effect, fn):
                extra = set()
                for a in call.args:
                    extra |= _leaf_tokens(a) - {arg}
                if extra:
                    findings.append(Finding(
                        RULE, sf.path, call.lineno,
                        f"{effect} not bounded by {arg!r}: the ack "
                        f"argument mentions {', '.join(sorted(extra))} — "
                        f"acking past the applied watermark tells the "
                        f"primary to drop records the standby never "
                        f"applied", ctx))
        elif verb == "requires-check":
            for node in ast.walk(fn):
                if not isinstance(node, ast.Expr):
                    continue
                if any(c is node.value
                       for c in _site_calls(effect, node.value)):
                    findings.append(Finding(
                        RULE, sf.path, node.lineno,
                        f"{effect} result discarded: a refused {arg}() "
                        f"must fall through to the fence check, so the "
                        f"boolean result has to be tested", ctx))


def _check_undeclared(sf: SourceFile, fp: _FileProto,
                      findings: list[Finding]) -> None:
    """Inside a class that declares effect E on some method, every other
    method containing an E site must carry its own annotation."""
    by_cls: dict[str, set[str]] = {}
    declared: dict[tuple[str, str], set[str]] = {}
    #: effect -> ids of the defs that declare it (a nested def declaring
    #: it is its own contract, not an undeclared site of its outer def).
    declaring: dict[str, set[int]] = {}
    for cls, fn, effect, _verb, _arg, _ln in fp.effects:
        by_cls.setdefault(cls, set()).add(effect)
        declared.setdefault((cls, fn.name), set()).add(effect)
        declaring.setdefault(effect, set()).add(id(fn))
    for cls in ast.walk(sf.tree):
        if not isinstance(cls, ast.ClassDef) or cls.name not in by_cls:
            continue
        for fn in cls.body:
            if (not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    or fn.name == "__init__"):
                continue
            have = declared.get((cls.name, fn.name), set())
            for effect in sorted(by_cls[cls.name] - have):
                sites = _sites_in_fn(
                    effect, fn, frozenset(declaring.get(effect, ())))
                if sites:
                    findings.append(Finding(
                        RULE, sf.path, sites[0],
                        f"undeclared protocol effect: {cls.name} declares "
                        f"{effect} contracts but {fn.name} performs "
                        f"{EFFECTS[effect]} without its own "
                        f"protocol-effect annotation",
                        f"{cls.name}.{fn.name}"))


# ---- monotone watermarks (dataflow) -----------------------------------------

def _compare_fact(expr: ast.AST,
                  leaves: set[str]) -> tuple[str, str] | None:
    """(leaf, other-side key) when ``expr`` proves other > leaf-attr."""
    if not (isinstance(expr, ast.Compare) and len(expr.ops) == 1):
        return None
    op = expr.ops[0]
    left, right = expr.left, expr.comparators[0]
    if isinstance(op, (ast.Gt, ast.GtE)):
        if isinstance(right, ast.Attribute) and right.attr in leaves:
            return (right.attr, ast.dump(left))
    elif isinstance(op, (ast.Lt, ast.LtE)):
        if isinstance(left, ast.Attribute) and left.attr in leaves:
            return (left.attr, ast.dump(right))
    return None


def _facts_from_test(test: ast.AST, leaves: set[str],
                     flags: frozenset) -> frozenset:
    """Facts proven on the TRUE edge of ``test``: bare comparisons, bare
    guard-flag names, and ``and``-conjunctions of those (``or`` proves
    nothing about any single conjunct)."""
    conjuncts = (test.values
                 if isinstance(test, ast.BoolOp)
                 and isinstance(test.op, ast.And) else [test])
    facts = set()
    for c in conjuncts:
        fact = _compare_fact(c, leaves)
        if fact:
            facts.add(fact)
        elif isinstance(c, ast.Name):
            facts.update((leaf, key) for name, leaf, key in flags
                         if name == c.id)
    return frozenset(facts)


class _MonotoneAnalysis(df.Analysis):
    """Must-facts {(leaf, rhs-key)}: 'rhs was proven >= self.<leaf> on
    every path reaching here'. A guarded rebind is OK exactly when its
    (leaf, rhs) fact holds at the store."""

    def __init__(self, sf: SourceFile, leaves: set[str], ctx: str,
                 sites: dict[int, list[tuple[str, str, int]]],
                 findings: list[Finding]):
        self.sf = sf
        self.leaves = leaves
        self.ctx = ctx
        self.sites = sites  # id(stmt) -> [(leaf, rhs_key, lineno)]
        self.findings = findings
        self.report = False
        self._seen: set[int] = set()

    def initial(self):
        return {"#facts": frozenset(), "#flags": frozenset()}

    def transfer(self, node, state, cfg):
        stmt = node.stmt
        if stmt is None:
            return state
        # Guard-flag definitions: `progress = a > self.acked_seq`.
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            nm = stmt.targets[0].id
            flags = {f for f in state["#flags"] if f[0] != nm}
            fact = _compare_fact(stmt.value, self.leaves)
            if fact:
                flags.add((nm,) + fact)
            state["#flags"] = frozenset(flags)
        if self.report:
            for leaf, rhs_key, ln in self.sites.get(id(stmt), ()):
                if (leaf, rhs_key) not in state["#facts"] \
                        and ln not in self._seen:
                    self._seen.add(ln)
                    self.findings.append(Finding(
                        RULE, self.sf.path, ln,
                        f"non-monotone rebind of watermark {leaf!r}: not "
                        f"dominated by a >/>= comparison against the "
                        f"stored value (watermarks only advance — compare "
                        f"first, use max(), or annotate the store "
                        f"'# protocol-rebase: <why>')", self.ctx))
        # Invalidate facts about a leaf once it is re-stored — unless the
        # store binds exactly the proven-greater value (x = a under
        # a >= x keeps a >= x true).
        for tgt in _store_attr_targets(stmt):
            if tgt.attr not in self.leaves:
                continue
            rhs_key = (ast.dump(stmt.value)
                       if isinstance(stmt, (ast.Assign, ast.AnnAssign))
                       and stmt.value is not None else None)
            state["#facts"] = frozenset(
                f for f in state["#facts"]
                if f[0] != tgt.attr or f[1] == rhs_key)
            state["#flags"] = frozenset(
                f for f in state["#flags"]
                if f[1] != tgt.attr or f[2] == rhs_key)
        return state

    def edge(self, node, kind, pre, post, cfg):
        if kind == df.EXC:
            return pre
        stmt = node.stmt
        if isinstance(stmt, (ast.If, ast.While)) and kind == df.TRUE:
            facts = _facts_from_test(stmt.test, self.leaves,
                                     post["#flags"])
            if facts:
                post = dict(post)
                post["#facts"] = post["#facts"] | facts
        return post

    def join(self, a, b):
        if isinstance(a, frozenset) and isinstance(b, frozenset):
            return a & b
        return a if a == b else None


def _rhs_monotone(stmt: ast.AST, tgt: ast.Attribute) -> str:
    """'ok' | 'violation' | 'guard' for an Assign/AnnAssign store."""
    tgt_name = dotted_name(tgt)
    rhs = stmt.value
    mentions_self = tgt_name and any(
        dotted_name(sub) == tgt_name for sub in ast.walk(rhs))
    if isinstance(rhs, ast.Call) and isinstance(rhs.func, ast.Name) \
            and rhs.func.id == "max" and mentions_self:
        return "ok"
    if isinstance(rhs, ast.BinOp) and isinstance(rhs.op, ast.Add) \
            and tgt_name and (dotted_name(rhs.left) == tgt_name
                              or dotted_name(rhs.right) == tgt_name):
        return "ok"
    if mentions_self:
        return "violation"
    return "guard"


def _check_monotone(sf: SourceFile, fp: _FileProto,
                    findings: list[Finding]) -> None:
    leaves = set(fp.monotone)
    if not leaves:
        return
    for cls, fn in df.iter_functions(sf.tree):
        ctx = f"{cls}.{fn.name}" if cls else fn.name
        in_init = fn.name == "__init__"
        #: id(stmt) -> [(leaf, rhs_key, lineno)] needing a guard fact.
        guard_sites: dict[int, list[tuple[str, str, int]]] = {}
        for stmt in ast.walk(fn):
            for tgt in _store_attr_targets(stmt):
                if tgt.attr not in leaves:
                    continue
                if isinstance(stmt, ast.AugAssign):
                    if not isinstance(stmt.op, ast.Add):
                        findings.append(Finding(
                            RULE, sf.path, stmt.lineno,
                            f"watermark {tgt.attr!r} mutated with "
                            f"{type(stmt.op).__name__}: epoch/seq "
                            f"watermarks may only be compared or "
                            f"monotonically advanced (+=, max, guarded "
                            f"rebind)", ctx))
                    continue
                if in_init:
                    continue  # construction binds the initial watermark
                if (stmt.lineno in fp.rebase
                        or stmt.lineno - 1 in fp.rebase):
                    fp.rebase_used.add(
                        stmt.lineno if stmt.lineno in fp.rebase
                        else stmt.lineno - 1)
                    continue
                verdict = _rhs_monotone(stmt, tgt)
                if verdict == "ok":
                    continue
                if verdict == "violation":
                    findings.append(Finding(
                        RULE, sf.path, stmt.lineno,
                        f"watermark {tgt.attr!r} rewound from its own "
                        f"value: only += / max() / guarded advance keep "
                        f"it monotone", ctx))
                    continue
                guard_sites.setdefault(id(stmt), []).append(
                    (tgt.attr, ast.dump(stmt.value), stmt.lineno))
        if guard_sites:
            cfg = df.CFG(fn)
            df.solve_and_report(
                cfg, _MonotoneAnalysis(sf, leaves, ctx, guard_sites,
                                       findings))


# ---- record-type vocabulary (cross-file) ------------------------------------

class Vocab:
    """Registry of every RT_* record-type constant across the tree (the
    cache-aware engine collects it once over the FULL tree and salts the
    per-file cache with its digest, like locks.ExternalContracts)."""

    def __init__(self) -> None:
        #: name -> value -> sorted paths defining it
        self.defs: dict[str, dict[int, list[str]]] = {}

    @property
    def names(self) -> set[str]:
        return set(self.defs)

    def add(self, name: str, value: int, path: str) -> None:
        paths = self.defs.setdefault(name, {}).setdefault(value, [])
        if path not in paths:
            paths.append(path)

    def digest(self) -> str:
        blob = json.dumps(
            {n: {str(v): sorted(p) for v, p in vs.items()}
             for n, vs in self.defs.items()}, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def collect_vocab(sources: list[SourceFile]) -> Vocab:
    vocab = Vocab()
    for sf in sources:
        if not _in_scope(sf):
            continue
        for stmt in sf.tree.body:
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and _RT_RE.match(stmt.targets[0].id)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, int)):
                continue
            vocab.add(stmt.targets[0].id, stmt.value.value, sf.path)
    return vocab


def _check_vocab(sf: SourceFile, vocab: Vocab,
                 findings: list[Finding]) -> None:
    my_defs: dict[str, tuple[int, int]] = {}
    for stmt in sf.tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and _RT_RE.match(stmt.targets[0].id)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, int)):
            my_defs[stmt.targets[0].id] = (stmt.value.value, stmt.lineno)
    # Same name, different value across the tree (drift).
    for name, (value, ln) in sorted(my_defs.items()):
        values = vocab.defs.get(name, {})
        others = {v: p for v, p in values.items() if v != value}
        if others:
            where = "; ".join(
                f"{v} in {', '.join(p)}" for v, p in sorted(others.items()))
            findings.append(Finding(
                RULE, sf.path, ln,
                f"record-type vocabulary drift: {name} = {value} here but "
                f"{where} — sender, applier and journal_dump must agree",
                f"vocab.{name}"))
    # Two names for one value (alias collision).
    by_value: dict[int, set[str]] = {}
    for name, values in vocab.defs.items():
        for v in values:
            by_value.setdefault(v, set()).add(name)
    for name, (value, ln) in sorted(my_defs.items()):
        twins = by_value.get(value, set()) - {name}
        if twins:
            findings.append(Finding(
                RULE, sf.path, ln,
                f"record-type vocabulary collision: {name} and "
                f"{', '.join(sorted(twins))} share value {value} — an "
                f"applier cannot tell them apart on the wire",
                f"vocab.{name}.collision"))
    # RT_NAMES rendering maps must cover the whole vocabulary.
    for stmt in sf.tree.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == "RT_NAMES"
                and isinstance(stmt.value, ast.Dict)):
            continue
        keys = {k.id for k in stmt.value.keys
                if isinstance(k, ast.Name) and _RT_RE.match(k.id)}
        missing = sorted(vocab.names - keys)
        if missing:
            findings.append(Finding(
                RULE, sf.path, stmt.lineno,
                f"RT_NAMES misses record type(s) {', '.join(missing)}: "
                f"journal_dump would render them as opaque rtypeN",
                "vocab.RT_NAMES"))
    # An applier class must reference every streamed record type.
    for cls in ast.walk(sf.tree):
        if not (isinstance(cls, ast.ClassDef) and "Applier" in cls.name
                and any(isinstance(f, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                        and f.name == "_apply" for f in cls.body)):
            continue
        seen = {n.id for n in ast.walk(cls)
                if isinstance(n, ast.Name) and _RT_RE.match(n.id)}
        missing = sorted(vocab.names - seen
                         - set(_VOCAB_APPLIER_EXEMPT))
        if missing:
            findings.append(Finding(
                RULE, sf.path, cls.lineno,
                f"applier {cls.name} never references record type(s) "
                f"{', '.join(missing)}: a streamed record it cannot "
                f"apply silently diverges the standby",
                f"vocab.{cls.name}"))
    # Schema version literals next to FORMAT_VERSION users.
    if "FORMAT_VERSION" in sf.text:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if (isinstance(k, ast.Constant) and k.value == "version"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, int)):
                    findings.append(Finding(
                        RULE, sf.path, node.lineno,
                        f"schema version hardcoded as "
                        f"{{'version': {v.value}}} in a module that uses "
                        f"FORMAT_VERSION: write the constant, not the "
                        f"literal", "vocab.version"))


# ---- entry point ------------------------------------------------------------

def check(sources: list[SourceFile],
          vocab: "Vocab | None" = None) -> list[Finding]:
    findings: list[Finding] = []
    if vocab is None:
        vocab = collect_vocab(sources)
    for sf in sources:
        if not _in_scope(sf):
            continue
        fp = _collect(sf, findings)
        if fp.anns:
            _check_roles(sf, fp, findings)
            _check_effects(sf, fp, findings)
            _check_undeclared(sf, fp, findings)
            _check_monotone(sf, fp, findings)
            _flag_unconsumed(sf, fp, findings)
        _check_vocab(sf, vocab, findings)
    return findings
