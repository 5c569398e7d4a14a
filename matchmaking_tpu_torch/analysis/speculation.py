"""``speculation``: the validate-before-commit ordering for speculative
formation.

A committed speculative window must carry a validation token newer than
the last pool mutation: ``spec_commit`` is only sound immediately after a
``spec_validate`` on the same engine with NO pool mutation in between —
the O(1) cut-time check compares the speculation's basis sequence against
the engine's mutation clock, and any admit/evict/expire/remove/restore/
rebuild between the two calls makes the stamped token stale. The engine
raises on the broken orderings at runtime and the sanitizer's speculation
twin observes them dynamically; this rule catches them at lint time,
lexically, so a refactor that slides a mutation between the validate and
the commit (or drops the validate entirely) fails the gate before any
test runs.

Per function (statement order, one shared state — the lexical
approximation matches how every legitimate call site is written: validate
and commit adjacent under the engine lock):

- a ``*.spec_validate(...)`` call arms the validation;
- any pool-mutating or speculation-consuming call disarms it —
  search/rescan/remove/expire/restore/heartbeat/probe/warmup and the
  speculation seam's own ``speculate``/``spec_invalidate``;
- a ``*.spec_commit(...)`` call while disarmed is the finding
  (commit-without-validate, or validate-after-mutate when a mutation
  disarmed an earlier validate). A commit also consumes the arm — two
  commits need two validates.

Scope: package code only (``in_package``); tests plant their own broken
orderings as fixtures.
"""

from __future__ import annotations

import ast
import collections

from matchmaking_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    in_package,
    qualname_of,
)

RULE = "speculation"

#: Calls that disarm a pending validation: every engine entry point that
#: advances the mutation clock (or consumes/replaces the speculation).
_MUTATORS = frozenset({
    "search", "search_async", "search_columns_async", "rescan",
    "rescan_async", "remove", "expire", "expire_deadlines", "restore",
    "restore_columns", "heartbeat", "probe", "warmup", "speculate",
    "spec_invalidate", "_pool_mutated",
})


def _call_attr(node: ast.Call) -> str | None:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


def _own_calls(func: ast.AST) -> list[ast.Call]:
    """The calls whose innermost enclosing function is ``func`` (a nested
    def's calls belong to it: it runs on its own schedule)."""
    out: list[ast.Call] = []
    todo = collections.deque(ast.iter_child_nodes(func))  # ast.walk's order
    while todo:
        node = todo.popleft()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Call):
            out.append(node)
        todo.extend(ast.iter_child_nodes(node))
    return out


class _SpecScanner(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: list[Finding] = []
        self._stack: list[ast.AST] = []

    def _visit_func(self, node) -> None:
        self._stack.append(node)
        # Lexical pass over THIS function's calls only (nested defs get
        # their own pass — they run on their own schedule).
        calls = sorted(_own_calls(node),
                       key=lambda c: (c.lineno, c.col_offset))
        validated = False
        for call in calls:
            attr = _call_attr(call)
            if attr == "spec_validate":
                validated = True
            elif attr == "spec_commit":
                if not validated:
                    self.findings.append(Finding(
                        RULE, self.sf.path, call.lineno,
                        "spec_commit without a live spec_validate: a "
                        "committed speculative window must carry a "
                        "validation token newer than the last pool "
                        "mutation — call spec_validate immediately before "
                        "spec_commit with no pool mutation in between",
                        qualname_of(self._stack)))
                validated = False  # a commit consumes its validation
            elif attr in _MUTATORS:
                validated = False
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()


def check(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in sources:
        if not in_package(sf):
            continue
        v = _SpecScanner(sf)
        v.visit(sf.tree)
        findings.extend(v.findings)
    return findings
