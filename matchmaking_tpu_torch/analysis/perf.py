"""``perf``: O(pool)/O(matches) host-side scans on the hot path.

The 8× service/engine gap (ROADMAP: the device idles behind Python host
work) is exactly the regression this rule gates: the columnar hot path is
scan-free by design — per-request Python is ONE dict membership in
``search_columns_async`` and everything else is vectorized numpy — and one
innocent-looking ``for`` over a pool column or a full-column
``np.asarray`` quietly reintroduces the O(pool) wall the reference hit at
~2k players. The quality-accumulation path is armed under this rule:
its device kernel + vectorized host fallback must STAY scan-free.

Scope: functions whose name marks them as hot-path — containing ``flush``,
``dispatch``, ``collect``, ``settle``, ``finalize``, ``submit`` or
``accum``, or starting with ``search_columns`` (the oracle's ``search``/
``_search_1v1`` sequential scan is its SEMANTICS, not a regression, and is
deliberately out of scope). Inside those:

- a ``for``/comprehension/generator iterating an expression that touches a
  pool surface — a ``m_<column>`` mirror attribute, ``waiting()``/
  ``waiting_slots()``, or the ``_entries``/``_slot_of`` oracle tables —
  is an O(pool) host scan;
- ``np.asarray(...)``/``np.array(...)`` whose argument IS a bare pool
  column attribute (``pool.m_rating``) materializes the full column;
  a SUBSCRIPTED column (``pool.m_rating[slots]``) is the sanctioned
  vectorized read and is not flagged;
- ``<pool column>.tolist()`` — same full-column materialization;
- a ``request_at(...)`` call inside any loop — per-element object
  materialization, O(elements)·(10-20 µs each);
- **per-delivery wire work inside the window loops** (the
  window-granular hot path must STAY window-granular): a
  ``headers[...]`` subscript or ``headers.get(...)`` call inside a loop
  (parse once at admission, cache on the Delivery — ``tier`` /
  ``deadline`` / ``first_received``), and an ``encode_response(...)``
  call inside a loop (bodies come from the native batch encoder; the
  Python encoder is the per-ROW fallback, sanctioned by an inline
  ignore). Hot scope additionally covers ``handle``-named functions
  (``_handle_columnar_out`` is the egress hot loop).

Sanctioned object-path sites (team finalize, object 1v1 finalize — whole
code paths whose contract IS per-object work; NEEDS_PYTHON fallback rows)
carry ``# matchlint: ignore[perf] <reason>``.
"""

from __future__ import annotations

import ast
import re

from matchmaking_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    dotted_name,
    in_package,
    qualname_of,
)

RULE = "perf"

#: Function-name predicate for the hot path.
_HOT_NAME = re.compile(
    r"(flush|dispatch|collect|settle|finalize|submit|accum|handle)"
    r"|^_?search_columns")

#: Attribute names that ARE the pool surface.
_POOL_COL = re.compile(r"^m_[a-z_]+$")
_POOL_CALLS = frozenset({"waiting", "waiting_slots"})
_POOL_ATTRS = frozenset({"_entries", "_slot_of"})


def _pool_surface(node: ast.AST) -> str | None:
    """Name of the pool surface an expression touches ('' = none): any
    ``m_*`` attribute, a ``waiting()``/``waiting_slots()`` call, or the
    oracle's ``_entries``/``_slot_of`` tables."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            if _POOL_COL.match(sub.attr) or sub.attr in _POOL_ATTRS:
                return sub.attr
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            if sub.func.attr in _POOL_CALLS:
                return f"{sub.func.attr}()"
    return None


class _HotScanner(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: list[Finding] = []
        self._stack: list[ast.AST] = []
        self._hot_depth = 0
        self._loop_depth = 0

    # ---- function scoping --------------------------------------------------

    def _visit_func(self, node) -> None:
        self._stack.append(node)
        hot = bool(_HOT_NAME.search(node.name))
        self._hot_depth += hot
        # A nested def starts a fresh loop context (it runs when called).
        depth, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = depth
        self._hot_depth -= hot
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    # ---- loops over pool surfaces ------------------------------------------

    def _check_iter(self, iter_node: ast.AST, lineno: int) -> None:
        if self._hot_depth <= 0:
            return
        surface = _pool_surface(iter_node)
        if surface is not None:
            self.findings.append(Finding(
                RULE, self.sf.path, lineno,
                f"O(pool) host scan: loop iterates over pool surface "
                f"{surface!r} inside a hot-path function — vectorize over "
                f"the mirror columns instead",
                qualname_of(self._stack)))

    def _visit_loop(self, node) -> None:
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._check_iter(node.iter, node.lineno)
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter, node.lineno)
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    # ---- full-column materialization + per-element object builds -----------

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if (self._hot_depth > 0 and self._loop_depth > 0
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "headers"):
            self.findings.append(Finding(
                RULE, self.sf.path, node.lineno,
                "per-delivery header parse: headers[...] inside a loop in "
                "a hot-path function — parse once at admission and cache "
                "on the Delivery (tier/deadline/first_received)",
                qualname_of(self._stack)))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self._hot_depth > 0:
            name = dotted_name(node.func)
            if (self._loop_depth > 0
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr == "headers"):
                self.findings.append(Finding(
                    RULE, self.sf.path, node.lineno,
                    "per-delivery header parse: headers.get(...) inside a "
                    "loop in a hot-path function — parse once at admission "
                    "and cache on the Delivery",
                    qualname_of(self._stack)))
            if (self._loop_depth > 0
                    and (name == "encode_response"
                         or name.endswith(".encode_response"))):
                self.findings.append(Finding(
                    RULE, self.sf.path, node.lineno,
                    "per-element response encode: encode_response() inside "
                    "a loop in a hot-path function — use the native batch "
                    "encoder (codec.encode_matched_batch / "
                    "encode_simple_batch); the Python encoder is the "
                    "per-ROW fallback only (ignore[perf] with a reason)",
                    qualname_of(self._stack)))
            if (name.endswith((".asarray", ".array"))
                    and node.args
                    and isinstance(node.args[0], ast.Attribute)
                    and _POOL_COL.match(node.args[0].attr)):
                self.findings.append(Finding(
                    RULE, self.sf.path, node.lineno,
                    f"full-column materialization: "
                    f"{name}(…{node.args[0].attr}) copies the whole pool "
                    f"column on the hot path — index the column "
                    f"(col[slots]) instead",
                    qualname_of(self._stack)))
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "tolist"
                    and isinstance(node.func.value, ast.Attribute)
                    and _POOL_COL.match(node.func.value.attr)):
                self.findings.append(Finding(
                    RULE, self.sf.path, node.lineno,
                    f"full-column materialization: "
                    f"{node.func.value.attr}.tolist() on the hot path",
                    qualname_of(self._stack)))
            if (self._loop_depth > 0
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "request_at"):
                self.findings.append(Finding(
                    RULE, self.sf.path, node.lineno,
                    "per-element object materialization: request_at() "
                    "inside a loop in a hot-path function (~10-20 µs per "
                    "object) — keep the columnar form or move off the hot "
                    "path",
                    qualname_of(self._stack)))
        self.generic_visit(node)


def check(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in sources:
        if not in_package(sf):
            continue
        v = _HotScanner(sf)
        v.visit(sf.tree)
        findings.extend(v.findings)
    return findings
