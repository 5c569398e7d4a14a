"""Lock-discipline rules: ``await-under-lock`` and ``guarded-by``.

Both rules encode the port's concurrency contract (service/app.py): each
queue runtime serializes its pool behind one ``asyncio.Lock``,
``_pool_lock``; a window's dispatch runs ON the event loop under it (the
engine only queues device work — the card runs it, and a replayed CUDA
graph costs no host wait); and pool/window bookkeeping must not be
observable in a half-mutated state across an await.  Host-side modules
(journal, replication, forensics, net) guard their own state with
``threading`` locks, checked by the same ``guarded-by`` rule.

**await-under-lock** — inside the body of ``async with <...lock>``, every
``await`` must be one of the sanctioned shapes:

- ``await asyncio.to_thread(...)`` (or ``_shielded_to_thread``, its
  cancellation-hardened form in service/app.py) — the off-loop seam: the
  work blocks a worker thread while the critical section stays closed to
  other event-loop tasks (compaction's snapshot and rotation).
- ``await self._backpressure_wait(...)`` — the pipeline's lock-held
  backpressure wait: a full pipeline holds the flush (and so the batcher)
  until the collector frees a window slot.  Holding ``_pool_lock`` there
  is the design — windows are serialized by it — and the wait itself
  collects landed windows, the only work a slot waits for.
- ``await self.<m>(...)`` where ``m`` is an ``async def`` of the same
  class marked ``# holds-lock: <lock>``: a lock-held coroutine (the flush
  bodies, the dispatch).  Its own body is checked as if it sat inside the
  lock, so the sanction is transitive, never blanket.

Anything else (``asyncio.sleep``, broker RPC, middleware pipelines, bare
coroutines) suspends the critical section at a point where OTHER tasks
can acquire nothing but can observe and schedule against half-updated
host state once the holder resumes.

**guarded-by** — a declaration convention on shared attributes::

    self._inflight_meta = {}  # guarded-by: _pool_lock

Every mutation of a declared attribute (rebind, aug-assign, ``del``,
subscript store, or a mutating method call like ``.pop``/``.append``, and
attribute stores THROUGH it like ``self.engine.device_error = ...``) must
be dominated by the declared lock: lexically inside ``with``/``async
with`` on that lock (the ``with`` shape covers ``threading.Lock``/
``RLock`` in host-side modules — journal, replication, forensics, net —
the same way ``async with`` covers ``asyncio.Lock``), or in a method that
is ``__init__``, ends with ``_locked``, carries ``# holds-lock: <lock>``
on/above its ``def`` line, or is **construction-only**: a private helper
whose every in-class caller is ``__init__`` (directly or through other
construction-only helpers) and that never escapes as a bound value —
construction is single-threaded, no other thread can hold the half-built
instance, so ``__init__``-factored helpers binding guarded attributes
stay undeclared. Calls to ``self.<m>()`` where ``m`` is a lock-holding
method are checked the same way, so the caller-holds-lock convention is
enforced one level deep instead of trusted.

**cross-class mode** — a class whose WHOLE public surface is serialized by
a lock its CALLER owns (``GpuEngine``: no internal locks, driven only by
the owning queue runtime under ``_pool_lock``) declares the contract on
the class itself::

    # externally-serialized-by: _pool_lock
    # lock-free: pool_size, inflight, util_report
    class GpuEngine(Engine):

When any class declares ``externally-serialized-by: L``, every METHOD CALL
through an attribute guarded by ``L`` (``self.engine.search_async(...)``
where ``self.engine`` carries ``# guarded-by: _pool_lock``) is checked
like a mutation: the call site must hold ``L`` (lexically, or via a
``*_locked``/``holds-lock`` method). ``lock-free:`` names the read-only
methods exempt from the contract (point reads safe off-lock — pool_size
for admission, inflight for backpressure); the exemption set is the UNION
across declaring classes, since the static checker binds by lock name, not
by type.
"""

from __future__ import annotations

import ast
import re

from matchmaking_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    dotted_name,
    in_package,
)

AWAIT_RULE = "await-under-lock"
GUARD_RULE = "guarded-by"

#: Awaited callables allowed inside a lock body (dotted suffix match):
#: the off-loop seam.  ``_shielded_to_thread`` is service/app's
#: cancellation-hardened ``asyncio.to_thread`` (shield detaches the await
#: chain from the thread task); the work is off-loop exactly like
#: to_thread — the runtime sanitizer sanctions the same name
#: (testing/sanitizer.py).
ALLOWED_AWAIT_CALLS = ("asyncio.to_thread", "_shielded_to_thread")
#: Lock-held waits allowed by name: the pipeline's backpressure wait
#: (``_QueueRuntime._backpressure_wait``), which holds ``_pool_lock``
#: while the collector frees a window slot — the sanitizer sanctions the
#: same name.
ALLOWED_AWAIT_METHODS = ("_backpressure_wait",)

#: Container/set/dict methods that mutate their receiver.
MUTATORS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popleft", "popitem", "appendleft", "remove", "discard", "clear",
})

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*(\w+)")
_EXT_RE = re.compile(r"#\s*externally-serialized-by:\s*(\w+)")
_LOCKFREE_RE = re.compile(r"#\s*lock-free:\s*([\w\s,]+)")


class ExternalContracts:
    """Cross-class registry: which locks have an externally-serialized
    class declared against them, and which method names those classes
    exempt as lock-free reads. Collected in one pass over ALL sources
    (the declaring class and its callers live in different files)."""

    def __init__(self) -> None:
        self.locks: set[str] = set()
        self.lockfree: dict[str, set[str]] = {}
        #: lock -> class names declaring it (for messages).
        self.classes: dict[str, list[str]] = {}


def collect_external(sources: list[SourceFile]) -> ExternalContracts:
    ec = ExternalContracts()
    for sf in sources:
        if not in_package(sf):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            lock = None
            free: set[str] = set()
            # The contract comments sit directly above the class line
            # (decorators would shift lineno to the decorator — these
            # classes carry none; a 4-line window tolerates both comment
            # lines plus blank spacing).
            for ln in range(max(1, node.lineno - 4), node.lineno + 1):
                line = sf.line_at(ln)
                m = _EXT_RE.search(line)
                if m:
                    lock = m.group(1)
                m = _LOCKFREE_RE.search(line)
                if m:
                    free.update(x.strip() for x in m.group(1).split(",")
                                if x.strip())
            if lock:
                ec.locks.add(lock)
                ec.lockfree.setdefault(lock, set()).update(free)
                ec.classes.setdefault(lock, []).append(node.name)
    return ec


def _is_lock_expr(node: ast.AST) -> str | None:
    """The lock's attribute/variable name when ``node`` looks like a lock
    (name ends in ``lock``), else None."""
    name = dotted_name(node)
    leaf = name.rsplit(".", 1)[-1] if name else ""
    return leaf if leaf.lower().endswith("lock") else None


def _await_allowed(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False  # awaiting a bare name/attribute: not analyzable, flag
    name = dotted_name(call.func)
    if any(name == a or name.endswith("." + a) for a in ALLOWED_AWAIT_CALLS):
        return True
    leaf = name.rsplit(".", 1)[-1] if name else ""
    return leaf in ALLOWED_AWAIT_METHODS


def _holding_coroutines(sf: SourceFile, cls: ast.ClassDef) -> dict[str, str]:
    """``async def`` methods of ``cls`` marked ``# holds-lock: <lock>``:
    name -> lock."""
    out: dict[str, str] = {}
    for item in cls.body:
        if isinstance(item, ast.AsyncFunctionDef):
            lock = _comment_match(sf, item.lineno, _HOLDS_RE)
            if lock:
                out[item.name] = lock
    return out


class _AwaitUnderLock(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: list[Finding] = []
        self._stack: list[ast.AST] = []
        self._held: list[str] = []
        #: The enclosing class's lock-held coroutines (name -> lock).
        self._holding: dict[str, str] = {}

    def _context(self) -> str:
        from matchmaking_tpu_torch.analysis.core import qualname_of

        return qualname_of(self._stack)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node)
        holding, self._holding = (self._holding,
                                  _holding_coroutines(self.sf, node))
        self.generic_visit(node)
        self._holding = holding
        self._stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # A nested sync def's body runs wherever it is CALLED (often inside
        # to_thread); its awaits can't exist, its lexical position under a
        # lock is irrelevant — still descend for nested async defs.
        self._stack.append(node)
        held, self._held = self._held, []
        self.generic_visit(node)
        self._held = held
        self._stack.pop()

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        # A lock-held coroutine's body is checked as if it sat in the lock
        # — except a sanctioned wait's own body: its suspension IS the
        # sanctioned shape.
        self._stack.append(node)
        lock = (self._holding.get(node.name)
                if len(self._stack) >= 2
                and isinstance(self._stack[-2], ast.ClassDef)
                and node.name not in ALLOWED_AWAIT_METHODS else None)
        held, self._held = self._held, [lock] if lock else []
        self.generic_visit(node)
        self._held = held
        self._stack.pop()

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        locks = [n for item in node.items
                 if (n := _is_lock_expr(item.context_expr))]
        self._held.extend(locks)
        for stmt in node.body:
            self.visit(stmt)
        for _ in locks:
            self._held.pop()

    def _holding_call(self, call: ast.AST) -> bool:
        """``self.m(...)`` of a lock-held coroutine of this class."""
        return (isinstance(call, ast.Call)
                and _self_attr(call.func) in self._holding)

    def visit_Await(self, node: ast.Await) -> None:
        if (self._held and not _await_allowed(node.value)
                and not self._holding_call(node.value)):
            awaited = dotted_name(
                node.value.func if isinstance(node.value, ast.Call)
                else node.value) or "<expr>"
            self.findings.append(Finding(
                AWAIT_RULE, self.sf.path, node.lineno,
                f"await of {awaited!r} while holding "
                f"{'/'.join(self._held)}: the critical section suspends at "
                f"a point other tasks can interleave with "
                f"(sanction via asyncio.to_thread or a holds-lock helper)",
                self._context()))
        self.generic_visit(node)


# ---- guarded-by ------------------------------------------------------------

class _MethodInfo:
    __slots__ = ("node", "holds")

    def __init__(self, node: ast.AST, holds: set[str]):
        self.node = node
        self.holds = holds


def _comment_match(sf: SourceFile, lineno: int, rx: re.Pattern) -> str | None:
    """Match ``rx`` on ``lineno`` or the line directly above it."""
    for ln in (lineno, lineno - 1):
        m = rx.search(sf.line_at(ln))
        if m:
            return m.group(1)
    return None


def _self_attr(node: ast.AST) -> str | None:
    """``X`` when node is ``self.X``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _root_self_attr(node: ast.AST) -> str | None:
    """The first attribute off ``self`` in a chain like
    ``self.X.y[...].z`` — the object whose state the statement mutates."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


class _GuardedByClass:
    """Per-class analysis: collect declarations, then check every method."""

    def __init__(self, sf: SourceFile, cls: ast.ClassDef,
                 findings: list[Finding],
                 external: "ExternalContracts | None" = None):
        self.sf = sf
        self.cls = cls
        self.findings = findings
        self.external = external
        self.guarded: dict[str, str] = {}   # attr -> lock
        self.methods: dict[str, _MethodInfo] = {}
        self._collect()
        self._ctor_only = self._construction_only()

    def _collect(self) -> None:
        for item in self.cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            holds: set[str] = set()
            lock = _comment_match(self.sf, item.lineno, _HOLDS_RE)
            if lock:
                holds.add(lock)
            self.methods[item.name] = _MethodInfo(item, holds)
            for node in ast.walk(item):
                # Both assignment forms declare: `self.x = ...` AND the
                # annotated `self.x: T = ...` (missing the latter would
                # silently disarm any guard on an annotated attribute).
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                else:
                    continue
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr is None:
                        continue
                    g = _comment_match(self.sf, node.lineno, _GUARD_RE)
                    if g:
                        self.guarded[attr] = g

    def _construction_only(self) -> set[str]:
        """Private helpers reachable ONLY from ``__init__`` (directly or
        through other construction-only helpers) and never referenced as
        a bound value (a callback could run on any thread). Construction
        is single-threaded — no other thread holds the half-built
        instance — so their guarded-attribute binds need no lock."""
        callers: dict[str, set[str]] = {}
        escaped: set[str] = set()
        for name, info in self.methods.items():
            call_funcs: set[int] = set()
            for node in ast.walk(info.node):
                if isinstance(node, ast.Call):
                    call_funcs.add(id(node.func))
                    attr = _self_attr(node.func)
                    if attr in self.methods:
                        callers.setdefault(attr, set()).add(name)
            for node in ast.walk(info.node):
                attr = _self_attr(node)
                if attr in self.methods and id(node) not in call_funcs:
                    escaped.add(attr)
        ctor: set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, info in self.methods.items():
                # An async def "called" in __init__ only CREATES the
                # coroutine (create_task(self._loop())) — the body runs
                # concurrently later, the opposite of construction-only.
                if (name in ctor or not name.startswith("_")
                        or name.startswith("__") or name in escaped
                        or isinstance(info.node, ast.AsyncFunctionDef)):
                    continue
                calls = callers.get(name)
                if calls and all(c == "__init__" or c in ctor
                                 for c in calls):
                    ctor.add(name)
                    changed = True
        return ctor

    def _method_holds(self, name: str, lock: str) -> bool:
        if (name == "__init__" or name.endswith("_locked")
                or name in self._ctor_only):
            return True
        info = self.methods.get(name)
        return info is not None and lock in info.holds

    def check(self) -> None:
        if not self.guarded:
            return
        lockers = {
            name for name, info in self.methods.items()
            if info.holds or name.endswith("_locked")
        }
        for name, info in self.methods.items():
            _MethodChecker(self, name, lockers).visit(info.node)


class _MethodChecker(ast.NodeVisitor):
    """Walks one method tracking which locks are lexically held. Nested
    defs inherit the current held set: a closure defined inside the lock
    block is dispatched while the section is closed (``to_thread``)."""

    def __init__(self, owner: _GuardedByClass, method: str,
                 lockers: set[str]):
        self.owner = owner
        self.method = method
        self.lockers = lockers
        self._held: list[str] = []

    def _ok(self, lock: str) -> bool:
        return lock in self._held or self.owner._method_holds(
            self.method, lock)

    def _flag(self, node: ast.AST, attr: str, lock: str, what: str) -> None:
        self.owner.findings.append(Finding(
            GUARD_RULE, self.owner.sf.path, node.lineno,
            f"{what} of {attr!r} (guarded-by: {lock}) outside the lock: "
            f"hold {lock}, move into a *_locked/holds-lock method, or "
            f"annotate why the site is safe",
            f"{self.owner.cls.name}.{self.method}"))

    def _with(self, node: ast.With | ast.AsyncWith) -> None:
        locks = [n for item in node.items
                 if (n := _is_lock_expr(item.context_expr))]
        self._held.extend(locks)
        for stmt in node.body:
            self.visit(stmt)
        for _ in locks:
            self._held.pop()

    visit_With = _with
    visit_AsyncWith = _with

    def _check_target(self, node: ast.AST, tgt: ast.AST, what: str) -> None:
        attr = _root_self_attr(tgt)
        if attr is None:
            return
        lock = self.owner.guarded.get(attr)
        if lock is not None and not self._ok(lock):
            self._flag(node, attr, lock, what)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            targets = tgt.elts if isinstance(tgt, (ast.Tuple,
                                                   ast.List)) else [tgt]
            for t in targets:
                self._check_target(node, t, "mutation")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_target(node, node.target, "mutation")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node, node.target, "mutation")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._check_target(node, tgt, "deletion")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            # self.X.pop(...) / self.X[...].append(...): receiver mutation.
            if func.attr in MUTATORS:
                self._check_target(node, func.value, f"{func.attr}()")
            elif self.owner.external is not None:
                # Cross-class mode: ANY method call through an attribute
                # guarded by a lock some class declares itself
                # externally-serialized-by is a use of that class's
                # contract — the caller must hold the lock unless the
                # method is on the declared lock-free read list.
                root = _root_self_attr(func.value)
                if root is not None:
                    lock = self.owner.guarded.get(root)
                    ext = self.owner.external
                    if (lock is not None and lock in ext.locks
                            and func.attr not in ext.lockfree.get(lock, ())
                            and not self._ok(lock)):
                        who = "/".join(ext.classes.get(lock, ())) or "?"
                        self.owner.findings.append(Finding(
                            GUARD_RULE, self.owner.sf.path, node.lineno,
                            f"call {root}.{func.attr}() outside {lock}: "
                            f"{who} is externally-serialized-by {lock} — "
                            f"hold the lock, move the call into a "
                            f"*_locked/holds-lock method, or add "
                            f"{func.attr!r} to the class's lock-free list "
                            f"if it is a safe point read",
                            f"{self.owner.cls.name}.{self.method}"))
            # self.M(...) where M is a lock-holding method: the callee
            # assumes the lock; verify this caller actually provides it.
            attr = _self_attr(func)
            if attr in self.lockers:
                info = self.owner.methods.get(attr)
                locks = (info.holds if info and info.holds
                         else {"_pool_lock"})
                for lock in locks:
                    if not self._ok(lock):
                        self.owner.findings.append(Finding(
                            GUARD_RULE, self.owner.sf.path, node.lineno,
                            f"call to lock-holding method {attr!r} without "
                            f"{lock}: acquire it first or mark the caller "
                            f"holds-lock",
                            f"{self.owner.cls.name}.{self.method}"))
        self.generic_visit(node)


def check(sources: list[SourceFile],
          external: "ExternalContracts | None" = None) -> list[Finding]:
    findings: list[Finding] = []
    # Pass 1: cross-class contracts (the declaring class and its callers
    # live in different files, so the registry spans all sources).  The
    # cache-aware engine passes a registry collected over the FULL tree
    # while checking one file at a time.
    if external is None:
        external = collect_external(sources)
    for sf in sources:
        if not in_package(sf):
            continue
        v = _AwaitUnderLock(sf)
        v.visit(sf.tree)
        findings.extend(v.findings)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                _GuardedByClass(sf, node, findings,
                                external=external).check()
    return findings
