"""``blocking-call``: event-loop stalls you can see lexically.

The service is one asyncio loop per process; every millisecond a callback
blocks is a millisecond EVERY queue's consumers, sweepers, and auth RPC
deadlines stall.  The port dispatches its windows ON the loop, so its
hot path must never wait for the card there: the step is queued (a
replayed CUDA graph) and its results come back into pinned host tensors
behind a CUDA event that the collector polls — a blocking call appearing
lexically inside an ``async def`` body is almost always a bug.

Flagged inside async bodies (nested sync ``def``/``lambda`` bodies are
excluded — they execute wherever they are CALLED, usually a worker
thread):

- ``time.sleep(...)`` — use ``await asyncio.sleep``.
- ``open(...)`` — sync file I/O; move to a thread.
- torch host syncs — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()`` (each one copies a device tensor to the host and waits
  for the stream), ``torch.cuda.synchronize()``, and an event's or a
  stream's ``.synchronize()`` — plus ``np.asarray(...)`` of a tensor.
  Each parks the loop on the device's queue. Readback belongs in the
  engine's event-guarded pinned copies, or off-loop.

The method names are matched on any receiver (the rule is lexical: it
cannot tell a tensor from a numpy array or a list), so a host-side
``.tolist()`` of a numpy column in an async body reads as a finding too:
move it into a sync helper (the usual shape — the window's numpy work
lives in sync methods the coroutine calls) or suppress it with a reason.

Intentional sites (rare admin endpoints, bounded one-shot work) carry
``# matchlint: ignore[blocking-call] <reason>``.
"""

from __future__ import annotations

import ast

from matchmaking_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    dotted_name,
    in_package,
    qualname_of,
)

RULE = "blocking-call"

#: Dotted-call suffixes that block the loop, with the suggested fix.
BLOCKING_CALLS: dict[str, str] = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "torch.cuda.synchronize": "collect via the engine's off-loop readback",
    "np.asarray": "host-syncs a device tensor; readback belongs off-loop",
    "numpy.asarray": "host-syncs a device tensor; readback belongs "
                     "off-loop",
}
#: Method names that host-sync whatever they're called on (no arguments).
BLOCKING_METHODS: dict[str, str] = {
    "item": "host-syncs a device scalar; materialize off-loop",
    "tolist": "host-syncs a device tensor; materialize off-loop",
    "cpu": "copies a device tensor to the host and waits; use the "
           "engine's pinned, event-guarded readback",
    "numpy": "host-syncs a device tensor; materialize off-loop",
    "synchronize": "device sync; run via asyncio.to_thread",
}


class _AsyncBodyScanner(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: list[Finding] = []
        self._stack: list[ast.AST] = []
        self._async_depth = 0

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # Sync body: not loop code (even when nested in an async def).
        self._stack.append(node)
        depth, self._async_depth = self._async_depth, 0
        self.generic_visit(node)
        self._async_depth = depth
        self._stack.pop()

    def visit_Lambda(self, node: ast.Lambda) -> None:
        depth, self._async_depth = self._async_depth, 0
        self.generic_visit(node)
        self._async_depth = depth

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._stack.append(node)
        self._async_depth += 1
        self.generic_visit(node)
        self._async_depth -= 1
        self._stack.pop()

    def visit_Call(self, node: ast.Call) -> None:
        if self._async_depth > 0:
            name = dotted_name(node.func)
            hint = None
            what = name
            if name == "open":
                hint = "sync file I/O on the event loop; move to a thread"
            else:
                for suffix, h in BLOCKING_CALLS.items():
                    if name == suffix or name.endswith("." + suffix):
                        hint = h
                        break
            if hint is None and isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if meth in BLOCKING_METHODS and not node.args \
                        and not node.keywords:
                    hint = BLOCKING_METHODS[meth]
                    what = f".{meth}()"
            if hint is not None:
                self.findings.append(Finding(
                    RULE, self.sf.path, node.lineno,
                    f"blocking call {what!r} in an async body: {hint}",
                    qualname_of(self._stack)))
        self.generic_visit(node)


def check(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in sources:
        if not in_package(sf):
            continue
        v = _AsyncBodyScanner(sf)
        v.visit(sf.tree)
        findings.extend(v.findings)
    return findings
