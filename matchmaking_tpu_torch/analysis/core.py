"""matchlint core: findings, ignore comments, baseline, source discovery.

The analyzer is project-specific by design: its rules encode THIS
package's concurrency contract — each queue runtime serializes its pool
behind one ``asyncio.Lock``, ``_pool_lock``, and dispatches its windows on
the event loop (the engine only queues device work; the card runs it);
host-side modules (journal, replication, forensics, net) guard their state
with ``threading`` locks; and chaos replay determinism forbids unseeded
RNGs, the torch generators included. Generic linters can't see any of
that.

Vocabulary shared by every rule module:

- ``Finding`` — one violation: rule, file, line, message, plus a
  ``context`` (the enclosing ``Class.method`` qualname) that anchors the
  baseline fingerprint so line drift doesn't churn the baseline.
- ``# matchlint: ignore[rule-a,rule-b] <reason>`` — inline suppression on
  the offending line or the line directly above it. The reason is
  REQUIRED: a bare ignore is inactive (the finding still reports), so
  every suppression documents why the pattern is intentional.
- ``analysis/baseline.json`` — checked-in fingerprints of accepted
  findings (empty when the gate is clean). ``--write-baseline``
  regenerates it; entries carry a ``reason`` like inline ignores do.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Iterable

#: Every rule the suite ships (rule modules register against these names).
RULES = (
    "await-under-lock",
    "guarded-by",
    "blocking-call",
    "determinism",
    "perf",
    "settlement",
    "lock-pairing",
    "stale-ignore",
    "speculation",
    "protocol",
    "recompile",
    "device",
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    #: Enclosing ``Class.method`` (or module-level ``<module>``): the
    #: baseline anchor — stable across unrelated line churn.
    context: str = ""

    def fingerprint(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.context)

    def render(self) -> str:
        where = f" (in {self.context})" if self.context else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{where}"


_IGNORE_RE = re.compile(
    r"#\s*matchlint:\s*ignore\[([a-z\-, ]+)\]\s*(\S.*)?")


def _comment_lines(lines: list[str],
                   source: str | None) -> "list[tuple[int, str]]":
    """(lineno, comment text) for every REAL comment token.  Tokenizing
    (rather than regex over raw lines) keeps ignore syntax quoted inside
    docstrings and test-fixture strings from registering as live ignores —
    which the stale-ignore rule would otherwise flag forever."""
    if source is None:
        return list(enumerate(lines, start=1))
    import io
    import tokenize

    try:
        return [(tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline)
                if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        return list(enumerate(lines, start=1))


class IgnoreMap:
    """Per-file map of line → rules suppressed there. An ignore covers its
    own line and the line below it (so a comment can sit above a long
    statement). Ignores without a reason are INACTIVE.

    Usage is tracked per (comment line, rule): an active ignore that
    suppresses nothing in a full-rules run becomes a ``stale-ignore``
    finding itself (suppression hygiene — dead ignores hide future real
    findings at the same line)."""

    def __init__(self, lines: list[str], source: str | None = None):
        #: line → {(rule, owning comment line)}.
        self._by_line: dict[int, set[tuple[str, int]]] = {}
        #: (comment line, rules named there) for every ACTIVE ignore.
        self.entries: list[tuple[int, frozenset[str]]] = []
        self.bare: list[int] = []  # ignores missing the required reason
        #: (comment line, rule) pairs that suppressed at least one finding
        #: this run (filled by apply_ignores).
        self.used: set[tuple[int, str]] = set()
        for i, text in _comment_lines(lines, source):
            m = _IGNORE_RE.search(text)
            if not m:
                continue
            if not (m.group(2) or "").strip():
                self.bare.append(i)
                continue
            rules = frozenset(r.strip() for r in m.group(1).split(",")
                              if r.strip())
            self.entries.append((i, rules))
            for rule in rules:
                self._by_line.setdefault(i, set()).add((rule, i))
                self._by_line.setdefault(i + 1, set()).add((rule, i))

    def suppressed(self, line: int, rule: str) -> bool:
        for r, comment_line in self._by_line.get(line, ()):
            if r == rule:
                self.used.add((comment_line, rule))
                return True
        return False


class SourceFile:
    """One parsed source file: text, lines, AST, and its ignore map."""

    def __init__(self, root: str, relpath: str):
        self.root = root
        self.path = relpath.replace(os.sep, "/")
        with open(os.path.join(root, relpath), encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=relpath)
        self.ignores = IgnoreMap(self.lines, source=self.text)

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


#: What the analyzer walks (repo-relative): the port package whole, and
#: the port's own files beside it — its tests, its smoke, its scripts.
#: Rule modules narrow further via path predicates (e.g. blocking-call
#: scans the package only).
PACKAGE = "matchmaking_tpu_torch"
DEFAULT_SCAN_DIRS = (PACKAGE,)
DEFAULT_SCAN_FILES = ("chip_smoke.py",)
#: (directory, file-name prefix) pairs: only the port's files there.
DEFAULT_SCAN_PREFIXED = (("tests", "test_torch_"), ("scripts", "torch_"))
_SKIP_PARTS = {"__pycache__", ".git"}


def discover(root: str) -> list[SourceFile]:
    out: list[SourceFile] = []
    for rel in DEFAULT_SCAN_FILES:
        if os.path.isfile(os.path.join(root, rel)):
            out.append(SourceFile(root, rel))
    for base, prefix in DEFAULT_SCAN_PREFIXED:
        top = os.path.join(root, base)
        if not os.path.isdir(top):
            continue
        for name in sorted(os.listdir(top)):
            if name.startswith(prefix) and name.endswith(".py"):
                out.append(SourceFile(root, os.path.join(base, name)))
    for base in DEFAULT_SCAN_DIRS:
        top = os.path.join(root, base)
        if not os.path.isdir(top):
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_PARTS)
            for name in sorted(filenames):
                if name.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, name), root)
                    out.append(SourceFile(root, rel))
    return out


def in_package(sf: SourceFile) -> bool:
    """The port package without its own analyzer."""
    return sf.path.startswith(PACKAGE + "/") and not sf.path.startswith(
        PACKAGE + "/analysis/")


def qualname_of(stack: Iterable[ast.AST]) -> str:
    """``Class.method`` context from an enclosing-node stack."""
    parts = [
        node.name for node in stack
        if isinstance(node, (ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef))
    ]
    return ".".join(parts) if parts else "<module>"


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains ('' when not a plain chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def apply_ignores(findings: list[Finding],
                  sources: dict[str, SourceFile]) -> list[Finding]:
    """Drop findings suppressed by an (active, reasoned) inline ignore."""
    kept = []
    for f in findings:
        sf = sources.get(f.path)
        if sf is not None and sf.ignores.suppressed(f.line, f.rule):
            continue
        kept.append(f)
    return kept


def stale_ignores(sources: "Iterable[SourceFile]") -> list[Finding]:
    """Suppression hygiene: every ACTIVE ignore that suppressed nothing in
    this (full-rules) run is itself a finding.  Call after apply_ignores —
    usage marks accumulate there."""
    out: list[Finding] = []
    for sf in sources:
        for comment_line, rules in sf.ignores.entries:
            dead = [r for r in sorted(rules)
                    if r != "stale-ignore"
                    and (comment_line, r) not in sf.ignores.used]
            if dead:
                out.append(Finding(
                    "stale-ignore", sf.path, comment_line,
                    f"ignore[{','.join(dead)}] no longer suppresses any "
                    f"finding — the violation it excused is gone; delete "
                    f"the comment (dead ignores silently hide FUTURE "
                    f"findings on this line)",
                    f"ignore@{comment_line}"))
    return out


# ---- baseline --------------------------------------------------------------

def load_baseline(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return list(data.get("findings", []))


def write_baseline(path: str, findings: list[Finding]) -> None:
    entries = [
        {"rule": f.rule, "path": f.path, "context": f.context,
         "reason": "TODO: document why this finding is accepted"}
        for f in sorted(set(findings),
                        key=lambda f: (f.path, f.rule, f.context))
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"findings": entries}, f, indent=2, sort_keys=True)
        f.write("\n")


def update_baseline(path: str, findings: list[Finding]) -> tuple[int, int]:
    """Rewrite the baseline IN PLACE: drop entries no current finding
    matches (their violations are fixed), keep matching entries with their
    hand-written reasons verbatim.  Returns (kept, dropped)."""
    baseline = load_baseline(path)
    current = {f.fingerprint() for f in findings}
    kept = [e for e in baseline
            if (e.get("rule", ""), e.get("path", ""),
                e.get("context", "")) in current]
    dropped = len(baseline) - len(kept)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"findings": kept}, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(kept), dropped


def split_by_baseline(
    findings: list[Finding], baseline: list[dict]
) -> tuple[list[Finding], list[Finding]]:
    """(new, accepted): a finding is accepted when a baseline entry matches
    its (rule, path, context) fingerprint."""
    accepted_keys = {(e.get("rule", ""), e.get("path", ""),
                      e.get("context", "")) for e in baseline}
    new, accepted = [], []
    for f in findings:
        (accepted if f.fingerprint() in accepted_keys else new).append(f)
    return new, accepted


def repo_root() -> str:
    """The repo the analyzer should scan: cwd when it holds the package,
    else the checkout this module was imported from."""
    cwd = os.getcwd()
    if os.path.isdir(os.path.join(cwd, PACKAGE)):
        return cwd
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
