"""matchlint entry point: run the rule suite, diff against the baseline.

Split from ``__main__`` so tests (and ``pytest -m lint``) call the same
:func:`analyze_repo` the CLI does — one gate, two entry points.

Tooling:

- ``--format=json`` — machine-readable findings for editors/CI.
- ``--changed-only`` — scope the per-file rules to files git reports
  modified (cross-file contract collection still reads the whole tree),
  so pre-commit runs stay sub-second.
- ``--update-baseline`` — rewrite ``analysis/baseline.json`` in place:
  entries whose violation is fixed are dropped, surviving entries keep
  their hand-written reasons (``--write-baseline`` regenerates from
  scratch with TODO reasons).
- per-file result cache (``.matchlint_torch_cache.json``, content-hash
  keyed; its own name, so the JAX package's analyzer and this one never
  read each other's) — unchanged files replay their findings instead of
  re-running the checkers.  Tests pass ``use_cache=False``: test workers
  run side by side.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

from matchmaking_tpu_torch.analysis import (
    blocking,
    determinism,
    device_audit,
    lifecycle,
    locks,
    perf,
    protocol,
    recompile,
    speculation,
)
from matchmaking_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    apply_ignores,
    PACKAGE,
    discover,
    load_baseline,
    repo_root,
    split_by_baseline,
    stale_ignores,
    update_baseline,
    write_baseline,
)

#: Bump to invalidate every cache entry when rule semantics change.
ANALYZER_VERSION = "torch-2"

#: The result cache's file name at the repo root (git-ignored).
CACHE_NAME = ".matchlint_torch_cache.json"

#: Per-file rule-module checkers (run per SourceFile; locks and protocol
#: additionally take cross-file registries).
_PER_FILE_CHECKS = (blocking.check, determinism.check, perf.check,
                    lifecycle.check, speculation.check,
                    recompile.check_static, device_audit.check_static)


def _check_file(sf: SourceFile, external, vocab=None) -> list[Finding]:
    findings: list[Finding] = []
    findings.extend(locks.check([sf], external=external))
    findings.extend(protocol.check([sf], vocab=vocab))
    for chk in _PER_FILE_CHECKS:
        findings.extend(chk([sf]))
    return findings


def analyze_source(code: str, path: str = "snippet.py") -> list[Finding]:
    """Run the static rules over one source string (the test seam for
    fixture positives). ``path`` controls which rules consider the snippet
    in scope — default places it inside the package."""
    if not path.startswith((PACKAGE + "/", "tests/", "scripts/")) \
            and path != "chip_smoke.py":
        path = PACKAGE + "/" + path
    with tempfile.TemporaryDirectory() as tmp:
        full = os.path.join(tmp, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "w", encoding="utf-8") as f:
            f.write(code)
        sf = SourceFile(tmp, path)
    findings = _check_file(sf, locks.collect_external([sf]),
                           vocab=protocol.collect_vocab([sf]))
    findings = apply_ignores(findings, {sf.path: sf})
    # stale-ignore findings are themselves inline-suppressible, like
    # every other rule — apply the ignore map to them too.
    findings.extend(apply_ignores(stale_ignores([sf]), {sf.path: sf}))
    return findings


# ---- per-file result cache --------------------------------------------------

def _cache_path(root: str) -> str:
    return os.path.join(root, CACHE_NAME)


def _load_cache(root: str) -> dict:
    try:
        with open(_cache_path(root), encoding="utf-8") as f:
            data = json.load(f)
        if data.get("version") != ANALYZER_VERSION:
            return {}
        return data.get("files", {})
    except (OSError, ValueError):
        return {}


def _save_cache(root: str, files: dict) -> None:
    try:
        with open(_cache_path(root), "w", encoding="utf-8") as f:
            json.dump({"version": ANALYZER_VERSION, "files": files}, f)
    except OSError:  # read-only checkout: caching is best-effort
        pass


def _external_digest(external) -> str:
    blob = json.dumps({
        "locks": sorted(external.locks),
        "lockfree": {k: sorted(v) for k, v in external.lockfree.items()},
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _finding_to_dict(f: Finding) -> dict:
    return {"rule": f.rule, "path": f.path, "line": f.line,
            "message": f.message, "context": f.context}


def _finding_from_dict(d: dict) -> Finding:
    return Finding(d["rule"], d["path"], d["line"], d["message"],
                   d.get("context", ""))


def _changed_paths(root: str) -> "set[str] | None":
    """Repo-relative paths git reports as modified/added/untracked (both
    sides of a rename).  None when git is unavailable — caller falls back
    to a full scan."""
    try:
        out = subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=10, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    changed: set[str] = set()
    for line in out.splitlines():
        if len(line) < 4:
            continue
        rest = line[3:]
        for part in rest.split(" -> "):
            part = part.strip().strip('"')
            if part:
                changed.add(part.replace(os.sep, "/"))
    return changed


#: What the dynamic half's results depend on besides the torch build and
#: the trace device: the engine (every step it traces), the pool layout
#: and the two rule modules.
_DYNAMIC_INPUTS = (PACKAGE + "/engine/", PACKAGE + "/core/pool.py",
                   PACKAGE + "/config.py",
                   PACKAGE + "/analysis/recompile.py",
                   PACKAGE + "/analysis/device_audit.py")


def _dynamic_key(by_path: dict, trace_device: str) -> str:
    import torch

    digest = hashlib.sha256()
    for path in sorted(by_path):
        if path.startswith(_DYNAMIC_INPUTS):
            digest.update(path.encode())
            digest.update(by_path[path].text.encode())
    return (f"{ANALYZER_VERSION}:{torch.__version__}:{trace_device}:"
            + digest.hexdigest()[:24])


def dynamic_findings(trace_device: str = "cpu") -> list[Finding]:
    """The trace-time halves of ``recompile`` and ``device``: every
    captured step traced once (on ``trace_device``) for both."""
    traces = recompile.trace_families(trace_device)
    return (recompile.check_dynamic(traces=traces)
            + device_audit.check_dynamic(traces=traces))


def analyze_repo(root: str | None = None, dynamic: bool = True,
                 rules: set[str] | None = None,
                 changed_only: bool = False, use_cache: bool = True,
                 trace_device: str = "cpu",
                 ) -> tuple[list[Finding], list[Finding], list[str]]:
    """Returns (new, baselined, warnings) for the repo at ``root``.
    ``dynamic`` runs the trace-time halves of ``recompile`` and ``device``
    (skipped when ``rules`` names neither), tracing on ``trace_device``
    and cached as the ``"<dynamic>"`` entry."""
    root = root or repo_root()
    sources = discover(root)
    by_path = {sf.path: sf for sf in sources}
    # Cross-file contracts always come from the FULL tree, even when the
    # per-file scope is narrowed: a changed caller must see an unchanged
    # class's externally-serialized-by declaration.
    external = locks.collect_external(sources)
    # The record-type vocabulary is a cross-file registry like the lock
    # contracts: collected over the FULL tree, folded into the per-file
    # cache salt so a new RT_* constant elsewhere re-evaluates cached
    # drift/coverage verdicts.
    vocab = protocol.collect_vocab(sources)
    salt = _external_digest(external) + ":" + vocab.digest()

    scope = sources
    warnings: list[str] = []
    if changed_only:
        changed = _changed_paths(root)
        if changed is None:
            warnings.append("git unavailable: --changed-only fell back to "
                            "a full scan")
        else:
            scope = [sf for sf in sources if sf.path in changed]

    cache = _load_cache(root) if use_cache else {}
    cache_out: dict = dict(cache)
    findings: list[Finding] = []
    for sf in scope:
        key = hashlib.sha256(
            (salt + "\0" + sf.text).encode()).hexdigest()
        hit = cache.get(sf.path)
        if hit is not None and hit.get("key") == key:
            findings.extend(_finding_from_dict(d)
                            for d in hit.get("findings", []))
            continue
        file_findings = _check_file(sf, external, vocab=vocab)
        findings.extend(file_findings)
        cache_out[sf.path] = {
            "key": key,
            "findings": [_finding_to_dict(f) for f in file_findings],
        }
    # Drop cache entries for files that no longer exist ("<dynamic>" is
    # the trace-time results' entry, not a file).
    cache_out = {p: v for p, v in cache_out.items()
                 if p in by_path or p == "<dynamic>"}
    if dynamic and (rules is None or rules & {"recompile", "device"}):
        dyn_key = _dynamic_key(by_path, trace_device)
        hit = cache.get("<dynamic>")
        if hit is not None and hit.get("key") == dyn_key:
            findings.extend(_finding_from_dict(d)
                            for d in hit.get("findings", []))
        else:
            dyn = dynamic_findings(trace_device)
            findings.extend(dyn)
            cache_out["<dynamic>"] = {
                "key": dyn_key,
                "findings": [_finding_to_dict(f) for f in dyn]}
    if use_cache:
        _save_cache(root, cache_out)

    findings = apply_ignores(findings, by_path)
    if rules is None:
        # Suppression hygiene runs only when every rule was evaluated —
        # under a rule subset an ignore for an unevaluated rule is not
        # stale, just out of scope this run.  Stale-ignore findings are
        # themselves inline-suppressible like any other rule.
        findings.extend(apply_ignores(stale_ignores(scope), by_path))
    else:
        findings = [f for f in findings if f.rule in rules]
    warnings.extend(
        f"{sf.path}:{ln}: matchlint ignore without a reason is inactive — "
        f"add one ('# matchlint: ignore[rule] why')"
        for sf in scope for ln in sf.ignores.bare
    )
    baseline = load_baseline(baseline_path(root))
    new, accepted = split_by_baseline(findings, baseline)
    return new, accepted, warnings


def baseline_path(root: str) -> str:
    return os.path.join(root, PACKAGE, "analysis", "baseline.json")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="matchlint",
        description="the port's static analyzer: concurrency, lifecycle, "
                    "protocol and device rules")
    p.add_argument("--root", default=None, help="repo root (default: auto)")
    p.add_argument("--rules", default="",
                   help="comma-separated rule subset (default: all)")
    p.add_argument("--static-only", action="store_true",
                   help="skip the trace-time recompile/device checks")
    p.add_argument("--trace-device", default="cpu",
                   help="where the trace-time checks trace the captured "
                        "steps (default cpu: no kernel is launched; cuda "
                        "traces the kernels' CUDA operators on the card)")
    p.add_argument("--changed-only", action="store_true",
                   help="scope per-file rules to git-modified files "
                        "(pre-commit mode)")
    p.add_argument("--no-cache", action="store_true",
                   help="ignore + don't write the per-file result cache")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="output format (json: machine-readable findings)")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept all current findings into baseline.json "
                        "(edit the generated reasons!)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite baseline.json in place: drop entries "
                        "whose violation is fixed, keep reasons")
    args = p.parse_args(argv)
    root = args.root or repo_root()
    rules = ({r.strip() for r in args.rules.split(",") if r.strip()}
             or None)
    if args.update_baseline and (rules or args.changed_only
                                 or args.static_only):
        # The in-place rewrite keeps only entries a CURRENT finding
        # matches — run under a narrowed scope it would silently delete
        # every entry whose rule/file wasn't evaluated this run.
        print("matchlint: --update-baseline requires a full run "
              "(no --rules/--changed-only/--static-only)", file=sys.stderr)
        return 2
    new, accepted, warnings = analyze_repo(
        root, dynamic=not args.static_only, rules=rules,
        changed_only=args.changed_only, use_cache=not args.no_cache,
        trace_device=args.trace_device)
    if args.update_baseline:
        kept, dropped = update_baseline(baseline_path(root), new + accepted)
        print(f"baseline updated in place: {kept} kept, {dropped} dropped")
        return 0
    if args.write_baseline:
        write_baseline(baseline_path(root), new + accepted)
        print(f"baseline written: {len(new) + len(accepted)} finding(s)")
        return 0
    if args.format == "json":
        print(json.dumps({
            "findings": [_finding_to_dict(f) for f in
                         sorted(new, key=lambda f: (f.path, f.line))],
            "baselined": len(accepted),
            "warnings": warnings,
        }, indent=2))
        return 1 if new else 0
    for w in warnings:
        print(f"warning: {w}", file=sys.stderr)
    for f in sorted(new, key=lambda f: (f.path, f.line)):
        print(f.render())
    if accepted:
        print(f"({len(accepted)} baselined finding(s) suppressed — see "
              f"{PACKAGE}/analysis/baseline.json)")
    if new:
        print(f"matchlint: {len(new)} finding(s)")
        return 1
    print("matchlint: clean")
    return 0
