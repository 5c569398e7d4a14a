"""The port's matchlint (matchmaking_tpu_torch/analysis) held to the JAX
package's, and the port's gate.

- JAX's ``tests/test_matchlint.py`` fixtures for every ported rule: each
  JAX test runs as written (its own assertions on the JAX analyzer), its
  ``analyze_source`` calls are recorded, and every recorded source goes
  through the port's ``analyze_source`` too, with paths mapped from
  ``matchmaking_tpu/`` to ``matchmaking_tpu_torch/`` (``scripts/x`` to
  ``scripts/torch_x``) and JAX's vocabulary mapped to the port's: the
  lock ``_engine_lock`` is ``_pool_lock``, JAX's sanctioned lock-held
  helper ``_drain_engine`` is the port's ``_backpressure_wait``,
  ``.block_until_ready()`` is ``.synchronize()``, and ``jax.jit`` is
  ``torch.compile`` (what a capture freezes). The findings are equal in
  rule, line, context and message (messages mapped back), with one kept
  difference: on JAX's use-after-donation fixture the port reports
  nothing (it donates nothing: a step writes the pool in place, so
  reading the pool after the step is correct; the port's graph-address
  rule, in ``tests/test_torch_device_audit.py``, takes its place). JAX's
  trace-time ``recompile``/``device`` cases call no ``analyze_source``:
  their twins are ``tests/test_torch_recompile.py`` and
  ``tests/test_torch_device_audit.py``. The tests that scan the JAX tree
  are left out.
- The port's own vocabulary: torch host syncs, ``_pool_lock`` and its
  lock-held coroutines, explicit generators, a nested def's protocol
  contract.
- The gate: ``analyze_repo()`` of the port reports nothing outside its
  baseline (which is empty), with no warnings.
"""

import ast
import json
import os
import re

import pytest

import test_matchlint as jax_lint
from matchmaking_tpu_torch.analysis import RULES, core
from matchmaking_tpu_torch.analysis import engine as port_engine
from matchmaking_tpu_torch.analysis.engine import (
    analyze_repo,
    analyze_source,
    main,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX tests left out: the trace-time cases (no ``analyze_source``; their
#: twins are in test_torch_recompile.py and test_torch_device_audit.py),
#: and the tests that scan the JAX tree or drive its CLI (the port's
#: twins of those are below).
_LEFT_OUT = re.compile(
    r"recompile_dynamic|device_padded|device_dtype|device_ring|"
    r"repo_is_clean|cli_json|result_cache|flush_columnar_empty_residue")

#: JAX findings the port does not report, by design: use-after-donation
#: (the port writes the pool in place and donates nothing).
_KEPT_DIFFERENCES = ("DONATED",)


def _jax_cases() -> list[str]:
    tree = ast.parse(open(jax_lint.__file__, encoding="utf-8").read())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
            and not _LEFT_OUT.search(n.name) and not n.args.args]


#: JAX's vocabulary -> the port's, in fixture sources.
_SOURCE_MAP = (("_engine_lock", "_pool_lock"),
               ("_drain_engine", "_backpressure_wait"),
               (".block_until_ready()", ".synchronize()"),
               ("jax.jit", "torch.compile"))


def _port_path(path: str) -> str:
    if path.startswith("matchmaking_tpu/"):
        return "matchmaking_tpu_torch/" + path[len("matchmaking_tpu/"):]
    if path.startswith("scripts/"):
        return "scripts/torch_" + path[len("scripts/"):]
    if path.startswith("tests/"):
        return "tests/test_torch_" + path[len("tests/"):]
    return path


def _vocabulary(code: str):
    """The pairs of ``_SOURCE_MAP`` this source uses (a source that already
    names the port's word keeps JAX's word as it is)."""
    return [(a, b) for a, b in _SOURCE_MAP if a in code and b not in code]


def _port_source(code: str, pairs) -> str:
    for a, b in pairs:
        code = code.replace(a, b)
    return code


def _back(message: str, pairs) -> str:
    """A port message in JAX's vocabulary."""
    for a, b in pairs:
        message = message.replace(b, a)
    return (message.replace("matchmaking_tpu_torch/", "matchmaking_tpu/")
            .replace("scripts/torch_", "scripts/"))


@pytest.mark.parametrize("case", _jax_cases())
def test_jax_fixture_findings_equal_on_both_analyzers(case, monkeypatch):
    calls = []
    real = jax_lint.analyze_source

    def recording(code, path="snippet.py"):
        out = real(code, path=path)
        calls.append((code, path, out))
        return out

    monkeypatch.setattr(jax_lint, "analyze_source", recording)
    getattr(jax_lint, case)()  # JAX's own assertions on JAX's analyzer
    assert calls, f"{case} analyzed no fixture"
    for code, path, theirs in calls:
        pairs = _vocabulary(code)
        mine = analyze_source(_port_source(code, pairs),
                              path=_port_path(path))
        want = sorted((f.rule, f.line, f.context, f.message)
                      for f in theirs if f.rule in RULES
                      and not any(k in f.message for k in _KEPT_DIFFERENCES))
        assert sorted((f.rule, f.line, f.context, _back(f.message, pairs))
                      for f in mine) == want, (path, code)


# ---- the port's vocabulary ---------------------------------------------------


def _rules(findings):
    return [f.rule for f in findings]


def test_torch_host_syncs_are_blocking_in_async_bodies_only():
    findings = analyze_source('''
import torch

async def handler(t, ev, stream):
    a = t.cpu()
    b = t.numpy()
    c = t.tolist()
    d = t.item()
    torch.cuda.synchronize()
    ev.synchronize()
    stream.synchronize()

def sync_helper(t, ev):
    ev.synchronize()  # worker-thread code: fine
    return t.cpu().numpy()

async def off_loop(t):
    def run():
        return t.cpu()  # nested sync def: runs where it is called
    return run
''', path="matchmaking_tpu_torch/service/fixture.py")
    assert _rules(findings) == ["blocking-call"] * 7
    assert all(f.context == "handler" for f in findings)
    assert {f.line for f in findings} == set(range(5, 12))
    # A readback guarded by an event (query(), not synchronize()) and a
    # pinned copy enqueued with non_blocking are not host syncs.
    assert analyze_source('''
async def collect(ev, dst, src):
    dst.copy_(src, non_blocking=True)
    return ev.query()
''', path="matchmaking_tpu_torch/engine/fixture.py") == []


_POOL_RUNTIME = '''
import asyncio

class Runtime:
    def __init__(self):
        self._pool_lock = asyncio.Lock()

    async def flush(self, window):
        async with self._pool_lock:
            await self._flush_columnar(window)

    # holds-lock: _pool_lock
    async def _flush_columnar(self, window):
        self.engine.search_columns_async(window)
        await self._backpressure_wait()
%s
    # holds-lock: _pool_lock
    async def _backpressure_wait(self):
        while self.engine.inflight() >= 2:
            await asyncio.sleep(0.001)
'''


def test_pool_lock_backpressure_wait_and_lock_held_coroutines_sanctioned():
    assert analyze_source(_POOL_RUNTIME % "",
                          path="matchmaking_tpu_torch/service/fixture.py") == []


def test_sleep_under_pool_lock_outside_the_helper_is_flagged():
    findings = analyze_source(_POOL_RUNTIME % '''
    async def sweep(self):
        async with self._pool_lock:
            await asyncio.sleep(0.01)
''', path="matchmaking_tpu_torch/service/fixture.py")
    assert _rules(findings) == ["await-under-lock"]
    assert findings[0].context == "Runtime.sweep"
    assert "asyncio.sleep" in findings[0].message
    # Inside a lock-held coroutine the body is checked as if it sat in the
    # lock: the sanction is transitive, never blanket.
    findings = analyze_source(
        (_POOL_RUNTIME % "").replace(
            "        await self._backpressure_wait()",
            "        await asyncio.sleep(0.001)"),
        path="matchmaking_tpu_torch/service/fixture.py")
    assert _rules(findings) == ["await-under-lock"]
    assert findings[0].context == "Runtime._flush_columnar"
    # An unmarked coroutine awaited under the lock is not sanctioned.
    findings = analyze_source(
        (_POOL_RUNTIME % "").replace(
            "    # holds-lock: _pool_lock\n    async def _flush_columnar",
            "    async def _flush_columnar"),
        path="matchmaking_tpu_torch/service/fixture.py")
    assert _rules(findings) == ["await-under-lock"]
    assert "_flush_columnar" in findings[0].message


def test_shielded_to_thread_is_the_off_loop_seam():
    assert analyze_source('''
import asyncio

class Runtime:
    def __init__(self):
        self._pool_lock = asyncio.Lock()

    async def compact(self, fn):
        async with self._pool_lock:
            return await _shielded_to_thread(fn)
''', path="matchmaking_tpu_torch/service/fixture.py") == []


def test_explicit_generators_and_the_global_torch_generator():
    findings = analyze_source('''
import torch

def draws(n, t):
    g = torch.Generator()
    x = torch.rand(n)
    y = torch.randn(n, generator=torch.Generator(device="cpu"))
    torch.manual_seed(0)
    t.uniform_()
    return x, y
''', path="matchmaking_tpu_torch/utils/fixture.py")
    assert _rules(findings) == ["determinism"] * 5
    assert [f.line for f in findings] == [5, 6, 7, 8, 9]
    assert "never manual_seed" in findings[0].message
    assert "generator=" in findings[1].message
    assert "global torch seed" in findings[3].message
    clean = analyze_source('''
import torch

class Sampler:
    def __init__(self, seed):
        self._gen = torch.Generator(device="cpu")
        self._gen.manual_seed(seed)

    def draw(self, n, t):
        g = torch.Generator().manual_seed(7)
        t.normal_(generator=g)
        return torch.randint(0, 9, (n,), generator=self._gen)
''', path="tests/test_torch_fixture.py")
    assert clean == []


def test_a_nested_def_carries_its_own_protocol_contract():
    src = '''
class Runtime:
    def _publish(self, body):
        # protocol-effect: response_publish requires-fence _may_publish
        def publish():
            if not self._may_publish(1):
                return
            self.broker.publish("q", body)
        self._effect(publish)

    def _may_publish(self, n):
        return True
'''
    assert analyze_source(
        src, path="matchmaking_tpu_torch/service/fixture.py") == []
    findings = analyze_source(
        src.replace("            if not self._may_publish(1):\n"
                    "                return\n", ""),
        path="matchmaking_tpu_torch/service/fixture.py")
    assert _rules(findings) == ["protocol"]
    assert findings[0].context == "Runtime.publish"


def test_discover_scans_the_port_and_its_own_files_only(tmp_path):
    for rel in ("matchmaking_tpu_torch/service/a.py",
                "matchmaking_tpu_torch/analysis/b.py",
                "matchmaking_tpu/service/c.py", "tests/test_torch_d.py",
                "tests/test_e.py", "scripts/torch_f.py", "scripts/g.py",
                "chip_smoke.py", "bench.py"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("x = 1\n")
    found = sorted(sf.path for sf in core.discover(str(tmp_path)))
    assert found == ["chip_smoke.py",
                     "matchmaking_tpu_torch/analysis/b.py",
                     "matchmaking_tpu_torch/service/a.py",
                     "scripts/torch_f.py", "tests/test_torch_d.py"]


# ---- tooling ------------------------------------------------------------------


def test_cli_json_format_is_machine_readable(capsys, tmp_path):
    pkg = tmp_path / "matchmaking_tpu_torch" / "service"
    pkg.mkdir(parents=True)
    (pkg / "fix.py").write_text(
        "import time\n\n\nasync def handler():\n    time.sleep(0.1)\n")
    rc = main(["--root", str(tmp_path), "--no-cache", "--format=json"])
    data = json.loads(capsys.readouterr().out)
    assert set(data) == {"findings", "baselined", "warnings"}
    assert rc == 1
    assert [(f["rule"], f["path"], f["line"]) for f in data["findings"]] == [
        ("blocking-call", "matchmaking_tpu_torch/service/fix.py", 5)]
    (pkg / "fix.py").write_text("import asyncio\n")
    assert main(["--root", str(tmp_path), "--no-cache"]) == 0
    assert "matchlint: clean" in capsys.readouterr().out


def test_result_cache_replays_findings_for_unchanged_files(tmp_path):
    root = tmp_path / "repo"
    (root / "matchmaking_tpu_torch" / "service").mkdir(parents=True)
    (root / "matchmaking_tpu_torch" / "service" / "fix.py").write_text(
        "import time\n\n\nasync def handler():\n    time.sleep(0.1)\n")
    new1, _, _ = analyze_repo(str(root))
    assert [f.rule for f in new1] == ["blocking-call"]
    cache = json.loads((root / port_engine.CACHE_NAME).read_text())
    assert "matchmaking_tpu_torch/service/fix.py" in cache["files"]
    new2, _, _ = analyze_repo(str(root))
    assert [(f.rule, f.path, f.line) for f in new1] == \
        [(f.rule, f.path, f.line) for f in new2]


def test_settlement_is_clean_over_the_live_app_without_ignores():
    with open(os.path.join(ROOT, "matchmaking_tpu_torch", "service",
                           "app.py"), encoding="utf-8") as f:
        assert "ignore[settlement]" not in f.read()
    new, _accepted, _warnings = analyze_repo(
        ROOT, rules={"settlement"}, use_cache=False)
    assert [f for f in new if "app.py" in f.path] == [], new


# ---- the gate ------------------------------------------------------------------


@pytest.mark.lint
def test_repo_is_clean():
    """``python -m matchmaking_tpu_torch.analysis``'s gate: nothing outside
    the port's baseline, no warnings, and the baseline is empty."""
    new, accepted, warnings = analyze_repo(ROOT, use_cache=False)
    assert not warnings, "\n".join(warnings)
    assert not new, "matchlint findings:\n" + "\n".join(
        f.render() for f in new)
    assert accepted == []
    with open(port_engine.baseline_path(ROOT), encoding="utf-8") as f:
        assert json.load(f) == {"findings": []}
