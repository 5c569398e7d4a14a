"""The port's offline operator tools (``scripts/torch_journal_dump.py``,
``scripts/torch_postmortem.py``, ``scripts/torch_trace_dump.py``) held to
the JAX package's (``scripts/journal_dump.py``, ``postmortem.py``,
``trace_dump.py``).

- JAX's script tests run as written (``tests/test_replication.py``'s
  ``journal_dump`` cases, ``tests/test_forensics.py``'s ``postmortem`` and
  ``--lsn-range`` cases), with every script they load replaced by both
  scripts side by side (``Dual``): each call runs the port's tool and
  JAX's on the same arguments; the returned dicts, stdout, stderr and exit
  status are equal (the port's script names mapped back), and the test
  sees JAX's, so its own assertions hold JAX's tool as before. Those
  journals and bundles are the JAX app's.
- The same tools on what the port writes: a journal written by the port's
  ``PoolJournal`` (intact, torn, with a snapshot), and a bundle and a
  journal from a run of the port's app; both tools read them alike.
- ``/debug`` bodies recorded from the port's service over HTTP, rendered
  by both ``trace_dump`` renderers: the same text.
"""

import asyncio
import contextlib
import importlib.util
import inspect
import io
import json
import os
import sys

import pytest
import torch

import test_forensics as jax_forensics_tests
import test_replication as jax_replication_tests
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    Config,
    DurabilityConfig,
    EngineConfig,
    ForensicsConfig,
    ObservabilityConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.engine.cpu import CpuEngine
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.testing.drain import fully_drained
from matchmaking_tpu_torch.utils import journal as port_journal
from matchmaking_tpu_torch.utils.checkpoint import save_pool
from test_torch_observability import free_port, get

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
Q = "matchmaking.search"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"mm_ops_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _unmap(text: str) -> str:
    """The port's output in the JAX scripts' words."""
    return text.replace("scripts/torch_", "scripts/")


class _Ran:
    def __init__(self, fn, args, kwargs):
        self.out, self.err = io.StringIO(), io.StringIO()
        self.sink = None
        if "out" in inspect.signature(fn).parameters:
            # Each side writes its own buffer; the caller's gets JAX's.
            self.sink = kwargs.get("out")
            kwargs = dict(kwargs, out=self.out)
        self.value = self.exc = None
        with contextlib.redirect_stdout(self.out), \
                contextlib.redirect_stderr(self.err):
            try:
                self.value = fn(*args, **kwargs)
            except BaseException as e:  # SystemExit included
                self.exc = e

    def shape(self, unmap=False):
        f = _unmap if unmap else (lambda t: t)
        exc = None if self.exc is None else (
            type(self.exc).__name__,
            f(str(getattr(self.exc, "code", self.exc))))
        return (json.loads(f(json.dumps(self.value, default=str))),
                f(self.out.getvalue()), f(self.err.getvalue()), exc)


class Dual:
    """The JAX script and the port's, side by side: a call runs both on
    the same arguments and holds the port's result, stdout, stderr and
    exit status to JAX's; it returns JAX's (its output written where JAX's
    call wrote it)."""

    def __init__(self, jax_mod, port_mod):
        self.jax, self.port, self.calls = jax_mod, port_mod, []

    def __getattr__(self, name):
        theirs, mine = getattr(self.jax, name), getattr(self.port, name)
        if not callable(theirs):
            return theirs

        def call(*args, **kwargs):
            p = _Ran(mine, args, kwargs)
            j = _Ran(theirs, args, kwargs)
            assert p.shape(unmap=True) == j.shape(), name
            self.calls.append(name)
            text = j.out.getvalue()
            if j.sink is not None:
                j.sink.write(text)
            else:
                sys.stdout.write(text)
            sys.stderr.write(j.err.getvalue())
            if j.exc is not None:
                raise j.exc
            return j.value
        return call


def dual(name: str) -> Dual:
    return Dual(_load(name), _load(f"torch_{name}"))


#: JAX's script tests, by module: each runs as written over ``Dual``.
JAX_CASES = [
    (jax_replication_tests, "test_journal_dump_intact_segment_report"),
    (jax_replication_tests, "test_journal_dump_torn_tail_diagnosis"),
    (jax_replication_tests, "test_journal_dump_snapshot_verification"),
    (jax_forensics_tests,
     "test_postmortem_reconstructs_takeover_root_chain_offline"),
    (jax_forensics_tests, "test_postmortem_main_exits_2_on_schema_problems"),
    (jax_forensics_tests, "test_journal_dump_lsn_range_slices_bundle_window"),
]


@pytest.mark.parametrize("module,case", JAX_CASES,
                         ids=[c for _, c in JAX_CASES])
def test_jax_script_tests_on_both_packages(module, case, tmp_path, capsys,
                                           monkeypatch):
    made: list[Dual] = []

    def loader(name="journal_dump"):
        made.append(dual(name))
        return made[-1]

    monkeypatch.setattr(module, "_load_journal_dump", loader,
                        raising=False)
    monkeypatch.setattr(module, "_load_script", loader, raising=False)
    fn = getattr(module, case)
    kwargs = {k: v for k, v in (("tmp_path", tmp_path), ("capsys", capsys))
              if k in inspect.signature(fn).parameters}
    if inspect.iscoroutinefunction(fn):
        asyncio.run(fn(**kwargs))
    else:
        fn(**kwargs)
    assert made and all(d.calls for d in made), case


# ---- what the port writes --------------------------------------------------


def _port_rows(*pids):
    return [jax_replication_tests._row(p) for p in pids]


def test_a_port_journal_reads_alike_intact_torn_and_snapshotted(tmp_path,
                                                                capsys):
    jd = dual("journal_dump")
    d = str(tmp_path / "intact")
    j = port_journal.PoolJournal(d, "q", fsync="window")
    j.append_admits(_port_rows("a", "b"))
    j.append_terminal("a", b"matched", 99.0)
    j.commit(force_sync=True)
    j.mark_clean()
    j.close()
    rep = jd.inspect_queue(d, "q")
    assert rep["intact"] and rep["segment"]["clean_tail"]
    assert rep["segment"]["counts"] == {"admit": 1, "terminal": 1,
                                        "clean": 1}
    assert jd.inspect_dir(d) == {"q": rep}
    assert jd.main([d]) == 0
    assert jd.main([d, "--queue", "q", "--json"]) == 0
    assert jd.main([d, "--queue", "q", "--lsn-range", "1,2"]) == 0
    assert "2 record(s) in range" in capsys.readouterr().out

    torn = str(tmp_path / "torn")
    j = port_journal.PoolJournal(torn, "q", fsync="window")
    j.append_admits(_port_rows("a"))
    j.commit(force_sync=True)
    j.abandon()
    with open(port_journal.journal_path(torn, "q"), "ab") as f:
        f.write(b"\x07\x07torn-partial-frame")
    assert jd.inspect_queue(torn, "q")["segment"]["torn"]
    assert jd.main([torn]) == 1

    snap = str(tmp_path / "snap")
    j = port_journal.PoolJournal(snap, "q", fsync="window")
    j.append_admits(_port_rows("a", "b"))
    j.commit(force_sync=True)
    anchor, snap_path = j.compact_begin()
    cfg = Config(queues=(QueueConfig(rating_threshold=100.0),))
    eng = CpuEngine(cfg, cfg.queues[0])
    eng.restore([port_journal.row_to_request(r)
                 for r in _port_rows("a", "b")], 1.0)
    save_pool(eng, snap_path, queue_name="q")
    j.compact_finish(anchor, snap_path)
    j.close()
    rep = jd.inspect_queue(snap, "q")
    assert rep["snapshots"][0]["verified"] and rep["intact"]
    assert set(jd.calls) == {"inspect_queue", "inspect_dir", "main"}


async def _port_bundle(jdir: str) -> dict:
    """A journaled run of the port's app on the CPU (the JAX
    ``--lsn-range`` test's): four players matched, then a captured
    bundle."""
    app = MatchmakingApp(Config(
        queues=(QueueConfig(rating_threshold=50.0, dedup_ttl_s=600.0),),
        engine=EngineConfig(backend="gpu", pool_capacity=256, pool_block=64,
                            batch_buckets=(8, 32)),
        batcher=BatcherConfig(max_batch=8, max_wait_ms=5.0),
        durability=DurabilityConfig(journal_dir=jdir, fsync="window"),
        forensics=ForensicsConfig(min_interval_s=0.0)), device="cpu")
    reply = "ops.replies"
    app.broker.declare_queue(reply)
    app.broker.basic_consume(reply, lambda d: None, prefetch=1_000_000)
    await app.start()
    try:
        for i in range(4):
            app.broker.publish(Q, json.dumps(
                {"id": f"jp{i}", "rating": 1200.0 + (i // 2) * 300.0}
            ).encode(), Properties(reply_to=reply, correlation_id=f"jp{i}"))
        rt = app.runtime(Q)
        for _ in range(2400):
            await asyncio.sleep(0.025)
            if fully_drained(app, rt, Q, 4):
                break
        app.events.append("slo_burn", Q, "fixture burn")
        return app.incidents.capture(
            "breaker_trip",
            app.events.append("engine_revive", Q, "fixture anchor"))
    finally:
        await app.stop()


def test_a_port_bundle_and_journal_read_alike(tmp_path, capsys):
    jdir = str(tmp_path / "journal")
    bundle = asyncio.run(_port_bundle(jdir))
    pm, jd = dual("postmortem"), dual("journal_dump")
    analysis = pm.analyze(bundle)
    assert analysis["problems"] == []
    pm.render(bundle, out=io.StringIO())
    pm.root_chain(bundle)
    path = tmp_path / "bundle.json"
    path.write_text(json.dumps(bundle))
    assert pm.main([str(path)]) == 0
    assert pm.main([str(path), "--json"]) == 0
    capsys.readouterr()
    lo, hi = bundle["journal"][Q]["lsn_range"]
    sliced = jd.slice_lsn_range(jdir, Q, lo, hi)
    assert sliced["records"] and "error" not in sliced
    assert jd.main([jdir, "--queue", Q, "--lsn-range", f"{lo},{hi}",
                    "--json"]) == 0
    assert jd.main([jdir]) == 0  # a stopped app leaves a clean journal


async def _record_bodies() -> dict:
    """The port's ``/debug`` bodies after a traced soak, over HTTP."""
    port = free_port()
    app = MatchmakingApp(Config(
        queues=(QueueConfig(rating_threshold=50.0, dedup_ttl_s=600.0),),
        engine=EngineConfig(backend="gpu", pool_capacity=256, pool_block=64,
                            batch_buckets=(8, 32)),
        batcher=BatcherConfig(max_batch=8, max_wait_ms=5.0),
        observability=ObservabilityConfig(trace=True, slow_trace_ms=0.0),
        forensics=ForensicsConfig(min_interval_s=0.0),
        metrics_port=port), device="cpu")
    reply = "ops.trace.replies"
    app.broker.declare_queue(reply)
    await app.start()
    try:
        for i in range(12):
            app.broker.publish(Q, json.dumps(
                {"id": f"t{i}", "rating": 1400.0 + 10.0 * (i // 2)}).encode(),
                Properties(reply_to=reply, correlation_id=f"t{i}"))
        for _ in range(400):
            if await app.broker.get(reply, timeout=0.05) is None and \
                    fully_drained(app, app.runtime(Q), Q, 12):
                break
        app.events.append("breaker_trip", Q, "fixture trip")
        app.sample_telemetry()
        bodies = {}
        for route in ("/debug/traces", "/debug/attribution",
                      "/debug/quality", "/debug/events", "/debug/incidents"):
            status, text = await get(port, route)
            assert status == 200, (route, text)
            bodies[route] = json.loads(text)
        return bodies
    finally:
        await app.stop()


def test_recorded_debug_bodies_render_alike():
    bodies = asyncio.run(_record_bodies())
    td = dual("trace_dump")
    traces = [tr for rings in bodies["/debug/traces"]["queues"].values()
              for ring in rings.values() for tr in ring]
    assert traces
    for tr in traces:
        td.render_trace(tr, out=io.StringIO())
        td.render_gaps(tr, out=io.StringIO())
    td.render_attribution(bodies["/debug/attribution"], out=io.StringIO())
    td.render_quality(bodies["/debug/quality"], out=io.StringIO())
    with open(os.path.join(ROOT, "BENCH_r06.json"), encoding="utf-8") as f:
        td.render_frontier(json.load(f), out=io.StringIO())
    assert bodies["/debug/events"]["events"]
    assert set(td.calls) == {"render_trace", "render_gaps",
                             "render_attribution", "render_quality",
                             "render_frontier"}
