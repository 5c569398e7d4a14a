"""The event spine and the event log through the port's service, against
the JAX package's.

- ``EventSpine`` (``utils/forensics.py``): the component table, and the
  same emissions give the same rows, ``transcript()`` and ``digest()``.
- The JAX crash storm (``tests/test_torch_breaker.py``: chaos-failed
  steps trip the breaker, a probe fails, the next closes it) through both
  apps: the event log's kinds, queues, components, details and refs are
  equal, event for event.
- The crash and recovery of ``tests/test_torch_durability.py`` (with and
  without a chaos-failed window before the crash) through both apps: the
  crashed app's and the successor's events equal (the recovery's measured
  ms aside), and the spine's transcript and digest equal.
- The drain with a backlog, and a restore whose admission sidecar is
  corrupt: the same events.
- Adaptive shedding on a seeded overload soak with tracing on: the credit
  fraction after every window cut, and whether the stage p99 was known
  there, equal to the JAX app's.
"""

import asyncio
import dataclasses
import json
import os
import re
import shutil

import pytest
import torch

from matchmaking_tpu.config import ObservabilityConfig as JaxObservabilityConfig
from matchmaking_tpu.config import OverloadConfig as JaxOverloadConfig
from matchmaking_tpu.service import overload as jax_overload
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.utils import forensics as jax_forensics
from matchmaking_tpu_torch.config import ObservabilityConfig, OverloadConfig
from matchmaking_tpu_torch.service import overload
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.utils import forensics
from test_torch_breaker import JaxApp, _crash_storm, _storm_cfgs
from test_torch_durability import (
    PLAYERS,
    Q,
    _app,
    _cfg,
    _collect,
    _drain_cfg,
    _publish,
    _quiesce,
    _statuses,
)
from test_torch_overload import OVERLOAD, QUEUE, _bursts, _jax_app, _port_app

torch.set_num_threads(1)

KINDS = ("crash_recovered", "journal_compacted", "journal_corrupt",
         "breaker_trip", "breaker_probe", "probe_failed", "breaker_closed",
         "engine_crash", "engine_revive", "degraded_revive", "window_failed",
         "spec_invalidate", "team_delegated", "team_repromoted",
         "rescan_overrun", "chaos_step_fault", "chaos_probe_fault",
         "shed", "expired", "overload_tighten", "drain_begin",
         "drain_admission_stopped", "drain_complete", "backlog_checkpointed",
         "backlog_restored", "checkpoint_corrupt", "dead_letter",
         "slo_burn", "lease_expired", "epoch_bump", "replay_window",
         "failover_takeover", "autotune_move", "placement_move", "other")


def test_component_table_equals_jax():
    assert forensics._COMPONENT_PREFIXES == jax_forensics._COMPONENT_PREFIXES
    assert forensics.DETERMINISTIC_KINDS == jax_forensics.DETERMINISTIC_KINDS
    for kind in KINDS:
        assert forensics.component_of(kind) == jax_forensics.component_of(kind)


def _emit(spine):
    for i, kind in enumerate(KINDS):
        spine.stamp(kind, f"q{i % 3}", f"detail {i}",
                    component="custom" if i % 7 == 3 else "",
                    refs={"players": i, "epoch": i // 4, "rto_ms": 1.5 * i,
                          "records": i * 2} if i % 2 else None)


def test_spine_transcript_and_digest_equal_jax():
    spine, jspine = forensics.EventSpine(ring=64), jax_forensics.EventSpine(
        ring=64)
    seen = []
    spine.subscribe(seen.append)
    spine.subscribe(lambda ev: 1 / 0)  # a broken observer is ignored
    _emit(spine)
    _emit(jspine)
    assert len(spine) == len(jspine) == len(KINDS) == len(seen)
    assert [ev["seq"] for ev in seen] == list(range(1, len(KINDS) + 1))
    for kinds in (None, KINDS, ("engine_crash", "crash_recovered")):
        assert spine.transcript(kinds) == jspine.transcript(kinds)
        assert spine.digest(kinds) == jspine.digest(kinds)
    assert spine.transcript()  # the deterministic kinds are among them

    def clockless(rows):
        return [{k: v for k, v in r.items() if k not in ("wall", "mono_ns")}
                for r in rows]
    for kw in ({}, {"limit": 5}, {"queue": "q1"},
               {"kinds": ("shed", "expired")}):
        assert clockless(spine.window(**kw)) == clockless(jspine.window(**kw))


def _rows(app, mask=None):
    """The event log without its clocks (and ``mask`` applied to the
    details and refs: measured values differ by nature)."""
    out = []
    for r in app.events.snapshot():
        detail, refs = r["detail"], dict(r["refs"])
        if mask is not None:
            detail = re.sub(mask, "#", detail)
            refs.pop("rto_ms", None)
        out.append((r["component"], r["kind"], r["queue"], detail,
                    json.dumps(refs, sort_keys=True)))
    return out


def test_crash_storm_events_equal_jax_app():
    port_cfg, jax_cfg = _storm_cfgs()
    app = MatchmakingApp(port_cfg, device="cpu")
    asyncio.run(_crash_storm(app, Properties,
                             lambda k: app.counters.get(k, 0)))
    japp = JaxApp(jax_cfg)
    asyncio.run(_crash_storm(japp, JaxProperties,
                             lambda k: japp.metrics.counters.get(k) or 0))
    mine, theirs = _rows(app), _rows(japp)
    assert mine == theirs
    kinds = [k for _, k, _, _, _ in mine]
    for kind in ("chaos_step_fault", "engine_crash", "breaker_trip",
                 "degraded_revive", "engine_revive", "breaker_probe",
                 "chaos_probe_fault", "probe_failed", "breaker_closed"):
        assert kind in kinds, kind
    assert kinds.count("engine_crash") == 3
    # The breaker gauges are the JAX app's after the storm.
    q = port_cfg.queues[0].name
    for g in ("breaker_state", "breaker_probe_delay_s"):
        key = f"{g}[{q}]"
        assert app.metrics.gauges[key] == japp.metrics.gauges[key], key
    assert app.metrics.counters.get("breaker_closes") == 1


async def _crash_then_recover(pkg, jdir, chaos_steps=()):
    """``tests/test_torch_durability.py``'s crash cycle, then the
    successor's recovery and redelivery; returns both apps."""
    first = _app(pkg, _cfg(pkg, jdir, chaos_steps=chaos_steps, trace=True))
    await first.start()
    replies: list = []
    _collect(first, "ev.replies", replies)
    _publish(pkg, first, PLAYERS, "ev.replies")
    await _quiesce(first, lambda: len(_statuses(replies, "matched")) == 4
                   and "s0" in _statuses(replies, "queued"))
    await first.crash()
    second = _app(pkg, _cfg(pkg, jdir, trace=True))
    await second.start()
    try:
        again: list = []
        _collect(second, "ev.again", again)
        _publish(pkg, second, PLAYERS, "ev.again")
        await _quiesce(second, lambda: _statuses(again, "matched") == {
            "p0", "p1", "p2", "p3"})
    finally:
        await second.stop()
    return first, second


@pytest.mark.parametrize("chaos_steps", [(), (0,)])
def test_crash_recovery_events_equal_jax_app(tmp_path, chaos_steps):
    got = {pkg: asyncio.run(_crash_then_recover(pkg, tmp_path / pkg,
                                                chaos_steps))
           for pkg in ("port", "jax")}
    rto = r"rto [0-9.]+ ms"
    for i in (0, 1):
        mine, theirs = got["port"][i], got["jax"][i]
        assert _rows(mine, rto) == _rows(theirs, rto), i
        assert mine.spine.transcript() == theirs.spine.transcript()
        assert mine.spine.digest() == theirs.spine.digest()
    successor = [k for _, k, _, _, _ in _rows(got["port"][1], rto)]
    assert successor[:2] == ["crash_recovered", "journal_compacted"] or (
        successor[:2] == ["journal_compacted", "crash_recovered"])
    assert got["port"][1].spine.transcript() == [{
        "component": "durability", "queue": Q, "kind": "crash_recovered",
        "refs": {"snapshot_players": 0, "players": 1}}]
    gauge = f"crash_rto_ms[{Q}]"
    assert got["port"][1].metrics.gauges[gauge] > 0.0
    assert got["port"][1].metrics.gauges[gauge] == (
        got["port"][1].runtime(Q).last_recovery["rto_ms"])
    if chaos_steps:
        kinds = [k for _, k, _, _, _ in _rows(got["port"][0])]
        assert {"chaos_step_fault", "engine_crash",
                "engine_revive"} <= set(kinds)


async def _drain_and_restore(pkg, directory):
    """Four waiting players and two requests that reach the broker after
    the consumer is cancelled (the backlog), drained into ``directory``;
    a successor restores it with a corrupt admission sidecar."""
    props = JaxProperties if pkg == "jax" else Properties
    app = _app(pkg, _drain_cfg(pkg, directory))
    await app.start()
    rt = app.runtime("rr.q")
    app.broker.declare_queue("rr.replies")

    def publish(i):
        app.broker.publish("rr.q", f'{{"id":"rr{i}","rating":{1000 + 400 * i}}}'
                           .encode(), props(reply_to="rr.replies",
                                            correlation_id=f"c{i}"))
    for i in range(4):
        publish(i)
    for _ in range(1500):
        await asyncio.sleep(0.02)
        if rt.engine.pool_size() == 4:
            break
    assert rt.engine.pool_size() == 4
    real_cancel = app.broker.basic_cancel

    def cancel(tag):
        real_cancel(tag)
        if tag == getattr(rt, "consumer_tag", getattr(rt, "_tag", None)):
            publish(4)
            publish(5)
    app.broker.basic_cancel = cancel
    await app.drain(str(directory))
    with open(os.path.join(directory, "_admission.json"), "w") as f:
        f.write("{not json")
    successor = _app(pkg, _drain_cfg(pkg, directory))
    await successor.start()
    try:
        await successor.restore_checkpoint(str(directory))
    finally:
        await successor.stop()
    return app, successor


def test_drain_and_restore_events_equal_jax_app(tmp_path):
    got = {}
    for pkg in ("port", "jax"):
        shutil.rmtree(tmp_path / pkg, ignore_errors=True)
        got[pkg] = asyncio.run(_drain_and_restore(pkg, tmp_path / pkg))
    for i in (0, 1):
        assert _rows(got["port"][i]) == _rows(got["jax"][i]), i
    drained = [k for _, k, _, _, _ in _rows(got["port"][0])]
    assert drained[0] == "drain_begin" and drained[-1] == "drain_complete"
    assert {"drain_admission_stopped", "backlog_checkpointed"} <= set(drained)
    restored = [k for _, k, _, _, _ in _rows(got["port"][1])]
    assert {"checkpoint_corrupt", "backlog_restored"} <= set(restored)


def _adaptive(pkg, monkeypatch):
    """The overload service of ``tests/test_torch_overload.py`` with
    adaptive shedding on a 1 µs p99 target and tracing on: every cut that
    follows a settled trace tightens, every other one judges on occupancy
    alone. Returns the app and its list of (p99 known, fraction) at each
    cut."""
    ov = dict(OVERLOAD, batch_admission=True, adaptive=True,
              target_p99_ms=0.001, min_credit_fraction=0.2)
    if pkg == "port":
        cfg = _port_app(True).cfg
        app = MatchmakingApp(dataclasses.replace(
            cfg, overload=OverloadConfig(**ov),
            observability=ObservabilityConfig(trace=True)), device="cpu")
        cls = overload.AdmissionController
    else:
        cfg = _jax_app(True).cfg
        app = JaxApp(dataclasses.replace(
            cfg, overload=JaxOverloadConfig(**ov),
            observability=JaxObservabilityConfig(trace=True)))
        cls = jax_overload.AdmissionController
    seq = []
    real = cls.observe_window

    def observe(self, fill, frac, p99):
        real(self, fill, frac, p99)
        seq.append((p99 is not None, self.credit_fraction))
    monkeypatch.setattr(cls, "observe_window", observe)
    return app, seq


async def _serve_bursts(app, props, bursts):
    """Publish each burst once every request of the last is answered (a
    shed counts: under tightening most are); returns the answers."""
    app.broker.declare_queue("ev.overload")
    await app.start()
    answers: dict[str, list[bytes]] = {}
    try:
        for rows in bursts:
            for corr, body, headers in rows:
                app.broker.publish(QUEUE, body, props(
                    reply_to="ev.overload", correlation_id=corr,
                    headers=dict(headers)))
            corrs = {c for c, _, _ in rows}
            for _ in range(3000):
                d = await app.broker.get("ev.overload", timeout=0.02)
                if d is not None:
                    answers.setdefault(d.properties.correlation_id,
                                       []).append(bytes(d.body))
                elif corrs <= set(answers):
                    break
            assert corrs <= set(answers), corrs - set(answers)
    finally:
        await app.stop()
    return answers


def test_adaptive_fraction_sequence_equals_jax_app(monkeypatch):
    runs = {}
    # The sweep-expired straggler of the last burst is left out: its
    # answers depend on whether tightening sheds it first.
    bursts = _bursts()[:-1]
    for pkg, props in (("port", Properties), ("jax", JaxProperties)):
        app, seq = _adaptive(pkg, monkeypatch)
        answers = asyncio.run(_serve_bursts(app, props, bursts))
        runs[pkg] = (app, seq, answers)
    (app, seq, answers), (japp, jseq, janswers) = runs["port"], runs["jax"]
    assert seq == jseq
    assert len(seq) >= len(bursts) and any(known for known, _ in seq)
    assert min(f for _, f in seq) < 1.0  # it tightened
    statuses = {c: [json.loads(b)["status"] for b in v]
                for c, v in answers.items()}
    assert statuses == {c: [json.loads(b)["status"] for b in v]
                        for c, v in janswers.items()}
    tighten = [r for r in _rows(app) if r[1] == "overload_tighten"]
    assert len(tighten) == len([r for r in _rows(japp)
                                if r[1] == "overload_tighten"]) > 0
    q = QUEUE
    assert app.metrics.gauges[f"overload_credit_fraction[{q}]"] == (
        japp.metrics.gauges[f"overload_credit_fraction[{q}]"])
