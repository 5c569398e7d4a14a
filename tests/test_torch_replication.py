"""Hot-standby replication and fenced failover in the port
(service/replication.py and the service's replication half) against the
JAX package's, on the CPU.

- The JAX package's unit scripts (``tests/test_replication.py``: the lease
  and its epoch, the link's scripted drop, duplicate, delay and
  partition, the applier's baseline rebase and terminal/clean rules, the
  fence, the loss bound) run on both packages' classes with the same
  outcome; a seeded ``repl_drop_prob`` link soak drops the same records.
- Config #1's queue (its pool cut to a CPU size) through both apps with a
  journal and a standby: the shadow's waiting set and replay keys,
  ``applied_seq == journal.seq``, the gauges, CLEAN and the lease's
  release at stop, and a drain that holds until the stream quiesces.
  The stream's ADMIT, baseline and CLEAN records are byte-equal to the
  JAX app's, its TERMINALS equal once the fields that differ by nature
  (match id, latency, wait, expiry) are carried over.
- Failover: crash, takeover at epoch 2, the fenced ex-primary's append
  raises ``FencedError`` and its publish is refused and counted, the
  successor adopts ``["s0"]`` (with the JAX app's transcript and events)
  and a redelivered ``p0`` replays its body byte for byte.
- Across packages: a JAX primary's stream applied by the port's standby
  gives the JAX standby's shadow; a port successor adopts a JAX standby's
  handoff.
- The ``failover_takeover`` trigger freezes a bundle the JAX package's
  schema check accepts; ``/healthz`` and the Prometheus families with
  replication on equal the JAX app's but for the pinned ack-lag naming
  (``REPLICATION_PROM_DIFFERENCES``), and a fenced queue is ``degraded``.
- Attaching replication with windows in flight: the stream is gapless
  from the baseline's seq and the shadow equals the pool.
"""

import asyncio
import base64
import dataclasses
import json
import os
import re
import threading
import time

import pytest
import torch

from matchmaking_tpu.config import BatcherConfig as JaxBatcherConfig
from matchmaking_tpu.config import ChaosConfig as JaxChaosConfig
from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import DurabilityConfig as JaxDurabilityConfig
from matchmaking_tpu.config import ObservabilityConfig as JaxObservabilityConfig
from matchmaking_tpu.config import ReplicationConfig as JaxReplicationConfig
from matchmaking_tpu.service import replication as jax_repl
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.testing.drain import fully_drained
from matchmaking_tpu.utils import forensics as jax_forensics
from matchmaking_tpu.utils import journal as jax_jr
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    ChaosConfig,
    Config,
    DurabilityConfig,
    ObservabilityConfig,
    ReplicationConfig,
)
from matchmaking_tpu_torch.service import replication as repl_mod
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.service.observability import build_report
from matchmaking_tpu_torch.testing.drain import (
    fully_drained as port_fully_drained,
)
from matchmaking_tpu_torch.utils import journal as jr
from test_torch_observability import (
    PROM_DIFFERENCES,
    free_port,
    get,
    healthz_shape,
    prom_differences,
    prom_shape,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG1 = os.path.join(ROOT, "configs", "elo_1v1.json")
Q = "matchmaking.search"
PKGS = ("port", "jax")
#: Each package's (replication module, journal module, ChaosConfig).
MODS = {"port": (repl_mod, jr, ChaosConfig),
        "jax": (jax_repl, jax_jr, JaxChaosConfig)}
PLAYERS = (("p0", 1500.0), ("p1", 1501.0), ("p2", 2000.0), ("p3", 2001.0),
           ("s0", 4000.0))


def _row(pid, rating=1500.0):
    return [pid, rating, 0.0, "", "", None, 1.0, "r.q", pid, 0, 0.0]


def _admit(*pids):
    return json.dumps({"rows": [_row(p) for p in pids]}).encode()


# ---- the unit scripts, on both packages ------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_lease_acquire_renew_expire_epoch_bump(pkg):
    R = MODS[pkg][0]
    auth = R.LeaseAuthority(lease_s=0.5)
    assert auth.acquire(Q, "p", 100.0) == 1
    assert auth.acquire(Q, "p", 100.2) == 1
    assert auth.renew(Q, "p", 1, 100.4) is True
    assert auth.is_current(Q, "p", 1)
    assert not auth.expired(Q, 100.8)
    with pytest.raises(R.LeaseHeldError):
        auth.acquire(Q, "s", 100.8)
    assert auth.expired(Q, 100.9)
    assert auth.acquire(Q, "s", 100.9) == 2
    assert not auth.is_current(Q, "p", 1)
    assert auth.is_current(Q, "s", 2)
    assert auth.renew(Q, "p", 1, 101.0) is False
    assert auth.epoch_of(Q) == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_lease_takeover_and_release(pkg):
    R = MODS[pkg][0]
    auth = R.LeaseAuthority(lease_s=0.5)
    auth.acquire(Q, "p", 10.0)
    with pytest.raises(R.LeaseHeldError):
        auth.takeover(Q, "s", 10.1)
    assert auth.takeover(Q, "s", 10.1, force=True) == 2
    assert auth.takeover(Q, "t", 10.6 + 0.5) == 3
    auth.release(Q, "t", 3, 20.0)
    assert auth.expired(Q, 20.0)
    assert auth.takeover(Q, "u", 20.0) == 4


@pytest.mark.parametrize("pkg", PKGS)
def test_lease_scripted_renewal_faults(pkg):
    R = MODS[pkg][0]
    auth = R.LeaseAuthority(lease_s=0.5, fail_renewals=(0,))
    auth.acquire(Q, "p", 1.0)
    assert auth.renew(Q, "p", 1, 1.1) is False
    assert auth.is_current(Q, "p", 1)
    assert auth.renew(Q, "p", 1, 1.2) is True


def _sender(pkg, chaos=None, lease_s=60.0):
    R = MODS[pkg][0]
    auth = R.LeaseAuthority(lease_s=lease_s)
    epoch = auth.acquire(Q, "p", 0.0)
    link = R.InProcReplicationLink(Q, chaos=chaos)
    repl = R.QueueReplication(Q, "p", epoch, auth, link)
    applier = R.StandbyApplier(Q, link, auth, owner="s")
    return auth, link, repl, applier


@pytest.mark.parametrize("pkg", PKGS)
def test_link_drop_heals_via_stall_retransmit(pkg):
    _, J, C = MODS[pkg]
    _auth, link, repl, applier = _sender(pkg, chaos=C(repl_drop_seqs=(2,)))
    for seq, pid in ((1, "a"), (2, "b"), (3, "c")):
        repl.on_record(seq, J.RT_ADMIT, _admit(pid))
    applier.pump()
    assert applier.applied_seq == 1
    assert link.counters["dropped"] == 1
    assert applier.counters["buffered"] == 1
    assert not repl.quiescent
    repl.pump(1.0)
    repl.pump(2.0)
    repl.pump(3.0)  # the second pump without progress retransmits {2, 3}
    assert link.counters["retransmits"] >= 2
    applier.pump()
    assert applier.applied_seq == 3
    assert sorted(applier.shadow.waiting) == ["a", "b", "c"]
    repl.pump(4.0)
    assert repl.quiescent and repl.lag() == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_link_dup_and_delay_reorder_absorbed(pkg):
    _, J, C = MODS[pkg]
    _auth, link, repl, applier = _sender(
        pkg, chaos=C(repl_dup_seqs=(1,), repl_delay_seqs=((2, 1),)))
    repl.on_record(1, J.RT_ADMIT, _admit("a"))
    repl.on_record(2, J.RT_ADMIT, _admit("b"))
    repl.on_record(3, J.RT_ADMIT, _admit("c"))
    assert link.counters["dup"] == 1 and link.counters["delayed"] == 1
    applier.pump()
    assert applier.applied_seq == 3
    assert applier.counters["dups"] >= 1
    assert sorted(applier.shadow.waiting) == ["a", "b", "c"]


@pytest.mark.parametrize("pkg", PKGS)
def test_link_runtime_partition_holds_and_resumes(pkg):
    _, J, _ = MODS[pkg]
    _auth, link, repl, applier = _sender(pkg)
    link.partition(2, resume=4)
    for seq, pid in ((1, "a"), (2, "b"), (3, "c")):
        repl.on_record(seq, J.RT_ADMIT, _admit(pid))
    applier.pump()
    assert applier.applied_seq == 1
    assert link.counters["partitions"] == 1
    repl.on_record(4, J.RT_ADMIT, _admit("d"))
    applier.pump()
    assert applier.applied_seq == 4
    assert sorted(applier.shadow.waiting) == ["a", "b", "c", "d"]
    link.partition(5)
    repl.on_record(5, J.RT_ADMIT, _admit("e"))
    repl.on_record(6, J.RT_ADMIT, _admit("f"))
    applier.pump()
    assert applier.applied_seq == 4
    repl.pump(1.0)
    assert not repl.quiescent
    assert repl.unacked_admit_players() == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_applier_baseline_rebase_and_stale_baseline_dropped(pkg):
    R, J, _ = MODS[pkg]
    link = R.InProcReplicationLink(Q)
    applier = R.StandbyApplier(Q, link)
    link.send(10, R.RT_REPL_SNAPSHOT,
              R.baseline_payload([_row("a"), _row("b")],
                                 [("z", b"z-body", 9e9)], {"k": 1}))
    applier.pump()
    assert applier.applied_seq == 10
    assert sorted(applier.shadow.waiting) == ["a", "b"]
    assert applier.shadow.recent["z"] == (b"z-body", 9e9)
    assert applier.shadow.admission == {"k": 1}
    assert link.acked == 10
    link.send(11, J.RT_ADMIT, _admit("c"))
    applier.pump()
    assert applier.applied_seq == 11 and "c" in applier.shadow.waiting
    link.send(5, R.RT_REPL_SNAPSHOT, R.baseline_payload([_row("x")], [], None))
    applier.pump()
    assert applier.applied_seq == 11 and "x" not in applier.shadow.waiting


@pytest.mark.parametrize("pkg", PKGS)
def test_applier_terminal_and_clean_semantics(pkg):
    R, J, _ = MODS[pkg]
    link = R.InProcReplicationLink(Q)
    applier = R.StandbyApplier(Q, link)
    link.send(1, J.RT_ADMIT, _admit("a", "b"))
    b64 = base64.b64encode(b"matched-body").decode("ascii")
    link.send(2, J.RT_TERMINAL,
              json.dumps({"id": "a", "body": b64, "exp": 9e9}).encode())
    link.send(3, J.RT_CLEAN, b"")
    applier.pump()
    assert sorted(applier.shadow.waiting) == ["b"]
    assert applier.shadow.recent["a"] == (b"matched-body", 9e9)
    assert "a" in applier.shadow.removed and applier.shadow.clean
    link.send(4, J.RT_ADMIT, _admit("c"))
    applier.pump()
    assert not applier.shadow.clean


@pytest.mark.parametrize("pkg", PKGS)
def test_fenced_live_primary_cannot_append_or_publish(pkg, tmp_path):
    R, J, _ = MODS[pkg]
    auth = R.LeaseAuthority(lease_s=0.5)
    epoch = auth.acquire(Q, "p", 100.0)
    link = R.InProcReplicationLink(Q)
    repl = R.QueueReplication(Q, "p", epoch, auth, link)
    j = J.PoolJournal(str(tmp_path), Q, fsync="window")
    j.tap = repl.on_record
    j.fence = repl.may_write
    try:
        j.append_admits([_row("a")])
        assert repl.sent_seq == j.seq and repl.role == "primary"
        assert auth.takeover(Q, "s", 101.0) == epoch + 1
        assert repl.superseded()
        with pytest.raises(J.FencedError):
            j.append_admits([_row("b")])
        assert repl.role == "fenced"
        assert repl.may_publish() is False
        assert repl.snapshot()["role"] == "fenced"
        sent_before = link.counters["sent"]
        repl.on_record(99, J.RT_ADMIT, _admit("x"))
        assert link.counters["sent"] == sent_before
    finally:
        j.abandon()


@pytest.mark.parametrize("pkg", PKGS)
def test_unacked_admit_players_is_the_loss_bound(pkg):
    _, J, _ = MODS[pkg]
    _auth, link, repl, applier = _sender(pkg)
    repl.on_record(1, J.RT_ADMIT, _admit("a", "b"))
    repl.on_record(2, J.RT_TERMINAL,
                   json.dumps({"id": "a", "body": "eA==", "exp": 9e9}).encode())
    assert repl.unacked_admit_players() == 2
    applier.pump()
    repl.pump(1.0)
    assert repl.unacked_admit_players() == 0


def test_seeded_link_soak_equals_jax():
    """``repl_drop_prob`` with scripted faults of every kind over 400
    records: both links drop, hold and deliver the same records, and both
    standbys converge to the same shadow through retransmission."""
    script = dict(seed=21, repl_drop_prob=0.1, repl_drop_seqs=(3, 50),
                  repl_dup_seqs=(7, 8), repl_delay_seqs=((10, 3), (90, 7)),
                  repl_partitions=((120, 140),))
    got = {}
    for pkg in PKGS:
        R, J, C = MODS[pkg]
        auth = R.LeaseAuthority(lease_s=60.0)
        link = R.InProcReplicationLink(Q, chaos=C(**script), seed=21)
        repl = R.QueueReplication(Q, "p", auth.acquire(Q, "p", 0.0), auth,
                                  link)
        applier = R.StandbyApplier(Q, link, auth, owner="s")
        trace = []
        for seq in range(1, 401):
            repl.on_record(seq, J.RT_ADMIT, _admit(f"x{seq}"))
            if seq % 10 == 0:
                applier.pump()
                repl.pump(float(seq))
                trace.append((applier.applied_seq, repl.acked_seq,
                              repl.unacked_admit_players()))
        for k in range(20):
            applier.pump()
            repl.pump(500.0 + k)
        assert repl.quiescent
        got[pkg] = (trace, dict(link.counters), dict(applier.counters),
                    applier.shadow.transcript())
    assert got["port"] == got["jax"]
    assert got["port"][1]["dropped"] > 2


# ---- the service: config #1's queue through both apps ----------------------


def _cfg(pkg, jdir, *, owner="primary", metrics_port=0, chaos=None):
    small = dict(pool_capacity=1024, pool_block=256, batch_buckets=(16, 64))
    if pkg == "jax":
        cfg = JaxConfig.from_json(CONFIG1)
        return dataclasses.replace(
            cfg, engine=dataclasses.replace(cfg.engine, **small),
            batcher=JaxBatcherConfig(max_batch=8, max_wait_ms=5.0),
            durability=JaxDurabilityConfig(journal_dir=str(jdir),
                                           fsync="window"),
            replication=JaxReplicationConfig(role="primary", owner=owner),
            observability=JaxObservabilityConfig(trace=False),
            chaos=chaos or JaxChaosConfig(), metrics_port=metrics_port)
    cfg = Config.from_json(CONFIG1, backend="gpu")
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, **small),
        batcher=BatcherConfig(max_batch=8, max_wait_ms=5.0),
        durability=DurabilityConfig(journal_dir=str(jdir), fsync="window"),
        replication=ReplicationConfig(role="primary", owner=owner),
        observability=ObservabilityConfig(trace=False),
        chaos=chaos or ChaosConfig(), metrics_port=metrics_port)


def _app(pkg, cfg, hub):
    if pkg == "jax":
        return JaxApp(cfg, replication_hub=hub)
    return MatchmakingApp(cfg, device="cpu", replication_hub=hub)


def _hub(pkg, **kw):
    return MODS[pkg][0].ReplicationHub(**kw)


def _counter(app, name):
    return app.metrics.counters.get(name) or 0


def _publish(pkg, app, pid, rating, reply):
    props = JaxProperties if pkg == "jax" else Properties
    app.broker.publish(Q, json.dumps({"id": pid, "rating": rating}).encode(),
                       props(reply_to=reply, correlation_id=pid,
                             headers={"x-first-received": "1.0"}))


def _collect(app, reply, sink):
    async def on_reply(delivery):
        sink.setdefault(delivery.properties.correlation_id, []).append(
            bytes(delivery.body))

    app.broker.declare_queue(reply)
    app.broker.basic_consume(reply, on_reply, prefetch=1_000_000)


def _drained(pkg, app, rt, matched, replication=True):
    drained = fully_drained if pkg == "jax" else port_fully_drained
    return drained(app, rt, Q, matched, replication=replication)


async def _quiesce(pkg, app, rt, *, matched=0, standby=None,
                   replication=True, tries=2400):
    for _ in range(tries):
        await asyncio.sleep(0.025)
        if standby is not None:
            standby.pump()
        if _drained(pkg, app, rt, matched, replication):
            return True
    return False


def _record(hub):
    """Every first transmission on the hub's link: seq → (type, payload)."""
    link = hub.link(Q)
    sent: dict = {}
    real = link.send

    def send(seq, rtype, payload):
        sent.setdefault(seq, (rtype, bytes(payload)))
        real(seq, rtype, payload)
    link.send = send
    return sent


def _stream_normalized(sent, rt_terminals):
    """The stream as (seq, type, payload) with a TERMINALS record's bodies
    and expiries reduced to what is equal by nature."""
    out = []
    for seq in sorted(sent):
        rtype, payload = sent[seq]
        if rtype == rt_terminals:
            d = json.loads(payload)
            rows = []
            for pid, b64, _exp in d["t"]:
                body = json.loads(base64.b64decode(b64))
                for key in ("latency_ms", "waited_ms", "trace_id"):
                    body.pop(key, None)
                if body.get("match"):
                    body["match"].pop("match_id", None)
                rows.append((pid, body))
            payload = json.dumps(rows, sort_keys=True).encode()
        out.append((seq, rtype, payload))
    return out


async def _roundtrip(pkg, tmp_path):
    hub = _hub(pkg, lease_s=0.5)
    sent = _record(hub)
    app = _app(pkg, _cfg(pkg, tmp_path / f"{pkg}.j1"), hub)
    await app.start()
    rt = app.runtime(Q)
    standby = hub.standby(Q)
    replies: dict = {}
    stopped = False
    try:
        attached = [e["kind"] for e in app.events.snapshot()
                    if e["kind"] == "replication_attached"]
        _collect(app, "repl.replies", replies)
        for pid, rating in PLAYERS:
            _publish(pkg, app, pid, rating, "repl.replies")
        assert await _quiesce(pkg, app, rt, matched=4, standby=standby)
        standby.pump()
        blk = build_report(app)["replication"][Q] if pkg == "port" else None
        out = {
            "attached": attached,
            "waiting": sorted(standby.shadow.waiting),
            "recent": sorted(standby.shadow.recent),
            "applied": standby.applied_seq, "journal_seq": rt.journal.seq,
            "quiescent": rt.replication.quiescent,
            "gauges": (app.metrics.gauges.get(f"replication_lag[{Q}]"),
                       app.metrics.gauges.get(f"replication_epoch[{Q}]")),
            "report": blk,
        }
        await app.stop()
        stopped = True
        standby.pump()
        out["clean"] = standby.shadow.clean
        out["released"] = hub.authority.expired(Q, time.monotonic())
        out["stream"] = _stream_normalized(sent, MODS[pkg][1].RT_TERMINALS)
        out["sent"] = sent
        return out
    finally:
        if not stopped:
            await app.stop()


@pytest.fixture(scope="module")
def roundtrips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("repl")
    return {pkg: asyncio.run(_roundtrip(pkg, tmp)) for pkg in PKGS}


def test_replication_service_roundtrip_and_clean_handoff(roundtrips):
    mine, theirs = roundtrips["port"], roundtrips["jax"]
    assert mine["attached"] == ["replication_attached"]
    assert mine["waiting"] == ["s0"]
    assert {"p0", "p1", "p2", "p3"} <= set(mine["recent"])
    assert mine["applied"] == mine["journal_seq"] and mine["quiescent"]
    assert mine["gauges"] == (0, 1)
    blk = mine["report"]
    assert blk["role"] == "primary" and blk["lag"] == 0
    assert blk["acked_seq"] == blk["sent_seq"] == mine["journal_seq"]
    assert mine["clean"] and mine["released"]
    for key in ("attached", "waiting", "recent", "applied", "journal_seq",
                "quiescent", "gauges", "clean", "released"):
        assert mine[key] == theirs[key], key


def test_stream_records_equal_the_jax_apps(roundtrips):
    mine, theirs = roundtrips["port"], roundtrips["jax"]
    assert mine["stream"] == theirs["stream"]
    kinds = {rtype for _, rtype, _ in mine["stream"]}
    assert {jr.RT_ADMIT, jr.RT_TERMINALS, jr.RT_CLEAN,
            repl_mod.RT_REPL_SNAPSHOT} <= kinds
    for seq, (rtype, payload) in mine["sent"].items():
        if rtype != jr.RT_TERMINALS:  # byte for byte
            assert payload == theirs["sent"][seq][1], (seq, rtype)


def test_a_jax_primarys_stream_gives_the_port_standby_the_jax_shadow(
        roundtrips):
    sent = roundtrips["jax"]["sent"]
    shadows = {}
    for pkg in PKGS:
        R = MODS[pkg][0]
        link = R.InProcReplicationLink(Q)
        applier = R.StandbyApplier(Q, link)
        for seq in sorted(sent):
            link.send(seq, *sent[seq])
        applier.pump()
        sh = applier.shadow
        shadows[pkg] = (applier.applied_seq, sh.transcript(), sh.recent,
                        sh.waiting, sh.admission, sh.last_seq)
    assert shadows["port"] == shadows["jax"]
    assert shadows["port"][1]["waiting"] == ["s0"]


async def test_drain_holds_until_replication_quiesces(tmp_path):
    hub = _hub("port", lease_s=5.0)
    app = _app("port", _cfg("port", tmp_path / "j1"), hub)
    await app.start()
    rt = app.runtime(Q)
    standby = hub.standby(Q)
    try:
        replies: dict = {}
        _collect(app, "drain.replies", replies)
        _publish("port", app, "a0", 1500.0, "drain.replies")
        _publish("port", app, "a1", 1501.0, "drain.replies")
        assert await _quiesce("port", app, rt, matched=2, replication=False)
        assert not _drained("port", app, rt, 2)          # the unacked tail
        assert _drained("port", app, rt, 2, replication=False)
        assert await _quiesce("port", app, rt, matched=2, standby=standby)
        assert rt.replication.quiescent
    finally:
        await app.stop()


# ---- failover ---------------------------------------------------------------


async def _failover(pkg, tmp):
    R, J, _ = MODS[pkg]
    hub = _hub(pkg, lease_s=0.5)
    app = _app(pkg, _cfg(pkg, tmp / f"{pkg}.j1", owner="hostA"), hub)
    await app.start()
    rt = app.runtime(Q)
    standby = hub.standby(Q, owner="hostB")
    before: dict = {}
    _collect(app, "fo.replies", before)
    for pid, rating in (("p0", 1500.0), ("p1", 1501.0), ("s0", 4000.0)):
        _publish(pkg, app, pid, rating, "fo.replies")
    assert await _quiesce(pkg, app, rt, matched=2, standby=standby)
    await app.crash()
    out = {"epoch": standby.takeover(time.monotonic() + 0.5 + 0.05),
           "superseded": rt.replication.superseded()}
    handoff = dict(hub.adopted[Q])
    with pytest.raises(J.FencedError):
        rt.journal.append_admits([_row("zz")])
    refused = _counter(app, "fenced_publish_refused")
    if pkg == "jax":
        rt._publish_body("fo.replies", "zz", b"{}")
    else:
        rt._publish("fo.replies", "zz", b"{}")
    out["refused"] = _counter(app, "fenced_publish_refused") - refused
    out["role"] = rt.replication.role
    app2 = _app(pkg, _cfg(pkg, tmp / f"{pkg}.j2", owner="hostB"), hub)
    await app2.start()
    rt2 = app2.runtime(Q)
    try:
        out["waiting"] = sorted(r.id for r in rt2.engine.waiting())
        out["rto"] = app2.metrics.gauges.get(f"failover_rto_ms[{Q}]")
        out["takeovers"] = _counter(app2, "failover_takeovers")
        rec = rt2.last_recovery
        out["recovery"] = {k: rec[k] for k in (
            "source", "epoch", "tail_players", "snapshot_players",
            "dedup_entries", "transcript")}
        out["events"] = [(e["kind"], e.get("detail", ""))
                         for e in app2.events.snapshot()
                         if e["kind"] in ("lease_expired", "epoch_bump",
                                          "replay_window",
                                          "failover_takeover",
                                          "replication_attached")]
        snap = app2.incidents.snapshot(include_bundles=True)
        out["bundles"] = [b for b in snap["bundles"]
                          if b["trigger"]["class"] == "failover"]
        after: dict = {}
        _collect(app2, "fo.again", after)
        _publish(pkg, app2, "p0", 1500.0, "fo.again")
        assert await _quiesce(pkg, app2, rt2, replication=False)
        out["replayed"] = after["p0"]
        out["before"] = before["p0"]
    finally:
        await app2.stop()
    out["handoff"] = handoff
    return out


@pytest.fixture(scope="module")
def failovers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("failover")
    return {pkg: asyncio.run(_failover(pkg, tmp)) for pkg in PKGS}


def _rto_free(events):
    """Event details with the measured rto taken out."""
    return [(k, d.split(", rto ")[0]) for k, d in events]


def test_failover_crash_takeover_successor_adopts(failovers):
    mine, theirs = failovers["port"], failovers["jax"]
    assert mine["epoch"] == 2 and mine["superseded"]
    assert mine["refused"] == 1 and mine["role"] == "fenced"
    assert mine["waiting"] == ["s0"]
    assert mine["rto"] is not None and mine["rto"] > 0
    assert mine["takeovers"] == 1
    assert mine["recovery"]["source"] == "replica"
    assert mine["recovery"]["epoch"] == 2
    assert mine["recovery"]["tail_players"] == 1
    # The redelivered p0 replays its pre-crash answer byte for byte.
    matched = [b for b in mine["before"] if json.loads(b)["status"] == "matched"]
    assert mine["replayed"] == matched
    for key in ("epoch", "superseded", "refused", "role", "waiting",
                "takeovers", "recovery"):
        assert mine[key] == theirs[key], key
    assert _rto_free(mine["events"]) == _rto_free(theirs["events"])
    assert [k for k, _ in mine["events"]] == [
        "lease_expired", "epoch_bump", "replay_window", "failover_takeover",
        "replication_attached"]


def test_failover_bundle_validates_under_the_jax_schema(failovers):
    (bundle,) = failovers["port"]["bundles"]
    assert bundle["trigger"]["kind"] == "failover_takeover"
    assert jax_forensics.validate_bundle(bundle) == []
    assert len(failovers["jax"]["bundles"]) == 1


async def test_a_port_successor_adopts_a_jax_standbys_handoff(failovers,
                                                             tmp_path):
    theirs = failovers["jax"]
    handoff = theirs["handoff"]
    state = jr.RecoveredQueue(queue=Q, clean=False)
    for f in dataclasses.fields(state):
        setattr(state, f.name, getattr(handoff["state"], f.name))
    hub = _hub("port", lease_s=0.5)
    now = time.monotonic()
    hub.authority.acquire(Q, "hostA", now)
    assert hub.authority.takeover(Q, "hostB", now + 1.0) == handoff["epoch"]
    hub.adopted[Q] = dict(handoff, state=state)
    app = _app("port", _cfg("port", tmp_path / "j", owner="hostB"), hub)
    await app.start()
    rt = app.runtime(Q)
    try:
        assert sorted(r.id for r in rt.engine.waiting()) == ["s0"]
        assert rt.last_recovery["transcript"] == theirs["recovery"][
            "transcript"]
        after: dict = {}
        _collect(app, "x.again", after)
        _publish("port", app, "p0", 1500.0, "x.again")
        assert await _quiesce("port", app, rt, replication=False)
        assert after["p0"] == theirs["replayed"]
    finally:
        await app.stop()


async def test_a_window_held_for_its_commit_is_fenced_as_it_leaves(tmp_path):
    """Under fsync "window" a window's publish waits for its commit on a
    worker thread; a takeover while that commit runs fences the publish
    as it leaves: no answer reaches the client and every row is counted
    refused."""
    hub = _hub("port", lease_s=0.5)
    app = _app("port", _cfg("port", tmp_path / "j", owner="hostA"), hub)
    await app.start()
    rt = app.runtime(Q)
    standby = hub.standby(Q, owner="hostB")
    entered, release = threading.Event(), threading.Event()
    real = rt._timed_commit

    def held_commit():
        entered.set()
        release.wait(10.0)
        return real()
    rt._timed_commit = held_commit
    replies: dict = {}
    _collect(app, "f.replies", replies)
    try:
        for pid, rating in (("p0", 1500.0), ("p1", 1501.0)):
            _publish("port", app, pid, rating, "f.replies")
        for _ in range(400):
            await asyncio.sleep(0.01)
            if entered.is_set() and _counter(app, "players_matched") >= 2:
                break
        assert entered.is_set() and rt._settler is not None
        refused = _counter(app, "fenced_publish_refused")
        assert standby.takeover(time.monotonic() + 0.5 + 0.05) == 2
        release.set()
        await rt._settled()
        await asyncio.sleep(0.05)
        assert replies == {}
        assert _counter(app, "fenced_publish_refused") - refused == 2
        assert rt.counters["publish_batches"] == 0
    finally:
        release.set()
        await app.crash()


# ---- the HTTP surfaces with replication on ----------------------------------


async def _scrape(pkg, tmp, fence):
    port = free_port()
    hub = _hub(pkg, lease_s=0.5)
    app = _app(pkg, _cfg(pkg, tmp / f"{pkg}.{fence}", metrics_port=port), hub)
    await app.start()
    rt = app.runtime(Q)
    standby = hub.standby(Q)
    try:
        replies: dict = {}
        _collect(app, "h.replies", replies)
        for pid, rating in PLAYERS:
            _publish(pkg, app, pid, rating, "h.replies")
        assert await _quiesce(pkg, app, rt, matched=4, standby=standby)
        rt.replication.pump(time.monotonic())
        if fence:
            hub.authority.takeover(Q, "standby", time.monotonic(), force=True)
            assert not rt.replication.may_publish()
        return await get(port, "/healthz"), await get(port,
                                                      "/metrics?format=prom")
    finally:
        if not fence:
            await app.stop()
        else:
            await app.crash()


#: Stats of a latency series in the exposition.
_LATENCY_STATS = ("count", "p50_ms", "p90_ms", "p99_ms", "max_ms", "mean_ms")

#: The families in which the port's exposition differs from the JAX app's
#: with replication on. The JAX app names the ack-lag latency series
#: ``matchmaking_replication_ack_lag[<queue>]_<stat>`` (brackets are not
#: valid in a Prometheus family name, and ``parse_prom`` refuses them); the
#: port renders ``matchmaking_replication_ack_lag_<stat>{queue="<queue>"}``.
REPLICATION_PROM_DIFFERENCES: frozenset = frozenset(
    {f"matchmaking_replication_ack_lag_{s}" for s in _LATENCY_STATS}
    | {f"matchmaking_replication_ack_lag[{Q}]_{s}" for s in _LATENCY_STATS})


def _jax_prom_shape(text):
    """``prom_shape`` of the JAX app's exposition, its bracketed families
    (which ``parse_prom`` refuses) taken as they stand, with their
    label-key sets."""
    valid, bracketed = [], {}
    for line in text.split("\n"):
        m = re.match(r"(# TYPE )?(matchmaking_\w+\[[^\]]*\]\w*)(\{[^}]*\})?",
                     line)
        if m is None:
            valid.append(line)
            continue
        keys = tuple(sorted(re.findall(r'(\w+)="', m.group(3) or "")))
        fam = bracketed.setdefault(m.group(2), [])
        if not m.group(1) and keys not in fam:
            fam.append(keys)
    return {**prom_shape("\n".join(valid)), **bracketed}


@pytest.mark.parametrize("fence", [False, True])
def test_healthz_and_prom_with_replication_equal_jax(tmp_path, fence):
    mine = asyncio.run(_scrape("port", tmp_path, fence))
    theirs = asyncio.run(_scrape("jax", tmp_path, fence))
    assert mine[0][0] == theirs[0][0] == 200
    assert healthz_shape(mine[0][1]) == healthz_shape(theirs[0][1])
    body = json.loads(mine[0][1])
    entry = body["queues"][Q]["replication"]
    assert entry == {k: json.loads(theirs[0][1])["queues"][Q]["replication"][k]
                     for k in entry}
    assert body["status"] == ("degraded" if fence else "ok")
    assert entry["role"] == ("fenced" if fence else "primary")
    assert "matchmaking_replication_ack_lag_count{" in mine[1][1]
    assert prom_differences(prom_shape(mine[1][1]),
                            _jax_prom_shape(theirs[1][1])
                            ) == PROM_DIFFERENCES | REPLICATION_PROM_DIFFERENCES


# ---- the attach's lock guarantee -------------------------------------------


async def test_attach_with_windows_in_flight_is_gapless(tmp_path):
    """Replication attached to a live queue with windows in flight: under
    ``_pool_lock`` they are collected first, so the baseline is the pool
    at its seq and every later record follows it without a gap; the
    standby's shadow equals the pool once the windows are collected."""
    cfg = _cfg("port", tmp_path / "j")
    # A third pipeline slot: two windows held in flight leave the batcher
    # free (a full pipeline holds the flush, and _pool_lock with it).
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, pipeline_depth=3))
    off = dataclasses.replace(cfg, replication=ReplicationConfig())
    hub = _hub("port", lease_s=60.0)
    app = MatchmakingApp(off, device="cpu", replication_hub=hub)
    await app.start()
    rt = app.runtime(Q)
    sent = _record(hub)
    replies: dict = {}
    _collect(app, "g.replies", replies)
    try:
        eng = rt.engine
        real = eng.collect_ready
        eng.collect_ready = lambda: []  # hold every window in flight
        for i in range(16):  # two windows of 8
            _publish("port", app, f"w{i}", 1500.0 + 37.0 * i, "g.replies")
            if i == 7:
                await asyncio.sleep(0.05)
        for _ in range(200):
            await asyncio.sleep(0.01)
            if eng.inflight() >= 2:
                break
        assert eng.inflight() == 2
        app.cfg = cfg  # replication on, mid-life
        await rt.start_replication()
        eng.collect_ready = real
        base = min(sent)
        assert sent[base][0] == repl_mod.RT_REPL_SNAPSHOT
        assert eng.inflight() == 0  # collected before the baseline
        standby = hub.standby(Q)
        for i in range(24, 40):
            _publish("port", app, f"w{i}", 1500.0 + 37.0 * i, "g.replies")
        assert await _quiesce("port", app, rt, standby=standby)
        standby.pump()
        assert sorted(sent) == list(range(base, base + len(sent)))
        assert standby.applied_seq == rt.journal.seq
        assert sorted(standby.shadow.waiting) == sorted(
            r.id for r in eng.waiting())
    finally:
        await app.stop()
