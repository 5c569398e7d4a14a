"""Crash durability, the drain and its restore in the port's service,
against the JAX package's app, on the CPU.

Both apps (the JAX one with ``backend="tpu"`` on the CPU, tracing off;
the port's with ``device="cpu"``) take the same scripted traffic and the
same hard crash (``MatchmakingApp.crash()``: no drain, no clean marker):

- the successors recover the same transcript and the same waiting set,
  and a redelivery of every request is answered alike (bytes equal, the
  match id, latency and wait carried over), a matched player's answer
  replaying its pre-crash body byte for byte; the port's app also
  recovers the JAX app's directory;
- a clean shutdown skips recovery; two runs' transcripts are bit-identical
  (with a scripted engine fault); a bucketed queue's index after replay is
  its exact rebuild; the compaction timer is armed only after recovery;
  recovery discards a held speculation ("journal replay");
- write-ahead, under every fsync policy: no answer and no ack leaves
  before a commit covers its records, and the journal as a crash between
  that commit and the publish would leave it recovers the published
  players as terminal (their redeliveries replay the published bodies);
- a drain saves the pool, the admission state and the broker backlog, and
  a successor restores them (the pool's columns equal the JAX app's
  round trip), also with speculation on.
"""

import asyncio
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import BatcherConfig as JaxBatcherConfig
from matchmaking_tpu.config import ChaosConfig as JaxChaosConfig
from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import DurabilityConfig as JaxDurabilityConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import ObservabilityConfig as JaxObservabilityConfig
from matchmaking_tpu.config import OverloadConfig as JaxOverloadConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.service import contract as jax_contract
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.utils import checkpoint as jax_ck
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    ChaosConfig,
    Config,
    DurabilityConfig,
    EngineConfig,
    ObservabilityConfig,
    OverloadConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.engine.kernels import INDEX_FIELDS
from matchmaking_tpu_torch.service import contract
from matchmaking_tpu_torch.service.app import MatchmakingApp, _QueueRuntime
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.utils import checkpoint as ck
from matchmaking_tpu_torch.utils import journal as jr

torch.set_num_threads(1)

Q = "matchmaking.search"
PLAYERS = (("p0", 1500.0), ("p1", 1501.0), ("p2", 2000.0), ("p3", 2001.0),
           ("s0", 4000.0))


def _cfg(pkg, jdir, *, bucketed=False, chaos_steps=(), compact_interval=0.0,
         fsync="window", request_timeout=None, spec=False, trace=False):
    eng = dict(pool_capacity=256, pool_block=64, batch_buckets=(8, 32),
               top_k=4)
    if bucketed:
        eng.update(bucketed=True, band_spec="gaussian:1500:300",
                   prune_window_blocks=2, prune_chunk=8)
    if spec:
        eng.update(spec_formation=True, spec_interval_ms=5.0,
                   spec_max_steps=1)
    q = dict(rating_threshold=50.0, dedup_ttl_s=600.0,
             request_timeout_s=request_timeout)
    dur = dict(journal_dir=str(jdir), fsync=fsync,
               compact_interval_s=compact_interval)
    chaos = dict(seed=7, queues=(Q,), fail_steps=chaos_steps)
    if pkg == "jax":
        return JaxConfig(
            queues=(JaxQueueConfig(**q),),
            engine=JaxEngineConfig(backend="tpu", **eng),
            batcher=JaxBatcherConfig(max_batch=8, max_wait_ms=5.0),
            durability=JaxDurabilityConfig(**dur),
            chaos=JaxChaosConfig(**chaos) if chaos_steps else JaxChaosConfig(),
            observability=JaxObservabilityConfig(trace=trace))
    return Config(
        queues=(QueueConfig(**q),), engine=EngineConfig(**eng),
        batcher=BatcherConfig(max_batch=8, max_wait_ms=5.0),
        durability=DurabilityConfig(**dur),
        chaos=ChaosConfig(**chaos) if chaos_steps else ChaosConfig(),
        observability=ObservabilityConfig(trace=trace))


def _app(pkg, cfg):
    return JaxApp(cfg) if pkg == "jax" else MatchmakingApp(cfg, device="cpu")


def _counter(pkg, app, name):
    if pkg == "jax":
        return app.metrics.counters.get(name) or 0
    return app.runtime(Q).counters[name]


def _publish(pkg, app, players, reply):
    props = JaxProperties if pkg == "jax" else Properties
    app.broker.declare_queue(reply)
    for pid, rating in players:
        app.broker.publish(
            Q, json.dumps({"id": pid, "rating": rating}).encode(),
            props(reply_to=reply, correlation_id=pid,
                  headers={"x-first-received": "1.0"}))


def _collect(app, reply, sink):
    async def on_reply(delivery):
        sink.append((delivery.properties.correlation_id, bytes(delivery.body)))

    app.broker.declare_queue(reply)
    app.broker.basic_consume(reply, on_reply, prefetch=1_000_000)


async def _quiesce(app, until, tries=1500):
    """Poll until ``until()`` holds and nothing is buffered or in flight."""
    rt = app.runtime(Q)
    for _ in range(tries):
        await asyncio.sleep(0.02)
        batcher = getattr(rt, "batcher", None) or rt._batcher
        if (until() and app.broker.queue_depth(Q) == 0
                and app.broker.handlers_idle() and batcher.depth == 0
                and getattr(rt, "_flushing", 0) == 0
                and getattr(rt, "_settler", None) is None
                and (not hasattr(rt.engine, "inflight")
                     or rt.engine.inflight() == 0)):
            return
    raise AssertionError("the app did not quiesce")


def _statuses(replies, status):
    return {c for c, b in replies if json.loads(b)["status"] == status}


async def _crash_cycle(pkg, jdir, chaos_steps=()):
    """Two pairs that match and one player who waits, then a hard crash.
    Returns (waiting ids, replies)."""
    app = _app(pkg, _cfg(pkg, jdir, chaos_steps=chaos_steps))
    await app.start()
    replies: list = []
    _collect(app, "dur.replies", replies)
    _publish(pkg, app, PLAYERS, "dur.replies")
    await _quiesce(app, lambda: len(_statuses(replies, "matched")) == 4
                   and "s0" in _statuses(replies, "queued"))
    waiting = {r.id for r in app.runtime(Q).engine.waiting()}
    await app.crash()
    return waiting, replies


async def _successor(pkg, jdir):
    """Recover, then redeliver every request. Returns (last_recovery,
    waiting ids after recovery, replies to the redeliveries, app)."""
    app = _app(pkg, _cfg(pkg, jdir))
    await app.start()
    try:
        rt = app.runtime(Q)
        rec = rt.last_recovery
        waiting = {r.id for r in rt.engine.waiting()}
        replies: list = []
        _collect(app, "dur.replays", replies)
        _publish(pkg, app, PLAYERS, "dur.replays")
        # The waiting player's copy is a duplicate of a pool entry: it is
        # not answered (nor entered twice), in both packages.
        await _quiesce(app, lambda: _statuses(replies, "matched") == {
            "p0", "p1", "p2", "p3"})
        assert {r.id for r in rt.engine.waiting()} == {"s0"}
        assert _counter(pkg, app, "deduped_replays") >= 4
        assert _counter(pkg, app, "crash_recoveries") == 1
    finally:
        await app.stop()
    return rec, waiting, replies


def _normalized(body, jbody):
    """The JAX app's body with the port's match id, latency and wait."""
    mine = contract.decode_response(body)
    theirs = jax_contract.decode_response(jbody)
    match = theirs.match
    if match is not None:
        match = dataclasses.replace(match, match_id=mine.match.match_id)
    theirs = dataclasses.replace(theirs, match=match,
                                 latency_ms=mine.latency_ms,
                                 waited_ms=mine.waited_ms, trace_id="")
    return jax_contract.encode_response(theirs)


def _same_answers(port, jax):
    assert sorted(c for c, _ in port) == sorted(c for c, _ in jax)
    theirs = {}
    for c, b in jax:
        theirs.setdefault(c, []).append(b)
    for c, b in port:
        assert b == _normalized(b, theirs[c].pop(0)), c


def test_crash_recovery_equals_jax_app(tmp_path):
    async def run(pkg):
        jdir = tmp_path / pkg
        waiting, before = await _crash_cycle(pkg, jdir)
        shutil.copytree(jdir, tmp_path / f"{pkg}.copy")
        rec, recovered, after = await _successor(pkg, jdir)
        return waiting, before, rec, recovered, after

    port = asyncio.run(run("port"))
    jax = asyncio.run(run("jax"))
    for got, want in ((port, "port"), (jax, "jax")):
        waiting, before, rec, recovered, after = got
        assert waiting == recovered == {"s0"}, want
        assert rec["transcript"]["waiting"] == ["s0"]
        assert not rec["fallback"] and rec["rto_ms"] > 0.0
        # A matched player's redelivery replays its pre-crash body.
        first = {c: b for c, b in before
                 if json.loads(b)["status"] == "matched"}
        again = {c: b for c, b in after
                 if json.loads(b)["status"] == "matched"}
        assert first == again and len(first) == 4
    assert json.dumps(port[2]["transcript"], sort_keys=True) == json.dumps(
        jax[2]["transcript"], sort_keys=True)
    for key in ("snapshot_players", "tail_players", "dedup_entries"):
        assert port[2][key] == jax[2][key], key
    _same_answers(port[1], jax[1])
    _same_answers(port[4], jax[4])
    # The same traffic under a fixed clock wrote the same ADMIT records.
    admits = {}
    for pkg in ("port", "jax"):
        _, recs, torn, _ = jr.read_segment(jr.journal_path(
            str(tmp_path / f"{pkg}.copy"), Q))
        admits[pkg] = [p for _, t, p in recs if t == jr.RT_ADMIT]
        assert not torn
    assert admits["port"] == admits["jax"] and admits["port"]

    # The port's app recovers the JAX app's crashed directory.
    async def cross():
        return await _successor("port", tmp_path / "jax.copy")

    rec, recovered, after = asyncio.run(cross())
    assert recovered == {"s0"}
    assert rec["transcript"] == jax[2]["transcript"]
    theirs = {c: b for c, b in jax[1] if json.loads(b)["status"] == "matched"}
    assert {c: b for c, b in after
            if json.loads(b)["status"] == "matched"} == theirs


async def test_clean_shutdown_skips_recovery(tmp_path):
    jdir = tmp_path / "j"
    app = _app("port", _cfg("port", jdir))
    await app.start()
    _publish("port", app, [("s0", 4000.0)], "")
    await _quiesce(app, lambda: app.engine.pool_size() == 1)
    await app.stop()
    app2 = _app("port", _cfg("port", jdir))
    await app2.start()
    try:
        assert app2.counters["crash_recoveries"] == 0
        assert app2.runtime(Q).last_recovery is None
        assert app2.engine.pool_size() == 0
    finally:
        await app2.stop()


def test_two_run_recovery_transcripts_bit_identical(tmp_path):
    async def one(run):
        jdir = tmp_path / f"run{run}"
        await _crash_cycle("port", jdir, chaos_steps=(1,))
        app = _app("port", _cfg("port", jdir, chaos_steps=(1,)))
        await app.start()
        rec = app.runtime(Q).last_recovery
        await app.stop()
        assert rec is not None
        return rec["transcript"]

    t0 = asyncio.run(one(0))
    t1 = asyncio.run(one(1))
    assert json.dumps(t0, sort_keys=True) == json.dumps(t1, sort_keys=True)


async def test_bucketed_index_exact_after_replay(tmp_path):
    jdir = tmp_path / "j"
    app = _app("port", _cfg("port", jdir, bucketed=True))
    await app.start()
    singles = [(f"s{i}", r) for i, r in enumerate((800.0, 1500.0, 2200.0,
                                                   4000.0))]
    _publish("port", app, singles, "")
    await _quiesce(app, lambda: app.engine.pool_size() == 4)
    pre = {r.id for r in app.engine.waiting()}
    await app.crash()
    app2 = _app("port", _cfg("port", jdir, bucketed=True))
    await app2.start()
    try:
        eng = app2.engine
        assert {r.id for r in eng.waiting()} == pre
        names = [name for name, _ in INDEX_FIELDS]
        held = {k: eng.dev_pool[k].clone() for k in names}
        eng.kernels.index_rebuild(eng.dev_pool)
        for k in names:
            assert torch.equal(held[k], eng.dev_pool[k]), k
        assert int(held["bidx_count"].sum()) == 4
    finally:
        await app2.stop()


async def test_compaction_timer_armed_only_after_recovery(tmp_path,
                                                          monkeypatch):
    jdir = tmp_path / "j"
    await _crash_cycle("port", jdir)
    orig = _QueueRuntime.recover_from_journal
    seen: dict = {}

    async def spy(self):
        seen["armed_before_recovery"] = self._durability is not None
        return await orig(self)

    monkeypatch.setattr(_QueueRuntime, "recover_from_journal", spy)
    app = _app("port", _cfg("port", jdir, compact_interval=0.05))
    await app.start()
    try:
        rt = app.runtime(Q)
        assert seen["armed_before_recovery"] is False
        assert rt._durability is not None
        assert {r.id for r in rt.engine.waiting()} == {"s0"}
        # The timer compacts once the segment is over its budget.
        rt.journal.compact_records = 1
        _publish("port", app, [("t0", 3000.0)], "")
        for _ in range(1500):
            await asyncio.sleep(0.02)
            if rt.counters["journal_compactions"] >= 2:
                break
        assert rt.counters["journal_compactions"] >= 2  # recovery's + timer
        assert rt.counters["journal_compact_errors"] == 0
    finally:
        await app.stop()
    app2 = _app("port", _cfg("port", jdir))
    await app2.start()
    try:
        assert app2.runtime(Q).last_recovery is None  # a clean stop
        assert {r.id for r in app2.engine.waiting()} == set()
    finally:
        await app2.stop()


async def test_recovery_discards_a_held_speculation(tmp_path, monkeypatch):
    from matchmaking_tpu_torch.engine.gpu import GpuEngine

    jdir = tmp_path / "j"
    await _crash_cycle("port", jdir)
    reasons: list = []
    orig = GpuEngine.spec_invalidate

    def spy(self, reason="external"):
        reasons.append(reason)
        return orig(self, reason)

    monkeypatch.setattr(GpuEngine, "spec_invalidate", spy)
    app = _app("port", _cfg("port", jdir, spec=True))
    await app.start()
    try:
        assert reasons[0] == "journal replay"
        assert app.runtime(Q).last_recovery is not None
    finally:
        await app.stop()


# ---- write-ahead ---------------------------------------------------------------


@pytest.mark.parametrize("fsync", ["none", "interval", "window"])
async def test_no_answer_or_ack_before_its_commit(tmp_path, fsync):
    """Every publish and ack is audited: the journal holds nothing
    buffered, and (``fsync="window"``) the published player's terminal
    and the acked player's admission are fsynced. At the first matched
    publish the journal directory is copied (what a crash between the
    commit and the publish leaves); a successor on the copy holds the
    published players as terminal and replays their published bodies."""
    jdir = tmp_path / "j"
    app = _app("port", _cfg("port", jdir, fsync=fsync, request_timeout=0.3))
    await app.start()
    rt = app.runtime(Q)
    j = rt.journal
    seq_of: dict = {}
    for name in ("append_admits", "append_terminals"):
        real = getattr(j, name)

        def wrapped(arg, _real=real, _admit=name == "append_admits"):
            seq = _real(arg)
            for item in arg:
                seq_of[(_admit, item[0])] = seq
            return seq
        setattr(j, name, wrapped)
    real_one = j.append_terminal

    def one(pid, body, exp):
        seq = real_one(pid, body, exp)
        seq_of[(False, pid)] = seq
        return seq
    j.append_terminal = one
    audit: list = []
    published: dict = {}
    crash_copy = tmp_path / "at_publish"

    def covered(key):
        seq = seq_of.get(key)
        assert not j.dirty, "an effect left with records buffered"
        if seq is not None and fsync == "window":
            assert seq <= j.synced_seq, (key, seq, j.synced_seq)
        audit.append(key)

    real_pub, real_batch = app.broker.publish, app.broker.publish_batch
    real_ack = app.broker.ack

    def note(body):
        d = json.loads(body)
        if d["status"] in ("matched", "timeout"):
            covered((False, d["player_id"]))
            published[d["player_id"]] = bytes(body)
            if d["status"] == "matched" and not crash_copy.exists():
                shutil.copytree(jdir, crash_copy)

    def publish(queue, body, props=None):
        if queue == "wa.replies":
            note(body)
        real_pub(queue, body, props)

    def publish_batch(items):
        for queue, body, _ in items:
            if queue == "wa.replies":
                note(body)
        real_batch(items)

    def ack(tag, delivery_tag):
        covered((True, tags.get(delivery_tag)))
        real_ack(tag, delivery_tag)

    tags: dict = {}
    real_consume = rt._on_delivery_batch

    async def consume(deliveries):
        for d in deliveries:
            tags[d.delivery_tag] = d.properties.correlation_id
        await real_consume(deliveries)

    app.broker.publish, app.broker.publish_batch = publish, publish_batch
    app.broker.ack = ack
    rt._on_delivery_batch = consume
    players = PLAYERS + (("p4", 1200.0), ("p5", 1210.0))
    try:
        _publish("port", app, players, "wa.replies")
        await _quiesce(app, lambda: len(published) == 7)  # s0 times out
    finally:
        await app.stop()
    assert sum(1 for k in audit if k[0]) == len(players)
    assert json.loads(published["s0"])["status"] == "timeout"
    # The crash between the first matched commit and its publish.
    app2 = _app("port", _cfg("port", crash_copy))
    await app2.start()
    try:
        rec = app2.runtime(Q).last_recovery
        removed = set(rec["transcript"]["removed"])
        assert removed and removed <= set(published)
        assert not removed & {r.id for r in app2.engine.waiting()}
        replies: list = []
        _collect(app2, "again", replies)
        _publish("port", app2, [p for p in players if p[0] in removed],
                 "again")
        await _quiesce(app2, lambda: len(replies) == len(removed))
        assert {c: b for c, b in replies} == {
            p: published[p] for p in removed}
    finally:
        await app2.stop()


# ---- the drain ----------------------------------------------------------------------


def _drain_cfg(pkg, directory):
    q = dict(name="rr.q", rating_threshold=1.0, send_queued_ack=False)
    eng = dict(pool_capacity=64, pool_block=16, batch_buckets=(8,), top_k=4)
    ov = dict(max_inflight=32, max_waiting=32, tiers=3, adaptive=True,
              target_p99_ms=100.0, drain_checkpoint_dir=str(directory))
    if pkg == "jax":
        return JaxConfig(queues=(JaxQueueConfig(**q),),
                         engine=JaxEngineConfig(backend="tpu", **eng),
                         batcher=JaxBatcherConfig(max_batch=8,
                                                  max_wait_ms=5.0),
                         overload=JaxOverloadConfig(**ov),
                         observability=JaxObservabilityConfig(trace=False))
    return Config(queues=(QueueConfig(**q),), engine=EngineConfig(**eng),
                  batcher=BatcherConfig(max_batch=8, max_wait_ms=5.0),
                  overload=OverloadConfig(**ov),
                  observability=ObservabilityConfig(trace=False))


def _pool_rows(ckmod, engine):
    cols, regions, modes = ckmod.engine_waiting_columns(engine)
    return sorted(zip(cols.ids.tolist(), cols.rating.tolist(),
                      cols.rd.tolist(), regions.tolist(), modes.tolist(),
                      np.nan_to_num(cols.threshold, nan=-1.0).tolist(),
                      cols.enqueued_at.tolist(), cols.tier.tolist(),
                      cols.deadline.tolist()))


def test_drain_restore_round_trips_pool_admission_and_backlog(tmp_path):
    """Four tiered players (one with a deadline) wait; the limiter is
    tightened; two more requests reach the broker after the consumer is
    cancelled (the backlog). The drain saves all three; a successor
    restores the pool (columns equal to the JAX app's round trip), the
    credit fraction, the tier and deadline counts, and answers the
    re-published backlog. No credit is left held."""
    deadline = 4102444800.0  # 2100-01-01: never expires

    async def run(pkg):
        directory = tmp_path / pkg
        props = JaxProperties if pkg == "jax" else Properties
        app = _app(pkg, _drain_cfg(pkg, directory))
        await app.start()
        rt = app.runtime("rr.q")

        def publish(i, tier):
            headers = {"x-tier": str(tier), "x-first-received": "5.0"}
            if i == 0:
                headers["x-deadline"] = repr(deadline)
            app.broker.publish(
                "rr.q", f'{{"id":"rr{i}","rating":{1000 + 400 * i}}}'
                .encode(), props(reply_to="rr.replies", correlation_id=f"c{i}",
                                 headers=headers))

        app.broker.declare_queue("rr.replies")
        for i, tier in enumerate((0, 1, 2, 2)):
            publish(i, tier)
        for _ in range(1500):
            await asyncio.sleep(0.02)
            if rt.engine.pool_size() == 4:
                break
        assert rt.engine.pool_size() == 4
        rt.admission.observe_window(1.0, 1.0, 10.0)
        frac = rt.admission._fraction
        assert frac < 1.0
        real_cancel = app.broker.basic_cancel

        def cancel(tag):
            real_cancel(tag)
            if tag == getattr(rt, "consumer_tag", getattr(rt, "_tag", None)):
                for i in (4, 5):
                    publish(i, 1)
        app.broker.basic_cancel = cancel
        counts = await app.drain(str(directory))
        assert counts == {"rr.q": 4}
        assert rt.admission.inflight() == 0
        with open(directory / "_backlog.json") as f:
            assert json.load(f)["count"] == 2
        succ = _app(pkg, _drain_cfg(pkg, directory))
        await succ.start()
        try:
            rt2 = succ.runtime("rr.q")
            assert await succ.restore_checkpoint(str(directory)) == {
                "rr.q": 4}
            assert rt2.admission._fraction == frac
            assert rt2.engine.pool_tier_counts(3) == [1, 1, 2]
            assert rt2.engine.deadline_count() == 1
            rows = _pool_rows(jax_ck if pkg == "jax" else ck, rt2.engine)
            for _ in range(1500):
                await asyncio.sleep(0.02)
                if rt2.engine.pool_size() == 6:
                    break
            assert rt2.engine.pool_size() == 6  # the backlog entered
        finally:
            await succ.stop()
        assert rt2.admission.inflight() == 0
        return rows

    port = asyncio.run(run("port"))
    jax = asyncio.run(run("jax"))
    assert port == jax and len(port) == 4


async def test_drain_restore_with_speculation_loses_no_players(tmp_path):
    from matchmaking_tpu_torch.service.client import MatchmakingClient

    def mk():
        return MatchmakingApp(Config(
            queues=(QueueConfig(rating_threshold=1.0),),
            engine=EngineConfig(pool_capacity=64, pool_block=64,
                                batch_buckets=(16,), spec_formation=True,
                                spec_interval_ms=5.0, spec_max_steps=1),
            batcher=BatcherConfig(max_batch=16, max_wait_ms=1.0)),
            device="cpu")

    app = mk()
    await app.start()
    client = MatchmakingClient(app.broker, Q)
    handles = [client.submit({"id": f"w{i}", "rating": 1000.0 + 300 * i})
               for i in range(4)]
    for h in handles:
        r = await client.next_response(h, timeout=15.0)
        assert r.status == "queued"
    await asyncio.sleep(0.05)  # the speculation loop takes a speculation
    counts = await app.drain(checkpoint_dir=str(tmp_path))
    assert counts == {Q: 4}
    assert os.path.exists(tmp_path / "_backlog.json")
    succ = mk()
    await succ.start()
    try:
        assert await succ.restore_checkpoint(str(tmp_path)) == {Q: 4}
        assert succ.engine.pool_size() == 4
    finally:
        await succ.stop()


async def test_drain_sheds_what_arrives_while_it_closes(tmp_path):
    """Admission stops first: a request consumed during the drain is
    answered ``shed`` (not half-processed into the saved pool)."""
    app = MatchmakingApp(_drain_cfg("port", tmp_path), device="cpu")
    await app.start()
    rt = app.runtime("rr.q")
    app.broker.declare_queue("late")
    real_stop = rt.stop

    async def stop():
        app.broker.publish("rr.q", b'{"id":"late","rating":1500}',
                           Properties(reply_to="late", correlation_id="late"))
        await asyncio.sleep(0.05)
        await real_stop()
    rt.stop = stop
    assert await app.drain() == {"rr.q": 0}
    d = await app.broker.get("late", timeout=1.0)
    assert d is not None
    assert contract.decode_response(d.body).status == "shed"
    assert rt.admission.inflight() == 0


async def test_serve_drains_at_stop_and_restores_at_start(tmp_path,
                                                          monkeypatch):
    """``serve`` with ``MM_OVERLOAD_DRAIN_CHECKPOINT_DIR``: the stop is a
    drain into the directory, and the next ``serve`` restores the pool
    from it; an ``amqp://`` broker is refused."""
    from matchmaking_tpu_torch.service import app as appmod

    for k in list(os.environ):
        if k.startswith("MM_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("MM_ENGINE_POOL_CAPACITY", "256")
    monkeypatch.setenv("MM_ENGINE_POOL_BLOCK", "64")
    monkeypatch.setenv("MM_ENGINE_BATCH_BUCKETS", "[8, 32]")
    monkeypatch.setenv("MM_OVERLOAD_DRAIN_CHECKPOINT_DIR", str(tmp_path))
    apps = []
    real_init = appmod.MatchmakingApp.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        apps.append(self)
    monkeypatch.setattr(appmod.MatchmakingApp, "__init__", init)

    async def one(players):
        stop = asyncio.Event()
        task = asyncio.ensure_future(appmod.serve(stop, device="cpu"))
        while not apps or apps[-1].runtime(Q)._tag is None:
            await asyncio.sleep(0.01)
        app = apps[-1]
        size = app.engine.pool_size()
        _publish("port", app, players, "")
        await _quiesce(app, lambda: app.engine.pool_size() == size
                       + len(players))
        stop.set()
        await task
        return size

    assert await one([("a", 1000.0), ("b", 2000.0)]) == 0
    assert os.path.exists(tmp_path / f"{Q}.npz")
    assert await one([("c", 3000.0)]) == 2  # restored at the start
    monkeypatch.setenv("MM_BROKER_URL", "amqp://guest@localhost/")
    with pytest.raises(ValueError, match="amqp_transport"):
        await appmod.serve(asyncio.Event(), device="cpu")


async def test_a_demoted_queue_journals_and_recovers_through_the_oracle(
        tmp_path):
    """Two chaos-failed windows trip the breaker: the host oracle serves
    the queue, journals its synchronous windows (``_journal_admit_reqs``)
    and snapshots through ``waiting()``; after a crash a successor (the
    card's engine again) recovers the oracle's waiting set, and a matched
    player's redelivery replays its answer."""
    jdir = tmp_path / "j"
    cfg = dataclasses.replace(
        _cfg("port", jdir),
        engine=dataclasses.replace(_cfg("port", jdir).engine,
                                   breaker_threshold=2,
                                   health_interval_s=60.0),
        chaos=ChaosConfig(fail_step_ranges=((0, 2),)))
    app = _app("port", cfg)
    await app.start()
    rt = app.runtime(Q)
    replies: list = []
    _collect(app, "demoted", replies)
    _publish("port", app, PLAYERS, "demoted")
    await _quiesce(app, lambda: len(_statuses(replies, "matched")) == 4)
    assert type(rt.engine).__name__ == "CpuEngine"
    assert rt.counters["breaker_trips"] == 1
    await rt.compact_journal()  # the oracle's pool, through waiting()
    _publish("port", app, [("s1", 5000.0), ("q0", 3000.0), ("q1", 3001.0)],
             "demoted")
    await _quiesce(app, lambda: {"q0", "q1"} <= _statuses(replies,
                                                          "matched"))
    waiting = {r.id for r in rt.engine.waiting()}
    assert waiting == {"s0", "s1"}
    first = {c: b for c, b in replies if json.loads(b)["status"] == "matched"}
    await app.crash()
    app2 = _app("port", _cfg("port", jdir))
    await app2.start()
    try:
        assert type(app2.engine).__name__ == "GpuEngine"
        assert {r.id for r in app2.engine.waiting()} == waiting
        again: list = []
        _collect(app2, "again", again)
        _publish("port", app2, [("q1", 3001.0)], "again")
        await _quiesce(app2, lambda: len(again) == 1)
        assert again[0][1] == first["q1"]
    finally:
        await app2.stop()
