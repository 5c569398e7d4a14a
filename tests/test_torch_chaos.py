"""Broker chaos in the port (utils/chaos.py, service/broker.py) against
the JAX package's, on the CPU.

- ``hash01`` equals the JAX package's bit for bit on thousands of keys,
  and so do ``should_drop``, ``dup_copies`` and ``partition_action`` on a
  grid of (seed, queue, seq, attempt).
- ``tests/test_chaos.py``'s scripted broker-fault soak (a dropped first
  attempt, a storm of two copies, a partition from seq 6 to seq 9) runs on
  config #1's queue (its pool cut to a CPU size) through the JAX app and
  through the port's columnar path: the broker's stats, the depth while
  paused, the terminal replays and every player's answers are equal, the
  fault events equal, and two runs of the port equal each other.
- A seeded ``drop_prob``/``dup_prob`` soak of a few hundred requests with
  ``debug_invariants`` on: both apps answer every player, nobody is in two
  matches, no invariant is violated, and the fault stats and the fault
  events are equal.
- ``BrokerConfig``'s probabilistic faults (``random.Random(seed)``) draw
  the JAX broker's stream.
"""

import asyncio
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import BatcherConfig as JaxBatcherConfig
from matchmaking_tpu.config import BrokerConfig as JaxBrokerConfig
from matchmaking_tpu.config import ChaosConfig as JaxChaosConfig
from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import ObservabilityConfig as JaxObservabilityConfig
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import InProcBroker as JaxBroker
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.utils import chaos as jax_chaos
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    BrokerConfig,
    ChaosConfig,
    Config,
    ObservabilityConfig,
)
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import InProcBroker, Properties
from matchmaking_tpu_torch.utils import chaos

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG1 = os.path.join(ROOT, "configs", "elo_1v1.json")
Q, REPLY = "matchmaking.search", "chaos.replies"
#: Config #1's pool cut to a CPU size.
SMALL = dict(pool_capacity=1024, pool_block=256, batch_buckets=(16, 64),
             warm_start=True)
FAULT_EVENTS = ("chaos_drop", "chaos_dup", "partition_pause",
                "partition_resume", "dead_letter")


def _keys(rng, n):
    out = []
    for i in range(n):
        k = []
        for _ in range(int(rng.integers(0, 5))):
            if rng.random() < 0.4:
                k.append("".join(chr(int(c)) for c in
                                 rng.integers(32, 0x2FF, int(rng.integers(0, 9)))))
            else:
                k.append(int(rng.integers(-(1 << 62), 1 << 62))
                         if rng.random() < 0.5 else i)
        out.append((int(rng.integers(-(1 << 40), 1 << 63)), tuple(k)))
    return out


def test_hash01_equals_jax_bit_for_bit():
    rng = np.random.default_rng(13)
    keys = _keys(rng, 4000) + [(0, ()), (7, ("drop", Q, 0, 0)),
                               (-1, ("", -5)), ((1 << 64) + 3, (1 << 70,))]
    for seed, k in keys:
        got, want = chaos.hash01(seed, *k), jax_chaos.hash01(seed, *k)
        assert got == want and 0.0 <= got < 1.0, (seed, k)
    for h in rng.integers(0, 1 << 63, 500).tolist():
        assert chaos._mix(h) == jax_chaos._mix(h)


@pytest.mark.parametrize("seed", [0, 5, 77])
def test_fault_decisions_equal_jax(seed):
    script = dict(seed=seed, queues=(Q, "other"), drop_prob=0.2,
                  dup_prob=0.15, drop_seqs=(0, 3, 17), dup_seqs=((1, 2), (40, 1)),
                  partitions=((6, 9), (30, 31)))
    mine = chaos.ChaosState(ChaosConfig(**script))
    theirs = jax_chaos.ChaosState(JaxChaosConfig(**script))
    assert mine.consume_faults() == theirs.consume_faults() is True
    assert mine.publish_faults() == theirs.publish_faults() is True
    for queue in (Q, "other", "reply.q"):
        assert mine.applies(queue) == theirs.applies(queue)
        for seq in range(-2, 64):
            for attempt in range(4):
                assert (mine.should_drop(queue, seq, attempt)
                        == theirs.should_drop(queue, seq, attempt)), (
                    queue, seq, attempt)
            assert mine.dup_copies(queue, seq) == theirs.dup_copies(queue, seq)
            assert (mine.partition_action(queue, seq)
                    == theirs.partition_action(queue, seq))


def test_probabilistic_broker_faults_draw_the_jax_stream():
    """``BrokerConfig.drop_prob``/``dup_prob`` on one ``random.Random``:
    the same publishes give the same duplicates, and the flags say which
    side of the broker is armed."""
    async def run(broker_cls, cfg_cls, props):
        broker = broker_cls(cfg_cls(dup_prob=0.3, drop_prob=0.0), 11)
        broker.declare_queue("q")
        for i in range(200):
            broker.publish("q", b"x%d" % i, props(reply_to="r"))
        return (broker.stats["duplicated"], broker.queue_depth("q"),
                broker.consume_faults_enabled, broker.publish_faults_enabled)

    mine = asyncio.run(run(InProcBroker, BrokerConfig, Properties))
    theirs = asyncio.run(run(JaxBroker, JaxBrokerConfig, JaxProperties))
    assert mine == theirs and mine[0] > 0 and mine[2:] == (False, True)


def _port_cfg(chaos_cfg, batcher, invariants=True, **engine):
    cfg = Config.from_json(CONFIG1, backend="gpu")
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, **SMALL, **engine),
        batcher=BatcherConfig(**batcher), chaos=ChaosConfig(**chaos_cfg),
        observability=ObservabilityConfig(trace=False),
        debug_invariants=invariants)


def _jax_cfg(chaos_cfg, batcher, invariants=True, **engine):
    cfg = JaxConfig.from_json(CONFIG1)
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, **SMALL, **engine),
        batcher=JaxBatcherConfig(**batcher), chaos=JaxChaosConfig(**chaos_cfg),
        observability=JaxObservabilityConfig(trace=False),
        debug_invariants=invariants)


def _app(pkg, chaos_cfg, batcher, **engine):
    if pkg == "jax":
        return JaxApp(_jax_cfg(chaos_cfg, batcher, **engine)), JaxProperties
    return (MatchmakingApp(_port_cfg(chaos_cfg, batcher, **engine),
                           device="cpu"), Properties)


def _counter(app, name):
    return app.metrics.counters.get(name) or 0


def _collect(app, sink):
    async def on_reply(delivery):
        sink.setdefault(delivery.properties.correlation_id, []).append(
            bytes(delivery.body))

    app.broker.declare_queue(REPLY)
    app.broker.basic_consume(REPLY, on_reply, prefetch=1_000_000)


def _normalized(body):
    d = json.loads(body)
    for key in ("latency_ms", "waited_ms", "trace_id"):
        d.pop(key, None)
    if d.get("match"):
        d["match"].pop("match_id", None)
    return d


def _fault_events(app):
    return [(e["kind"], e["queue"], e.get("detail", ""))
            for e in app.events.snapshot() if e["kind"] in FAULT_EVENTS]


SCRIPTED = dict(seed=5, queues=(Q,), drop_seqs=(0,), dup_seqs=((1, 2),),
                partitions=((6, 9),), partition_max_s=5.0)


async def _scripted(pkg):
    """The JAX package's scripted soak: 5 publishes (the 5th carries seq 6:
    the pause), then 3 more (the 8th carries seq 9: the resume). Windows
    are cut by count alone (5 deliveries; the timer never fires), so
    their contents are fixed in both apps whatever the load: [b1 and its
    two storm copies, b2, b3], then [b4-b7 and b0's redelivery]; and each
    window is collected before the next is dispatched (pipeline depth
    1), so the pool a window sees is fixed too. A 1 ms timer cut the
    second window at [b7] or [b7, b0], depending on how soon the
    requeued b0 came back, and at depth 2 a slow first window (the JAX
    app's first step under load) was still in flight when the second was
    dispatched, which paired them otherwise."""
    app, props = _app(pkg, SCRIPTED, dict(max_batch=5, max_wait_ms=60_000.0),
                      pipeline_depth=1)
    answers: dict = {}
    _collect(app, answers)
    await app.start()
    try:
        for i in range(5):
            app.broker.publish(Q, f'{{"id":"b{i}","rating":1500}}'.encode(),
                               props(reply_to=REPLY, correlation_id=f"c{i}"))
        await asyncio.sleep(0.3)
        assert not app.broker._queues[Q].gate.is_set()  # paused
        paused_depth = app.broker.queue_depth(Q)
        for i in range(5, 8):
            app.broker.publish(Q, f'{{"id":"b{i}","rating":1500}}'.encode(),
                               props(reply_to=REPLY, correlation_id=f"c{i}"))
        for _ in range(200):
            await asyncio.sleep(0.05)
            if len(answers) == 8:
                break
        await asyncio.sleep(0.1)
        assert app.broker._queues[Q].gate.is_set()  # resumed
        s = app.broker.stats
        assert (s["dropped"], s["duplicated"], s["partitions"],
                s["dead_lettered"]) == (1, 2, 1, 0)
        return {"paused_depth": paused_depth,
                "stats": {k: s[k] for k in ("dropped", "duplicated",
                                            "partitions", "dead_lettered",
                                            "published", "acked")},
                "deduped": _counter(app, "deduped_replays"),
                "matched": _counter(app, "players_matched"),
                "answers": {c: [_normalized(b) for b in bs]
                            for c, bs in answers.items()},
                "events": _fault_events(app)}
    finally:
        await app.stop()


def test_scripted_broker_faults_equal_jax_app_and_replay():
    from test_torch_sanitizer import port_sanitized

    # The port's runs under the port's sanitizer, every check on, as the
    # JAX twin (tests/test_chaos.py) runs under JAX's.
    with port_sanitized():
        first = asyncio.run(_scripted("port"))
    with port_sanitized():
        second = asyncio.run(_scripted("port"))
    theirs = asyncio.run(_scripted("jax"))
    assert first == second
    assert first == theirs
    assert [k for k, _, _ in first["events"]] == [
        "chaos_dup", "partition_pause", "partition_resume", "chaos_drop"]
    # Every player answered once; the storm's copies of b1 share its
    # window, where the columnar step pairs b1 and b2 only, as the JAX
    # engine does (its host-oracle backend pairs all eight).
    assert {c: len(a) for c, a in first["answers"].items()} == {
        f"c{i}": 1 for i in range(8)}
    assert first["matched"] == 4 and first["paused_depth"] == 7


def _soak_bodies(seed, n):
    rng = np.random.default_rng(seed)
    return [f'{{"id":"p{i}","rating":{float(rng.normal(1500.0, 60.0)):.2f}}}'
            .encode() for i in range(n)]


async def _seeded_soak(pkg, n=320, burst=32):
    """Seeded drops and duplicates under ``debug_invariants``: bursts of
    ``burst`` requests, each published once the last is answered."""
    script = dict(seed=3, queues=(Q,), drop_prob=0.05, dup_prob=0.05)
    app, props = _app(pkg, script, dict(max_batch=burst, max_wait_ms=20.0))
    answers: dict = {}
    _collect(app, answers)
    await app.start()
    try:
        bodies = _soak_bodies(4, n)
        for b in range(0, n, burst):
            corrs = [f"p{i}" for i in range(b, b + burst)]
            for corr, body in zip(corrs, bodies[b:b + burst]):
                app.broker.publish(Q, body, props(reply_to=REPLY,
                                                  correlation_id=corr))
            end = time.monotonic() + 60.0
            while not all(c in answers for c in corrs):
                assert time.monotonic() < end, f"burst at {b} unanswered"
                await asyncio.sleep(0.01)
        await asyncio.sleep(0.3)
        rt = app.runtime(Q)
        faults = (app.faults() if pkg == "port" else
                  {k: v for k, v in rt.faults().items() if v}
                  if hasattr(rt, "faults") else {})
        return {"stats": dict(app.broker.stats),
                "deduped": _counter(app, "deduped_replays"),
                "matched": _counter(app, "players_matched"),
                "answers": {c: [_normalized(b) for b in bs]
                            for c, bs in answers.items()},
                "events": _fault_events(app), "faults": faults}
    finally:
        await app.stop()


def _kinds(events):
    return sorted(k for k, _, _ in events)


def test_seeded_soak_with_invariants_equals_jax_app():
    """Window composition here follows the clock (a requeued delivery may
    or may not catch its burst's window), so the pairs and the replays
    are not compared across apps; every fault decision is a function of
    the publish seq and attempt, so the stats and the fault events are."""
    runs = {pkg: asyncio.run(_seeded_soak(pkg)) for pkg in ("port", "jax")}
    for pkg, run in runs.items():
        assert run["faults"] == {}, pkg
        assert run["stats"]["dead_lettered"] == 0
        assert len(run["answers"]) == 320, pkg
        for corr, bodies in run["answers"].items():
            # Every player answered, and nobody in two matches (a copy
            # replays the same answer; a waiting copy is not answered).
            distinct = {json.dumps(b, sort_keys=True) for b in bodies}
            statuses = [json.loads(b)["status"] for b in distinct]
            assert statuses and set(statuses) <= {"queued", "matched"}, corr
            assert statuses.count("matched") <= 1 and statuses.count(
                "queued") <= 1, (pkg, corr)
    mine, theirs = runs["port"], runs["jax"]
    assert mine["stats"]["dropped"] > 0 and mine["stats"]["duplicated"] > 0
    for key in ("dropped", "duplicated", "partitions", "dead_lettered",
                "delayed"):
        assert mine["stats"][key] == theirs["stats"][key], key
    assert _kinds(mine["events"]) == _kinds(theirs["events"])
