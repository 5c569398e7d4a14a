"""Burst consume and burst decode in the port's service, against the JAX
package's (``tests/test_ingress_batch.py``'s cases that need no AMQP bridge
and no fault injection).

- Config #1 (``configs/elo_1v1.json``, its pool cut to a CPU size) served
  by the JAX app and by the port's app on the same seeded bursts, with
  ``consume_batch`` on: every answer's bytes are equal once the fields
  that differ by nature are carried over (match id, measured latency_ms
  and waited_ms) and the trace ids correspond one to one (both apps trace;
  each numbers its ids from a process-wide counter).
- Within the port: ``consume_batch`` on and off, and ``ingress_shards`` 1
  and 4, give the same answers; with it on, each burst is decoded once at
  consume and never again at the flush.
- The broker's burst seam: one callback gets the whole burst; a crashing
  callback nacks only what it had not settled; a cancel requeues a burst
  exactly once, whether its handler had started or not.
- Malformed and NEEDS_PYTHON rows inside a burst (escapes, unicode, a
  party on a 1v1 queue, a bad type) are answered as the JAX app answers
  them.
- The shard hash, ``ShardedRecent``, and ``decode_batch_concat`` against
  the JAX codec's on seeded bodies, inverted and out-of-range offsets
  included.

Each soak publishes a burst of ``BURST`` requests at once and waits until
every one is answered: the batcher cuts a window per burst (``max_batch``
is the burst, ``max_wait_ms`` far above the gap), so window composition is
the same on every side and every run.
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
from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.native import codec as jax_codec
from matchmaking_tpu.service import contract as jax_contract
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.service.ingress import shard_of as jax_shard_of
from matchmaking_tpu_torch.config import BatcherConfig, BrokerConfig, Config
from matchmaking_tpu_torch.native import codec
from matchmaking_tpu_torch.service import app as app_module
from matchmaking_tpu_torch.service import contract
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import InProcBroker, Properties
from matchmaking_tpu_torch.service.ingress import ShardedRecent, shard_of

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG1 = os.path.join(ROOT, "configs", "elo_1v1.json")
QUEUE, REPLY = "matchmaking.search", "rq.ingress"
#: Config #1's pool cut to a CPU size (the queue is the file's).
SMALL = dict(pool_capacity=1024, pool_block=256, batch_buckets=(16, 64))
#: Requests a burst (= the batcher's max_batch: one window a burst).
BURST = 64
BURSTS = 4


def port_cfg(consume_batch=True, shards=1):
    cfg = Config.from_json(CONFIG1, backend="gpu")
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, **SMALL),
        batcher=BatcherConfig(max_batch=BURST, max_wait_ms=250.0),
        broker=BrokerConfig(consume_batch=consume_batch,
                            ingress_shards=shards))


def jax_cfg():
    cfg = JaxConfig.from_json(CONFIG1)
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, **SMALL),
        batcher=JaxBatcherConfig(max_batch=BURST, max_wait_ms=250.0),
        broker=JaxBrokerConfig(consume_batch=True))


def soak_bodies(seed=11, n=BURST * BURSTS):
    """Seeded requests: plain rows, NEEDS_PYTHON rows (an escaped quote in
    the id, a unicode id, a party, which a 1v1 queue does not serve), a
    bad type and malformed JSON."""
    rng = np.random.default_rng(seed)
    bodies = []
    for i in range(n):
        r = float(rng.normal(1500.0, 150.0))
        if i % 23 == 7:
            bodies.append(json.dumps({"id": f'e"sc{i}', "rating": r}).encode())
        elif i % 23 == 15:
            bodies.append(f'{{"id":"uni-é{i}","rating":{r:.2f}}}'.encode())
        elif i % 29 == 3:
            bodies.append(json.dumps({"id": f"lead{i}", "rating": r, "party": [
                {"id": f"mate{i}", "rating": r + 5}]}).encode())
        elif i % 31 == 19:
            bodies.append(b'{"id":"broken" "rating":1}')
        elif i % 37 == 11:
            bodies.append(json.dumps({"id": f"t{i}", "rating": "high"}).encode())
        else:
            bodies.append(f'{{"id":"p{i}","rating":{r:.2f}}}'.encode())
    return bodies


async def serve_bursts(app, props, bodies, burst=BURST):
    """Publish ``bodies`` burst by burst, each once the last is answered;
    returns every answer's body by correlation id, in order."""
    app.broker.declare_queue(REPLY)
    await app.start()
    answers: dict[str, list[bytes]] = {}
    try:
        for b in range(0, len(bodies), burst):
            corrs = [f"c{i}" for i in range(b, min(b + burst, len(bodies)))]
            for corr, body in zip(corrs, bodies[b:b + burst]):
                app.broker.publish(QUEUE, body, props(reply_to=REPLY,
                                                      correlation_id=corr))
            end = time.monotonic() + 60.0
            while time.monotonic() < end:
                d = await app.broker.get(REPLY, timeout=0.05)
                if d is not None:
                    answers.setdefault(d.properties.correlation_id,
                                       []).append(bytes(d.body))
                elif all(c in answers for c in corrs):
                    break
            else:
                raise AssertionError(f"burst at {b}: answers {answers}")
        while (d := await app.broker.get(REPLY, timeout=0.1)) is not None:
            answers.setdefault(d.properties.correlation_id, []).append(
                bytes(d.body))
    finally:
        await app.stop()
    return answers


def normalized(body: bytes) -> dict:
    """An answer minus what differs by nature: the match id, the measured
    latency_ms and waited_ms, the trace id."""
    d = json.loads(body)
    for key in ("latency_ms", "waited_ms", "trace_id"):
        d.pop(key, None)
    if d.get("match"):
        d["match"].pop("match_id", None)
    return d


def same_trace(seen, mine, theirs):
    """The port's trace id, after checking that it and the JAX app's are
    both set or both empty and correspond one to one over a run (each app
    numbers its ids from a process-wide counter of its own)."""
    assert bool(mine) == bool(theirs), (mine, theirs)
    assert seen.setdefault(("jax", theirs), mine) == mine
    assert seen.setdefault(("port", mine), theirs) == theirs
    return mine


def assert_same_answers(got, want):
    assert set(got) == set(want)
    for corr in want:
        assert [normalized(b) for b in got[corr]] == [
            normalized(b) for b in want[corr]], corr


def run_port(cfg, bodies=None):
    app = MatchmakingApp(cfg, device="cpu")
    answers = asyncio.run(serve_bursts(app, Properties, bodies or soak_bodies()))
    assert app.faults() == {}
    return app, answers


def test_config1_answers_equal_jax_app_with_consume_batch():
    """Config #1 through both apps, consume_batch on: every answer's bytes
    equal the JAX app's (match id, latency_ms and waited_ms carried over,
    the trace ids one to one); real matches, queued acks and every kind of
    reject are among them."""
    app, port = run_port(port_cfg())
    japp = JaxApp(jax_cfg())
    jax = asyncio.run(serve_bursts(japp, JaxProperties, soak_bodies()))
    assert {c: len(v) for c, v in port.items()} == {
        c: len(v) for c, v in jax.items()}
    statuses = set()
    seen: dict = {}
    for corr, bodies in port.items():
        for body, jbody in zip(bodies, jax[corr]):
            mine = contract.decode_response(body)
            theirs = jax_contract.decode_response(jbody)
            statuses.add((mine.status, mine.error_code))
            match = theirs.match
            if match is not None:
                match = dataclasses.replace(match,
                                            match_id=mine.match.match_id)
            theirs = dataclasses.replace(
                theirs, match=match, latency_ms=mine.latency_ms,
                waited_ms=mine.waited_ms,
                trace_id=same_trace(seen, mine.trace_id, theirs.trace_id))
            assert body == jax_contract.encode_response(theirs), corr
    assert {("matched", ""), ("queued", ""), ("error", "bad_json"),
            ("error", "bad_type"),
            ("error", "party_not_supported")} <= statuses, statuses
    assert app.counters["windows"] == BURSTS


class DecodeCount:
    """Counts the codec's decode calls made by the service (the burst
    decode at consume and the window decode at the flush)."""

    def __init__(self, monkeypatch):
        self.burst = self.window = 0
        real_burst, real_window = codec.decode_batch_concat, codec.decode_batch

        def burst(*a, **k):
            self.burst += 1
            return real_burst(*a, **k)

        def window(*a, **k):
            self.window += 1
            return real_window(*a, **k)

        monkeypatch.setattr(codec, "decode_batch_concat", burst)
        monkeypatch.setattr(app_module.codec, "decode_batch", window)


def test_consume_batch_on_equals_off_and_decodes_each_burst_once(monkeypatch):
    """consume_batch off (each delivery stamped on its own, the window
    decoded at the flush) answers exactly as on. On, each burst is decoded
    once, at consume, and no window is decoded again at the flush; off,
    nothing is decoded at consume."""
    count = DecodeCount(monkeypatch)
    _, on = run_port(port_cfg(consume_batch=True))
    assert (count.burst, count.window) == (BURSTS, 0)
    count.burst = count.window = 0
    app_off, off = run_port(port_cfg(consume_batch=False))
    assert count.burst == 0 and count.window == BURSTS
    assert app_off.runtime(QUEUE)._consume_batch is False
    assert_same_answers(on, off)


def test_ingress_shards_1_equals_4():
    """Four shards (the fallback rows decoded per shard on worker threads,
    the replay cache split four ways) answer exactly as one."""
    _, one = run_port(port_cfg(shards=1))
    app, four = run_port(port_cfg(shards=4))
    assert app.runtime(QUEUE)._recent.n == 4
    assert_same_answers(four, one)


def test_burst_rows_that_need_python_settle_as_the_jax_app_settles_them():
    """One burst of 20 (decoded at consume) with every kind of row the
    native decoder leaves to Python or refuses, then a redelivery of an
    answered id: each answered as the JAX app answers it."""
    bodies = [json.dumps({"id": f'q"{i}', "rating": 1500 + i}).encode()
              for i in range(4)]
    bodies += [f'{{"id":"é{i}","rating":{1700 + i}}}'.encode() for i in range(4)]
    bodies += [json.dumps({"id": "lead", "rating": 1500, "party": [
        {"id": "mate", "rating": 1510}]}).encode(),
        b'{"id":"x" "rating":1}', b'[1, 2]',
        json.dumps({"id": "t", "rating": "high"}).encode(),
        json.dumps({"rating": 1500}).encode(),
        json.dumps({"id": "neg", "rating": 1500,
                    "rating_threshold": -5}).encode()]
    bodies += [f'{{"id":"n{i}","rating":{1900 + 3 * i}}}'.encode()
               for i in range(6)]
    cfg = dataclasses.replace(port_cfg(), batcher=BatcherConfig(
        max_batch=len(bodies), max_wait_ms=250.0))
    app = MatchmakingApp(cfg, device="cpu")
    port = asyncio.run(serve_bursts(app, Properties, bodies, len(bodies)))
    jcfg = dataclasses.replace(jax_cfg(), batcher=JaxBatcherConfig(
        max_batch=len(bodies), max_wait_ms=250.0))
    jax = asyncio.run(serve_bursts(JaxApp(jcfg), JaxProperties, bodies,
                                   len(bodies)))
    assert_same_answers(port, jax)
    codes = {contract.decode_response(v[0]).error_code for v in port.values()}
    assert {"party_not_supported", "bad_json", "bad_type", "missing_field",
            "bad_threshold"} <= codes
    assert app.counters["rejected"] == 6


# ---- the broker's burst seam ------------------------------------------------


async def test_burst_callback_receives_whole_burst():
    broker = InProcBroker(BrokerConfig())
    broker.declare_queue("q")
    for i in range(5):
        broker.publish("q", f"m{i}".encode())
    bursts: list[list[bytes]] = []

    async def on_batch(batch):
        bursts.append([d.body for d in batch])
        for d in batch:
            broker.ack(tag, d.delivery_tag)

    async def never(_d):
        raise AssertionError("the per-delivery callback ran")

    tag = broker.basic_consume("q", never, batch_callback=on_batch)
    for _ in range(100):
        await asyncio.sleep(0.005)
        if sum(len(b) for b in bursts) == 5:
            break
    # The buffered backlog drains as ONE burst.
    assert bursts == [[b"m0", b"m1", b"m2", b"m3", b"m4"]]
    assert broker.stats["acked"] == 5
    broker.close()


async def test_burst_callback_crash_nacks_only_unsettled():
    """The first call acks two of its five deliveries and raises: the
    other three (only they) are requeued, and come back redelivered."""
    broker = InProcBroker(BrokerConfig())
    broker.declare_queue("q")
    for i in range(5):
        broker.publish("q", f"m{i}".encode())
    calls: list[list[tuple[bytes, int]]] = []

    async def on_batch(batch):
        calls.append([(d.body, d.redelivery_count) for d in batch])
        if len(calls) == 1:
            broker.ack(tag, batch[0].delivery_tag)
            broker.ack(tag, batch[3].delivery_tag)
            raise RuntimeError("boom")
        for d in batch:
            broker.ack(tag, d.delivery_tag)

    tag = broker.basic_consume("q", lambda d: None, batch_callback=on_batch)
    for _ in range(200):
        await asyncio.sleep(0.005)
        if broker.stats["acked"] == 5:
            break
    assert broker.stats["consumer_errors"] == 1
    assert broker.stats["acked"] == 5
    assert calls[0] == [(f"m{i}".encode(), 0) for i in range(5)]
    again = sorted(x for call in calls[1:] for x in call)
    assert again == [(b"m1", 1), (b"m2", 1), (b"m4", 1)]
    broker.close()


@pytest.mark.parametrize("started", [False, True])
async def test_cancel_requeues_a_burst_exactly_once(started):
    """A burst drained into a handler task: cancelled before the task ever
    ran (its batch state is swept), or while the callback holds it (the
    unacked sweep takes it; the state was already handed over). Either
    way each delivery goes back to the queue exactly once."""
    broker = InProcBroker(BrokerConfig())
    broker.declare_queue("q")
    for i in range(5):
        broker.publish("q", f"m{i}".encode())
    entered = asyncio.Event()

    async def on_batch(batch):
        entered.set()
        await asyncio.sleep(10.0)

    tag = broker.basic_consume("q", lambda d: None, batch_callback=on_batch)
    consumer = broker._consumers[tag]
    await asyncio.sleep(0)  # the drain loop runs; the handler is only queued
    assert len(consumer._batch_states) == 1
    if started:
        await asyncio.wait_for(entered.wait(), 1.0)
        assert not consumer._batch_states and len(consumer.unacked) == 5
    else:
        assert not entered.is_set() and not consumer.unacked
    broker.basic_cancel(tag)
    await asyncio.sleep(0.01)  # a cancelled handler's finally has run
    messages = broker._queues["q"].messages
    got = [messages.get_nowait() for _ in range(messages.qsize())]
    assert sorted((d.body, d.redelivery_count) for d in got) == [
        (f"m{i}".encode(), 1) for i in range(5)]
    assert not entered.is_set() or started


# ---- sharded state and the concatenated decode ------------------------------


def test_shard_hash_is_deterministic_balanced_and_equal_to_jax():
    assert shard_of("player-1", 1) == 0
    counts = [0] * 8
    for i in range(4096):
        pid = f"p{i}"
        s = shard_of(pid, 8)
        assert s == shard_of(pid, 8) == jax_shard_of(pid, 8)
        counts[s] += 1
    assert min(counts) > 4096 // 8 // 2


def test_sharded_recent_routes_and_prunes():
    r = ShardedRecent(4)
    for i in range(100):
        r.set(f"p{i}", (b"body", 10.0 if i % 2 else 1.0))
    assert len(r) == 100
    assert r.get("p3") == (b"body", 10.0)
    r.pop("p3")
    assert r.get("p3") is None
    r.prune(5.0)  # drops the expiry-1.0 half
    assert len(r) == 49
    one = ShardedRecent(1)
    one.set("x", (b"b", 2.0))
    assert len(one) == 1 and one.get("x") == (b"b", 2.0)


def test_decode_batch_concat_equals_jax():
    """Seeded bodies (plain, escapes, unicode, parties, malformed) packed
    back to back, then the same buffer with inverted, negative and
    out-of-range offsets: every column equal to the JAX codec's, and the
    concatenated decode equal to the list decode on the same bodies."""
    bodies = soak_bodies(seed=5, n=200)
    buf = b"".join(bodies)
    offsets = np.zeros(len(bodies) + 1, np.int64)
    np.cumsum([len(b) for b in bodies], out=offsets[1:])
    rng = np.random.default_rng(6)
    bad = offsets.copy()
    for i in rng.choice(len(bodies), 12, replace=False):
        bad[i + 1] = bad[i] - 3  # inverted
    bad[-1] = len(buf) + 40     # out of range
    bad[5] = -7                 # negative
    def assert_same(mine, theirs):
        # Numbers are specified for the rows decoded OK only.
        ok = mine[-1] == codec.OK
        assert mine[-1].tolist() == theirs[-1].tolist()
        for a, b in zip(mine[:-1], theirs[:-1]):
            if a.dtype == np.float32:
                np.testing.assert_array_equal(a[ok].view(np.int32),
                                              b[ok].view(np.int32))
            else:
                assert a.tolist() == b.tolist()

    for offs in (offsets, bad):
        assert_same(codec.decode_batch_concat(buf, offs),
                    jax_codec.decode_batch_concat(buf, offs))
    assert (codec.decode_batch_concat(buf, bad)[-1] != codec.OK).sum() >= 12
    assert_same(codec.decode_batch_concat(buf, offsets),
                codec.decode_batch(bodies))
