"""The AMQP transport (service/amqp_transport.py) and its in-memory pika
fake (testing/fake_pika.py) in the port against the JAX package's, on the
CPU.

- The JAX package's ``tests/test_amqp_transport.py`` scripts run on both
  packages' ``AmqpBroker``, each with its own package's fake: the round
  trip, rpc, a connection kill with the requeue and the stale ack, the
  server's downtime, the redeclare, ``serve`` end to end, the trace header
  and its sampling, the chaos drop/dup and partition, ``publish_batch``.
- The packages interoperate on one ``FakeServer``: a JAX client against
  the port's ``serve`` and a port client against the JAX ``serve``; the
  same seeded requests through both ``serve``s give equal answers once
  the trace id, match id and measured times are normalised; the headers
  (``x-trace-enqueue``, ``x-chaos-seq``) ride the wire the same way.
- The chaos script's ``stats`` and events are equal across packages, and
  the two fakes answer one scripted kill / down / requeue sequence alike.
- Without pika and without ``pika_module`` both packages raise; an app
  given an ``AmqpBroker`` and a chaos config hands it the ``ChaosState``.
"""

import asyncio
import os
import sys
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from matchmaking_tpu import config as jax_config
from matchmaking_tpu.service import amqp_transport as jax_amqp
from matchmaking_tpu.service import app as jax_app
from matchmaking_tpu.service import broker as jax_broker
from matchmaking_tpu.service import client as jax_client
from matchmaking_tpu.testing import fake_pika as jax_fake
from matchmaking_tpu.utils import chaos as jax_chaos
from matchmaking_tpu.utils import trace as jax_trace
from matchmaking_tpu_torch import config
from matchmaking_tpu_torch.service import amqp_transport as port_amqp
from matchmaking_tpu_torch.service import app as port_app
from matchmaking_tpu_torch.service import broker as port_broker
from matchmaking_tpu_torch.service import client as port_client
from matchmaking_tpu_torch.testing import fake_pika as port_fake
from matchmaking_tpu_torch.utils import chaos as port_chaos
from matchmaking_tpu_torch.utils import trace as port_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG1 = os.path.join(ROOT, "configs", "elo_1v1.json")
Q = "matchmaking.search"

PKGS = ("port", "jax")
#: Each package's transport, fake, broker properties, chaos, event log,
#: serve entry point (with the arguments that keep it on the CPU) and
#: client.
NS = {
    "port": SimpleNamespace(
        A=port_amqp, fake=port_fake, Properties=port_broker.Properties,
        Chaos=config.ChaosConfig, ChaosState=port_chaos.ChaosState,
        EventLog=port_trace.EventLog, Config=config.Config,
        App=port_app.MatchmakingApp, serve=port_app.serve,
        serve_kw={"device": "cpu"}, app_kw={"device": "cpu"},
        Client=port_client.MatchmakingClient),
    "jax": SimpleNamespace(
        A=jax_amqp, fake=jax_fake, Properties=jax_broker.Properties,
        Chaos=jax_config.ChaosConfig, ChaosState=jax_chaos.ChaosState,
        EventLog=jax_trace.EventLog, Config=jax_config.Config,
        App=jax_app.MatchmakingApp, serve=jax_app.serve, serve_kw={},
        app_kw={}, Client=jax_client.MatchmakingClient),
}
#: A small pool for ``serve`` on the CPU (config #1's geometry otherwise).
SMALL_ENV = {"MM_ENGINE_POOL_CAPACITY": "1024", "MM_ENGINE_POOL_BLOCK": "256",
             "MM_ENGINE_BATCH_BUCKETS": "[16, 64]"}


def make_broker(pkg, url=None, fake=None, **kw):
    ns = NS[pkg]
    fake = fake or ns.fake
    url = url or f"amqp://fake-{uuid.uuid4().hex[:8]}"
    kw.setdefault("reconnect_base_s", 0.01)
    kw.setdefault("reconnect_max_s", 0.05)
    broker = ns.A.AmqpBroker(url, pika_module=fake, **kw)
    return broker, fake.FakeServer.for_url(url)


async def until(pred, polls=400, every=0.01):
    for _ in range(polls):
        if pred():
            return True
        await asyncio.sleep(every)
    return pred()


def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("MM_"):
            monkeypatch.delenv(k)


# ---- the JAX package's scripts, on both packages ------------------------


@pytest.mark.parametrize("pkg", PKGS)
async def test_publish_consume_ack_roundtrip(pkg):
    ns = NS[pkg]
    broker, server = make_broker(pkg)
    got = []

    async def on_delivery(d):
        got.append(d)
        broker.ack(tag, d.delivery_tag)

    broker.declare_queue("q1")
    tag = broker.basic_consume("q1", on_delivery)
    broker.publish("q1", b"hello", ns.Properties(reply_to="rq",
                                                 correlation_id="c1"))
    assert await until(lambda: got)
    assert got[0].body == b"hello"
    assert got[0].properties.reply_to == "rq"
    assert got[0].properties.correlation_id == "c1"
    consumer = broker._consumers[tag]
    assert ns.fake.wait_until(lambda: not consumer.channel._unacked)
    assert broker.stats["acked"] == 1
    assert broker.queue_depth("q1") == 0
    broker.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_rpc_roundtrip(pkg):
    ns = NS[pkg]
    broker, server = make_broker(pkg)

    async def on_request(d):
        broker.publish(d.properties.reply_to, b"pong:" + d.body,
                       ns.Properties(correlation_id=d.properties.correlation_id))
        broker.ack(tag, d.delivery_tag)

    broker.declare_queue("rpc.q")
    tag = broker.basic_consume("rpc.q", on_request)
    assert await broker.rpc("rpc.q", b"ping", timeout=5.0) == b"pong:ping"
    broker.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_connection_kill_reconnects_and_requeues(pkg):
    """Kill every connection while m1 is unacked: the consumer reconnects,
    resubscribes and sees m1 again (redelivered), then m2; the pre-kill
    tag's ack is dropped as stale."""
    broker, server = make_broker(pkg)
    got = []
    hold = {"acks": True}

    async def on_delivery(d):
        got.append(d)
        if not hold["acks"]:
            broker.ack(tag, d.delivery_tag)

    broker.declare_queue("q2")
    tag = broker.basic_consume("q2", on_delivery)
    consumer = broker._consumers[tag]
    assert consumer.connected.wait(2.0)
    broker.publish("q2", b"m1")
    assert await until(lambda: got)
    assert [d.body for d in got] == [b"m1"]
    first_tag = got[0].delivery_tag
    consumer.connected.clear()
    server.kill_connections()
    assert NS[pkg].fake.wait_until(lambda: consumer.connected.is_set(),
                                   timeout=5.0)
    assert broker.stats["consumer_reconnects"] >= 1
    hold["acks"] = False
    broker.publish("q2", b"m2")
    assert await until(lambda: len(got) >= 3)
    bodies = [d.body for d in got]
    assert bodies.count(b"m1") == 2, bodies
    assert b"m2" in bodies
    assert [d for d in got[1:] if d.body == b"m1"][0].redelivered
    assert broker.stats["reconnects"] >= 1
    stale = broker.stats["stale_acks"]
    broker.ack(tag, first_tag)
    assert broker.stats["stale_acks"] == stale + 1
    assert consumer.connected.is_set()
    assert NS[pkg].fake.wait_until(lambda: broker.queue_depth("q2") == 0)
    broker.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_reconnect_waits_out_server_downtime(pkg):
    broker, server = make_broker(pkg)
    broker.declare_queue("q3")
    server.set_down(True)

    async def bring_back():
        await asyncio.sleep(0.05)
        server.set_down(False)

    task = asyncio.create_task(bring_back())
    await asyncio.get_running_loop().run_in_executor(
        None, lambda: broker.publish("q3", b"late"))
    await task
    assert broker.queue_depth("q3") == 1
    assert broker.stats["reconnects"] >= 1
    broker.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_queue_redeclared_after_reconnect(pkg):
    broker, server = make_broker(pkg)
    broker.declare_queue("q4")
    server.kill_connections()
    with server.lock:
        server.queues.pop("q4", None)
    assert broker.queue_depth("q4") == 0
    broker.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_serve_entrypoint_end_to_end(pkg, monkeypatch):
    """MM_* → Config.from_env → AmqpBroker dialling MM_BROKER_URL → the
    service → two players matched over the fake AMQP from a client on its
    own connection."""
    ns = NS[pkg]
    clean_env(monkeypatch)
    url = f"amqp://serve-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("MM_BROKER_URL", url)
    monkeypatch.setenv("MM_ENGINE_BACKEND", "cpu")
    monkeypatch.setenv("MM_BATCHER_MAX_WAIT_MS", "1")
    stop = asyncio.Event()
    task = asyncio.create_task(ns.serve(stop, pika_module=ns.fake,
                                        **ns.serve_kw))
    try:
        server = ns.fake.FakeServer.for_url(url)
        assert await until(lambda: Q in server.queues or task.done(), 500)
        assert Q in server.queues
        client = ns.A.AmqpBroker(url, pika_module=ns.fake,
                                 reconnect_base_s=0.01)
        mm = ns.Client(client, Q)
        r1, r2 = await asyncio.gather(
            mm.search_until_matched({"id": "alice", "rating": 1500},
                                    timeout=10.0),
            mm.search_until_matched({"id": "bob", "rating": 1503},
                                    timeout=10.0))
        assert r1.status == "matched" and r2.status == "matched"
        assert r1.match.match_id == r2.match.match_id
        client.close()
    finally:
        stop.set()
        await task


@pytest.mark.parametrize("pkg", PKGS)
async def test_publish_stamps_trace_header_and_consumer_rebuilds_context(pkg):
    ns = NS[pkg]
    broker, server = make_broker(pkg)
    got = []

    async def on_delivery(d):
        got.append(d)
        broker.ack(tag, d.delivery_tag)

    broker.declare_queue("tq")
    tag = broker.basic_consume("tq", on_delivery)
    t0 = time.time()
    broker.publish("tq", b"x", ns.Properties(reply_to="rq",
                                             correlation_id="c9"))
    assert await until(lambda: got)
    d = got[0]
    assert ns.A.TRACE_HEADER in d.properties.headers
    assert d.trace is not None
    stage, t_enq = d.trace.marks[0]
    assert stage == "enqueue"
    assert t0 <= t_enq <= time.time()
    assert float(d.properties.headers[ns.A.TRACE_HEADER]) == t_enq
    broker.publish("tq", b"resp", ns.Properties(correlation_id="c9"))
    assert await until(lambda: len(got) == 2)
    assert got[1].trace is None
    assert ns.A.TRACE_HEADER not in got[1].properties.headers
    broker.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_trace_sample_n_stamps_every_nth_amqp_publish(pkg):
    ns = NS[pkg]
    broker, server = make_broker(pkg)
    got = []

    async def on_delivery(d):
        got.append(d)
        broker.ack(tag, d.delivery_tag)

    broker.trace_sample_n = 3
    broker.declare_queue("sq")
    tag = broker.basic_consume("sq", on_delivery)
    for i in range(9):
        broker.publish("sq", b"x", ns.Properties(reply_to="rq",
                                                 correlation_id=f"c{i}"))
    assert await until(lambda: len(got) == 9)
    stamped = [d for d in got if ns.A.TRACE_HEADER in d.properties.headers]
    assert len(stamped) == 3
    assert sum(d.trace is not None for d in got) == 3
    broker.close()


async def _scripted_drop_dup(pkg):
    """The JAX chaos drop/dup script: seq 1's first attempt dropped, seq 2
    stormed with two copies (seqs 3 and 4). Returns what a run shows."""
    ns = NS[pkg]
    broker, server = make_broker(pkg)
    broker.chaos = ns.ChaosState(ns.Chaos(seed=3, queues=("cq",),
                                          drop_seqs=(1,), dup_seqs=((2, 2),)))
    broker.events = ns.EventLog(64)
    got = []

    async def on_delivery(d):
        got.append(d)
        broker.ack(tag, d.delivery_tag)

    broker.declare_queue("cq")
    tag = broker.basic_consume("cq", on_delivery)
    for i in range(3):
        broker.publish("cq", f"m{i}".encode(),
                       ns.Properties(reply_to="rq", correlation_id=f"c{i}"))
    assert await until(lambda: len(got) >= 5)
    await asyncio.sleep(0.05)
    out = {
        "bodies": sorted(d.body for d in got),
        "m1_redelivered": [d.redelivered for d in got if d.body == b"m1"],
        "m2_seqs": sorted(int(d.properties.headers[ns.A.CHAOS_SEQ_HEADER])
                          for d in got if d.body == b"m2"),
        "stats": dict(broker.stats),
        "events": [(e["kind"], e["queue"], e.get("detail", ""))
                   for e in broker.events.snapshot()],
    }
    broker.close()
    return out


@pytest.mark.parametrize("pkg", PKGS)
async def test_amqp_chaos_scripted_drop_and_dup(pkg):
    r = await _scripted_drop_dup(pkg)
    assert r["bodies"] == [b"m0", b"m1", b"m2", b"m2", b"m2"]
    assert r["stats"]["dropped"] == 1 and r["stats"]["duplicated"] == 2
    assert r["m1_redelivered"][0]
    assert r["m2_seqs"] == [2, 3, 4]
    kinds = [k for k, _, _ in r["events"]]
    assert "chaos_drop" in kinds and "chaos_dup" in kinds


@pytest.mark.parametrize("pkg", PKGS)
async def test_amqp_chaos_partition_pause_and_resume(pkg):
    ns = NS[pkg]
    broker, server = make_broker(pkg)
    broker.chaos = ns.ChaosState(ns.Chaos(seed=4, queues=("pq",),
                                          partitions=((1, 3),),
                                          partition_max_s=10.0))
    got = []

    async def on_delivery(d):
        got.append(d)
        broker.ack(tag, d.delivery_tag)

    broker.declare_queue("pq")
    tag = broker.basic_consume("pq", on_delivery)
    props = ns.Properties
    broker.publish("pq", b"a", props(reply_to="r", correlation_id="a"))
    assert await until(lambda: got)
    broker.publish("pq", b"b", props(reply_to="r", correlation_id="b"))
    await asyncio.sleep(0.3)
    assert [d.body for d in got] == [b"a"]
    assert broker.stats["partitions"] == 1
    broker.publish("pq", b"c", props(reply_to="r", correlation_id="c"))
    broker.publish("pq", b"d", props(reply_to="r", correlation_id="d"))
    assert await until(lambda: len(got) == 4)
    assert sorted(d.body for d in got) == [b"a", b"b", b"c", b"d"]
    broker.close()


@pytest.mark.parametrize("pkg", PKGS)
async def test_publish_batch_one_channel_op(pkg):
    ns = NS[pkg]
    broker, server = make_broker(pkg)
    broker.declare_queue("replies")
    broker.declare_queue("req")
    broker.publish_batch([
        ("replies", b"r1", ns.Properties(correlation_id="c1")),
        ("replies", b"r2", ns.Properties(correlation_id="c2")),
        ("req", b"q1", ns.Properties(reply_to="replies", correlation_id="c3")),
    ])
    assert broker.stats["published"] == 3
    assert broker.queue_depth("replies") == 2
    assert broker.queue_depth("req") == 1
    got = await broker.get("replies", timeout=1.0)
    assert got.body == b"r1" and got.properties.correlation_id == "c1"
    req = await broker.get("req", timeout=1.0)
    assert "x-trace-enqueue" in req.properties.headers
    broker.close()


# ---- across packages -----------------------------------------------------


async def test_chaos_stats_and_events_equal_across_packages():
    mine = await _scripted_drop_dup("port")
    theirs = await _scripted_drop_dup("jax")
    assert mine == theirs
    assert [k for k, _, _ in mine["events"]] == ["chaos_dup", "chaos_drop"]


@pytest.mark.parametrize("server_pkg,client_pkg", [("port", "jax"),
                                                   ("jax", "port")])
async def test_client_of_one_package_against_serve_of_the_other(
        server_pkg, client_pkg, monkeypatch):
    """One FakeServer (the JAX package's fake passed to both): each
    package's client matches two players through the other's serve."""
    clean_env(monkeypatch)
    url = f"amqp://interop-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("MM_BROKER_URL", url)
    monkeypatch.setenv("MM_ENGINE_BACKEND", "cpu")
    monkeypatch.setenv("MM_BATCHER_MAX_WAIT_MS", "1")
    srv, cli = NS[server_pkg], NS[client_pkg]
    stop = asyncio.Event()
    task = asyncio.create_task(srv.serve(stop, pika_module=jax_fake,
                                         **srv.serve_kw))
    try:
        server = jax_fake.FakeServer.for_url(url)
        assert await until(lambda: Q in server.queues or task.done(), 500)
        client = cli.A.AmqpBroker(url, pika_module=jax_fake,
                                  reconnect_base_s=0.01)
        mm = cli.Client(client, Q)
        r1, r2 = await asyncio.gather(
            mm.search_until_matched({"id": "ann", "rating": 1400},
                                    timeout=10.0),
            mm.search_until_matched({"id": "ben", "rating": 1404},
                                    timeout=10.0))
        assert (r1.status, r2.status) == ("matched", "matched")
        assert r1.match.match_id == r2.match.match_id
        client.close()
    finally:
        stop.set()
        await task


def _normalized(body: bytes) -> dict:
    import json

    d = json.loads(body)
    for key in ("latency_ms", "waited_ms", "trace_id"):
        d.pop(key, None)
    if d.get("match"):
        d["match"].pop("match_id", None)
    return d


async def _serve_seeded(pkg, monkeypatch, n=128, burst=64):
    """``n`` seeded requests through ``pkg``'s serve over the JAX fake, in
    bursts of ``burst`` published by a client AmqpBroker of the same
    package; windows are cut by count (``max_batch`` is the burst, the
    timer never fires). Returns the answers by correlation id."""
    ns = NS[pkg]
    clean_env(monkeypatch)
    url = f"amqp://seeded-{pkg}-{uuid.uuid4().hex[:8]}"
    for k, v in {**SMALL_ENV, "MM_CONFIG_JSON": CONFIG1, "MM_BROKER_URL": url,
                 "MM_BATCHER_MAX_BATCH": str(burst),
                 "MM_BATCHER_MAX_WAIT_MS": "60000"}.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(31)
    ratings = rng.normal(1500.0, 200.0, size=n)
    stop = asyncio.Event()
    task = asyncio.create_task(ns.serve(stop, pika_module=jax_fake,
                                        **ns.serve_kw))
    answers: dict = {}
    try:
        server = jax_fake.FakeServer.for_url(url)
        assert await until(lambda: Q in server.queues or task.done(), 1000)
        client = ns.A.AmqpBroker(url, pika_module=jax_fake,
                                 reconnect_base_s=0.01)
        client.declare_queue("seeded.replies")

        async def on_reply(d):
            answers.setdefault(d.properties.correlation_id, []).append(d.body)
            client.ack(tag, d.delivery_tag)

        tag = client.basic_consume("seeded.replies", on_reply)
        for b in range(0, n, burst):
            for i in range(b, b + burst):
                client.publish(Q, f'{{"id":"s{i}","rating":{ratings[i]:.2f}}}'
                               .encode(), ns.Properties(
                                   reply_to="seeded.replies",
                                   correlation_id=f"c{i}"))
            assert await until(lambda: sum(map(len, answers.values()))
                               >= b + burst or task.done(), 2000)
        await asyncio.sleep(0.1)
        client.close()
    finally:
        stop.set()
        await task
    return answers


async def test_serve_answers_equal_across_packages(monkeypatch):
    """Config #1 (its pool cut to a CPU size) served over AMQP by each
    package, the same seeded bursts: equal answers after the trace id,
    match id and measured times are normalised, each request answered
    with one terminal answer at most (a "queued" ack first for a player
    who waits)."""
    mine = await _serve_seeded("port", monkeypatch)
    theirs = await _serve_seeded("jax", monkeypatch)
    assert set(mine) == set(theirs) == {f"c{i}" for i in range(128)}
    statuses = [[_normalized(b)["status"] for b in v] for v in mine.values()]
    assert all(s in (["matched"], ["queued"], ["queued", "matched"])
               for s in statuses), statuses
    assert any(s == ["matched"] for s in statuses)
    for corr in theirs:
        assert [_normalized(b) for b in mine[corr]] == [
            _normalized(b) for b in theirs[corr]], corr


async def test_headers_ride_the_wire_the_same_way():
    """The trace stamp and the chaos seq, published by each package into
    one FakeServer: the same header keys, the seqs equal, the stamps
    floats of the publish time; a response carries neither stamp."""
    url = f"amqp://hdr-{uuid.uuid4().hex[:8]}"
    server = jax_fake.FakeServer.for_url(url)
    raw = {}
    for pkg in PKGS:
        ns = NS[pkg]
        broker, _ = make_broker(pkg, url=url, fake=jax_fake)
        broker.chaos = ns.ChaosState(ns.Chaos(seed=1, queues=(f"h.{pkg}",),
                                              dup_seqs=((1, 1),)))
        broker.declare_queue(f"h.{pkg}")
        t0 = time.time()
        for i in range(3):
            broker.publish(f"h.{pkg}", b"x", ns.Properties(
                reply_to="r", correlation_id=f"c{i}",
                headers={"x-tier": 1}))
        broker.publish(f"h.{pkg}", b"resp", ns.Properties(correlation_id="z"))
        with server.lock:
            msgs = list(server.queues[f"h.{pkg}"].messages)
        raw[pkg] = [(m.body, m.properties.correlation_id,
                     dict(m.properties.headers or {})) for m in msgs]
        for _, _, h in raw[pkg]:
            if "x-trace-enqueue" in h:
                assert t0 <= float(h["x-trace-enqueue"]) <= time.time()
        broker.close()

    def shape(rows):
        return [(body, corr, sorted(h), h.get("x-chaos-seq"), h.get("x-tier"))
                for body, corr, h in rows]

    assert shape(raw["port"]) == shape(raw["jax"])
    assert [s[3] for s in shape(raw["port"])] == [0, 1, 2, 3, 4]


def _fake_script(fake):
    """One scripted kill / down / requeue sequence against a fake; what
    every call returned or raised."""
    url = f"amqp://script-{uuid.uuid4().hex[:8]}"
    out = []
    server = fake.FakeServer.for_url(url)
    conn = fake.BlockingConnection(fake.URLParameters(url))
    ch = conn.channel()
    ch.basic_qos(prefetch_count=2)
    ch.queue_declare(queue="s")
    for i in range(4):
        ch.basic_publish("", "s", f"m{i}".encode(),
                         fake.BasicProperties(correlation_id=f"c{i}"))
    for _ in range(2):
        m, p, b = ch.basic_get("s")
        out.append(("get", m.delivery_tag, m.redelivered, b,
                    p.correlation_id))
    ch.basic_ack(1)
    ch.basic_nack(2, requeue=True)
    out.append(("depth", server.depth("s")))
    m, p, b = ch.basic_get("s")
    out.append(("get", m.delivery_tag, m.redelivered, b))
    try:
        ch.basic_ack(99)
    except fake.exceptions.ChannelClosedByBroker as e:
        out.append(("ack99", type(e).__name__))
    server.kill_connections()
    out.append(("alive", conn.is_open, server.depth("s")))
    try:
        ch.basic_get("s")
    except fake.exceptions.AMQPConnectionError as e:
        out.append(("dead", type(e).__name__))
    server.set_down(True)
    try:
        fake.BlockingConnection(fake.URLParameters(url))
    except fake.exceptions.AMQPConnectionError as e:
        out.append(("down", type(e).__name__))
    server.set_down(False)
    conn2 = fake.BlockingConnection(fake.URLParameters(url))
    ch2 = conn2.channel()
    while True:
        m, p, b = ch2.basic_get("s", auto_ack=True)
        if m is None:
            break
        out.append(("after", b, m.redelivered))
    ran = []
    conn2.add_callback_threadsafe(lambda: ran.append(1))
    conn2.process_data_events()
    out.append(("callbacks", ran))
    ch2.queue_declare(queue="x", exclusive=True, auto_delete=True)
    conn2.close()
    out.append(("exclusive_gone", "x" in server.queues))
    out.append(("wait_until", fake.wait_until(lambda: True, timeout=0.1)))
    return out


def test_port_fake_equals_jax_fake_on_one_script():
    mine, theirs = _fake_script(port_fake), _fake_script(jax_fake)
    assert mine == theirs
    assert ("alive", False, 3) in mine


@pytest.mark.parametrize("pkg", PKGS)
def test_amqp_broker_without_pika_raises(pkg, monkeypatch):
    monkeypatch.setitem(sys.modules, "pika", None)  # the import fails
    with pytest.raises(RuntimeError, match="pika"):
        NS[pkg].A.AmqpBroker("amqp://nowhere")


@pytest.mark.parametrize("pkg", PKGS)
async def test_injected_amqp_broker_gets_the_chaos_state(pkg):
    ns = NS[pkg]
    broker, _ = make_broker(pkg)
    cfg = ns.Config(engine=type(ns.Config().engine)(backend="cpu"),
                    chaos=ns.Chaos(seed=2, queues=(Q,), drop_seqs=(0,)))
    app = ns.App(cfg, broker=broker, **ns.app_kw)
    assert app.chaos is not None and broker.chaos is app.chaos
    assert broker.events is app.events
    assert broker.trace_sample_n == app.trace_sample_n
    broker.close()


async def test_port_serve_refuses_a_multi_host_topology(monkeypatch):
    """``serve`` joins a topology ``MM_DCN_*`` names
    (tests/test_torch_dcn.py); one named without its size and rank, and
    ``MM_DCN_AUTO`` with neither a Slurm nor an Open MPI launcher's
    environment, are refused before anything serves."""
    clean_env(monkeypatch)
    monkeypatch.setenv("MM_DCN_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="MM_DCN_NUM_PROCESSES"):
        await port_app.serve(asyncio.Event(), device="cpu")
    clean_env(monkeypatch)
    for key in list(os.environ):
        if key.startswith(("SLURM_", "OMPI_")):
            monkeypatch.delenv(key)
    monkeypatch.setenv("MM_DCN_AUTO", "1")
    with pytest.raises(ValueError, match="no launcher's environment"):
        await port_app.serve(asyncio.Event(), device="cpu")


async def test_port_serve_without_pika_does_not_fall_back(monkeypatch):
    """An amqp:// URL with no pika raises: nothing serves in-process."""
    clean_env(monkeypatch)
    monkeypatch.setenv("MM_BROKER_URL", "amqp://nowhere")
    monkeypatch.setenv("MM_ENGINE_BACKEND", "cpu")
    monkeypatch.setitem(sys.modules, "pika", None)
    with pytest.raises(RuntimeError, match="pika"):
        await port_app.serve(asyncio.Event(), device="cpu")
