"""Auth ``static`` and ``rpc`` in the port (the middleware, the broker's
rpc, the service) against the JAX package, on the CPU.

- ``AuthMiddleware`` passes a good token and rejects a bad one with the
  JAX middleware's code and reason, in both modes; rpc with no responder
  is ``auth_unavailable``.
- The broker's ``rpc``: a round trip to a responder, None on a timeout,
  the ephemeral reply queue deleted either way.
- Both apps, the same traffic, one request in eight with a bad token: a
  first burst (one player of each pair), answered, then a second (their
  partners); every answer's bytes equal per correlation id (the match id,
  latency and wait carried over). The bad ones are ``unauthorized``; the
  rest are queued and matched.
"""

import asyncio
import dataclasses
import json
import time

import pytest
import torch

from matchmaking_tpu.config import AuthConfig as JaxAuthConfig
from matchmaking_tpu.config import BatcherConfig as JaxBatcherConfig
from matchmaking_tpu.config import BrokerConfig as JaxBrokerConfig
from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import ObservabilityConfig as JaxObservabilityConfig
from matchmaking_tpu.service import contract as jax_contract
from matchmaking_tpu.service import middleware as jax_mw
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Delivery as JaxDelivery
from matchmaking_tpu.service.broker import InProcBroker as JaxBroker
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu_torch.config import (
    AuthConfig,
    BatcherConfig,
    BrokerConfig,
    Config,
    EngineConfig,
    ObservabilityConfig,
)
from matchmaking_tpu_torch.service import contract
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Delivery, InProcBroker, Properties
from matchmaking_tpu_torch.service.client import MatchmakingClient
from matchmaking_tpu_torch.service.middleware import (
    AuthMiddleware,
    MessageContext,
    MiddlewareReject,
)

torch.set_num_threads(1)

Q = "matchmaking.search"
SECRET = "tok"


def _delivery(cls, props, token):
    headers = {"authorization": token} if token is not None else {}
    return cls(body=b"{}", properties=props(headers=headers), queue="q",
               delivery_tag=1)


def _responder(broker, queue):
    """An auth service on ``queue``: ``ok`` for a token with the secret as
    its prefix, else ``denied``."""
    async def verify(d):
        ok = d.body.startswith(SECRET.encode())
        broker.publish(d.properties.reply_to, b"ok" if ok else b"denied",
                       type(d.properties)(
                           correlation_id=d.properties.correlation_id))
        broker.ack(tag, d.delivery_tag)

    tag = broker.basic_consume(queue, verify)
    return tag


async def _verdict(mw, ctx_cls, delivery):
    ran = []

    async def nxt():
        ran.append(1)

    try:
        await mw.call(ctx_cls(delivery, queue="q"), nxt)
    except (MiddlewareReject, jax_mw.MiddlewareReject) as e:
        return (e.code, e.reason)
    return ran


@pytest.mark.parametrize("mode", ["static", "rpc"])
@pytest.mark.parametrize("token", ["tok-1", "wrong", "", None])
async def test_auth_middleware_equals_jax(mode, token):
    broker, jbroker = InProcBroker(BrokerConfig()), JaxBroker(
        JaxBrokerConfig())
    if mode == "rpc":
        _responder(broker, "auth.token.verify")
        _responder(jbroker, "auth.token.verify")
    mine = AuthMiddleware(AuthConfig(mode=mode, static_secret=SECRET), broker)
    theirs = jax_mw.AuthMiddleware(
        JaxAuthConfig(mode=mode, static_secret=SECRET), jbroker)
    got = await _verdict(mine, MessageContext,
                         _delivery(Delivery, Properties, token))
    want = await _verdict(theirs, jax_mw.MessageContext,
                          _delivery(JaxDelivery, JaxProperties, token))
    assert got == want
    assert (got == [1]) == (token == "tok-1")
    broker.close()
    jbroker.close()


async def test_rpc_without_a_responder_is_unavailable():
    broker = InProcBroker(BrokerConfig())
    mw = AuthMiddleware(AuthConfig(mode="rpc", rpc_timeout_ms=30.0), broker)
    got = await _verdict(mw, MessageContext,
                         _delivery(Delivery, Properties, "tok"))
    assert got == ("auth_unavailable", "auth service timeout")
    assert await _verdict(AuthMiddleware(AuthConfig(mode="rpc")),
                          MessageContext,
                          _delivery(Delivery, Properties, "tok")) == (
        "auth_unavailable", "no broker for auth rpc")


async def test_broker_rpc_roundtrip_and_timeout():
    broker = InProcBroker(BrokerConfig())

    async def echo(d):
        broker.publish(d.properties.reply_to, b"ok:" + d.body,
                       Properties(correlation_id=d.properties.correlation_id))
        broker.ack(tag, d.delivery_tag)

    tag = broker.basic_consume("auth", echo)
    assert await broker.rpc("auth", b"token123", timeout=1.0) == b"ok:token123"
    assert await broker.rpc("nobody-home", b"x", timeout=0.05) is None
    assert not [q for q in broker._queues if q.startswith("amq.gen-")]
    broker.close()


async def test_e2e_auth_static_rejects_without_token():
    cfg = Config(engine=EngineConfig(pool_capacity=256, pool_block=64,
                                     batch_buckets=(8, 32)),
                 auth=AuthConfig(mode="static", static_secret=SECRET))
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    try:
        good = MatchmakingClient(app.broker, Q, auth_token="tok-1")
        bad = MatchmakingClient(app.broker, Q)
        resp = await bad.next_response(bad.submit({"id": "evil",
                                                   "rating": 1500}), 15.0)
        assert resp.status == "error" and resp.error_code == "unauthorized"
        resp = await good.next_response(good.submit({"id": "nice",
                                                     "rating": 1500}), 15.0)
        assert resp.status == "queued"
    finally:
        await app.stop()


def _traffic(n_pairs=16):
    """Pairs 300 apart from each other (each pair 5 apart), one request in
    eight with a bad token."""
    first, second = [], []
    for k in range(n_pairs):
        for half, out in ((0, first), (1, second)):
            i = 2 * k + half
            token = "bad" if i % 8 == 5 else f"{SECRET}-{i}"
            out.append((f"p{i}", 1000.0 + 300.0 * k + 5.0 * half, token))
    return first, second


async def _serve(app, props, bursts):
    app.broker.declare_queue("auth.replies")
    await app.start()
    if app.cfg.auth.mode == "rpc":
        _responder(app.broker, app.cfg.auth.rpc_queue)
    answers: dict[str, list[bytes]] = {}
    try:
        for burst in bursts:
            for pid, rating, token in burst:
                app.broker.publish(
                    Q, json.dumps({"id": pid, "rating": rating}).encode(),
                    props(reply_to="auth.replies", correlation_id=pid,
                          headers={"authorization": token,
                                   "x-first-received": "2.0"}))
            want = {pid for pid, _, _ in burst}
            end = time.monotonic() + 30.0
            while time.monotonic() < end:
                d = await app.broker.get("auth.replies", timeout=0.1)
                if d is not None:
                    answers.setdefault(d.properties.correlation_id,
                                       []).append(bytes(d.body))
                elif want <= set(answers):
                    break
            else:
                raise AssertionError(f"unanswered: {want - set(answers)}")
    finally:
        await app.stop()
    return answers


@pytest.mark.parametrize("mode", ["static", "rpc"])
def test_service_answers_equal_jax_app(mode):
    eng = dict(pool_capacity=256, pool_block=64, batch_buckets=(8, 32))
    auth = dict(mode=mode, static_secret=SECRET)
    mine = MatchmakingApp(Config(engine=EngineConfig(**eng),
                                 batcher=BatcherConfig(max_batch=32,
                                                       max_wait_ms=20.0),
                                 auth=AuthConfig(**auth),
                                 observability=ObservabilityConfig(
                                     trace=False)), device="cpu")
    theirs = JaxApp(JaxConfig(engine=JaxEngineConfig(backend="tpu", **eng),
                              batcher=JaxBatcherConfig(max_batch=32,
                                                       max_wait_ms=20.0),
                              auth=JaxAuthConfig(**auth),
                              observability=JaxObservabilityConfig(
                                  trace=False)))
    bursts = _traffic()
    port = asyncio.run(_serve(mine, Properties, bursts))
    jax = asyncio.run(_serve(theirs, JaxProperties, bursts))
    assert {c: len(v) for c, v in port.items()} == {
        c: len(v) for c, v in jax.items()}
    for corr, bodies in port.items():
        for body, jbody in zip(bodies, jax[corr]):
            got = contract.decode_response(body)
            want = jax_contract.decode_response(jbody)
            match = want.match
            if match is not None:
                match = dataclasses.replace(match,
                                            match_id=got.match.match_id)
            want = dataclasses.replace(want, match=match,
                                       latency_ms=got.latency_ms,
                                       waited_ms=got.waited_ms, trace_id="")
            assert body == jax_contract.encode_response(want), corr
    statuses = {c: [json.loads(b)["status"] for b in v]
                for c, v in port.items()}
    bad = {f"p{i}" for i in range(32) if i % 8 == 5}
    for pid, seq in statuses.items():
        if pid in bad:
            assert seq == ["error"]
            assert contract.decode_response(
                port[pid][0]).error_code == "unauthorized"
        elif f"p{int(pid[1:]) ^ 1}" in bad:
            assert seq == ["queued"]  # its partner was refused
        else:
            assert seq[-1] == "matched"


async def _rpc_burst(app, props, n):
    """``n`` requests with good tokens in one burst through auth ``rpc``
    (the default timeout): each one's seconds from publish to its answer,
    and its status and error code."""
    app.broker.declare_queue("auth.burst")
    await app.start()
    _responder(app.broker, app.cfg.auth.rpc_queue)
    sent, got = {}, {}
    try:
        for i in range(n):
            pid = f"r{i}"
            sent[pid] = time.perf_counter()
            app.broker.publish(
                Q, json.dumps({"id": pid, "rating": 1000.0 + 7 * i}).encode(),
                props(reply_to="auth.burst", correlation_id=pid,
                      headers={"authorization": f"{SECRET}-{i}"}))
        end = time.monotonic() + 60.0
        while len(got) < n and time.monotonic() < end:
            d = await app.broker.get("auth.burst", timeout=0.1)
            if d is not None and d.properties.correlation_id not in got:
                body = json.loads(d.body)
                got[d.properties.correlation_id] = (
                    time.perf_counter() - sent[d.properties.correlation_id],
                    body["status"], body.get("error_code", ""))
    finally:
        await app.stop()
    assert len(got) == n
    return got


def test_rpc_burst_of_512_answers_as_the_jax_app_within_the_timeout():
    """A burst of 512 rpc round trips through each app on the CPU, auth's
    default 250 ms timeout: wherever the JAX app authorizes a request in
    time, the port does too (no more ``auth_unavailable`` answers). The
    p50s from publish to answer print with ``-s``."""
    eng = dict(pool_capacity=1024, pool_block=256, batch_buckets=(64, 512))
    batch = dict(max_batch=512, max_wait_ms=20.0)
    mine = asyncio.run(_rpc_burst(MatchmakingApp(Config(
        engine=EngineConfig(**eng), batcher=BatcherConfig(**batch),
        auth=AuthConfig(mode="rpc")), device="cpu"), Properties, 512))
    theirs = asyncio.run(_rpc_burst(JaxApp(JaxConfig(
        engine=JaxEngineConfig(backend="tpu", **eng),
        batcher=JaxBatcherConfig(**batch), auth=JaxAuthConfig(mode="rpc"))),
        JaxProperties, 512))

    def summary(got):
        lat = sorted(t for t, _, _ in got.values())
        late = sum(1 for _, _, code in got.values()
                   if code == "auth_unavailable")
        return lat[len(lat) // 2] * 1e3, late
    p50, late = summary(mine)
    jp50, jlate = summary(theirs)
    print(f"auth rpc, burst of 512 on the CPU: port p50 {p50:.1f} ms, "
          f"{late} timed out; JAX app p50 {jp50:.1f} ms, {jlate} timed out")
    assert late <= jlate
    assert {s for _, s, _ in mine.values()} <= {"queued", "matched", "error"}
