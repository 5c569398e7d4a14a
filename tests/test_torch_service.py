"""The port's columnar pipelined service, on the CPU, and its wire contract
against the JAX package's contract module (byte-identical encodings)."""

import asyncio
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from matchmaking_tpu.service import contract as jax_contract
from matchmaking_tpu_torch.config import (
    Config,
    EngineConfig,
    OverloadConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.service import contract
from matchmaking_tpu_torch.service.app import MatchmakingApp, run_demo
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.service.client import MatchmakingClient

# Small tensors: one intra-op thread each leaves the cores to the other
# test workers (several run side by side).
torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cfg(queue=None, **engine_kw):
    kw = dict(pool_capacity=1024, pool_block=256, batch_buckets=(16, 64))
    kw.update(engine_kw)
    return Config(engine=EngineConfig(**kw),
                  queues=(queue or QueueConfig(),))


def publish(app, reply_to, player, first_received=None, deadline=None):
    """Publish one request with correlation id = the player id."""
    headers = {}
    if first_received is not None:
        headers["x-first-received"] = first_received
    if deadline is not None:
        headers["x-deadline"] = repr(deadline)
    app.broker.declare_queue(reply_to)
    app.broker.publish(app.queue_cfg.name, json.dumps(player).encode(),
                       Properties(reply_to=reply_to,
                                  correlation_id=player["id"],
                                  headers=headers))


async def answers(app, reply_to, until, timeout=10.0):
    """(correlation id, response) from ``reply_to`` until ``until(got)``
    holds and 0.2 s pass with nothing more, or the timeout."""
    got = []
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        d = await app.broker.get(reply_to, timeout=0.2)
        if d is None:
            if until(got):
                return got
            continue
        got.append((d.properties.correlation_id,
                    contract.decode_response(d.body)))
    raise AssertionError(f"timed out with {len(got)} answers")


async def test_demo_answers_ten_players_on_cpu():
    answers = await run_demo(device="cpu")
    assert len(answers) == 10
    by_id = {r.player_id: r for r in answers}
    assert set(by_id) == {f"p{i}" for i in range(10)}
    for r in answers:
        assert r.status == "matched"
        partner = next(p for p in r.match.players if p != r.player_id)
        other = by_id[partner]
        assert other.status == "matched"
        assert other.match.match_id == r.match.match_id
        assert 0.0 <= r.match.quality <= 1.0


async def test_errors_queued_acks_and_terminal_replay():
    app = MatchmakingApp(small_cfg(), device="cpu")
    await app.start()
    try:
        client = MatchmakingClient(app.broker, app.queue_cfg.name)
        # Malformed payload → error response from the middleware.
        reply = "rq.bad"
        app.broker.declare_queue(reply)
        app.broker.publish(app.queue_cfg.name, b"{not json",
                           Properties(reply_to=reply, correlation_id="c1"))
        bad = await client.next_response(reply, timeout=5.0)
        assert bad.status == "error" and bad.error_code == "bad_json"
        # A lone player is queued (ack), then matched when a partner comes.
        lone = client.submit({"id": "solo", "rating": 1500})
        first = await client.next_response(lone, timeout=5.0)
        assert first.status == "queued" and first.player_id == "solo"
        got = await client.search_until_matched({"id": "mate", "rating": 1510})
        assert got.status == "matched" and set(got.match.players) == {"solo", "mate"}
        solo_final = await client.next_response(lone, timeout=5.0)
        assert solo_final.status == "matched"
        assert solo_final.match.match_id == got.match.match_id
        # A redelivered copy of an already-matched player replays "matched".
        again = await client.search_until_matched({"id": "mate", "rating": 1510})
        assert again.status == "matched"
        assert again.match.match_id == got.match.match_id
        assert app.counters["deduped_replays"] == 1
        assert app.engine.pool_size() == 0
    finally:
        await app.stop()


async def test_every_request_answered_once_in_one_batch_per_window():
    """Windows at pipeline depth 2: every request gets exactly one answer
    from its own window (``matched`` or ``queued``), a queued one at most
    one later ``matched``; partners agree; one publish_batch per window."""
    app = MatchmakingApp(small_cfg(pipeline_depth=2), device="cpu")
    await app.start()
    calls = []
    real = app.broker.publish_batch
    app.broker.publish_batch = lambda items: (calls.append(len(items)),
                                              real(items))
    try:
        rng = np.random.default_rng(11)
        n = 300
        for i in range(n):
            publish(app, "rq.all", {"id": f"p{i}",
                                    "rating": float(rng.normal(1500, 400))})
            if i % 37 == 0:
                await asyncio.sleep(0.002)  # several windows
        got = await answers(
            app, "rq.all", lambda g: len({cid for cid, _ in g}) == n)
        seq = {}
        for cid, resp in got:
            assert resp.player_id == cid
            seq.setdefault(cid, []).append(resp)
        matched = {}
        for cid, resps in seq.items():
            kinds = [r.status for r in resps]
            assert kinds in (["matched"], ["queued"], ["queued", "matched"]), kinds
            if kinds[-1] == "matched":
                matched[cid] = resps[-1].match
        for cid, m in matched.items():
            partner = next(p for p in m.players if p != cid)
            assert matched[partner].match_id == m.match_id
        assert len(matched) >= 100
        assert app.engine.pool_size() == n - len(matched)
        assert app.counters["windows"] >= 2
        assert len(calls) == app.counters["publish_batches"]
        assert len(calls) == app.counters["windows"]
        assert sum(calls) == len(got)
        assert app.faults() == {}
    finally:
        await app.stop()


async def test_rescan_tick_publishes_a_widening_match():
    """Config #4 (Glicko-2, widening 5/s): two players 95 apart (rd 0)
    cannot match on arrival (the newcomer's threshold is ~83, and reaches
    95 only 2.5 s after it is published); a rescan tick matches them once
    both thresholds have widened past 95."""
    cfg = Config.from_json(os.path.join(ROOT, "configs/glicko2.json"),
                           backend="gpu")
    queue = dataclasses.replace(cfg.queues[0], rescan_interval_s=0.1)
    assert cfg.queues[0].rescan_interval_s == 1.0  # read from the file
    app = MatchmakingApp(small_cfg(queue), device="cpu")
    await app.start()
    try:
        now = time.time()
        publish(app, "rq.old", {"id": "old", "rating": 1500,
                                "rating_deviation": 0}, first_received=now - 60)
        publish(app, "rq.new", {"id": "new", "rating": 1595,
                                "rating_deviation": 0}, first_received=now - 0.5)
        old = await answers(app, "rq.old", lambda g: len(g) == 2)
        new = await answers(app, "rq.new", lambda g: len(g) == 2)
        assert [r.status for _, r in old] == ["queued", "matched"]
        assert [r.status for _, r in new] == ["queued", "matched"]
        assert old[1][1].match.match_id == new[1][1].match.match_id
        assert app.counters["rescan_matches"] == 1
        assert app.engine.pool_size() == 0
        assert app.faults() == {}
    finally:
        await app.stop()


@pytest.mark.parametrize("sweep", ["request_timeout", "deadline"])
async def test_expiry_sweep_answers_timeout(sweep):
    """The sweep loop answers ``timeout``: for a player waiting past
    ``request_timeout_s``, or past its own ``x-deadline`` (with
    ``deadline_sweep_ms``); a redelivered copy replays the timeout."""
    if sweep == "request_timeout":
        cfg = small_cfg(QueueConfig(request_timeout_s=0.3))
        deadline = None
    else:
        cfg = dataclasses.replace(small_cfg(), overload=OverloadConfig(
            deadline_sweep_ms=20.0))
        # matchlint: ignore[determinism] x-deadline is wall-clock epoch seconds by the wire contract
        deadline = time.time() + 0.3
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    try:
        publish(app, "rq.lone", {"id": "lone", "rating": 1500},
                deadline=deadline)
        got = await answers(app, "rq.lone", lambda g: len(g) == 2)
        assert [r.status for _, r in got] == ["queued", "timeout"]
        if deadline is None:  # waited past the timeout, from its stamp
            assert got[1][1].latency_ms > 300.0
        else:
            # matchlint: ignore[determinism] x-deadline is wall-clock epoch seconds by the wire contract
            assert time.time() >= deadline
        assert app.counters["timeouts"] == 1 and app.engine.pool_size() == 0
        assert app.engine.deadline_count() == 0
        # A redelivered copy replays the timeout.
        publish(app, "rq.lone", {"id": "lone", "rating": 1500})
        again = await answers(app, "rq.lone", lambda g: len(g) == 1)
        assert again[0][1].status == "timeout"
    finally:
        await app.stop()


async def test_device_failure_nacks_its_window_and_revives_from_the_mirror():
    app = MatchmakingApp(small_cfg(), device="cpu")
    await app.start()
    try:
        for i in range(3):  # far apart: they wait
            publish(app, "rq.a", {"id": f"a{i}", "rating": 1000.0 * i})
        await answers(app, "rq.a", lambda g: len(g) == 3)
        old = app.engine
        real = old._fetch

        def failing(pending):  # the next window fails on "the device"
            pending.error = RuntimeError("CUDA error: injected")
            old._fetch = real

        old._fetch = failing
        nacked = []
        real_nack = app.broker.nack
        app.broker.nack = lambda tag, dtag, requeue=True: (
            nacked.append(dtag), real_nack(tag, dtag, requeue))
        publish(app, "rq.b", {"id": "b0", "rating": 5000.0})
        publish(app, "rq.b", {"id": "b1", "rating": 7000.0})
        for _ in range(500):
            if app.counters["revives"]:
                break
            await asyncio.sleep(0.01)
        assert app.counters["engine_failures"] == 1
        assert app.counters["revives"] == 1 and app.engine is not old
        # The caught failure is reported (the new engine parked none).
        assert app.faults() == {"engine_failures": 1, "revives": 1}
        assert isinstance(old.device_error, RuntimeError)
        assert len(nacked) == 2  # exactly the failed window's deliveries
        # The mirror carried every waiting player, b0/b1 included.
        waiting = {r.id for r in app.engine.waiting()}
        assert waiting == {"a0", "a1", "a2", "b0", "b1"}
        # The revived engine serves: a partner for b1 matches it, and the
        # answer reaches b1's reply queue from the restored mirror.
        publish(app, "rq.c", {"id": "c", "rating": 7001.0})
        got = await answers(app, "rq.c", lambda g: len(g) == 1)
        assert got[0][1].status == "matched"
        assert set(got[0][1].match.players) == {"c", "b1"}
        b = await answers(app, "rq.b", lambda g: any(
            r.status == "matched" for _, r in g))
        assert [r.player_id for _, r in b if r.status == "matched"] == ["b1"]
    finally:
        await app.stop()


async def test_depth_one_dispatches_and_collects_each_window():
    app = MatchmakingApp(small_cfg(pipeline_depth=1), device="cpu")
    await app.start()
    try:
        assert app.runtime(app.queue_cfg.name)._collector is None
        client = MatchmakingClient(app.broker, app.queue_cfg.name)
        a, b = await asyncio.gather(
            client.search_until_matched({"id": "x", "rating": 1500}),
            client.search_until_matched({"id": "y", "rating": 1520}))
        assert a.status == b.status == "matched"
        assert app.engine.inflight() == 0
    finally:
        await app.stop()


def _request_corpus():
    rng = np.random.default_rng(17)
    bodies = [
        {"id": "a", "rating": 1500},
        {"id": "b", "rating": 1432.5, "rating_deviation": 80.25,
         "game_mode": "ranked", "region": "eu", "rating_threshold": 60},
        {"id": "c", "rating": 2000, "roles": ["tank", "dps"],
         "party": [{"id": "c2", "rating": 1990, "roles": ["heal"]}]},
        {"id": "d", "rating": 1500, "region": "", "game_mode": None},
        {"id": "e", "rating": 1e6},
        {"id": "f", "rating": "high"},
        {"rating": 1500},
        {"id": "g", "rating": 1500, "rating_threshold": 0},
        {"id": "h", "rating": 1500, "party": [{"id": "h", "rating": 1}]},
        {"id": "i", "rating": True},
        [1, 2, 3],
    ]
    for i in range(20):
        bodies.append({"id": f"r{i}", "rating": float(rng.normal(1500, 300)),
                       "rating_deviation": float(rng.uniform(0, 350)),
                       "region": str(rng.choice(["eu", "na", "*"]))})
    raw = [json.dumps(b).encode() for b in bodies]
    return raw + [b"{not json", b"", "é".encode("latin-1")]


@pytest.mark.parametrize("body", _request_corpus())
def test_decode_request_matches_jax_contract(body):
    kw = dict(reply_to="rq", correlation_id="cid", queue="q", enqueued_at=3.5)
    try:
        want = jax_contract.decode_request(body, **kw)
    except jax_contract.ContractError as e:
        with pytest.raises(contract.ContractError) as got:
            contract.decode_request(body, **kw)
        assert (got.value.code, got.value.reason) == (e.code, e.reason)
        return
    got = contract.decode_request(body, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert contract.encode_request(got) == jax_contract.encode_request(want)


def _response_pairs():
    out = []
    for mod in (contract, jax_contract):
        res = mod.MatchResult(match_id="m1", players=("a", "b"),
                              teams=(("a",), ("b",)), quality=0.73456789)
        out.append([
            mod.SearchResponse(status="queued", player_id="a"),
            mod.SearchResponse(status="matched", player_id="a", match=res,
                               latency_ms=12.34567, waited_ms=11.0001),
            mod.SearchResponse(status="error", player_id="x",
                               error_code="pool_full",
                               error_reason="engine rejected request: pool_full"),
            mod.SearchResponse(status="timeout", player_id="t", trace_id="tr"),
            mod.SearchResponse(status="shed", player_id="s",
                               retry_after_ms=250.0, tier=2),
        ])
    return list(zip(*out))


@pytest.mark.parametrize("pair", _response_pairs(),
                         ids=["queued", "matched", "error", "timeout", "shed"])
def test_encode_response_bytes_match_jax_contract(pair):
    port, jax = pair
    body = contract.encode_response(port)
    assert body == jax_contract.encode_response(jax)
    assert (dataclasses.asdict(contract.decode_response(body))
            == dataclasses.asdict(jax_contract.decode_response(body)))


async def test_team_queue_serves_5v5_matches_on_the_object_path():
    """A 5v5 queue (``configs/team_5v5.json``, a 256-slot pool) through the
    object path: decode middleware → ``search_async`` → one
    ``publish_batch`` per window. Forty pinned players all match, in
    teams of five; each matched body is byte-equal to the JAX contract's
    ``encode_response`` of the same response; a malformed payload and a
    party (no roles on this queue) get errors; a wildcard hands the queue
    to the host oracle, which still answers it."""
    cfg = Config.from_json(os.path.join(ROOT, "configs/team_5v5.json"),
                           backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, pool_capacity=256, batch_buckets=(16, 64),
        team_max_matches=32))
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    calls = []
    real = app.broker.publish_batch
    app.broker.publish_batch = lambda items: (calls.append(len(items)),
                                              real(items))
    try:
        app.broker.declare_queue("rq.team")
        app.broker.publish(app.queue_cfg.name, b"{not json",
                           Properties(reply_to="rq.team", correlation_id="bad"))
        publish(app, "rq.team", {"id": "duo", "rating": 1500, "region": "eu",
                                 "game_mode": "ranked",
                                 "party": [{"id": "duo2", "rating": 1500}]})
        for i in range(40):
            publish(app, "rq.team", {"id": f"t{i}", "rating": 1500 + 3 * i,
                                     "region": "eu", "game_mode": "ranked"})
        bodies: dict[str, list[bytes]] = {}
        end = time.monotonic() + 10.0
        while time.monotonic() < end:  # until 40 matched and 0.2 s quiet
            d = await app.broker.get("rq.team", timeout=0.2)
            if d is not None:
                bodies.setdefault(d.properties.correlation_id, []).append(
                    d.body)
            elif sum(b"matched" in v[-1] for v in bodies.values()) >= 40:
                break
        assert contract.decode_response(bodies["bad"][0]).error_code == "bad_json"
        assert (contract.decode_response(bodies["duo"][0]).error_code
                == "party_not_supported")
        matches = {}
        for i in range(40):
            resp = contract.decode_response(bodies[f"t{i}"][-1])
            assert resp.status == "matched", (i, resp.status)
            assert [r.status for r in map(contract.decode_response,
                                          bodies[f"t{i}"][:-1])] in ([], ["queued"])
            m = resp.match
            assert [len(t) for t in m.teams] == [5, 5]
            assert resp.player_id in m.players and len(m.players) == 10
            matches.setdefault(m.match_id, set()).add(resp.player_id)
            jm = jax_contract.MatchResult(match_id=m.match_id,
                                          players=m.players, teams=m.teams,
                                          quality=m.quality)
            assert bodies[f"t{i}"][-1] == jax_contract.encode_response(
                jax_contract.SearchResponse(
                    status="matched", player_id=resp.player_id, match=jm,
                    latency_ms=resp.latency_ms, waited_ms=resp.waited_ms,
                    trace_id=resp.trace_id))
        assert sorted(len(v) for v in matches.values()) == [10] * 4
        assert len(calls) == app.counters["windows"]
        assert app.engine.pool_size() == 0
        # A wildcard: the queue moves to the host oracle, which queues it.
        publish(app, "rq.wild", {"id": "wild", "rating": 1500, "region": "*"})
        got = await answers(app, "rq.wild", lambda g: len(g) == 1)
        assert got[0][1].status == "queued"
        assert app.engine.counters == {"team_delegated": 1}
        assert [r.id for r in app.engine.waiting()] == ["wild"]
        assert app.faults() == {}
    finally:
        await app.stop()


async def test_team_queue_revives_from_waiting_requests():
    """A team window that fails on "the device" is nacked and the engine
    rebuilt from the old engine's ``waiting()`` requests (roles and
    region/mode included: team queues have no columnar mirror); the
    redelivered window then queues normally."""
    q = QueueConfig(team_size=2, rating_threshold=50.0,
                    role_slots=("tank", "dps"))
    app = MatchmakingApp(small_cfg(q, team_max_matches=16), device="cpu")
    await app.start()
    try:
        for i in range(3):  # far apart: they wait
            publish(app, "rq.r", {"id": f"r{i}", "rating": 1000.0 * i,
                                  "region": "eu", "game_mode": "ranked",
                                  "roles": ["tank"]})
        await answers(app, "rq.r", lambda g: len(g) == 3)
        old = app.engine
        real = old._fetch

        def failing(pending):
            pending.error = RuntimeError("CUDA error: injected")
            old._fetch = real

        old._fetch = failing
        publish(app, "rq.f", {"id": "f0", "rating": 9000.0, "region": "eu",
                              "game_mode": "ranked", "roles": ["dps"]})
        for _ in range(500):
            if app.counters["revives"]:
                break
            await asyncio.sleep(0.01)
        assert app.counters["revives"] == 1 and app.engine is not old
        waiting = {r.id: r for r in app.engine.waiting()}
        assert set(waiting) == {"r0", "r1", "r2", "f0"}
        assert waiting["r1"].roles == ("tank",)
        assert waiting["r1"].region == "eu"
        # The revived engine serves: a team of three completes r2's 2v2,
        # and r2's answer reaches its reply queue from the restored mirror.
        for pid, rating, role in (("d1", 2005, "dps"), ("t2", 2010, "tank"),
                                  ("d2", 2015, "dps")):
            publish(app, "rq.m", {"id": pid, "rating": rating, "region": "eu",
                                  "game_mode": "ranked", "roles": [role]})
        got = await answers(app, "rq.r", lambda g: len(g) == 1)
        assert got[0][1].status == "matched"
        assert sorted(len(t) for t in got[0][1].match.teams) == [2, 2]
        assert set(got[0][1].match.players) == {"r2", "d1", "t2", "d2"}
        assert app.faults() == {"engine_failures": 1, "revives": 1}
    finally:
        await app.stop()
