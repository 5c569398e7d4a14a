"""The port's service serves every queue of a config, and its health timer
moves an idle delegated role queue back onto the device.

- Config #2 (``configs/multiqueue_filters.json``): two queues, ranked at
  threshold 75 and casual at 150, each with its own runtime. A pair 100
  apart matches on casual and waits on ranked; players on different queues
  never match; every answer equals the JAX app's on the same requests.
- The health timer (``EngineConfig.health_interval_s``): a role queue that
  a party handed to the host oracle goes back to the device with no
  traffic once the party expired and the quiet period passed; a tick that
  raises is counted and the next tick still runs.
"""

import asyncio
import dataclasses
import json
import os
import time

import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.service import contract as jax_contract
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu_torch.config import (
    Config,
    EngineConfig,
    OverloadConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.service import contract
from matchmaking_tpu_torch.service.app import MatchmakingApp, run_demo
from matchmaking_tpu_torch.service.broker import Properties
from test_torch_ingress import same_trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG2 = os.path.join(ROOT, "configs", "multiqueue_filters.json")
RANKED, CASUAL = "matchmaking.search.ranked", "matchmaking.search.casual"
#: Config #2's geometry cut to a CPU-sized pool (the queues are the file's).
SMALL = dict(pool_capacity=1024, pool_block=256, batch_buckets=(16, 64))

#: (phase, queue, player id, rating). Phase 1 fills the pools; phase 2
#: brings each queue a player 100 above its first one (casual matches it,
#: ranked does not) and a casual player 10 away from a waiting ranked one
#: (the same queue would match them).
REQUESTS = [(1, RANKED, "ra", 1500.0), (1, CASUAL, "ca", 1500.0),
            (1, RANKED, "rx", 2500.0),
            (2, RANKED, "rb", 1600.0), (2, CASUAL, "cb", 1600.0),
            (2, CASUAL, "cx", 2510.0)]
#: Answers each player gets, in order.
EXPECTED = {"ra": ["queued"], "rb": ["queued"], "rx": ["queued"],
            "ca": ["queued", "matched"], "cb": ["matched"], "cx": ["queued"]}


def port_config2():
    cfg = Config.from_json(CONFIG2, backend="gpu")
    return dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine,
                                                               **SMALL))


async def serve(app, publish, props):
    """Drive ``REQUESTS`` through ``app`` phase by phase (each phase's
    answers awaited) and return every reply body by player id, in order."""
    app.broker.declare_queue("rq.mq")
    await app.start()
    bodies: dict[str, list[bytes]] = {}
    want = {pid: len(v) for pid, v in EXPECTED.items()}
    try:
        for phase in (1, 2):
            for ph, queue, pid, rating in REQUESTS:
                if ph == phase:
                    publish(queue, json.dumps({"id": pid,
                                               "rating": rating}).encode(),
                            props(reply_to="rq.mq", correlation_id=pid))
            done = {pid for ph, _, pid, _ in REQUESTS if ph <= phase}
            end = time.monotonic() + 60.0
            while time.monotonic() < end:
                d = await app.broker.get("rq.mq", timeout=0.1)
                if d is not None:
                    bodies.setdefault(d.properties.correlation_id,
                                      []).append(bytes(d.body))
                    continue
                got = {p: len(bodies.get(p, ())) for p in done}
                # ca's match arrives in phase 2.
                if all(n >= (1 if phase == 1 else want[p])
                       for p, n in got.items()):
                    break
            else:
                raise AssertionError(f"phase {phase}: answers {bodies}")
        await asyncio.sleep(0.2)  # nothing more may come
        while (d := await app.broker.get("rq.mq", timeout=0.05)) is not None:
            bodies.setdefault(d.properties.correlation_id, []).append(
                bytes(d.body))
    finally:
        await app.stop()
    return bodies


async def test_config2_serves_both_queues_each_at_its_own_threshold():
    """Both queues of config #2 are consumed and answered, each at its own
    threshold, never across queues; every answer's bytes equal the JAX
    app's on the same requests once the fields that differ by nature are
    carried over (the match id, the measured latency_ms and waited_ms) and
    the trace ids correspond one to one (both apps trace)."""
    app = MatchmakingApp(port_config2(), device="cpu")
    assert [app.runtime(n).queue_cfg.rating_threshold
            for n in (RANKED, CASUAL)] == [75.0, 150.0]
    port = await serve(app, app.broker.publish, Properties)
    assert {pid: [contract.decode_response(b).status for b in v]
            for pid, v in port.items()} == EXPECTED
    cb = contract.decode_response(port["cb"][0]).match
    assert set(cb.players) == {"ca", "cb"}
    ranked, casual = app.runtime(RANKED), app.runtime(CASUAL)
    assert ranked.engine.pool_size() == 3 and casual.engine.pool_size() == 1
    assert ranked.counters["players_matched"] == 0
    assert casual.counters["players_matched"] == 2
    assert ranked.counters["windows"] == casual.counters["windows"] == 2
    assert ranked.counters["publish_batches"] == 2
    assert casual.counters["publish_batches"] == 2
    ledger = app.quality.snapshot()["queues"]
    assert ledger[CASUAL]["matched_players"] == 2
    assert ledger.get(RANKED, {}).get("matched_players", 0) == 0
    assert app.faults() == {}

    jcfg = JaxConfig.from_json(CONFIG2)
    jcfg = dataclasses.replace(jcfg, engine=dataclasses.replace(jcfg.engine,
                                                                **SMALL))
    japp = JaxApp(jcfg)
    jax = await serve(japp, japp.broker.publish, JaxProperties)
    assert {pid: len(v) for pid, v in jax.items()} == {
        pid: len(v) for pid, v in port.items()}
    seen: dict = {}
    for pid, bodies in port.items():
        for body, jbody in zip(bodies, jax[pid]):
            mine = contract.decode_response(body)
            theirs = jax_contract.decode_response(jbody)
            match = theirs.match
            if match is not None:
                match = dataclasses.replace(match,
                                            match_id=mine.match.match_id)
            theirs = dataclasses.replace(
                theirs, match=match, latency_ms=mine.latency_ms,
                waited_ms=mine.waited_ms,
                trace_id=same_trace(seen, mine.trace_id, theirs.trace_id))
            assert body == jax_contract.encode_response(theirs), pid


async def test_demo_serves_every_queue_of_a_config():
    """``run_demo`` (what ``python -m ...service.app --demo --config`` runs)
    answers ten players on each of config #2's queues, each matched with a
    partner from its own queue."""
    answers = await run_demo(device="cpu", cfg=port_config2())
    assert len(answers) == 20
    for r in answers:
        assert r.status == "matched", r
        queue = r.player_id.split(":")[0]
        assert all(p.startswith(queue + ":") for p in r.match.players)
    assert {r.player_id.split(":")[0] for r in answers} == {RANKED, CASUAL}


def role_cfg(**engine_kw):
    """A small role queue (2v2, a tank and a dps a team), its health timer
    every 50 ms and the deadline sweep every 20 ms."""
    q = QueueConfig(name="mm.role", team_size=2, rating_threshold=100.0,
                    role_slots=("tank", "dps"))
    return Config(queues=(q,), engine=EngineConfig(
        pool_capacity=256, pool_block=64, batch_buckets=(16,),
        team_max_matches=16, health_interval_s=0.05, **engine_kw),
        overload=OverloadConfig(deadline_sweep_ms=20.0))


async def delegate_with_a_party(app, quiet_s):
    """A party (which the role step does not pack) hands the queue to the
    host oracle; it carries an ``x-deadline`` 0.1 s out, so the sweep
    answers it ``timeout`` before the quiet period ``quiet_s`` ends.
    Returns when it has expired, with the time of its arrival."""
    app.engine.TEAM_REPROMOTE_QUIET_S = quiet_s  # the instance's, not 5 s
    app.broker.declare_queue("rq.party")
    t_arrival = time.time()
    app.broker.publish("mm.role", json.dumps({
        "id": "lead", "rating": 1500, "region": "eu", "game_mode": "ranked",
        "roles": ["tank"],
        "party": [{"id": "mate", "rating": 1500, "roles": ["dps"]}]}).encode(),
        Properties(reply_to="rq.party", correlation_id="lead",
                   headers={"x-deadline": repr(t_arrival + 0.1)}))
    statuses = []
    end = time.monotonic() + 10.0
    while "timeout" not in statuses and time.monotonic() < end:
        d = await app.broker.get("rq.party", timeout=0.1)
        if d is not None:
            statuses.append(contract.decode_response(d.body).status)
    assert statuses == ["queued", "timeout"]
    assert app.engine.counters["team_delegated"] == 1
    assert app.engine.pool_size() == 0
    return t_arrival


async def await_repromotion(app, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if app.engine.counters.get("team_repromoted", 0):
            return time.time()
        await asyncio.sleep(0.005)
    raise AssertionError(f"still delegated: {app.engine.counters}, "
                         f"{app.counters}")


async def test_health_timer_repromotes_an_idle_delegated_role_queue():
    """No traffic after the party expired: only the health timer can move
    the queue back onto the device. It does so within one interval (plus
    slack for a loaded machine) of the quiet period's end, and the device
    step then forms the next match."""
    quiet = 0.3
    app = MatchmakingApp(role_cfg(), device="cpu")
    await app.start()
    try:
        assert app.queue_cfg.rescan_interval_s == 0  # no rescan ticks
        t_arrival = await delegate_with_a_party(app, quiet)
        t_back = await await_repromotion(app)
        assert t_back - (t_arrival + quiet) <= 0.05 + 0.5
        assert app.engine.counters == {"team_delegated": 1,
                                       "team_repromoted": 1}
        assert app.counters["health_repromotions"] >= 1
        assert app.engine._team_delegate is None
        assert app.engine.dev_pool is not None
        app.broker.declare_queue("rq.team")
        for pid, rating, role in (("t1", 1500, "tank"), ("d1", 1510, "dps"),
                                  ("t2", 1520, "tank"), ("d2", 1530, "dps")):
            app.broker.publish("mm.role", json.dumps({
                "id": pid, "rating": rating, "region": "eu",
                "game_mode": "ranked", "roles": [role]}).encode(),
                Properties(reply_to="rq.team", correlation_id=pid))
        matched = set()
        end = time.monotonic() + 10.0
        while len(matched) < 4 and time.monotonic() < end:
            d = await app.broker.get("rq.team", timeout=0.1)
            if d is not None and contract.decode_response(
                    d.body).status == "matched":
                matched.add(d.properties.correlation_id)
        assert matched == {"t1", "d1", "t2", "d2"}
        assert app.engine.counters["team_delegated"] == 1  # the device's
        assert app.faults() == {}
    finally:
        await app.stop()


async def test_a_failing_health_tick_is_counted_and_the_next_tick_runs():
    app = MatchmakingApp(role_cfg(), device="cpu")
    await app.start()
    try:
        await delegate_with_a_party(app, 0.2)
        eng = app.engine
        real = eng.heartbeat

        def failing(now):
            eng.heartbeat = real  # one failure, then the real heartbeat
            raise RuntimeError("injected heartbeat failure")

        eng.heartbeat = failing
        await await_repromotion(app)
        assert app.counters["health_tick_errors"] == 1
        assert app.counters["health_repromotions"] == 1
        assert app.faults() == {"health_tick_errors": 1}
    finally:
        await app.stop()


@pytest.mark.parametrize("interval", [0.0, 0.05])
async def test_health_timer_runs_only_when_configured(interval):
    """``health_interval_s`` 0 disables the timer (and so a delegated idle
    queue stays on the host oracle); > 0 starts one per queue."""
    app = MatchmakingApp(dataclasses.replace(role_cfg(), engine=(
        dataclasses.replace(role_cfg().engine, health_interval_s=interval))),
        device="cpu")
    await app.start()
    try:
        names = [t.get_coro().__name__
                 for t in app.runtime("mm.role")._loops]
        assert ("_health_loop" in names) == (interval > 0)
    finally:
        await app.stop()
