"""Overload control in the port against the JAX package, on the CPU.

- ``AdmissionController`` against the JAX one on seeded delivery streams
  (1 and 3 tiers, the equal ladder and explicit shares, both shed
  policies, drain mode, adaptive steps, window-granular and per-delivery
  decisions): every decision, the cached tier and deadline, the stamped
  headers, ``eviction_debt``, ``snapshot()`` and the ``checkpoint`` /
  ``restore_state`` round trip are equal after every operation.
- The tier and deadline header helpers against the JAX ones.
- The debt of ``shed_policy="oldest"``: the port's pick (one lexsort over
  the mirror's columns) and batched removal against the JAX service's
  ``_evict_oldest`` and ``_pay_debt_locked`` with sequential removes, on
  a pool with tied enqueue times: the same victims in the same order, and
  the same free-slot stacks after (so later windows take the same slots).
- The JAX app (``backend="tpu"`` on the CPU, tracing off) against the
  port's app (``device="cpu"``) on one seeded stream through the waiting
  cap with the "oldest" debt, 3 tiers, EDF, the credit cap, the deadline
  sweep and a request already past its deadline: every answer's bytes
  equal per correlation id (match id, latency and wait carried over), the
  shed, expired and matched sets equal, with window-granular admission
  and per delivery.
- Credits back at 0 after every settle path (replays, rejects, sheds,
  expiries, a failed window's nacks and the revive).

Each app soak publishes a burst and waits for its answers before the
next, so a window is a burst on both sides and nothing is in flight when
the next one is cut.
"""

import asyncio
import dataclasses
import json
import time
import types

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import BatcherConfig as JaxBatcherConfig
from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import ObservabilityConfig as JaxObservabilityConfig
from matchmaking_tpu.config import OverloadConfig as JaxOverloadConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service import contract as jax_contract
from matchmaking_tpu.service import overload as jax_overload
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.app import _QueueRuntime as JaxRuntime
from matchmaking_tpu.service.broker import Delivery as JaxDelivery
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    Config,
    EngineConfig,
    ObservabilityConfig,
    OverloadConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.service import contract, overload
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Delivery, Properties

torch.set_num_threads(1)

QUEUE, REPLY = "matchmaking.search", "rq.overload"
SMALL = dict(pool_capacity=1024, pool_block=256, batch_buckets=(16, 64))


# ---- the header helpers -----------------------------------------------------

HEADERS = [{}, {"x-tier": "2"}, {"x-tier": "7"}, {"x-tier": "-3"},
           {"x-tier": "1.9"}, {"x-tier": "high"}, {"x-tier": None},
           {"x-tier": 1}, {"x-deadline": "12.5"}, {"x-deadline": "soon"},
           {"x-deadline": 3}, {"x-deadline": None}, {"x-deadline": "nan"},
           {"x-tier": "0", "x-deadline": "1e9"}]


@pytest.mark.parametrize("headers", HEADERS, ids=repr)
@pytest.mark.parametrize("n_tiers,default", [(1, 0), (3, 0), (3, 2), (3, 9)])
def test_header_helpers_equal_jax(headers, n_tiers, default):
    assert overload.DEADLINE_HEADER == jax_overload.DEADLINE_HEADER
    assert overload.TIER_HEADER == jax_overload.TIER_HEADER
    assert overload.tier_of(headers, default, n_tiers) == \
        jax_overload.tier_of(headers, default, n_tiers)
    got, want = overload.deadline_of(headers), jax_overload.deadline_of(headers)
    assert (got == want) or (got != got and want != want)  # nan == nan
    mine, theirs = dict(headers), dict(headers)
    overload.stamp_deadline(mine, 100.25, 1.5)
    jax_overload.stamp_deadline(theirs, 100.25, 1.5)
    overload.stamp_tier(mine, 2)
    jax_overload.stamp_tier(theirs, 2)
    assert mine == theirs


# ---- AdmissionController ------------------------------------------------------

def _stream(seed, n, tiers):
    """Seeded (tag, headers, redelivered) rows: tiers in and out of range,
    garbled tiers, deadlines around the clock, first-receive stamps."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        headers = {}
        r = rng.random()
        if r < 0.7:
            headers["x-tier"] = str(int(rng.integers(0, tiers + 1)))
        elif r < 0.75:
            headers["x-tier"] = "garbled"
        if rng.random() < 0.3:
            headers["x-deadline"] = repr(float(100.0 + rng.uniform(-5, 40)))
        if rng.random() < 0.1:
            headers["x-first-received"] = repr(95.0)
        rows.append((i + 1, headers, bool(rng.random() < 0.1)))
    return rows


def _pair(tag, headers, redelivered, corr=""):
    mine = Delivery(body=b"", properties=Properties(
        correlation_id=corr, headers=dict(headers)), queue="q",
        delivery_tag=tag, redelivered=redelivered)
    theirs = JaxDelivery(body=b"", properties=JaxProperties(
        correlation_id=corr, headers=dict(headers)), queue="q",
        delivery_tag=tag, redelivered=redelivered)
    return mine, theirs


def _same_deliveries(mine, theirs):
    for a, b in zip(mine, theirs):
        assert (a.tier, a.deadline) == (b.tier, b.deadline)
        assert a.properties.headers == b.properties.headers


def _same_state(ac, jac, counters):
    assert ac.snapshot() == jac.snapshot()
    assert ac.checkpoint() == jac.checkpoint()
    assert ac.inflight() == jac.inflight()
    assert ac.credit_fraction == jac.credit_fraction
    assert counters.get("shed_requests", 0) == jac.shed_total
    assert counters.get("expired_requests", 0) == jac.expired_total
    if ac.tiers > 1:
        for t in range(ac.tiers):
            assert counters.get(f"shed_requests_t{t}", 0) == jac.shed_by_tier[t]


@pytest.mark.parametrize("tiers,shares", [(1, ()), (3, ()),
                                          (3, (1.0, 0.6, 0.3)), (3, (0.8,))])
@pytest.mark.parametrize("policy", ["reject", "oldest"])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("batch", [True, False])
def test_admission_controller_equals_jax(tiers, shares, policy, adaptive,
                                         batch):
    kw = dict(max_inflight=24, max_waiting=60, shed_policy=policy,
              default_deadline_ms=8000.0, tiers=tiers, tier_shares=shares,
              adaptive=adaptive, target_p99_ms=50.0, min_credit_fraction=0.25,
              tighten_step=0.5, relax_step=1.25, batch_admission=batch)
    counters: dict[str, int] = {}
    ac = overload.AdmissionController(OverloadConfig(**kw), "q", counters,
                                      default_tier=1)
    jac = jax_overload.AdmissionController(JaxOverloadConfig(**kw), "q",
                                           default_tier=1)
    rng = np.random.default_rng(7 + tiers)
    rows = _stream(11 * tiers + len(shares), 400, tiers)
    held: list[int] = []
    now = 100.0
    for step in range(0, len(rows), 16):
        now += 0.5
        if step == 320:
            ac.begin_drain()
            jac.begin_drain()
        pairs = [_pair(*r) for r in rows[step:step + 16]]
        mine = [p[0] for p in pairs]
        theirs = [p[1] for p in pairs]
        pool = int(rng.integers(0, 90))
        split = rng.multinomial(pool, [0.3, 0.3, 0.4])
        pool_tiers = (None if tiers == 1 or rng.random() < 0.2
                      else [int(x) for x in split])
        if batch:
            pre = ac.pre_decide_batch(mine, now)
            assert pre == jac.pre_decide_batch(theirs, now)
            keep = [i for i, d in enumerate(pre) if d == overload.ADMIT]
            got = ac.decide_batch([mine[i] for i in keep], now, pool,
                                  pool_tiers)
            want = jac.decide_batch([theirs[i] for i in keep], now, pool,
                                    pool_tiers)
            assert got == want
            held += [mine[i].delivery_tag for i, d in zip(keep, got)
                     if d == overload.ADMIT]
        else:
            for a, b in zip(mine, theirs):
                got = ac.decide(a, now, pool, pool_tiers)
                assert got == jac.decide(b, now, pool, pool_tiers)
                if got == overload.ADMIT:
                    ac.admit(a.delivery_tag, a.tier)
                    jac.admit(b.delivery_tag, b.tier)
                    held.append(a.delivery_tag)
                elif got == overload.SHED:
                    ac.record_shed(tier=a.tier)
                    jac.record_shed("", tier=b.tier)
                else:
                    ac.record_expired(tier=a.tier)
                    jac.record_expired("", tier=b.tier)
        _same_deliveries(mine, theirs)
        # Settle some credits (twice for some: release is idempotent).
        for tag in [t for t in held if rng.random() < 0.6]:
            ac.release(tag)
            jac.release(tag)
            if rng.random() < 0.2:
                ac.release(tag)
                jac.release(tag)
            held.remove(tag)
        n_in = int(rng.integers(0, 64))
        assert ac.eviction_debt(n_in, pool) == jac.eviction_debt(n_in, pool)
        fill, frac = float(rng.random() * 1.2), float(rng.random() * 1.3)
        p99 = None if rng.random() < 0.5 else float(rng.random() * 0.2)
        ac.observe_window(fill, frac, p99)
        jac.observe_window(fill, frac, p99)
        if step % 96 == 48:
            f = float(rng.random())
            assert ac.set_fraction(f) == jac.set_fraction(f)
        _same_state(ac, jac, counters)
    # A successor restores the checkpoint and decides as the original.
    ac2 = overload.AdmissionController(OverloadConfig(**kw), "q", {},
                                       default_tier=1)
    jac2 = jax_overload.AdmissionController(JaxOverloadConfig(**kw), "q",
                                            default_tier=1)
    ac2.restore_state(ac.checkpoint())
    jac2.restore_state(jac.checkpoint())
    assert ac2.snapshot() == jac2.snapshot()
    assert ac2.checkpoint() == ac.checkpoint()
    ac2.restore_state({"credit_fraction": "x", "shed_by_tier": [-1, "y"]})
    jac2.restore_state({"credit_fraction": "x", "shed_by_tier": [-1, "y"]})
    assert ac2.snapshot() == jac2.snapshot()


# ---- the debt pick and the batched removal -----------------------------------

def _debt_pool(seed, n, tiers, band_spec=""):
    """Waiting requests with tied enqueue times (eight distinct stamps)."""
    rng = np.random.default_rng(seed)
    return [contract.SearchRequest(
        id=f"w{i}", rating=float(rng.normal(1500, 300)),
        enqueued_at=50.0 + float(rng.integers(0, 8)),
        tier=int(rng.integers(0, tiers)),
        reply_to="rq", correlation_id=f"w{i}") for i in range(n)]


def _engines(band_spec, waiting):
    """A JAX TpuEngine and a port GpuEngine on the CPU with the same pool,
    restored from the same requests."""
    eng_kw = dict(SMALL, band_spec=band_spec)
    mine = GpuEngine(Config(engine=EngineConfig(**eng_kw)), QueueConfig(),
                     device="cpu")
    theirs = TpuEngine(JaxConfig(engine=JaxEngineConfig(backend="tpu",
                                                        **eng_kw)),
                       JaxQueueConfig())
    mine.restore(waiting, 60.0)
    theirs.restore([jax_contract.SearchRequest(**dataclasses.asdict(r))
                    for r in waiting], 60.0)
    return mine, theirs


def _free_stacks(pool):
    if getattr(pool, "_band_edges", None) is not None:
        return [b[:h].tolist() for b, h in zip(pool._band_free,
                                              pool._band_head)]
    return pool._free[:pool._head].tolist()


def _port_runtime(tiers, engine):
    cfg = Config(engine=EngineConfig(**SMALL, pipeline_depth=1),
                 overload=OverloadConfig(max_waiting=100, tiers=tiers,
                                         shed_policy="oldest"))
    rt = MatchmakingApp(cfg, device="cpu").runtime(QUEUE)
    rt.engine = engine
    sent = []
    rt._publish = lambda reply, corr, body, trace=None: sent.append(
        (corr, body))
    rt._ack = lambda d: sent.append(("ack", d.delivery_tag))
    return rt, sent


def _jax_stub(tiers, engine, sent):
    cfg = JaxConfig(overload=JaxOverloadConfig(max_waiting=100, tiers=tiers,
                                               shed_policy="oldest"))
    stub = types.SimpleNamespace(
        engine=engine, app=types.SimpleNamespace(cfg=cfg),
        admission=jax_overload.AdmissionController(cfg.overload, QUEUE))
    stub._remove_ids = lambda ids: JaxRuntime._remove_ids(stub, ids)
    stub._evict_oldest = lambda k, now: JaxRuntime._evict_oldest(stub, k, now)
    stub._publish_shed_evictions = lambda ev, now: sent.extend(
        (r.correlation_id, r.id) for r in ev)
    stub._respond_raw = lambda reply, corr, resp, trace=None: sent.append(
        (corr, jax_contract.encode_response(resp)))
    stub._ack = lambda d: sent.append(("ack", d.delivery_tag))
    return stub


@pytest.mark.parametrize("band_spec", ["", "gaussian:1500:300"])
@pytest.mark.parametrize("tiers", [1, 3])
def test_debt_pick_and_batched_removal_equal_jax(band_spec, tiers):
    waiting = _debt_pool(3, 300, tiers)
    mine, theirs = _engines(band_spec, waiting)
    assert _free_stacks(mine.pool) == _free_stacks(theirs.pool)
    # The window entering: 40 requests, tied enqueue times too.
    entering = []
    for j, r in enumerate(_debt_pool(4, 40, tiers)):
        pid = f"e{j}"
        d_mine, d_theirs = _pair(1000 + j, {}, False, corr=pid)
        d_mine.tier = d_theirs.tier = r.tier
        entering.append((pid, r.tier, r.enqueued_at, d_mine, d_theirs))
    rt, sent = _port_runtime(tiers, mine)
    jsent: list = []
    stub = _jax_stub(tiers, theirs, jsent)
    debt = 57
    drop = rt._pay_debt([e[:4] for e in entering], debt, 70.0)
    jdrop = asyncio.run(JaxRuntime._pay_debt_locked(
        stub, [(e[0], e[1], e[2], e[4]) for e in entering], debt, 70.0))
    assert drop == jdrop
    if tiers == 1:
        assert not drop
    # The pool's victims, evicted in the same order; the window's shed.
    evicted_mine = [c for c, _ in sent if c != "ack" and c.startswith("w")]
    evicted_jax = [c for c, _ in jsent if c != "ack" and c.startswith("w")]
    assert evicted_mine == evicted_jax and len(evicted_mine) + len(drop) == debt
    shed_mine = [(c, b) for c, b in sent if c != "ack" and not c.startswith("w")]
    shed_jax = [(c, b) for c, b in jsent if c != "ack" and not c.startswith("w")]
    assert shed_mine == shed_jax
    assert [r.id for r in mine.waiting()] == [r.id for r in theirs.waiting()]
    assert _free_stacks(mine.pool) == _free_stacks(theirs.pool)
    assert mine.pool_tier_counts(tiers) == theirs.pool_tier_counts(tiers)
    # The next admissions take the same slots.
    more = _debt_pool(5, 30, tiers)
    mine.restore(more, 80.0)
    theirs.restore([jax_contract.SearchRequest(**dataclasses.asdict(r))
                    for r in more], 80.0)
    assert {r.id: mine.pool.slot_of(r.id) for r in more} == {
        r.id: theirs.pool.slot_of(r.id) for r in more}
    assert np.array_equal(mine.pool.m_tier, theirs.pool.m_tier)


# ---- the service against the JAX app ---------------------------------------

OVERLOAD = dict(max_inflight=48, max_waiting=40, shed_policy="oldest",
                retry_after_ms=750.0, tiers=3, edf=True,
                deadline_sweep_ms=20.0)
BURST = 64


def _bursts(seed=21, n_bursts=6):
    """Seeded bursts of (correlation id, body, headers). Tiered and
    untiered rows (the queue's default tier is 1), deadlines far ahead
    (they order the EDF cut), one request already past its deadline, and
    in the last burst one player far from everyone with a deadline 4 s
    ahead, which the sweep must expire."""
    rng = np.random.default_rng(seed)
    bursts = []
    k = 0
    for b in range(n_bursts):
        rows = []
        for _ in range(BURST):
            headers = {}
            if rng.random() < 0.8:
                headers["x-tier"] = str(int(rng.integers(0, 3)))
            if rng.random() < 0.3:
                headers["x-deadline"] = repr(2e9 + float(rng.uniform(0, 100)))
            body = json.dumps({"id": f"p{k}", "rating": round(
                float(rng.normal(1500, 400)), 2)}).encode()
            rows.append((f"c{k}", body, headers))
            k += 1
        bursts.append(rows)
    bursts[2][5] = ("late", json.dumps({"id": "late", "rating": 1500.0})
                    .encode(), {"x-tier": "0", "x-deadline": repr(1.0)})
    bursts[-1][0] = ("lone", json.dumps({"id": "lone", "rating": 9000.0})
                     .encode(), {"x-tier": "0", "x-deadline": None})
    return bursts


async def _serve(app, props, bursts):
    """Publish each burst once the previous one is answered; returns every
    answer's body by correlation id, in order, and the runtime."""
    app.broker.declare_queue(REPLY)
    await app.start()
    answers: dict[str, list[bytes]] = {}
    try:
        for rows in bursts:
            for corr, body, headers in rows:
                headers = dict(headers)
                if corr == "lone":
                    # matchlint: ignore[determinism] x-deadline is wall-clock epoch seconds by the wire contract
                    headers["x-deadline"] = repr(time.time() + 4.0)
                app.broker.publish(QUEUE, body, props(
                    reply_to=REPLY, correlation_id=corr, headers=headers))
            corrs = {c for c, _, _ in rows}
            end = time.monotonic() + 60.0
            while time.monotonic() < end:
                d = await app.broker.get(REPLY, timeout=0.05)
                if d is not None:
                    answers.setdefault(d.properties.correlation_id,
                                       []).append(bytes(d.body))
                elif corrs <= set(answers) and (
                        "lone" not in corrs or len(answers["lone"]) == 2):
                    break
            else:
                raise AssertionError(f"unanswered: {corrs - set(answers)}")
        while (d := await app.broker.get(REPLY, timeout=0.2)) is not None:
            answers.setdefault(d.properties.correlation_id, []).append(
                bytes(d.body))
    finally:
        await app.stop()
    return answers


def _port_app(batch):
    cfg = Config(queues=(QueueConfig(default_tier=1),),
                 engine=EngineConfig(**SMALL),
                 batcher=BatcherConfig(max_batch=BURST, max_wait_ms=250.0),
                 overload=OverloadConfig(**OVERLOAD, batch_admission=batch),
                 observability=ObservabilityConfig(trace=False))
    return MatchmakingApp(cfg, device="cpu")


def _jax_app(batch):
    cfg = JaxConfig(queues=(JaxQueueConfig(default_tier=1),),
                    engine=JaxEngineConfig(backend="tpu", **SMALL),
                    batcher=JaxBatcherConfig(max_batch=BURST,
                                             max_wait_ms=250.0),
                    overload=JaxOverloadConfig(**OVERLOAD,
                                               batch_admission=batch),
                    observability=JaxObservabilityConfig(trace=False))
    return JaxApp(cfg)


def _statuses(answers, status):
    return {c for c, bodies in answers.items() for b in bodies
            if json.loads(b)["status"] == status}


@pytest.mark.parametrize("batch", [True, False])
def test_service_answers_equal_jax_app_under_overload(batch):
    """Both apps on the same bursts: every answer's bytes equal (the match
    id, latency_ms and waited_ms carried over from the port's answer), so
    the same requests are shed (by the credit cap, the waiting cap and
    the debt, with their tiers), expired (at receive and by the sweep),
    queued and matched, to the same partners."""
    from test_torch_sanitizer import port_sanitized

    bursts = _bursts()
    # The port's soak under the port's sanitizer, every check on, as the
    # JAX twin (tests/test_overload.py) runs under JAX's.
    with port_sanitized():
        app = _port_app(batch)
        port = asyncio.run(_serve(app, Properties, bursts))
    rt = app.runtime(QUEUE)
    assert rt.admission.inflight() == 0
    assert app.faults() == {}
    jax = asyncio.run(_serve(_jax_app(batch), JaxProperties, bursts))
    assert {c: len(v) for c, v in port.items()} == {
        c: len(v) for c, v in jax.items()}
    for corr, bodies in port.items():
        for body, jbody in zip(bodies, jax[corr]):
            mine = contract.decode_response(body)
            theirs = jax_contract.decode_response(jbody)
            match = theirs.match
            if match is not None:
                match = dataclasses.replace(match,
                                            match_id=mine.match.match_id)
            theirs = dataclasses.replace(
                theirs, match=match, latency_ms=mine.latency_ms,
                waited_ms=mine.waited_ms, trace_id="")
            assert body == jax_contract.encode_response(theirs), corr
    for status in ("shed", "timeout", "matched", "queued"):
        assert _statuses(port, status) == _statuses(jax, status), status
    # Every path ran: credit and cap sheds at the cut, pool evictions and
    # entrants shed by the debt, the expired-at-receive request, the
    # sweep's expiry, real matches.
    shed = [json.loads(b) for bodies in port.values() for b in bodies
            if json.loads(b)["status"] == "shed"]
    assert any(s["player_id"] == "" for s in shed)
    assert any(s["player_id"] != "" for s in shed)
    assert {s["tier"] for s in shed} <= {0, 1, 2}
    assert json.loads(port["late"][0]) == {
        "status": "timeout", "player_id": "", "latency_ms": 0.0, "tier": 0}
    assert [json.loads(b)["status"] for b in port["lone"]] == [
        "queued", "timeout"]
    assert _statuses(port, "matched")
    assert sum(rt.admission.shed_by_tier) == rt.counters["shed_requests"] \
        == len(shed)
    assert rt.admission.expired_total == 2


async def test_credits_return_on_every_settle_path():
    """With the credit cap on, every settle returns its credit: matched,
    queued, a malformed row, a terminal replay, a shed, an expired
    request and a window that failed on the device (nacked, then
    redelivered once the engine was revived)."""
    cfg = Config(engine=EngineConfig(**SMALL),
                 batcher=BatcherConfig(max_batch=16, max_wait_ms=20.0),
                 overload=OverloadConfig(max_inflight=6, tiers=2))
    app = MatchmakingApp(cfg, device="cpu")
    app.broker.declare_queue(REPLY)
    await app.start()
    rt = app.runtime(QUEUE)
    got: dict[str, list[str]] = {}

    def publish(corr, player, headers=None):
        body = player if isinstance(player, bytes) else json.dumps(
            player).encode()
        app.broker.publish(QUEUE, body, Properties(
            reply_to=REPLY, correlation_id=corr, headers=headers or {}))

    async def settle(corrs):
        end = time.monotonic() + 20.0
        while time.monotonic() < end and not set(corrs) <= set(got):
            d = await app.broker.get(REPLY, timeout=0.05)
            if d is not None:
                got.setdefault(d.properties.correlation_id, []).append(
                    json.loads(d.body)["status"])
        await asyncio.sleep(0.1)
        assert set(corrs) <= set(got), set(corrs) - set(got)

    try:
        for i in range(4):
            publish(f"m{i}", {"id": f"m{i}", "rating": 1500 + i})
        publish("bad", b"{not json")
        publish("old", {"id": "old", "rating": 1}, {"x-deadline": "1.0"})
        await settle(["m0", "m1", "m2", "m3", "bad", "old"])
        assert got["m0"] == ["matched"] and got["bad"] == ["error"]
        assert got["old"] == ["timeout"]
        assert rt.admission.inflight() == 0
        # A replay of an answered player, and more than the cap of tier 0
        # (6 credits) in one window: the tail is shed.
        publish("again", {"id": "m0", "rating": 1500})
        for i in range(10):
            publish(f"x{i}", {"id": f"x{i}", "rating": 3000 + 500 * i})
        await settle(["again"] + [f"x{i}" for i in range(10)])
        assert got["again"] == ["matched"]
        assert [got[f"x{i}"] for i in range(10)] == (
            [["queued"]] * 5 + [["shed"]] * 5)
        assert rt.admission.inflight() == 0
        # The next window fails on "the device": nacked, the engine
        # revived, the redelivery answered.
        old = rt.engine
        real = old._fetch

        def failing(pending):
            pending.error = RuntimeError("CUDA error: injected")
            old._fetch = real

        old._fetch = failing
        publish("f", {"id": "f", "rating": 9000})
        end = time.monotonic() + 20.0
        while time.monotonic() < end and rt.counters["revives"] == 0:
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.3)  # the redelivery's window
        assert rt.counters["revives"] == 1 and rt.engine is not old
        # The mirror carried f into the new engine, so the redelivered
        # copy was absorbed there (and settled).
        assert "f" in {r.id for r in rt.engine.waiting()}
        assert rt.admission.inflight() == 0
    finally:
        await app.stop()
    assert rt.admission.inflight() == 0
