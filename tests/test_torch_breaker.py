"""The circuit breaker, the chaos hook and the engine's probe and close in
the port, against the JAX package, on the CPU.

- ``CircuitBreaker`` and ``EngineChaosHook`` take the same call sequences
  as the JAX ones (``tests/test_breaker.py``'s cases, and seeded ones):
  the same states, returns, delays, snapshots and failing indices.
- The JAX crash storm (``tests/test_chaos.py``: the first 3 device steps
  fail, so does the first half-open probe; 32 players, then 8) through the
  port's app and the JAX app: the same transcript (matched pairs, acks,
  crash, trip, probe and degraded-revive counts, chaos steps consumed).
- The port's demotion and re-promotion with players waiting: the oracle
  gets the whole pool, the probe's engine gets the oracle's, every player
  is answered once, the quality counters never go down.
- ``GpuEngine.probe()`` leaves the pool, the bucket index, the quality
  state and the prune and formation reports bit-equal; a step the chaos
  hook fails leaves the mirror and the device pool bit-equal; ``close()``
  drops the device state; ``make_engine(backend="cpu")`` is the oracle.
- The config keys: breaker and chaos keys load (nested lists as tuples),
  values that need a later slice are refused, the broker and network
  fault keys are ignored.
"""

import asyncio
import dataclasses
import json
import logging
import time

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import BatcherConfig as JaxBatcherConfig
from matchmaking_tpu.config import ChaosConfig as JaxChaosConfig
from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.service import breaker as jax_breaker
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.utils import chaos as jax_chaos
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    ChaosConfig,
    Config,
    EngineConfig,
    OverloadConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.engine import kernels
from matchmaking_tpu_torch.engine.cpu import CpuEngine
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.engine.interface import make_engine
from matchmaking_tpu_torch.service import breaker
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.service.contract import RequestColumns, SearchRequest
from matchmaking_tpu_torch.utils import chaos

torch.set_num_threads(1)


# ---- CircuitBreaker ---------------------------------------------------------

BREAKER_KW = [dict(threshold=0), dict(threshold=3, window_s=10.0),
              dict(threshold=1, initial=1.0, backoff=2.0, max_s=3.0),
              dict(threshold=2, window_s=5.0, initial=0.25, backoff=3.0,
                   max_s=60.0)]


def _breakers(threshold=3, window_s=10.0, initial=1.0, backoff=2.0,
              max_s=8.0):
    kw = dict(breaker_threshold=threshold, breaker_window_s=window_s,
              breaker_probe_initial_s=initial, breaker_probe_backoff=backoff,
              breaker_probe_max_s=max_s)
    return (breaker.CircuitBreaker(EngineConfig(**kw)),
            jax_breaker.CircuitBreaker(JaxEngineConfig(**kw)))


#: tests/test_breaker.py's call sequences: (op, time).
SCRIPTS = {
    "disabled": [("crash", float(t)) for t in range(20)],
    "trip_on_nth": [("crash", 0.0), ("crash", 1.0), ("crash", 2.0)],
    "window_slides": [("crash", 0.0), ("crash", 1.0), ("crash", 11.5),
                      ("crash", 12.0), ("crash", 12.5)],
    "no_retrip_while_open": [("crash", 0.0), ("crash", 0.5), ("crash", 0.6)],
    "backoff_and_cap": [("crash", 0.0), ("due", 0.5), ("due", 1.0),
                        ("begin", 1.0), ("failed", 1.1), ("due", 3.0),
                        ("due", 3.1), ("begin", 3.1), ("failed", 3.2),
                        ("begin", 6.2), ("failed", 6.3)],
    "success_closes": [("crash", 0.0), ("begin", 1.0), ("failed", 1.0),
                       ("begin", 3.0), ("succeeded", 3.5), ("crash", 10.0),
                       ("crash", 10.1), ("crash", 10.2)],
}


def _seeded_script(seed, n=200):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n):
        t += float(rng.exponential(0.7))
        out.append((str(rng.choice(["crash", "crash", "due", "probe"])), t))
    return out


def _apply(b, op, t):
    if op == "crash":
        return b.record_crash(t)
    if op == "due":
        return b.probe_due(t)
    if op == "probe":  # the runtime's sequence: due → begin → outcome
        if not b.probe_due(t):
            return None
        b.begin_probe(t)
        if int(t * 1000) % 3:
            b.probe_failed(t + 0.01)
            return "failed"
        b.probe_succeeded(t + 0.01)
        return "ok"
    getattr(b, {"begin": "begin_probe", "failed": "probe_failed",
                "succeeded": "probe_succeeded"}[op])(t)
    return op


def _state(b):
    return (b.state, b.trips, b.probes, b.probe_failures, b.probe_delay_s,
            b.next_probe_at, b.opened_at, b.time_degraded_s, b.enabled,
            list(b._crashes))


@pytest.mark.parametrize("kw", BREAKER_KW, ids=lambda k: str(k["threshold"]))
@pytest.mark.parametrize("script", [*SCRIPTS, "seeded1", "seeded2"])
def test_breaker_equals_jax(kw, script):
    mine, theirs = _breakers(**kw)
    steps = (SCRIPTS[script] if script in SCRIPTS
             else _seeded_script(int(script[-1])))
    for op, t in steps:
        if op in ("begin", "failed", "succeeded"):
            want = {"begin": breaker.OPEN, "failed": breaker.HALF_OPEN,
                    "succeeded": breaker.HALF_OPEN}[op]
            if theirs.state != want:
                continue  # not a legal step for this breaker
        assert _apply(mine, op, t) == _apply(theirs, op, t), (op, t)
        assert _state(mine) == _state(theirs)
        assert mine.snapshot(t + 1.0) == theirs.snapshot(t + 1.0)
        assert mine.snapshot() == theirs.snapshot()
    assert breaker.STATE_CODE == jax_breaker.STATE_CODE
    assert (breaker.CLOSED, breaker.OPEN, breaker.HALF_OPEN) == (
        jax_breaker.CLOSED, jax_breaker.OPEN, jax_breaker.HALF_OPEN)


# ---- EngineChaosHook ----------------------------------------------------------

HOOKS = [dict(fail_steps=(1,), fail_step_ranges=((3, 5),)),
         dict(fail_probes=2, fail_steps=(0,)),
         dict(fail_step_ranges=((0, 3), (7, 9)), fail_probes=1),
         dict()]


def _outcome(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kw", HOOKS, ids=repr)
def test_chaos_hook_equals_jax(kw):
    mine = chaos.EngineChaosHook(ChaosConfig(**kw), "mm.q")
    theirs = jax_chaos.EngineChaosHook(JaxChaosConfig(**kw), "mm.q")
    rng = np.random.default_rng(len(kw))
    for _ in range(40):
        if rng.random() < 0.7:
            got, want = _outcome(mine.on_step), _outcome(theirs.on_step)
        else:
            got, want = _outcome(mine.on_probe), _outcome(theirs.on_probe)
        assert got == want
        assert (mine.steps, mine.probes) == (theirs.steps, theirs.probes)
    st = chaos.ChaosState(ChaosConfig(queues=("mm.q",), **kw))
    jst = jax_chaos.ChaosState(JaxChaosConfig(queues=("mm.q",), **kw))
    for q in ("mm.q", "other.q"):
        assert st.applies(q) == jst.applies(q)
    assert st.engine_hook("mm.q") is st.engine_hook("mm.q")
    assert ChaosConfig(**kw).enabled() == JaxChaosConfig(**kw).enabled()


# ---- the crash storm, through both apps --------------------------------------

def _storm_cfgs():
    q = dict(name="mm.chaos", rating_threshold=100.0, send_queued_ack=False)
    eng = dict(pool_capacity=64, pool_block=32, batch_buckets=(32,),
               pipeline_depth=2, breaker_threshold=3, breaker_window_s=60.0,
               breaker_probe_initial_s=0.15, breaker_probe_backoff=2.0,
               breaker_probe_max_s=2.0, health_interval_s=0.05)
    ch = dict(seed=1234, queues=(q["name"],), fail_step_ranges=((0, 3),),
              fail_probes=1)
    port = Config(queues=(QueueConfig(**q),),
                  engine=EngineConfig(backend="gpu", **eng),
                  batcher=BatcherConfig(max_batch=32, max_wait_ms=2.0),
                  chaos=ChaosConfig(**ch))
    jax = JaxConfig(queues=(JaxQueueConfig(**q),),
                    engine=JaxEngineConfig(backend="tpu", **eng),
                    batcher=JaxBatcherConfig(max_batch=32, max_wait_ms=2.0),
                    chaos=JaxChaosConfig(**ch))
    return port, jax


async def _crash_storm(app, props, count):
    """tests/test_chaos.py's storm; ``count(name)`` reads a counter."""
    q, reply = "mm.chaos", "chaos.replies"
    app.broker.declare_queue(q)
    app.broker.declare_queue(reply)
    n = 32
    for i in range(n):
        app.broker.publish(q, f'{{"id":"p{i}","rating":1500}}'.encode(),
                           props(reply_to=reply, correlation_id=f"c{i}"))
    await app.start()
    rt = app.runtime(q)
    try:
        for _ in range(400):
            await asyncio.sleep(0.05)
            if count("players_matched") >= n:
                break
        assert count("players_matched") == n
        for _ in range(400):
            await asyncio.sleep(0.05)
            if rt.breaker.state == breaker.CLOSED and rt.breaker.trips == 1:
                break
        assert rt.breaker.state == breaker.CLOSED
        assert hasattr(rt.engine, "search_columns_async")
        for j, i in enumerate(range(n, n + 8)):
            rating = 1000 + (j // 2) * 300 + (j % 2)
            app.broker.publish(q, f'{{"id":"p{i}","rating":{rating}}}'.encode(),
                               props(reply_to=reply, correlation_id=f"c{i}"))
        for _ in range(400):
            await asyncio.sleep(0.05)
            if count("players_matched") >= n + 8:
                break
        replies = []
        while (d := await app.broker.get(reply, timeout=0.05)) is not None:
            replies.append(json.loads(d.body))
        stats = app.broker.stats
        assert stats["dead_lettered"] == 0 and stats["consumer_errors"] == 0
        return {
            "pairs": sorted({tuple(sorted(r["match"]["players"]))
                             for r in replies if r["status"] == "matched"}),
            "answers": len(replies),
            "acked": stats["acked"],
            "crashes": count("engine_crashes"),
            "trips": count("breaker_trips"),
            "probes": count("breaker_probes"),
            "probe_failures": count("breaker_probe_failures"),
            "degraded_revives": count("breaker_degraded_revives"),
            "chaos_steps": app.chaos.engine_hook(q).steps,
        }
    finally:
        await app.stop()


def test_crash_storm_transcript_equals_jax_app():
    from test_torch_sanitizer import port_sanitized

    port_cfg, jax_cfg = _storm_cfgs()
    # The port's storm under the port's sanitizer, every check on, as the
    # JAX twin (tests/test_chaos.py) runs under JAX's.
    with port_sanitized():
        app = MatchmakingApp(port_cfg, device="cpu")
        mine = asyncio.run(_crash_storm(app, Properties,
                                        lambda k: app.counters.get(k, 0)))
    japp = JaxApp(jax_cfg)
    theirs = asyncio.run(_crash_storm(
        japp, JaxProperties, lambda k: japp.metrics.counters.get(k) or 0))
    assert mine == theirs
    assert len(mine["pairs"]) == 20 and mine["answers"] == 40
    assert sorted(p for pair in mine["pairs"] for p in pair) == sorted(
        f"p{i}" for i in range(40))
    assert (mine["crashes"], mine["trips"], mine["probes"],
            mine["probe_failures"], mine["degraded_revives"],
            mine["chaos_steps"]) == (3, 1, 2, 1, 1, 4)
    assert app.counters["breaker_closes"] == 1


async def test_demotion_and_repromotion_move_the_pool():
    """Phase 7 of chip_smoke.py at a CPU size: 300 waiting, two failed
    windows trip the breaker (threshold 2), the oracle takes the whole
    pool and answers the 8 requests, the first probe fails, the second
    moves the oracle's pool onto a fresh device engine, and 64 more
    requests are answered there. The counters are the script's, every
    request is answered once, the quality counters never go down."""
    cfg = Config(
        engine=EngineConfig(pool_capacity=1024, pool_block=256,
                            batch_buckets=(16, 64), breaker_threshold=2,
                            breaker_window_s=30.0,
                            breaker_probe_initial_s=0.25,
                            breaker_probe_backoff=2.0,
                            breaker_probe_max_s=60.0, health_interval_s=0.05),
        batcher=BatcherConfig(max_batch=64, max_wait_ms=5.0),
        chaos=ChaosConfig(fail_step_ranges=((0, 2),), fail_probes=1))
    app = MatchmakingApp(cfg, device="cpu")
    reply = "rq.breaker"
    app.broker.declare_queue(reply)
    await app.start()
    rt = app.runtime(app.queue_cfg.name)
    rng = np.random.default_rng(5)
    n = 300
    now = time.time()
    waiting = [SearchRequest(id=f"w{i}", rating=float(rng.normal(1500, 300)),
                             enqueued_at=now - float(rng.uniform(0, 20)),
                             reply_to=reply, correlation_id=f"w{i}")
               for i in range(n)]
    app.restore(waiting, now)
    answers: dict[str, list[str]] = {}
    quality_counts = []

    def quality_count():
        q = rt.engine.quality_checkpoint()
        return 0 if q is None else int(q["count"].sum())

    async def pump(pred, timeout=20.0):
        end = time.monotonic() + timeout
        while time.monotonic() < end and not pred():
            d = await app.broker.get(reply, timeout=0.02)
            if d is not None:
                answers.setdefault(d.properties.correlation_id, []).append(
                    json.loads(d.body)["status"])
            quality_counts.append(quality_count())
        assert pred()

    try:
        engines = [rt.engine]
        for i in range(8):
            app.broker.publish(app.queue_cfg.name, json.dumps(
                {"id": f"a{i}", "rating": float(rng.normal(1500, 300))})
                .encode(), Properties(reply_to=reply, correlation_id=f"a{i}"))
        await pump(lambda: all(f"a{i}" in answers for i in range(8)))
        assert isinstance(rt.engine, CpuEngine)
        assert rt.counters["engine_crashes"] == 2
        assert rt.counters["breaker_trips"] == 1
        # No traffic until the probe: the oracle's pool is what moves.
        oracle_ids = [r.id for r in rt.engine.waiting()]
        assert len(oracle_ids) >= n - 8
        await pump(lambda: rt.breaker.state == breaker.CLOSED, timeout=10.0)
        assert isinstance(rt.engine, GpuEngine)
        engines.append(rt.engine)
        assert sorted(r.id for r in rt.engine.waiting()) == sorted(oracle_ids)
        assert rt.last_probe["moved"] == len(oracle_ids)
        assert set(rt.last_probe) == {"build_ms", "probe_ms", "move_ms",
                                      "moved"}
        for i in range(64):
            app.broker.publish(app.queue_cfg.name, json.dumps(
                {"id": f"b{i}", "rating": float(rng.normal(1500, 300))})
                .encode(), Properties(reply_to=reply, correlation_id=f"b{i}"))
        await pump(lambda: all(f"b{i}" in answers for i in range(64)))
        await asyncio.sleep(0.2)
    finally:
        await app.stop()
    c = rt.counters
    assert (c["engine_crashes"], c["breaker_trips"], c["breaker_probes"],
            c["breaker_probe_failures"], c["breaker_closes"],
            c["breaker_degraded_revives"]) == (2, 1, 2, 1, 1, 1)
    assert app.chaos.engine_hook(app.queue_cfg.name).steps >= 3
    while (d := await app.broker.get(reply, timeout=0.05)) is not None:
        answers.setdefault(d.properties.correlation_id, []).append(
            json.loads(d.body)["status"])
    for corr, seq in answers.items():
        assert seq in (["matched"], ["queued"], ["queued", "matched"]), (
            corr, seq)
    assert all(np.diff(quality_counts) >= 0)
    assert rt.engine.dev_pool is not None and engines[0].dev_pool is None


async def test_a_window_failed_at_collection_trips_and_the_queue_reroutes():
    """A window that fails on the device when it is collected (not at its
    dispatch) is a crash too: with threshold 1 it trips the breaker, the
    revive before the next dispatch builds the host oracle, and the
    window whose flush found it there is nacked, not dispatched, so its
    redelivery takes the object path. The failed window's player is in
    the mirror, so the oracle holds it, and a partner matches it there."""
    cfg = Config(engine=EngineConfig(pool_capacity=1024, pool_block=256,
                                     batch_buckets=(16, 64),
                                     breaker_threshold=1,
                                     health_interval_s=0.0),
                 batcher=BatcherConfig(max_batch=16, max_wait_ms=5.0))
    app = MatchmakingApp(cfg, device="cpu")
    reply = "rq.collect"
    app.broker.declare_queue(reply)
    await app.start()
    rt = app.runtime(app.queue_cfg.name)
    got: dict[str, list[str]] = {}

    def publish(pid, rating):
        app.broker.publish(app.queue_cfg.name, json.dumps(
            {"id": pid, "rating": rating}).encode(),
            Properties(reply_to=reply, correlation_id=pid))

    async def pump(pred):
        end = time.monotonic() + 10.0
        while time.monotonic() < end and not pred():
            d = await app.broker.get(reply, timeout=0.02)
            if d is not None:
                got.setdefault(d.properties.correlation_id, []).append(
                    json.loads(d.body)["status"])
        assert pred()

    try:
        for i in range(3):
            publish(f"a{i}", 1000.0 * i)
        await pump(lambda: len(got) == 3)
        old = rt.engine
        real = old._fetch

        def failing(pending):
            pending.error = RuntimeError("CUDA error: injected")
            old._fetch = real

        old._fetch = failing
        publish("b", 5000.0)
        await pump(lambda: isinstance(rt.engine, CpuEngine))
        assert rt.breaker.state == breaker.OPEN
        assert rt.counters["engine_crashes"] == 1
        assert rt.counters["breaker_degraded_revives"] == 1
        await asyncio.sleep(0.2)  # the redelivery, absorbed by the oracle
        assert {r.id for r in rt.engine.waiting()} == {"a0", "a1", "a2", "b"}
        assert old.dev_pool is None  # closed
        publish("c", 5001.0)
        await pump(lambda: "matched" in got.get("b", []))
        assert got["c"] == ["matched"]
    finally:
        await app.stop()
    assert rt.counters["engine_crashes"] == 1


# ---- the engine: probe, chaos step, close ------------------------------------

VARIANTS = {
    "dense": {},
    "pruned": dict(band_spec="gaussian:1500:300", prune_window_blocks=2,
                   prune_chunk=16),
    "bucketed": dict(band_spec="gaussian:1500:300", bucketed=True,
                     prune_window_blocks=2, prune_chunk=16),
}


def _engine(variant, hook=None):
    cfg = Config(engine=EngineConfig(pool_capacity=1024, pool_block=128,
                                     batch_buckets=(16, 64),
                                     **VARIANTS[variant]))
    eng = GpuEngine(cfg, QueueConfig(), device="cpu")
    rng = np.random.default_rng(9)
    n = 400
    cols = RequestColumns(
        ids=np.array([f"p{i}" for i in range(n)], object),
        rating=rng.normal(1500, 300, n).astype(np.float32),
        rd=np.full(n, 50.0, np.float32), region=np.zeros(n, np.int32),
        mode=np.zeros(n, np.int32), threshold=np.full(n, np.nan, np.float32),
        enqueued_at=100.0 + rng.uniform(0, 20, n),
        reply_to=np.full(n, "rq", object),
        correlation_id=np.array([f"p{i}" for i in range(n)], object),
        tier=rng.integers(0, 3, n).astype(np.int32),
        deadline=np.zeros(n))
    eng.restore_columns(cols, 130.0)
    # A window with matches, so the quality state is not empty.
    eng.search_columns_async(cols.slice(0, 0), 131.0)
    extra = dataclasses.replace(
        cols.slice(0, 40), ids=np.array([f"x{i}" for i in range(40)], object),
        correlation_id=np.array([f"x{i}" for i in range(40)], object))
    eng.search_columns_async(extra, 132.0)
    eng.flush()
    eng.chaos_hook = hook
    return eng


def _device_state(eng):
    state = {k: v.clone() for k, v in eng.dev_pool.items()}
    state["quality"] = eng._q_dev.flat.clone()
    return state


def _mirror_state(eng):
    p = eng.pool
    return (dict(p._slot_of), p._free.copy(), p._head, p.m_id.copy(),
            p.m_rating.copy(), p.m_tier.copy(), p.m_enqueued.copy(),
            p.tier_counts(3), None if p.segment_counts() is None
            else p.segment_counts().copy(),
            None if p._band_edges is None
            else [b.copy() for b in p._band_free],
            None if p._band_edges is None else p._band_head.copy())


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_probe_leaves_pool_index_and_quality_bit_equal(variant):
    eng = _engine(variant)
    before = _device_state(eng)
    reports = (eng.prune_report(), eng.formation_report(),
               eng.quality_report(), eng.pool_mutations)
    eng.probe()
    _same(_device_state(eng), before)
    _same((eng.prune_report(), eng.formation_report(), eng.quality_report(),
           eng.pool_mutations), reports)
    # A scripted probe failure raises before anything runs.
    eng.chaos_hook = chaos.EngineChaosHook(ChaosConfig(fail_probes=1))
    with pytest.raises(chaos.ChaosInjectedError):
        eng.probe()
    eng.probe()
    _same(_device_state(eng), before)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("path", ["columns", "objects", "rescan"])
def test_a_failed_chaos_step_leaves_mirror_and_device_pool_bit_equal(
        variant, path):
    hook = chaos.EngineChaosHook(ChaosConfig(fail_steps=(0,)))
    eng = _engine(variant, hook)
    dev, mirror = _device_state(eng), _mirror_state(eng)
    window = [SearchRequest(id=f"n{i}", rating=1500.0 + i, enqueued_at=140.0)
              for i in range(20)]
    with pytest.raises(chaos.ChaosInjectedError):
        if path == "columns":
            eng.search_columns_async(RequestColumns.from_requests(
                window, eng.pool.regions.code, eng.pool.modes.code), 140.0)
        elif path == "objects":
            eng.search_async(window, 140.0)
        else:
            eng.rescan_async(64, 140.0)
    assert eng.inflight() == 0 and hook.steps == 1
    _same(_device_state(eng), dev)
    _same(_mirror_state(eng), mirror)
    # The next step is not scripted: it runs.
    eng.search_async(window, 141.0)
    assert eng.flush() and hook.steps == 2


def test_close_drops_the_device_state_and_make_engine_cpu_is_the_oracle():
    eng = _engine("bucketed")
    report = eng.quality_report()
    eng.close()
    assert eng.dev_pool is None and eng._spec_pool is None
    assert eng._q_dev is None and eng.inflight() == 0
    assert eng.quality_report() == report
    cfg = dataclasses.replace(Config(), engine=EngineConfig(backend="cpu"))
    oracle = make_engine(cfg, cfg.queues[0])
    assert isinstance(oracle, CpuEngine)
    oracle.restore([SearchRequest(id="a", rating=1500.0, tier=2),
                    SearchRequest(id="b", rating=1500.0, tier=9)], 0.0)
    assert oracle.pool_tier_counts(3) == [0, 0, 2]
    oracle.probe()
    oracle.close()
    assert [r.id for r in oracle.remove_many(["b", "zz", "a"])] == ["b", "a"]
    assert oracle.pool_tier_counts(3) == [0, 0, 0]
    with pytest.raises(ValueError, match="backend"):
        make_engine(dataclasses.replace(
            cfg, engine=EngineConfig(backend="tpu")), cfg.queues[0])


async def test_the_service_runs_on_the_cpu_backend():
    """``backend="cpu"``: every queue on the host oracle, served by the
    synchronous object flush (no breaker: nothing to demote to)."""
    from matchmaking_tpu_torch.service.app import run_demo

    cfg = Config(engine=EngineConfig(backend="cpu"))
    answers = await run_demo(cfg=cfg)
    assert [a.status for a in answers] == ["matched"] * 10


# ---- the config ----------------------------------------------------------------

def test_breaker_overload_and_chaos_keys_load_like_jax(caplog):
    d = {"engine": {"breaker_threshold": 2, "breaker_probe_initial_s": 0.25},
         "queues": [{"name": "q", "default_tier": 2}],
         "overload": {"max_waiting": 100, "tiers": 3, "tier_shares": [1, 0.5],
                      "edf": True, "shed_policy": "oldest"},
         "chaos": {"seed": 9, "fail_step_ranges": [[0, 3]], "fail_probes": 1,
                   "drop_seqs": [1, 2], "net_drop_prob": 0.5}}
    with caplog.at_level(logging.WARNING):
        cfg = Config.from_dict(d, backend="gpu")
    jcfg = JaxConfig.from_dict(d)
    assert cfg.chaos.fail_step_ranges == jcfg.chaos.fail_step_ranges == (
        (0, 3),)
    assert cfg.chaos.enabled() and cfg.chaos.seed == 9
    for f in dataclasses.fields(OverloadConfig):
        assert getattr(cfg.overload, f.name) == getattr(jcfg.overload, f.name)
    assert cfg.overload.enabled() == jcfg.overload.enabled()
    for name in ("breaker_threshold", "breaker_window_s",
                 "breaker_probe_initial_s", "breaker_probe_backoff",
                 "breaker_probe_max_s", "health_interval_s"):
        assert getattr(cfg.engine, name) == getattr(jcfg.engine, name)
    assert cfg.queues[0].default_tier == 2
    ignored = " ".join(r.getMessage() for r in caplog.records)
    # The broker faults are carried (utils/chaos.py), and so are the
    # network ones (net/nemesis.py).
    assert cfg.chaos.drop_seqs == jcfg.chaos.drop_seqs == (1, 2)
    assert cfg.chaos.net_drop_prob == jcfg.chaos.net_drop_prob == 0.5
    assert "chaos.drop_seqs" not in ignored
    assert "chaos.net_drop_prob" not in ignored
    drain = {"overload": {"drain_checkpoint_dir": "/tmp/x"}}
    assert Config.from_dict(drain).overload == OverloadConfig(
        **vars(JaxConfig.from_dict(drain).overload))
    # The device-loss keys are carried as the JAX package carries them:
    # a schedule of lost steps enables the script, the lost device too.
    lost = ChaosConfig(device_lost_steps=(3,), device_lost_device=0)
    jlost = JaxChaosConfig(device_lost_steps=(3,), device_lost_device=0)
    assert (lost.device_lost_steps, lost.device_lost_device) == (
        jlost.device_lost_steps, jlost.device_lost_device) == ((3,), 0)
    assert lost.enabled() == jlost.enabled() is True
    assert ChaosConfig().device_lost_device == JaxChaosConfig(
        ).device_lost_device == -1
    with pytest.raises(ValueError, match="shed_policy"):
        OverloadConfig(shed_policy="newest")
