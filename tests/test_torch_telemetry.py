"""The telemetry ring, the SLO burn monitors and the service's sampler in
the port (``utils/timeseries.py``, ``MatchmakingApp.sample_telemetry``)
against the JAX package's.

- ``TelemetryRing`` on seeded scripted sequences (counter resets among
  them): ``delta`` (value, span and the reset flag), ``rate``, ``series``
  and ``snapshot`` (limits and prefix filters) equal the JAX ring's,
  exactly (the same float operations in the same order).
- ``SloMonitor`` (latency and quality kinds) on the same scripted
  good/total sequences: the burning state after every evaluation, the
  snapshots, the ``slo_burn`` / ``slo_burn_clear`` events and the four
  gauges equal the JAX monitor's.
- Config #1's seeded soak through both apps on the CPU, with three tiers,
  an SLO target and a quality target, sampled at explicit ``now`` values
  after every burst: the key sets equal, the count-valued keys equal,
  and the burn monitors' events and gauges equal (the ``frontier_k``
  series of a bucket-frontier queue: tests/test_torch_sharded_frontier.py).
- The telemetry reset across an engine revive: every delta across it is
  non-negative and flagged.
- The sampler runs by default every second, counts a failed tick
  (``telemetry_errors``) and goes on, and a stopped app leaves no task.
"""

import asyncio
import dataclasses
import logging

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import ObservabilityConfig as JaxObservabilityConfig
from matchmaking_tpu.config import OverloadConfig as JaxOverloadConfig
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.utils import metrics as jax_metrics
from matchmaking_tpu.utils import timeseries as jax_timeseries
from matchmaking_tpu.utils import trace as jax_trace
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    ChaosConfig,
    Config,
    EngineConfig,
    ObservabilityConfig,
    OverloadConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.engine.quality import QualitySpec
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.service.quality import QualityLedger
from matchmaking_tpu_torch.utils import metrics, timeseries, trace
from test_torch_ingress import QUEUE, REPLY, jax_cfg, port_cfg, soak_bodies

torch.set_num_threads(1)


# ---- the ring ------------------------------------------------------------------

def _script(seed, n=40, names=("a", "b[q]", "c[q@t1]")):
    """Seeded snapshots: monotone counters with random restarts (a revive
    sets a counter back to a small value), a series that appears late and
    one that is absent from some snapshots."""
    rng = np.random.default_rng(seed)
    t, vals, rows = 100.0, {k: 0.0 for k in names}, []
    for i in range(n):
        t += float(rng.uniform(0.2, 1.5))
        for k in names:
            if rng.random() < 0.08:
                vals[k] = float(rng.integers(0, 5))  # a restart
            else:
                vals[k] += float(rng.integers(0, 20))
        row = {k: v for k, v in vals.items()
               if not (k == names[2] and (i < 5 or rng.random() < 0.1))}
        rows.append((t, row))
    return rows


def _ring_queries(ring, rows):
    out = []
    t_end = rows[-1][0]
    for span in (0.5, 1.0, 3.0, 7.5, 20.0, 1e9):
        for name in ("a", "b[q]", "c[q@t1]", "absent"):
            for now in (None, t_end, t_end - 2.0):
                d = ring.delta(name, span, now)
                out.append((span, name, now,
                            None if d is None else (d.value, d.span_s,
                                                    d.reset, tuple(d)),
                            ring.rate(name, span, now)))
    for name in ("a", "c[q@t1]", "absent"):
        out.append(ring.series(name))
        out.append(ring.series(name, limit=3))
    out.append(ring.snapshot())
    out.append(ring.snapshot(limit=4))
    out.append(ring.snapshot(prefixes=("b", "c[")))
    out.append(ring.snapshot(limit=2, prefixes=("a",)))
    out.append((len(ring), ring.latest()))
    return out


@pytest.mark.parametrize("capacity", [4, 16, 512])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_queries_equal_jax(seed, capacity):
    rows = _script(seed)
    ring = timeseries.TelemetryRing(capacity)
    jring = jax_timeseries.TelemetryRing(capacity)
    for t, vals in rows:
        assert ring.append(t, vals) == jring.append(t, vals)
    assert _ring_queries(ring, rows) == _ring_queries(jring, rows)
    assert timeseries.TelemetryRing(1).delta("a", 1.0) is None


def test_ring_reset_clamp_and_flag_equal_jax():
    """``tests/test_attribution.py``'s reset cases: a revive between two
    samples, a reset hidden inside an endpoint-increasing window, and a
    reset-free window keeping the exact endpoint difference."""
    cases = [[(0, 10.0), (1, 20.0), (2, 30.0), (3, 2.0), (4, 8.0)],
             [(0, 10.0), (1, 1.0), (2, 12.0)],
             [(0, 5.0), (1, 6.0), (2, 9.0)]]
    want = [(28.0, True), (12.0, True), (4.0, False)]
    for seq, (value, reset) in zip(cases, want):
        ring, jring = (timeseries.TelemetryRing(16),
                       jax_timeseries.TelemetryRing(16))
        for t, v in seq:
            ring.append(float(t), {"c": v})
            jring.append(float(t), {"c": v})
        now = float(seq[-1][0])
        d, jd = ring.delta("c", 100.0, now), jring.delta("c", 100.0, now)
        assert tuple(d) == tuple(jd)
        assert (d.value, d.reset) == (pytest.approx(value), reset)
        assert ring.rate("c", 100.0, now) == jring.rate("c", 100.0, now) >= 0
    assert timeseries.Delta._fields == jax_timeseries.Delta._fields


# ---- the monitors --------------------------------------------------------------

def _good_total(seed, n=60):
    """Cumulative good/total: a healthy stretch, a stretch that misses
    (the error rate drawn per tick), a recovery, and idle ticks."""
    rng = np.random.default_rng(seed)
    good = total = 0.0
    rows = []
    for i in range(n):
        arrivals = 0 if rng.random() < 0.1 else int(rng.integers(1, 40))
        miss = (rng.uniform(0.2, 0.9) if 15 <= i < 30
                else rng.uniform(0.0, 0.005))
        bad = int(round(arrivals * miss))
        good += arrivals - bad
        total += arrivals
        rows.append((1000.0 + i * float(rng.uniform(0.5, 1.5)), good, total))
    return rows


def _run_monitor(mod, metrics_mod, trace_mod, rows, kind, **kw):
    events = trace_mod.EventLog(256)
    m = metrics_mod.Metrics()
    ring = mod.TelemetryRing(kw.pop("capacity"))
    q = "q#quality" if kind == "quality" else "q"
    keys = ({"good_key": "quality_good[q]", "total_key": "quality_total[q]",
             "kind": "quality"} if kind == "quality" else {})
    mon = mod.SloMonitor(q, events=events, metrics=m, **keys, **kw)
    snaps = []
    for t, good, total in rows:
        names = (("quality_good[q]", "quality_total[q]") if kind == "quality"
                 else ("slo_good[q]", "slo_total[q]"))
        ring.append(t, {names[0]: good, names[1]: total})
        snaps.append(mon.evaluate(ring, t))
    rows_out = [{k: v for k, v in r.items() if k not in ("wall", "mono_ns",
                                                          "t")}
                for r in events.snapshot()]
    return snaps, rows_out, dict(m.gauges)


@pytest.mark.parametrize("kind", ["latency", "quality"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_slo_monitor_transitions_events_and_gauges_equal_jax(seed, kind):
    kw = dict(target_ms=100.0 if kind == "latency" else 0.7, objective=0.9,
              fast_window_s=3.0, slow_window_s=9.0, burn_threshold=1.0,
              capacity=64)
    rows = _good_total(seed)
    mine = _run_monitor(timeseries, metrics, trace, rows, kind, **dict(kw))
    theirs = _run_monitor(jax_timeseries, jax_metrics, jax_trace, rows, kind,
                          **dict(kw))
    assert mine == theirs
    snaps, events, gauges = mine
    kinds = [e["kind"] for e in events]
    assert "slo_burn" in kinds and kinds.count("slo_burn") == (
        kinds.count("slo_burn_clear") + snaps[-1]["burning"])
    assert {k.split("[")[0] for k in gauges} >= {
        "slo_burning", "slo_burn_fast", "slo_burn_slow", "slo_attainment"}


def test_objective_one_is_clamped_like_jax():
    for mod in (timeseries, jax_timeseries):
        mon = mod.SloMonitor("q", 1.0, 1.0, 1.0, 2.0)
        assert mon.objective == 0.9999
    assert (timeseries.SloMonitor("q", 1.0, 0.5, 1.0, 2.0).snapshot()
            == jax_timeseries.SloMonitor("q", 1.0, 0.5, 1.0, 2.0).snapshot())


def test_quality_slo_burns_and_clears_from_the_ledger():
    """``tests/test_quality.py``'s quality burn on the port's ledger and
    monitor: GOOD = matched with quality >= target."""
    ledger = QualityLedger(QualitySpec(), quality_target=0.7)
    ring = timeseries.TelemetryRing(64)
    events = trace.EventLog(64)
    mon = timeseries.SloMonitor("q#quality", target_ms=0.7, objective=0.9,
                                fast_window_s=10.0, slow_window_s=30.0,
                                burn_threshold=1.0, events=events,
                                good_key="quality_good[q]",
                                total_key="quality_total[q]", kind="quality")

    def sample(t):
        g, tot = ledger.slo_counts("q")
        ring.append(t, {"quality_good[q]": float(g),
                        "quality_total[q]": float(tot)})
        return mon.evaluate(ring, t)

    t = 1000.0
    sample(t)
    for _ in range(5):
        ledger.observe("q", np.full(10, 0.9), np.full(10, 0.1))
        t += 1.0
        sample(t)
    assert not mon.burning
    for _ in range(8):
        ledger.observe("q", np.full(10, 0.2), np.full(10, 0.1))
        t += 1.0
        snap = sample(t)
    assert mon.burning and snap["kind"] == "quality"
    assert any(e["kind"] == "slo_burn" for e in events.snapshot())
    for _ in range(40):
        ledger.observe("q", np.full(10, 0.95), np.full(10, 0.1))
        t += 1.0
        sample(t)
    assert not mon.burning
    assert any(e["kind"] == "slo_burn_clear" for e in events.snapshot())


# ---- the service's sampler -----------------------------------------------------

#: Keys whose values are measured times or ratios of them.
TIMED_KEYS = ("stage_total_p99_ms", "work_s", "wait_s", "device_busy_s",
              "device_idle_s", "idle_frac")

OBS = dict(slo_target_ms=60_000.0, quality_slo_target=0.97,
           quality_slo_objective=0.9, slo_fast_window_s=2.0,
           slo_slow_window_s=4.0, snapshot_interval_s=0.0)


def _tiered(port, jax):
    port = dataclasses.replace(port, observability=ObservabilityConfig(**OBS),
                               overload=OverloadConfig(tiers=3))
    jax = dataclasses.replace(jax, observability=JaxObservabilityConfig(**OBS),
                              overload=JaxOverloadConfig(tiers=3))
    return port, jax


async def _sampled_soak(app, props, bodies, burst=64):
    """Publish ``bodies`` burst by burst (tiers 0, 1, 2 in turn), each once
    the last is answered, and sample the telemetry after each at
    ``now`` = 1000 + the burst's index."""
    app.broker.declare_queue(REPLY)
    await app.start()
    answered: set[str] = set()
    samples = []
    try:
        for k, b in enumerate(range(0, len(bodies), burst)):
            corrs = [f"c{i}" for i in range(b, min(b + burst, len(bodies)))]
            for i, (corr, body) in enumerate(zip(corrs, bodies[b:b + burst])):
                app.broker.publish(QUEUE, body, props(
                    reply_to=REPLY, correlation_id=corr,
                    headers={"x-tier": str((b + i) % 3)}))
            for _ in range(1200):
                d = await app.broker.get(REPLY, timeout=0.05)
                if d is not None:
                    answered.add(d.properties.correlation_id)
                elif all(c in answered for c in corrs):
                    break
            else:
                raise AssertionError(f"burst {k} unanswered")
            samples.append(app.sample_telemetry(now=1000.0 + k))
    finally:
        await app.stop()
    return samples


def _events(app):
    return [(r["kind"], r["queue"], r["detail"])
            for r in app.events.snapshot()]


def test_sample_telemetry_equals_jax_app():
    port_c, jax_c = _tiered(port_cfg(), jax_cfg())
    bodies = soak_bodies(seed=3)
    app = MatchmakingApp(port_c, device="cpu")
    mine = asyncio.run(_sampled_soak(app, Properties, bodies))
    japp = JaxApp(jax_c)
    theirs = asyncio.run(_sampled_soak(japp, JaxProperties, bodies))
    assert app.faults() == {}
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine, theirs):
        jax_keys = set(b)
        assert set(a) == jax_keys
        for k in jax_keys:
            if k.split("[")[0] not in TIMED_KEYS:
                assert a[k] == b[k], k
    last = mine[-1]
    assert {f"slo_good[{QUEUE}@t{t}]" for t in range(3)} <= set(last)
    assert {f"shed_total[{QUEUE}@t{t}]" for t in range(3)} <= set(last)
    assert last[f"quality_total[{QUEUE}]"] > 0
    # The rejects (bad JSON, bad types, parties) settle as not served.
    assert last[f"slo_total[{QUEUE}]"] > last[f"slo_good[{QUEUE}]"] > 0
    assert 0.0 <= last[f"idle_frac[{QUEUE}]"] <= 1.0
    # The monitors: one per queue, per tier and for quality, in both apps.
    # Every one burns: the rejects miss the latency objective (0.99), and
    # the quality target is above most matches' quality. The same events
    # and gauges.
    assert set(app._slo_monitors) == set(japp._slo_monitors) == {
        QUEUE, f"{QUEUE}#quality", *(f"{QUEUE}@t{t}" for t in range(3))}
    assert all(m.burning for m in app._slo_monitors.values())
    for key, mon in app._slo_monitors.items():
        assert mon.snapshot() == japp._slo_monitors[key].snapshot(), key
    slo_events = [e for e in _events(app) if e[0].startswith("slo_")]
    assert slo_events == [e for e in _events(japp) if e[0].startswith("slo_")]
    assert [e[:2] for e in slo_events] == [
        ("slo_burn", key) for key in app._slo_monitors]
    gauges = {k: v for k, v in app.metrics.gauges.items()
              if k.startswith("slo_")}
    assert gauges == {k: v for k, v in japp.metrics.gauges.items()
                      if k.startswith("slo_")}
    assert [s["seq"] for s in app.telemetry.snapshot()] == [1, 2, 3, 4]


async def test_telemetry_reset_survives_an_engine_revive():
    """``tests/test_attribution.py``'s revive mid-soak on the port: a
    chaos-failed step crashes the engine, the revive installs a fresh one
    (its busy/idle counters restart at 0), and every delta across the
    revive is non-negative, at least one flagged as a reset."""
    q = QueueConfig(name="mm.reset", rating_threshold=1.0,
                    send_queued_ack=False)
    cfg = Config(
        queues=(q,),
        engine=EngineConfig(backend="gpu", pool_capacity=512, pool_block=256,
                            batch_buckets=(16, 64), pipeline_depth=1),
        batcher=BatcherConfig(max_batch=32, max_wait_ms=2.0),
        chaos=ChaosConfig(seed=7, queues=(q.name,), fail_steps=(2,)),
        observability=ObservabilityConfig(snapshot_interval_s=0.0))
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    rt = app.runtime(q.name)
    try:
        for wave in range(6):
            for j in range(8):
                rating = 1000 + (wave * 8 + j) * 300
                app.broker.publish(q.name, (
                    f'{{"id":"p{wave}_{j}","rating":{rating}}}').encode(),
                    Properties(reply_to="reset.replies",
                               correlation_id=f"c{wave}_{j}"))
            for _ in range(400):
                await asyncio.sleep(0.01)
                if (app.broker.queue_depth(q.name) == 0
                        and rt._batcher.depth == 0
                        and rt.engine.pool_size() >= 8 * (wave + 1)
                        and rt.engine.inflight() == 0):
                    break
            app.sample_telemetry(now=float(wave + 1))
        assert any(e["kind"] == "engine_crash" for e in app.events.snapshot())
        deltas = [app.telemetry.delta(f"{k}[{q.name}]", 100.0, now=6.0)
                  for k in ("device_busy_s", "device_idle_s")]
        assert all(d is not None and d.value >= 0.0 for d in deltas), deltas
        assert any(d.reset for d in deltas), deltas
        assert all(s["values"][f"idle_frac[{q.name}]"] >= 0.0
                   for s in app.telemetry.snapshot())
    finally:
        await app.stop()
    assert app.faults() == {"engine_failures": 1, "revives": 1}


def _small(**obs):
    return Config(
        queues=(QueueConfig(rating_threshold=100.0),),
        engine=EngineConfig(backend="gpu", pool_capacity=256, pool_block=64,
                            batch_buckets=(8, 32)),
        batcher=BatcherConfig(max_batch=8, max_wait_ms=2.0),
        observability=ObservabilityConfig(**obs))


async def test_the_sampler_ticks_every_second_by_default_and_stops():
    app = MatchmakingApp(_small(), device="cpu")
    assert app.cfg.observability.snapshot_interval_s == 1.0
    await app.start()
    task = app._telemetry_task
    try:
        assert task is not None and not task.done()
        for _ in range(300):
            await asyncio.sleep(0.01)
            if len(app.telemetry) >= 1:
                break
        assert len(app.telemetry) == 1
        assert app.telemetry.latest()["values"][
            "pool_size[matchmaking.search]"] == 0.0
    finally:
        await app.stop()
    assert task.done() and app._telemetry_task is None


async def test_a_failed_tick_is_counted_and_the_sampler_goes_on(caplog):
    app = MatchmakingApp(_small(snapshot_interval_s=0.02), device="cpu")
    real = app.sample_telemetry
    calls = []

    def flaky(now=None):
        calls.append(now)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return real(now)

    app.sample_telemetry = flaky
    await app.start()
    try:
        with caplog.at_level(logging.ERROR):
            for _ in range(500):
                await asyncio.sleep(0.01)
                if len(calls) >= 4:
                    break
    finally:
        await app.stop()
    assert len(calls) >= 4
    assert app.metrics.counters.get("telemetry_errors") == 1
    assert len(app.telemetry) == len(calls) - 1
    assert "telemetry snapshot failed" in caplog.text


async def test_monitors_without_the_sampler_warn_like_jax(caplog):
    app = MatchmakingApp(_small(snapshot_interval_s=0.0, slo_target_ms=5.0),
                         device="cpu")
    with caplog.at_level(logging.WARNING):
        await app.start()
    try:
        assert app._telemetry_task is None and set(app._slo_monitors) == {
            "matchmaking.search"}
        assert "SLO burn monitors will never evaluate" in caplog.text
    finally:
        await app.stop()
