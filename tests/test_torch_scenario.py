"""Population-model load scenarios (scenario.py) and the load generator
(service/loadgen.py) in the port against the JAX package's, on the CPU
(marker ``scenario``).

- ``build_arrivals`` is bit-equal to the JAX package's for every committed
  scenario, seeds {0, 7, 21, 29} and rate_scale x time_scale in
  {0.5, 1, 4}²: times, ratings, cohorts, tiers, deadlines, retry flags and
  retry delays (the port draws the same numpy streams in the same order).
- The JAX package's scenario scripts on the port: replay identity, the
  steady scenario equal to the flat ``offered_load`` byte for byte, the
  legacy RNG order, the curve and population shapes, the spec round trip,
  retry-on-shed and the conflicting-model refusal through the port's app.
- Incidents build the port's ChaosConfig equal to the JAX one field by
  field; a device-loss incident (a kind the JAX package lacks) raises the
  JAX package's "unknown incident kind" error.
- ``offered_load`` of each package through its own app, one seeded load:
  the published requests are equal (bodies, correlation ids, header keys
  and tiers; the ``x-deadline`` value is a wall-clock stamp and only its
  presence is compared), the result's keys are equal, and every request
  gets exactly one terminal answer in both (which answer — matched or
  timeout — follows the window cut, which is timed, so it is not
  compared).
- ``chip_smoke.py`` phase 6's cohort table is the mixed-tier-peak file's.
"""

import asyncio
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from matchmaking_tpu import config as jax_config
from matchmaking_tpu import scenario as jax_scenario
from matchmaking_tpu.service import app as jax_app
from matchmaking_tpu.service import loadgen as jax_loadgen
from matchmaking_tpu_torch import config
from matchmaking_tpu_torch import scenario
from matchmaking_tpu_torch.scenario import (
    Cohort,
    Incident,
    Scenario,
    Segment,
    load_scenario,
    scenario_names,
)
from matchmaking_tpu_torch.service import loadgen
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.loadgen import offered_load

pytestmark = pytest.mark.scenario

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = "matchmaking.search"
EXPECTED = {"steady", "diurnal", "flash-crowd", "skewed-ladder",
            "retry-storm", "mixed-tier-peak"}
ARRAYS = ("t", "rating", "cohort", "tier", "deadline_s", "retry",
          "retry_delay_s")
SCALES = (0.5, 1.0, 4.0)


def _small_cfg(**over):
    return config.Config(
        queues=(config.QueueConfig(rating_threshold=100.0,
                                   send_queued_ack=False),),
        engine=config.EngineConfig(backend="cpu", pool_capacity=4096),
        batcher=config.BatcherConfig(max_batch=64, max_wait_ms=2.0),
        observability=config.ObservabilityConfig(snapshot_interval_s=0.0),
        **over)


# ---- bit-equal arrivals ---------------------------------------------------


@pytest.mark.parametrize("seed", (0, 7, 21, 29))
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_build_arrivals_bit_equal_to_jax(name, seed):
    mine, theirs = load_scenario(name), jax_scenario.load_scenario(name)
    assert mine.to_dict() == theirs.to_dict()
    for rate_scale in SCALES:
        for time_scale in SCALES:
            a = mine.build_arrivals(seed, rate_scale=rate_scale,
                                    time_scale=time_scale)
            b = theirs.build_arrivals(seed, rate_scale=rate_scale,
                                      time_scale=time_scale)
            assert len(a) == len(b) > 0
            assert a.duration_s == b.duration_s
            for k in ARRAYS:
                x, y = getattr(a, k), getattr(b, k)
                assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
                assert np.array_equal(x, y), (name, seed, rate_scale,
                                              time_scale, k)


def test_committed_library_loads_and_transcripts_replay_bit_identical():
    names = scenario_names()
    assert EXPECTED <= set(names), names
    assert names == jax_scenario.scenario_names()
    assert scenario.scenarios_dir() == jax_scenario.scenarios_dir()
    for name in names:
        s = load_scenario(name)
        a = s.build_arrivals(21, rate_scale=0.8, time_scale=0.5)
        b = s.build_arrivals(21, rate_scale=0.8, time_scale=0.5)
        assert len(a) > 50, name
        assert a.transcript() == b.transcript(), name
        assert a.digest() == b.digest(), name
        c = s.build_arrivals(22, rate_scale=0.8, time_scale=0.5)
        assert c.digest() != a.digest(), name


def test_trivial_build_matches_legacy_rng_order_exactly():
    s = load_scenario("steady")
    a = s.build_arrivals(7)
    rate, dur = s.segments[0].rate, s.segments[0].duration_s
    rng = np.random.default_rng(7)
    n_max = int(rate * dur * 2) + 16
    ratings = np.repeat(rng.normal(1500.0, 300.0, size=n_max // 2 + 1), 2)
    sched = np.cumsum(rng.exponential(1.0 / rate, size=n_max))
    n = int((sched <= dur).sum())
    assert np.array_equal(a.t, sched[:n])
    assert np.array_equal(a.rating, ratings[:n])


def test_steady_scenario_reduces_to_legacy_offered_load_byte_for_byte():
    """scenario="steady" at half time publishes the exact request sequence
    of ``offered_load(rate=400, duration=2)``: bodies, correlation ids,
    headers, order."""
    sent: dict = {}

    async def run(mode):
        app = MatchmakingApp(_small_cfg(), device="cpu")
        log = []
        orig = app.broker.publish

        def recording(queue, body, props=None):
            if queue == Q:
                log.append((bytes(body), props.correlation_id,
                            dict(props.headers or {})))
            return orig(queue, body, props)

        app.broker.publish = recording
        await app.start()
        try:
            if mode == "legacy":
                await offered_load(app, Q, rate=400.0, duration=2.0, seed=5)
            else:
                s = load_scenario("steady")
                assert s.is_trivial()
                await offered_load(app, Q, rate=0.0, duration=0.0, seed=5,
                                   scenario=s, time_scale=0.5)
        finally:
            await app.stop()
        sent[mode] = log

    asyncio.run(run("legacy"))
    asyncio.run(run("steady"))
    assert len(sent["legacy"]) > 300
    assert sent["legacy"] == sent["steady"]


def test_flash_crowd_curve_and_cohort_shapes():
    a = load_scenario("flash-crowd").build_arrivals(3)
    base = ((a.t >= 0.0) & (a.t < 2.0)).sum() / 2.0
    peak = ((a.t >= 3.0) & (a.t < 5.0)).sum() / 2.0
    assert 3.5 < peak / base < 6.5, (base, peak)
    assert (a.deadline_s == 2.0).all()
    m = load_scenario("mixed-tier-peak").build_arrivals(9)
    first = ((m.t >= 0.0) & (m.t < 1.0)).sum()
    last = ((m.t >= 2.0) & (m.t < 3.0)).sum()
    assert last > 2 * first
    assert set(np.unique(m.tier).tolist()) == {0, 1, 2}
    assert 0.35 < float((m.tier == 1).mean()) < 0.65
    b = load_scenario("skewed-ladder").build_arrivals(4)
    means = [float(b.rating[b.cohort == j].mean()) for j in range(3)]
    assert means[0] < 1300 < means[1] < 1800 < means[2]


# ---- incidents and the spec -----------------------------------------------


_VOCABULARY = dict(name="inc", incidents=(
    dict(kind="drop", at=5, count=3), dict(kind="partition", at=10, until=20),
    dict(kind="dup_storm", at=30, count=2, copies=3),
    dict(kind="engine_fault", at=2, count=2), dict(kind="probe_fail", count=1)))


def _spec(mod, d):
    return mod.Scenario.from_dict({**d, "incidents": [
        dict(i) for i in d["incidents"]]})


@pytest.mark.parametrize("which", ["retry-storm", "vocabulary"])
def test_incidents_equal_jax_chaos_config_field_by_field(which):
    if which == "retry-storm":
        mine = load_scenario(which).chaos_config("mm.q", seed=13)
        theirs = jax_scenario.load_scenario(which).chaos_config("mm.q",
                                                                 seed=13)
        assert mine.dup_seqs == tuple((s, 2) for s in range(900, 908))
    else:
        mine = _spec(scenario, _VOCABULARY).chaos_config("q", seed=4)
        theirs = _spec(jax_scenario, _VOCABULARY).chaos_config("q", seed=4)
        assert (mine.drop_seqs, mine.partitions, mine.fail_step_ranges,
                mine.fail_probes) == ((5, 6, 7), ((10, 20),), ((2, 4),), 1)
    assert isinstance(mine, config.ChaosConfig)
    for f in dataclasses.fields(config.ChaosConfig):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    # The JAX package's one field the port does not carry is at its default.
    extra = ({f.name for f in dataclasses.fields(jax_config.ChaosConfig)}
             - {f.name for f in dataclasses.fields(config.ChaosConfig)})
    for name in extra:
        assert getattr(theirs, name) == getattr(jax_config.ChaosConfig(),
                                                name), name
    assert mine.enabled() == theirs.enabled() is True
    assert load_scenario("steady").chaos_config("q") is None


def test_unknown_and_device_loss_incidents_are_refused():
    with pytest.raises(ValueError, match="unknown incident kind"):
        Scenario(name="bad", incidents=(Incident(kind="nope"),)
                 ).chaos_config("q")
    # The JAX package has no device_lost incident kind: the port raises
    # its error, word for word, on the same scenario.
    with pytest.raises(ValueError) as theirs:
        jax_scenario.Scenario(
            name="dl", incidents=(jax_scenario.Incident(kind="device_lost"),)
        ).chaos_config("q")
    with pytest.raises(ValueError, match="unknown incident kind") as mine:
        Scenario(name="dl", incidents=(Incident(kind="device_lost"),)
                 ).chaos_config("q")
    assert str(mine.value) == str(theirs.value)


def test_scenario_spec_roundtrip_and_unknown_key_rejected():
    for name in scenario_names():
        s = load_scenario(name)
        assert Scenario.from_dict(s.to_dict()) == s
        assert s.to_dict() == jax_scenario.Scenario.from_dict(
            s.to_dict()).to_dict()
    with pytest.raises(ValueError, match="unknown"):
        Scenario.from_dict({"name": "x",
                            "segments": [{"kind": "steady", "rat": 1}]})
    with pytest.raises(FileNotFoundError):
        load_scenario("no-such-scenario")
    with pytest.raises(ValueError, match="segment"):
        Scenario.from_dict({"name": "x", "segments": []})
    with pytest.raises(ValueError, match="cohort"):
        Scenario.from_dict({"name": "x", "cohorts": []})
    with pytest.raises(ValueError, match="no mass"):
        Scenario(name="x", cohorts=(Cohort(weight=0.0),))
    with pytest.raises(ValueError, match="duration"):
        Scenario(name="x", segments=(Segment(duration_s=0.0),))
    with pytest.raises(ValueError, match="kind"):
        Scenario(name="x", segments=(Segment(kind="square"),))


def test_parse_tier_mix_equals_jax():
    for spec in ("", "0:0.2,1:0.5,2:0.3", "2:1,0:3"):
        assert loadgen.parse_tier_mix(spec) == jax_loadgen.parse_tier_mix(spec)
    for mod in (loadgen, jax_loadgen):
        with pytest.raises(ValueError, match="no mass"):
            mod.parse_tier_mix("0:0")


# ---- the load generator through the port's app -------------------------------


async def test_retry_on_shed_republishes_once_and_accounts_per_cohort():
    s = Scenario(
        name="shedder",
        segments=(Segment(kind="steady", duration_s=1.2, rate=300.0),),
        cohorts=(Cohort(name="impatient", rating_sigma=4000.0,
                        retry_on_shed=1.0, retry_delay_s=0.05),))
    cfg = config.Config(
        queues=(config.QueueConfig(rating_threshold=1.0,
                                   send_queued_ack=False),),
        engine=config.EngineConfig(backend="cpu", pool_capacity=4096),
        batcher=config.BatcherConfig(max_batch=64, max_wait_ms=2.0),
        overload=config.OverloadConfig(max_waiting=8, retry_after_ms=50.0),
        observability=config.ObservabilityConfig(snapshot_interval_s=0.0))
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    try:
        r = await offered_load(app, Q, rate=0.0, duration=0.0, seed=4,
                               scenario=s)
    finally:
        await app.stop()
    assert r["shed"] > 0
    assert r["retries_sent"] > 0
    assert r["cohorts"]["impatient"]["retries"] == r["retries_sent"]
    gap = r["sent"] + r["retries_sent"] - r["replies"]
    assert 0 <= gap <= 8, r
    assert r["retries_sent"] <= r["sent"]


async def test_scenario_mode_rejects_conflicting_models():
    app = MatchmakingApp(_small_cfg(), device="cpu")
    await app.start()
    try:
        with pytest.raises(ValueError, match="scenario mode"):
            await offered_load(app, Q, rate=0.0, duration=0.0, seed=1,
                               scenario=load_scenario("steady"),
                               tier_mix={0: 1.0})
    finally:
        await app.stop()


#: Two paired cohorts, tiered, one with a deadline budget.
_TIERED = dict(
    name="tiered-pairs",
    segments=[{"kind": "flash", "duration_s": 1.0, "rate": 300.0,
               "peak_x": 2.0, "peak_start_s": 0.3, "peak_len_s": 0.3}],
    cohorts=[{"name": "fast", "weight": 0.4, "paired": True, "tier": 0,
              "deadline_ms": 5000.0},
             {"name": "slow", "weight": 0.6, "paired": True, "tier": 1,
              "rating_mean": 1450.0}])


def _offered_cfg(pkg):
    mod = config if pkg == "port" else jax_config
    return mod.Config(
        queues=(mod.QueueConfig(rating_threshold=100.0, send_queued_ack=False,
                                request_timeout_s=0.4),),
        engine=mod.EngineConfig(backend="cpu", pool_capacity=4096),
        batcher=mod.BatcherConfig(max_batch=64, max_wait_ms=2.0),
        overload=mod.OverloadConfig(tiers=2),
        observability=mod.ObservabilityConfig(snapshot_interval_s=0.0))


async def _offered(pkg):
    if pkg == "port":
        app = MatchmakingApp(_offered_cfg(pkg), device="cpu")
        spec, drive = scenario.Scenario.from_dict(_TIERED), offered_load
    else:
        app = jax_app.MatchmakingApp(_offered_cfg(pkg))
        spec = jax_scenario.Scenario.from_dict(_TIERED)
        drive = jax_loadgen.offered_load
    requests, answers = [], {}
    orig_one = app.broker.publish
    orig_batch = app.broker.publish_batch

    def note(queue, body, props):
        if queue == Q:
            h = dict(props.headers or {})
            requests.append((bytes(body), props.correlation_id, sorted(h),
                             h.get("x-tier")))
        elif props is not None and props.correlation_id:
            answers.setdefault(props.correlation_id, []).append(bytes(body))

    in_batch = [False]  # an in-process publish_batch calls publish

    def publish(queue, body, props=None):
        if not in_batch[0]:
            note(queue, body, props)
        return orig_one(queue, body, props)

    def publish_batch(items):
        for queue, body, props in items:
            note(queue, body, props)
        in_batch[0] = True
        try:
            return orig_batch(items)
        finally:
            in_batch[0] = False

    app.broker.publish, app.broker.publish_batch = publish, publish_batch
    await app.start()
    try:
        result = await drive(app, Q, rate=0.0, duration=0.0, seed=3,
                             scenario=spec, time_scale=0.5)
        for _ in range(300):
            if len(answers) >= result["sent"]:
                break
            await asyncio.sleep(0.02)
    finally:
        await app.stop()
    return requests, answers, result


async def test_offered_load_through_both_apps_on_one_seeded_load():
    req_p, ans_p, res_p = await _offered("port")
    req_j, ans_j, res_j = await _offered("jax")
    assert req_p == req_j and len(req_p) > 150
    assert set(res_p) == set(res_j)
    assert res_p["scenario_digest"] == res_j["scenario_digest"]
    assert res_p["sent"] == res_j["sent"] == len(req_p)
    for ans in (ans_p, ans_j):
        assert set(ans) == {c for _, c, _, _ in req_p}
        terminal = {c: [b for b in bs if b'"status":"queued"' not in b]
                    for c, bs in ans.items()}
        assert all(len(v) == 1 for v in terminal.values()), [
            (c, v) for c, v in terminal.items() if len(v) != 1][:3]
    for res in (res_p, res_j):
        assert res["cohorts"]["fast"]["offered"] + res["cohorts"]["slow"][
            "offered"] == res["sent"]
        assert sorted(res["tiers"]) == ["0", "1"]


def test_phase6_cohort_table_is_the_scenario_file():
    """chip_smoke.py phase 6 reads its cohorts from the committed
    mixed-tier-peak scenario; the table (and so phase 6's seeded draws)
    is the one it hard-coded before."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.scenario_cohorts() == (
        ("ranked", 0.25, 0, 1600.0, 150.0, 1.5),
        ("quickplay", 0.50, 1, 1480.0, 300.0, 4.0),
        ("botfill", 0.25, 2, 1400.0, 350.0, None))
    rng = np.random.default_rng(16)
    rows = smoke.cohort_requests(np, rng, 64, 0)
    assert [r[2] for r in rows[:8]] == [r[2] for r in smoke.cohort_requests(
        np, np.random.default_rng(16), 8, 0)]
