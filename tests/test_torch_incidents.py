"""Incident capture in the port (``utils/forensics.py``: ``IncidentRecorder``,
``validate_bundle``) against the JAX package's.

- The trigger table and the schema are the JAX module's.
- ``tests/test_forensics.py``'s recorder cases through both apps: a
  breaker trip freezes a bundle; a second within ``min_interval_s`` is
  dropped and counted; a trigger while a capture runs is dropped and
  counted, never recursed; another class is not limited by the first.
  Captured, dropped and ``by_class`` equal the JAX app's at every step.
- Persistence under ``incident_dir`` with the retention cap, and
  ``snapshot()``'s counters and capture p99.
- ``validate_bundle``: the schema mutations the JAX test rejects give the
  same problems from both validators.
- The JAX crash storm (``tests/test_torch_breaker.py``) and the crash and
  recovery (``tests/test_torch_events.py``) through both apps: the bundles'
  trigger classes in order, ``by_class``, and the incident counters equal
  the JAX app's; each bundle has the JAX bundle's top-level keys.
- A bundle the port wrote passes the JAX ``validate_bundle``, and a bundle
  the JAX app wrote passes the port's.
"""

import asyncio
import json
import os

import pytest
import torch

from matchmaking_tpu.config import BatcherConfig as JaxBatcherConfig
from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import ForensicsConfig as JaxForensicsConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.utils import forensics as jax_forensics
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    Config,
    EngineConfig,
    ForensicsConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.utils import forensics
from test_torch_breaker import _crash_storm, _storm_cfgs
from test_torch_events import _crash_then_recover

torch.set_num_threads(1)

Q = "matchmaking.search"


def test_trigger_table_and_schema_equal_jax():
    assert forensics.TRIGGER_KINDS == jax_forensics.TRIGGER_KINDS
    assert forensics.INCIDENT_SCHEMA == jax_forensics.INCIDENT_SCHEMA
    assert forensics._BUNDLE_REQUIRED == jax_forensics._BUNDLE_REQUIRED
    assert forensics._TRIGGER_REQUIRED == jax_forensics._TRIGGER_REQUIRED
    assert ForensicsConfig().enabled() and not ForensicsConfig(
        capture=False).enabled()


def _apps(forensics_kw):
    """A small port app on the CPU and its JAX twin (``tests/
    test_forensics.py``'s config)."""
    q = dict(rating_threshold=50.0, dedup_ttl_s=600.0)
    eng = dict(pool_capacity=256, pool_block=64, batch_buckets=(8, 32))
    port = MatchmakingApp(Config(
        queues=(QueueConfig(**q),),
        engine=EngineConfig(backend="gpu", **eng),
        batcher=BatcherConfig(max_batch=8, max_wait_ms=5.0),
        forensics=ForensicsConfig(**forensics_kw)), device="cpu")
    jax = JaxApp(JaxConfig(
        queues=(JaxQueueConfig(**q),),
        engine=JaxEngineConfig(backend="tpu", top_k=4, **eng),
        batcher=JaxBatcherConfig(max_batch=8, max_wait_ms=5.0),
        forensics=JaxForensicsConfig(**forensics_kw)))
    return port, jax


def _counts(app):
    inc = app.incidents
    return (inc.captured, inc.dropped, dict(inc.by_class),
            app.metrics.counters.get("incidents_captured") or 0,
            app.metrics.counters.get("incidents_dropped") or 0)


async def _rate_limit_script(app):
    """The JAX test's script; returns the counts after every step and the
    first bundle."""
    await app.start()
    steps = []
    try:
        ev = app.events.append("breaker_trip", Q, "fixture trip",
                               refs={"crashes": 2})
        steps.append(_counts(app))
        bundle = app.incidents.get("inc-000001")
        assert bundle["trigger"]["seq"] == ev["seq"]
        app.events.append("breaker_trip", Q, "storm repeat")
        steps.append(_counts(app))
        app.incidents._capturing = True
        try:
            app.events.append("crash_recovered", Q, "mid-capture")
        finally:
            app.incidents._capturing = False
        steps.append(_counts(app))
        app.events.append("crash_recovered", Q, "other class")
        steps.append(_counts(app))
        app.events.append("slo_burn_clear", Q, "a checkpoint trigger")
        app.events.append("engine_revive", Q, "not a trigger")
        steps.append(_counts(app))
    finally:
        await app.stop()
    return steps, bundle


def test_rate_limit_and_reentrancy_equal_jax_app():
    port, jax = _apps(dict(min_interval_s=60.0))
    mine, bundle = asyncio.run(_rate_limit_script(port))
    theirs, jbundle = asyncio.run(_rate_limit_script(jax))
    assert mine == theirs
    assert mine == [
        (1, 0, {"breaker_trip": 1}, 1, 0),
        (1, 1, {"breaker_trip": 1}, 1, 1),
        (1, 2, {"breaker_trip": 1}, 1, 2),
        (2, 2, {"breaker_trip": 1, "crash_recovery": 1}, 2, 2),
        (3, 2, {"breaker_trip": 1, "crash_recovery": 1,
                "slo_burn_clear": 1}, 3, 2)]
    assert forensics.validate_bundle(bundle) == []
    assert jax_forensics.validate_bundle(bundle) == []
    assert jax_forensics.validate_bundle(jbundle) == []
    assert forensics.validate_bundle(jbundle) == []
    # The port's bundle carries the JAX bundle's keys: replication stays
    # empty and no placement or autotune block exists on either side.
    assert set(bundle) == set(jbundle)
    assert bundle["replication"] == jbundle["replication"] == {}
    assert bundle["trigger"].keys() == jbundle["trigger"].keys()
    assert bundle["schema"] == forensics.INCIDENT_SCHEMA


async def test_capture_off_subscribes_nothing():
    port, _ = _apps(dict(capture=False))
    await port.start()
    try:
        port.events.append("breaker_trip", Q, "no capture")
        assert port.incidents.captured == 0 and port.incidents.dropped == 0
    finally:
        await port.stop()


async def test_persist_retention_and_snapshot(tmp_path):
    inc_dir = str(tmp_path / "incidents")
    port, _ = _apps(dict(incident_dir=inc_dir, min_interval_s=0.0,
                         retention_files=2))
    await port.start()
    try:
        for i in range(3):
            port.events.append("breaker_trip", Q, f"trip {i}")
        files = sorted(os.listdir(inc_dir))
        assert files == ["incident_inc-000002_breaker_trip.json",
                         "incident_inc-000003_breaker_trip.json"]
        with open(os.path.join(inc_dir, files[-1]), encoding="utf-8") as f:
            written = json.load(f)
        assert forensics.validate_bundle(written) == []
        assert jax_forensics.validate_bundle(written) == []
        snap = port.incidents.snapshot()
        assert snap["captured"] == 3 and snap["dropped"] == 0
        assert snap["by_class"] == {"breaker_trip": 3}
        assert snap["capture_ms_p99"] is not None
        assert [b["id"] for b in snap["incidents"]] == [
            "inc-000001", "inc-000002", "inc-000003"]
        assert len(port.incidents.snapshot(include_bundles=True)[
            "bundles"]) == 3
        assert port.incidents.get("inc-000009") is None
    finally:
        await port.stop()


async def test_a_failed_write_is_counted_not_raised(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    port, _ = _apps(dict(incident_dir=str(blocker / "sub")))
    await port.start()
    try:
        port.events.append("breaker_trip", Q, "unwritable")
        assert port.incidents.captured == 1
        assert port.metrics.counters.get("incidents_persist_errors") == 1
    finally:
        await port.stop()


def _ok_bundle():
    return {
        "schema": forensics.INCIDENT_SCHEMA, "id": "inc-000001",
        "trigger": {"class": "failover", "seq": 5, "kind":
                    "failover_takeover", "queue": Q, "detail": "", "refs": {}},
        "captured_wall": 1.0, "capture_ms": 0.5,
        "spine": [{"seq": 1, "mono_ns": 10, "wall": 1.0,
                   "component": "replication", "queue": Q,
                   "kind": "lease_expired", "refs": {}},
                  {"seq": 5, "mono_ns": 20, "wall": 1.0,
                   "component": "replication", "queue": Q,
                   "kind": "failover_takeover", "refs": {}}],
        "spine_digest": "x", "telemetry": {}, "replication": {},
        "journal": {}, "counters": {},
    }


def _mutations():
    ok = _ok_bundle()
    missing = dict(ok)
    del missing["spine_digest"]
    no_seq = {**ok, "spine": [{k: v for k, v in ok["spine"][0].items()
                               if k != "seq"}]}
    return {
        "ok": ok,
        "not_an_object": [],
        "schema": {**ok, "schema": "mm.incident/999"},
        "missing_field": missing,
        "trigger_class": {**ok, "trigger": {**ok["trigger"],
                                            "class": "nope"}},
        "trigger_field": {**ok, "trigger": {"class": "failover"}},
        "trigger_type": {**ok, "trigger": "failover"},
        "spine_order": {**ok, "spine": list(reversed(ok["spine"]))},
        "spine_row": {**ok, "spine": [1]},
        "spine_keys": no_seq,
        "spine_type": {**ok, "spine": {}},
        "capture_ms": {**ok, "capture_ms": "fast"},
    }


@pytest.mark.parametrize("name", list(_mutations()))
def test_validate_bundle_equals_jax(name):
    bundle = _mutations()[name]
    problems = forensics.validate_bundle(bundle)
    assert problems == jax_forensics.validate_bundle(bundle)
    assert (problems == []) == (name == "ok")


def _incident_rows(app):
    """Each bundle's trigger (class, kind, queue) in capture order, the
    counts, and each bundle's top-level keys."""
    snap = app.incidents.snapshot(include_bundles=True)
    return ([(b["trigger"]["class"], b["trigger"]["kind"],
              b["trigger"]["queue"]) for b in snap["bundles"]],
            _counts(app), [sorted(b) for b in snap["bundles"]])


def test_crash_storm_incidents_equal_jax_app():
    port_cfg, jax_cfg = _storm_cfgs()
    app = MatchmakingApp(port_cfg, device="cpu")
    asyncio.run(_crash_storm(app, Properties,
                             lambda k: app.counters.get(k, 0)))
    japp = JaxApp(jax_cfg)
    asyncio.run(_crash_storm(japp, JaxProperties,
                             lambda k: japp.metrics.counters.get(k) or 0))
    mine, theirs = _incident_rows(app), _incident_rows(japp)
    assert mine == theirs
    assert mine[0] == [("breaker_trip", "breaker_trip", "mm.chaos")]
    bundle = app.incidents.snapshot(include_bundles=True)["bundles"][0]
    assert forensics.validate_bundle(bundle) == []
    assert jax_forensics.validate_bundle(bundle) == []
    # The capture froze the breaker's crashes in its counters and the
    # trip in its spine window.
    assert bundle["counters"]["engine_crashes"] == 3
    assert bundle["spine"][-1]["kind"] == "breaker_trip"


@pytest.mark.parametrize("chaos_steps", [(), (0,)])
def test_crash_recovery_incidents_equal_jax_app(tmp_path, chaos_steps):
    got = {pkg: asyncio.run(_crash_then_recover(pkg, tmp_path / pkg,
                                                chaos_steps))
           for pkg in ("port", "jax")}
    for i in (0, 1):
        assert _incident_rows(got["port"][i]) == _incident_rows(
            got["jax"][i]), i
    successor = got["port"][1]
    rows, counts, _ = _incident_rows(successor)
    assert rows == [("crash_recovery", "crash_recovered", Q)]
    assert counts == (1, 0, {"crash_recovery": 1}, 1, 0)
    bundle = successor.incidents.snapshot(include_bundles=True)["bundles"][0]
    assert forensics.validate_bundle(bundle) == []
    assert jax_forensics.validate_bundle(bundle) == []
    # The recovery's bundle carries the journal's watermark.
    (queue, mark), = bundle["journal"].items()
    assert mark["seq"] >= mark["synced_seq"] >= 0
    assert len(mark["tail_digest"]) == 64


def test_a_jax_bundle_passes_the_port_validator(tmp_path):
    """A bundle the JAX app wrote to disk passes the port's validator."""
    _, jax = _apps(dict(incident_dir=str(tmp_path), min_interval_s=0.0))

    async def run():
        await jax.start()
        try:
            jax.events.append("slo_burn", Q, "burn", refs={"slo_kind":
                                                           "latency"})
        finally:
            await jax.stop()
    asyncio.run(run())
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name, encoding="utf-8") as f:
        assert forensics.validate_bundle(json.load(f)) == []
