"""Device-loss failover (the D → D − 1 demotion) of the port's app against
the JAX package's, on the CPU.

Both apps take the same durable config #1 queue sharded D ways (the JAX
one over its virtual CPU devices, the port's over ``(cpu,) × D``) and the
same chaos schedule: a ``ChaosDeviceLostError`` at a device step. Then:

- the demotion itself: the binding after the loss, the
  ``device_failovers`` counter, each ``failover_log`` entry (equal but
  for ``blackout_ms``, which must be > 0 in both, and ``at``), the matched
  players and the event transcript (kinds and queues in order, details
  with the blackout's ms masked) equal the JAX app's, at the default lost
  device (the last), at device 0 and at D = 4 → 3; the demoted queue goes
  on serving;
- a D = 1 queue and a team queue that lose a device take the plain revive
  in both apps (no demotion, no failover entry);
- ``EngineChaosHook`` on a schedule naming one step both lost and failed:
  the loss wins, as in the JAX package;
- with the placement controller on, a failover and then a forced
  migration: ``/metrics?format=prom``'s families equal the JAX app's
  (``PROM_DIFFERENCES`` stays empty; ``device_failovers``,
  ``queue_migrations``, ``placement_migrations`` and both blackout gauges
  appear in both), and ``/debug/placement`` gives the JAX app's keys and
  failover audit.
"""

import asyncio
import json
import re

import pytest
import torch

from matchmaking_tpu import config as jax_config
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.utils import chaos as jax_chaos
from matchmaking_tpu_torch import config
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.utils import chaos
from test_torch_observability import (
    PROM_DIFFERENCES,
    free_port,
    get,
    prom_differences,
    prom_shape,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.durability

Q = "matchmaking.search"
REPLY = "fo.replies"


def _tree(jdir, *, mesh, lost_steps=(0,), lost_device=-1, team=False):
    queue = {"name": Q, "rating_threshold": 50.0, "dedup_ttl_s": 600.0}
    if team:
        queue.update(team_size=2)
    return {
        "queues": [queue],
        "engine": {"pool_capacity": 256, "pool_block": 64,
                   "batch_buckets": (8, 32), "top_k": 4,
                   "mesh_pool_axis": mesh},
        "batcher": {"max_batch": 8, "max_wait_ms": 5.0},
        "durability": {"journal_dir": str(jdir), "fsync": "window"},
        "chaos": {"seed": 3, "queues": (Q,), "device_lost_steps": lost_steps,
                  "device_lost_device": lost_device},
    }


def _app(pkg, tree):
    if pkg == "jax":
        tree = {**tree, "engine": {**tree["engine"], "backend": "tpu"}}
        return JaxApp(jax_config.Config.from_dict(tree))
    return MatchmakingApp(config.Config.from_dict(tree, backend="gpu"),
                          device="cpu")


def _publish(pkg, app, pid, rating, team=False):
    props = JaxProperties if pkg == "jax" else Properties
    body = {"id": pid, "rating": rating}
    if team:
        # No wildcard: a team queue keeps the window on the device step.
        body.update(region="eu", game_mode="ranked")
    app.broker.publish(
        Q, json.dumps(body).encode(),
        props(reply_to=REPLY, correlation_id=pid,
              headers={"x-first-received": "1.0"}))


def _collect(app, sink):
    async def on_reply(delivery):
        sink.append(json.loads(delivery.body))

    app.broker.declare_queue(REPLY)
    app.broker.basic_consume(REPLY, on_reply, prefetch=1_000_000)


async def _quiesce(app, rt, replies, matched_at_least, tries=600):
    """Nothing buffered or in flight, and the matched floor reached."""
    for _ in range(tries):
        await asyncio.sleep(0.025)
        matched = sum(r.get("status") == "matched" for r in replies)
        if (matched >= matched_at_least
                and app.broker.queue_depth(Q) == 0
                and app.broker.handlers_idle()
                and rt.batcher.depth == 0
                and getattr(rt, "_flushing", 0) == 0
                and (not hasattr(rt.engine, "inflight")
                     or rt.engine.inflight() == 0)):
            return True
    return False


_MS = re.compile(r"\d+(\.\d+)? ms")


def _transcript(app):
    """The event log in order: kind, queue and detail (ms masked)."""
    return [(e["kind"], e["queue"], _MS.sub("<ms> ms", e["detail"]))
            for e in app.events.snapshot()]


async def _failover(pkg, jdir, *, mesh, lost_device=-1, team=False,
                    pairs=((("a0", 1500.0), ("a1", 1501.0)),
                           (("b0", 1600.0), ("b1", 1601.0)))):
    """The JAX package's script: a pair published, the first device step
    lost, the redelivered pair matched on the rebuilt engine, then one
    more pair. Returns what the two apps must agree on."""
    app = _app(pkg, _tree(jdir, mesh=mesh, lost_device=lost_device,
                          team=team))
    await app.start()
    rt = app.runtime(Q)
    replies: list[dict] = []
    try:
        _collect(app, replies)
        want = 0
        for pair in pairs:
            for pid, rating in pair:
                _publish(pkg, app, pid, rating, team)
            want += len(pair)
            assert await _quiesce(app, rt, replies, want)
        log = [dict(e) for e in rt.failover_log]
        for entry in log:
            assert entry.pop("blackout_ms") > 0.0
            assert entry.pop("at") > 0.0
        matched = sorted(r["player_id"] for r in replies
                         if r.get("status") == "matched")
        return {"placement": rt.placement,
                "failovers": app.metrics.counters.get("device_failovers"),
                "crashes": app.metrics.counters.get("engine_crashes"),
                "log": log, "matched": matched,
                "gauges": sorted(k for k in app.metrics.gauges
                                 if k.startswith("failover_")),
                "events": _transcript(app)}
    finally:
        await app.stop()


async def test_device_lost_failover_demotes_to_surviving_devices(tmp_path):
    """The JAX package's test on both apps: D = 2 loses its last device,
    demotes onto (0,), and the pair redelivered after the loss matches on
    the demoted engine; every audited fact equals the JAX app's."""
    mine = await _failover("port", tmp_path / "p", mesh=2)
    assert mine == await _failover("jax", tmp_path / "j", mesh=2)
    assert mine["placement"] == (0,) and mine["failovers"] == 1
    assert mine["log"] == [{"queue": Q, "from_devices": [0, 1],
                            "to_devices": [0], "lost_device": 1,
                            "restored": 0}]
    assert mine["matched"] == ["a0", "a1", "b0", "b1"]
    kinds = [k for k, _, _ in mine["events"]]
    assert kinds.index("chaos_device_lost") < kinds.index("device_lost") \
        < kinds.index("engine_revive") < kinds.index("device_failover")


@pytest.mark.parametrize("mesh,lost_device,survivors", [
    (2, 0, (1,)), (4, -1, (0, 1, 2)), (4, 1, (0, 2, 3))])
async def test_failover_at_other_devices_and_wider_meshes(
        tmp_path, mesh, lost_device, survivors):
    """Losing device 0 of two, and one device of four (D = 4 → 3): the
    survivors, the audit and the transcript equal the JAX app's."""
    mine = await _failover("port", tmp_path / "p", mesh=mesh,
                           lost_device=lost_device)
    assert mine == await _failover("jax", tmp_path / "j", mesh=mesh,
                                   lost_device=lost_device)
    assert mine["placement"] == survivors and mine["failovers"] == 1
    assert mine["log"][0]["to_devices"] == list(survivors)


@pytest.mark.parametrize("team", [False, True])
async def test_no_demotion_takes_the_plain_revive(tmp_path, team):
    """A D = 1 queue, and a team queue (not elastic-shardable) sharded two
    ways, lose a device: both apps revive in place (no demotion, no
    failover entry, the binding untouched) and serve on."""
    mesh = 2 if team else 1
    pairs = ((("a0", 1500.0), ("a1", 1501.0), ("a2", 1502.0),
              ("a3", 1503.0)),) if team else (
        (("a0", 1500.0), ("a1", 1501.0)),)
    mine = await _failover("port", tmp_path / "p", mesh=mesh, team=team,
                           pairs=pairs)
    assert mine == await _failover("jax", tmp_path / "j", mesh=mesh,
                                   team=team, pairs=pairs)
    assert mine["placement"] is None and not mine["failovers"]
    assert mine["log"] == [] and mine["crashes"] == 1
    kinds = [k for k, _, _ in mine["events"]]
    assert "device_failover" not in kinds and "engine_revive" in kinds


def _hook_trace(mod, cfg_mod):
    cfg = cfg_mod.ChaosConfig(seed=1, queues=("q",), fail_steps=(1, 2),
                              device_lost_steps=(2, 4),
                              device_lost_device=0)
    hook = mod.EngineChaosHook(cfg, "q")
    out = []
    for _ in range(6):
        try:
            hook.on_step()
            out.append("ok")
        except mod.ChaosDeviceLostError as e:
            out.append(("lost", e.device, str(e)))
        except mod.ChaosInjectedError as e:
            out.append(("failed", str(e)))
    return out


def test_a_step_both_lost_and_failed_is_a_loss():
    """Step 2 is scripted both lost and failed: the loss wins, in both
    packages' hooks, and the rest of the schedule is alike."""
    mine = _hook_trace(chaos, config)
    assert mine == _hook_trace(jax_chaos, jax_config)
    assert mine[2][0] == "lost" and mine[1][0] == "failed"
    assert issubclass(chaos.ChaosDeviceLostError, chaos.ChaosInjectedError)


async def _scrape_after_failover(pkg, jdir):
    """Placement on, D = 2 at boot: the first step loses device 1 (the
    queue demotes to (0,)), then the controller forces a migration onto
    device 2; the Prometheus text and ``/debug/placement`` are fetched."""
    tree = _tree(jdir, mesh=2)
    tree["placement"] = {"interval_s": 3600.0, "devices": 4, "max_shard": 2,
                         "cooldown_s": 0.0}
    port = free_port()
    tree["metrics_port"] = port
    app = _app(pkg, tree)
    await app.start()
    rt = app.runtime(Q)
    replies: list[dict] = []
    try:
        _collect(app, replies)
        for pid, rating in (("a0", 1500.0), ("a1", 1501.0)):
            _publish(pkg, app, pid, rating)
        assert await _quiesce(app, rt, replies, 2)
        assert rt.placement == (0,)
        dec = await app.placement.force("migrate", Q, (2,))
        assert dec["status"] == "applied", dec
        assert rt.placement == (2,)
        prom = await get(port, "/metrics?format=prom")
        status, text = await get(port, "/debug/placement?n=4")
        body = json.loads(text)
        failover = body["failover"][Q]
        for entry in failover["demotions"]:
            assert entry.pop("blackout_ms") > 0.0 and entry.pop("at") > 0.0
        return {"prom": prom_shape(prom[1]), "status": status,
                "keys": sorted(body), "failover": failover,
                "decisions": [(d["kind"], d["from"], d["to"], d["status"])
                              for d in body["decisions"]],
                "live": body["live"][Q]["devices"]}
    finally:
        await app.stop()


async def test_prom_families_and_debug_placement_equal_jax_with_a_failover(
        tmp_path):
    mine = await _scrape_after_failover("port", tmp_path / "p")
    theirs = await _scrape_after_failover("jax", tmp_path / "j")
    families = mine.pop("prom")
    assert prom_differences(families, theirs.pop("prom")) == PROM_DIFFERENCES
    for name in ("device_failovers", "failover_blackout_ms",
                 "queue_migrations", "placement_migrations",
                 "placement_blackout_ms"):
        assert "matchmaking_" + name in families, name
    assert mine == theirs
    assert mine["status"] == 200 and mine["live"] == [2]
    assert {"failover", "arbiter", "decisions", "bindings"} <= set(
        mine["keys"])
