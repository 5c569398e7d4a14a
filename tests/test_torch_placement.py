"""The elastic placement control plane of the port against the JAX
package's, on the CPU: every script of the JAX package's
``tests/test_placement.py`` runs on both packages, and their results are
compared where both give one.

- State, policy and simulation (devices play no part): the typestate, the
  refusals, the snapshots and the decision traces of
  ``run_simulation`` equal the JAX package's, on its seeds and several
  more; a hypothesis property holds ``GreedyPolicy.plan`` to JAX's on
  random states and signal views.
- The D = 1 → 2 → 1 shard cycle through ``rebuild_engine`` on ``(cpu,) ×
  2``: each window's pairs bit-identical to a never-migrated control, and
  to the JAX package's cycle on the same seeded windows.
- The live scripts (migration under load, the controller's promotion and
  demotion, the refusal while degraded, chaos around a migration, the
  arbiter on co-located queues, the snapshot, a forced refusal, and a
  migration past the device inventory, which fails as JAX's IndexError
  does while the source serves on) run
  through each package's app; what is deterministic is compared equal
  (bindings, counters, decision kinds and statuses, snapshot keys), and
  each app is held to the script's own invariants (every player matched
  or waiting, nobody answered twice).
- Four scripts run under each package's own async sanitizer, every check
  on: the port's app under the port's (its settlement twin patches the
  port's broker and admission classes, its await-under-lock check sees the
  port's ``_pool_lock``), the JAX app under JAX's. For the port the
  settlement is also asserted directly: nothing left unacked, no admission
  credit held.
"""

import asyncio
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from matchmaking_tpu import config as jax_config
from matchmaking_tpu.control import arbiter as jax_arbiter
from matchmaking_tpu.control import executor as jax_executor
from matchmaking_tpu.control import policy as jax_policy
from matchmaking_tpu.control import simulate as jax_simulate
from matchmaking_tpu.control import state as jax_state
from matchmaking_tpu.engine.interface import make_engine as jax_make_engine
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.client import MatchmakingClient as JaxClient
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu.testing.sanitizer import AsyncSanitizer
from matchmaking_tpu_torch import config
from matchmaking_tpu_torch.control import arbiter, executor, policy, simulate
from matchmaking_tpu_torch.control import state
from matchmaking_tpu_torch.engine.interface import make_engine
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.client import MatchmakingClient
from matchmaking_tpu_torch.service.contract import SearchRequest
from matchmaking_tpu_torch.testing.sanitizer import \
    AsyncSanitizer as PortSanitizer

torch.set_num_threads(1)

pytestmark = pytest.mark.placement

#: Each package's modules, by the name the scripts use.
PKGS = {
    "jax": dict(config=jax_config, state=jax_state, policy=jax_policy,
                simulate=jax_simulate, arbiter=jax_arbiter,
                executor=jax_executor, make_engine=jax_make_engine,
                Request=JaxRequest, Client=JaxClient),
    "port": dict(config=config, state=state, policy=policy,
                 simulate=simulate, arbiter=arbiter, executor=executor,
                 make_engine=make_engine, Request=SearchRequest,
                 Client=MatchmakingClient),
}


def _cfg(pkg, d):
    """One config tree for both packages (the JAX one names its backend
    "tpu")."""
    if pkg == "jax":
        d = {**d, "engine": {**d.get("engine", {}), "backend": "tpu"}}
        return jax_config.Config.from_dict(d)
    return config.Config.from_dict(d, backend="gpu")


def _app(pkg, d):
    cfg = _cfg(pkg, d)
    return JaxApp(cfg) if pkg == "jax" else MatchmakingApp(cfg, device="cpu")


def _tiny(mesh=1):
    return {"queues": [{"rating_threshold": 100.0}],
            "engine": {"pool_capacity": 256, "pool_block": 64,
                       "batch_buckets": (8, 32), "top_k": 4,
                       "mesh_pool_axis": mesh}}


def _decisions(rows):
    """Audit rows without their wall-clock stamp and measured blackout."""
    return [{k: v for k, v in r.items() if k not in ("t", "blackout_ms")}
            for r in rows]


# ---- the sanitizer and the settlement, per package ---------------------------


@contextlib.contextmanager
def sanitized(pkg):
    """Each package's own sanitizer around its app's script, every check
    on (lock order, await under a lock, loop stalls, the settlement,
    journal, replication and speculation twins), asserted clean."""
    cls = AsyncSanitizer if pkg == "jax" else PortSanitizer
    san = cls(stall_threshold_s=2.0)
    with san.installed():
        yield san
    san.assert_clean()


async def _settle_check(pkg, app, san):
    """The settlement after a script drained: no admission credit open in
    the sanitizer's ledger; for the port also that deliveries were settled
    at all, nothing is left unacked on any queue's consumer and every
    admission controller is back to zero in flight (a double settle is
    the twin's finding, raised by ``assert_clean``)."""
    if pkg == "jax":
        assert san.settlement_report()["open_credits"] == []
        return
    for _ in range(200):
        if app.broker.handlers_idle():
            break
        await asyncio.sleep(0.01)
    report = san.settlement_report()
    assert report["open_credits"] == [] and report["settled"] > 0, report
    for rt in app._runtimes.values():
        consumer = app.broker._consumers.get(rt._tag)
        assert consumer is not None and not consumer.unacked, (
            rt.queue_cfg.name, sorted(consumer.unacked)
            if consumer is not None else None)
        if rt.admission is not None:
            assert rt.admission.inflight() == 0


# ---- state model -----------------------------------------------------------


def _typestate_script(m):
    st_ = m["state"]
    PlacementError = st_.PlacementError
    st = st_.PlacementState(4, decision_ring=3)
    st.bind("a", (0,))
    st.bind("b", (1,))
    d = st.begin("migrate", "a", (2,), now=10.0, signals={"x": 1})
    with pytest.raises(PlacementError) as e1:
        st.begin("migrate", "a", (3,), now=10.0)
    st.complete(d, 11.0, blackout_s=0.01, transferred=5)
    assert st.placement("a").devices == (2,)
    assert st.placement("a").generation == 1
    assert st.blackout_max["a"] == pytest.approx(0.01)
    d2 = st.begin("migrate", "a", (3,), now=20.0)
    st.fail(d2, 21.0, "boom")
    assert st.placement("a").devices == (2,)
    assert st.placement("a").last_action_t == 21.0
    with pytest.raises(PlacementError) as e2:
        st.begin("migrate", "b", (9,), now=30.0)
    with pytest.raises(PlacementError) as e3:
        st.begin("migrate", "b", (1, 1), now=30.0)
    for i in range(5):
        di = st.begin("migrate", "b", ((i % 2) + 2,), now=40.0 + i)
        st.complete(di, 40.0 + i, 0.0, 0)
    assert len(st.decisions) == 3
    snap = st.snapshot()
    assert snap["bindings"]["a"]["devices"] == [2]
    assert len(snap["decisions"]) == 3
    return snap, [str(e.value) for e in (e1, e2, e3)]


def test_placement_state_typestate_exactly_once_and_audit():
    assert _typestate_script(PKGS["port"]) == _typestate_script(PKGS["jax"])


def _shared_script(m):
    st = m["state"].PlacementState(4)
    st.bind("a", (0,))
    st.bind("b", (0,))
    st.bind("c", (1, 2))
    assert st.queues_on(0) == ["a", "b"]
    assert st.shared_devices() == {0}
    assert st.free_devices() == [3]
    return st.snapshot()


def test_placement_state_shared_and_free_devices():
    assert _shared_script(PKGS["port"]) == _shared_script(PKGS["jax"])


def _refusal_script(m):
    st = m["state"].PlacementState(2)
    st.bind("a", (0,))
    d = st.refuse("migrate", "a", (0,), now=5.0, detail="already there")
    assert d.status == "refused" and d.src == (0,) and d.dst == (0,)
    st.refuse("migrate", "ghost", (7,), now=6.0, detail="unknown queue")
    assert [x.status for x in st.decisions] == ["refused", "refused"]
    return st.snapshot()


def test_placement_state_refusals_are_audited():
    assert _refusal_script(PKGS["port"]) == _refusal_script(PKGS["jax"])


# ---- greedy policy over the seeded simulation ------------------------------


def _sim(m, seed, ticks=40, jitter=0.0):
    cfg = m["config"].PlacementConfig(interval_s=0.1, devices=3,
                                      cooldown_s=2.0, max_shard=2)
    SimQueue = m["simulate"].SimQueue
    queues = [
        SimQueue(name="hot", load=(0.3, 1.6, 0.1), edges=(0, 5, 18),
                 device=0, shardable=True, jitter=jitter),
        SimQueue(name="cold", load=(0.1,), edges=(0,), device=0,
                 jitter=jitter),
    ]
    return m["simulate"].run_simulation(cfg, queues, ticks=ticks, seed=seed)


def test_greedy_policy_sim_canonical_migrate_promote_demote():
    """The JAX script's story (a co-located hot queue migrates to an idle
    device, promotes to D = 2, demotes once load recedes), deterministic
    on the seed; the port's whole trace equals the JAX package's."""
    out = _sim(PKGS["port"], 7)
    kinds = [(d["kind"], d["queue"], tuple(d["to"])) for d in out["decisions"]]
    assert kinds == [("migrate", "hot", (1,)),
                     ("promote", "hot", (1, 2)),
                     ("demote", "hot", (1,))]
    for d in out["decisions"]:
        assert "hot" in d["signals"] and d["status"] == "applied"
        assert 0.0 < d["blackout_ms"] < 100.0
    assert out == _sim(PKGS["port"], 7)
    assert out == _sim(PKGS["jax"], 7)
    assert _sim(PKGS["port"], 8) == _sim(PKGS["jax"], 8)


@pytest.mark.parametrize("seed,jitter", [(0, 0.3), (1, 0.5), (3, 0.2),
                                         (11, 0.4), (42, 0.6)])
def test_simulation_trace_equals_jax_on_more_seeds(seed, jitter):
    """Jittered load (the seeded RNG draws) on more seeds: the traces,
    every tick's signals and decisions, equal the JAX package's."""
    mine = _sim(PKGS["port"], seed, ticks=60, jitter=jitter)
    theirs = _sim(PKGS["jax"], seed, ticks=60, jitter=jitter)
    assert mine == theirs
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)


def _policy_script(m):
    cfg = m["config"].PlacementConfig(interval_s=1.0, devices=3,
                                      cooldown_s=100.0, max_shard=2)
    P, S, V = (m["policy"].GreedyPolicy, m["policy"].QueueSignals,
               m["policy"].SignalView)
    pol = P(cfg)
    st = m["state"].PlacementState(3)
    st.bind("hot", (0,))
    st.bind("cold", (0,))
    hot = S(burning=True, idle_frac=0.0, occupancy=1.0, shardable=True)
    view = V(queues={"hot": hot, "cold": S()})

    def plan(v, now):
        return [(a.kind, a.queue, a.devices, a.signals, a.reason)
                for a in pol.plan(st, v, now=now)]

    out = [plan(view, 1000.0)]
    assert [a[:3] for a in out[0]] == [("migrate", "hot", (1,))]
    d = st.begin("migrate", "hot", (1,), now=1000.0)
    st.complete(d, 1000.0, 0.0, 0)
    out.append(plan(view, 1050.0))
    assert out[-1] == []
    out.append(plan(view, 2000.0))
    assert [a[:3] for a in out[-1]] == [("promote", "hot", (1, 2))]
    view_deg = V(queues={"hot": dataclasses.replace(hot, degraded=True),
                         "cold": S()})
    out.append(plan(view_deg, 3000.0))
    assert out[-1] == []
    return out


def test_greedy_policy_cooldown_degraded_and_solo_rules():
    assert _policy_script(PKGS["port"]) == _policy_script(PKGS["jax"])


_signals = st.builds(
    dict, burning=st.booleans(),
    idle_frac=st.floats(0.0, 1.0, allow_nan=False),
    occupancy=st.floats(0.0, 1.0, allow_nan=False),
    p99_ms=st.floats(0.0, 1e3, allow_nan=False),
    pool=st.integers(0, 10_000), degraded=st.booleans(),
    shardable=st.booleans())


@st.composite
def _worlds(draw):
    n = draw(st.integers(1, 4))
    names = draw(st.lists(st.sampled_from(["a", "b", "c", "d", "e"]),
                          min_size=1, max_size=4, unique=True))
    bindings = {}
    for q in names:
        k = draw(st.integers(1, n))
        bindings[q] = tuple(sorted(draw(st.lists(
            st.integers(0, n - 1), min_size=k, max_size=k, unique=True))))
    last = {q: draw(st.sampled_from([0.0, 50.0, 95.0])) for q in names}
    sigs = {q: draw(_signals) for q in names if draw(st.booleans())}
    cfg = dict(
        interval_s=1.0, devices=n,
        hot_idle_below=draw(st.sampled_from([0.1, 0.15, 0.3])),
        cold_idle_above=draw(st.sampled_from([0.3, 0.5, 0.7])),
        min_idle_gain=draw(st.sampled_from([0.0, 0.2, 0.5])),
        cooldown_s=draw(st.sampled_from([0.0, 10.0, 60.0])),
        max_shard=draw(st.integers(1, 3)),
        promote_occupancy=draw(st.sampled_from([0.0, 0.5, 0.9])),
        demote_idle_above=draw(st.sampled_from([0.5, 0.8])))
    return cfg, bindings, last, sigs


def _plan(m, world, now):
    cfg, bindings, last, sigs = world
    st_ = m["state"].PlacementState(cfg["devices"])
    for q, devs in bindings.items():
        st_.bind(q, devs)
        st_.placement(q).last_action_t = last[q]
    S = m["policy"].QueueSignals
    view = m["policy"].SignalView(queues={q: S(**s) for q, s in sigs.items()})
    pol = m["policy"].GreedyPolicy(m["config"].PlacementConfig(**cfg))
    return [(a.kind, a.queue, a.devices, a.signals, a.reason)
            for a in pol.plan(st_, view, now)]


@settings(max_examples=300, deadline=None)
@given(world=_worlds(), now=st.sampled_from([10.0, 60.0, 100.0]))
def test_greedy_policy_plans_equal_jax_on_random_views(world, now):
    assert _plan(PKGS["port"], world, now) == _plan(PKGS["jax"], world, now)


# ---- the shard cycle (the bit-identity proof) ------------------------------


def _seeded(m, rng, n, start):
    return [m["Request"](id=f"s{start + i}", rating=float(r),
                         rating_deviation=60.0, game_mode="m", region="r")
            for i, r in enumerate(rng.normal(1500.0, 120.0, n))]


def _match_pairs(out):
    rows = []
    for match in out.matches:
        ids = sorted(r.id for r in match.requests())
        rows.append((ids[0], ids[1], float(match.quality)))
    return sorted(rows)


def _engine(pkg, mesh, devices):
    cfg = _cfg(pkg, _tiny(mesh))
    if pkg == "jax":
        return jax_make_engine(cfg, cfg.queues[0], devices=devices)
    return make_engine(cfg, cfg.queues[0], device="cpu",
                       devices=tuple(torch.device("cpu") for _ in devices))


def _cycle(pkg, columns):
    """Promote → demote (D = 1 → 2 → 1) through ``rebuild_engine``,
    beside a never-migrated control fed the same seeded windows."""
    m = PKGS[pkg]
    rebuild = m["executor"].rebuild_engine
    kw = {"columns": columns} if pkg == "port" else {}
    rng = np.random.default_rng(42)
    windows = [_seeded(m, rng, 24, 100 * k) for k in range(3)]
    control = _engine(pkg, 1, (0,))
    cycle = _engine(pkg, 1, (0,))
    outs = [[_match_pairs(control.search(windows[0], 1000.0))],
            [_match_pairs(cycle.search(windows[0], 1000.0))]]
    cycle, stats = rebuild(cycle, lambda: _engine(pkg, 2, (0, 1)),
                           now=1000.5, **kw)
    assert stats["transferred"] == control.pool_size()
    if pkg == "port":
        assert type(cycle.kernels).__name__ == "ShardedKernelSet"
    outs[0].append(_match_pairs(control.search(windows[1], 1001.0)))
    outs[1].append(_match_pairs(cycle.search(windows[1], 1001.0)))
    cycle, stats = rebuild(cycle, lambda: _engine(pkg, 1, (1,)),
                           now=1001.5, **kw)
    outs[0].append(_match_pairs(control.search(windows[2], 1002.0)))
    outs[1].append(_match_pairs(cycle.search(windows[2], 1002.0)))
    assert outs[1] == outs[0]
    assert cycle.pool_size() == control.pool_size()
    rep_cycle, rep_control = cycle.quality_report(), control.quality_report()
    assert rep_cycle["samples"] == rep_control["samples"] > 0
    waiting = sorted((r.id, r.rating) for r in cycle.waiting())
    return outs[1], waiting, rep_cycle["samples"]


@pytest.mark.parametrize("columns", [True, False])
def test_shard_cycle_bit_identical_vs_never_migrated_control(columns):
    """The port's D = 1 → 2 → 1 cycle on ``(cpu,) × 2`` (its pool moved as
    columns, and as requests) is bit-identical to its never-migrated
    control and to the JAX package's cycle on the same seeded windows."""
    assert _cycle("port", columns) == _cycle("jax", None)


def _rebuild_failure(pkg):
    m = PKGS[pkg]
    engine = _engine(pkg, 1, (0,))
    rng = np.random.default_rng(3)
    engine.search(_seeded(m, rng, 9, 0), 1000.0)
    before = engine.pool_size()
    assert before > 0

    def broken():
        raise RuntimeError("no such device")

    with pytest.raises(m["executor"].MigrationFailed) as e:
        m["executor"].rebuild_engine(engine, broken, now=1000.5)
    assert engine.pool_size() == before
    out = engine.search(_seeded(m, rng, 9, 50), 1001.0)
    assert out.matches
    return before, _match_pairs(out), str(e.value)


def test_rebuild_failure_leaves_source_engine_serving():
    assert _rebuild_failure("port") == _rebuild_failure("jax")


def test_adopt_interners_keeps_the_old_codes():
    """A successor pool adopts the old pool's region and mode codes in
    their order (names already known keep their codes), as JAX's does."""
    got = {}
    for pkg in PKGS:
        old, new = _engine(pkg, 1, (0,)), _engine(pkg, 1, (0,))
        for name in ("eu", "na", "apac"):
            old.pool.regions.code(name)
        old.pool.modes.code("ranked")
        new.pool.regions.code("na")
        PKGS[pkg]["executor"].adopt_interners(new, old)
        got[pkg] = (list(new.pool.regions._names), list(new.pool.modes._names))
    assert got["port"] == got["jax"]


# ---- live migration through the app ----------------------------------------


_MIG = {"queues": [{"name": "mig.q", "rating_threshold": 200.0}],
        "engine": {"pool_capacity": 256, "pool_block": 64,
                   "batch_buckets": (8, 32), "top_k": 4},
        "batcher": {"max_batch": 8, "max_wait_ms": 5.0},
        "overload": {"max_inflight": 128},
        "placement": {"interval_s": 3600.0, "devices": 4}}


async def _live_migration(pkg):
    app = _app(pkg, _MIG)
    with sanitized(pkg) as san:
        await app.start()
        try:
            rt = app.runtime("mig.q")
            assert rt.placement == (0,)
            client = PKGS[pkg]["Client"](app.broker, "mig.q")

            async def one(i):
                return await client.search_until_matched(
                    {"id": f"p{i}", "rating": 1500 + (i % 11) * 9},
                    timeout=15.0)

            tasks = [asyncio.create_task(one(i)) for i in range(60)]
            await asyncio.sleep(0.02)
            stats = await rt.migrate((2,))
            assert stats["devices"] == (2,)
            assert 0.0 < stats["blackout_s"] < 30.0
            if pkg == "jax":
                assert rt.engine.devices == (2,)
            else:
                assert rt.engine.devices == (app.inventory[2],)
            await asyncio.sleep(0.02)
            await rt.migrate((1,))
            assert rt.placement == (1,)
            results = await asyncio.gather(*tasks)
            matched = [r for r in results if r.status == "matched"]
            ids = [r.player_id for r in matched]
            assert len(ids) == len(set(ids)), "duplicate terminal responses"
            waiting = {r.id for r in rt.engine.waiting()}
            assert len(matched) + len(waiting) == 60
            assert waiting == {f"p{i}" for i in range(60)} - set(ids)
            assert len(matched) >= 50
            snap = app.placement.snapshot()
            await _settle_check(pkg, app, san)
            return {"migrations": app.metrics.counters.get("queue_migrations"),
                    "placement": rt.placement,
                    "live": snap["live"]["mig.q"]["devices"],
                    "bindings": snap["bindings"],
                    "statuses": sorted({r.status for r in results})}
        finally:
            await app.stop()


async def test_live_migration_under_load_zero_lost_or_dup():
    """Two live migrations (move and back) while 60 players stream
    through admission: every player is answered once or still waits, in
    both apps, and their bindings, counters and snapshots agree."""
    mine = await _live_migration("port")
    assert mine == await _live_migration("jax")
    assert mine["migrations"] == 2 and mine["live"] == [1]


_EL = {"queues": [{"name": "el.q", "rating_threshold": 200.0}],
       "engine": {"pool_capacity": 256, "pool_block": 64,
                  "batch_buckets": (8, 32), "top_k": 4},
       "batcher": {"max_batch": 8, "max_wait_ms": 5.0},
       "placement": {"interval_s": 3600.0, "devices": 4, "max_shard": 2,
                     "cooldown_s": 0.0}}


async def _promote_demote(pkg):
    m = PKGS[pkg]
    app = _app(pkg, _EL)
    with sanitized(pkg) as san:
        await app.start()
        try:
            rt = app.runtime("el.q")
            S, V = m["policy"].QueueSignals, m["policy"].SignalView
            hot = V(queues={"el.q": S(burning=True, idle_frac=0.0,
                                      occupancy=0.9, shardable=True)})
            dec = await app.placement.step(now=1000.0, view=hot)
            assert dec is not None and dec["kind"] == "promote"
            assert rt.placement == (0, 1)
            kernels = [type(rt.engine.kernels).__name__]
            assert kernels[0] == "ShardedKernelSet"
            if pkg == "port":
                assert rt.engine.kernels.mesh.devices == app.inventory.resolve(
                    (0, 1))
            cold = V(queues={"el.q": S(burning=False, idle_frac=0.95,
                                       occupancy=0.05, shardable=True)})
            dec2 = await app.placement.step(now=2000.0, view=cold)
            assert dec2 is not None and dec2["kind"] == "demote"
            assert rt.placement == (0,)
            kernels.append(type(rt.engine.kernels).__name__)
            assert kernels[1] == "KernelSet"
            snap = app.placement.snapshot()
            for d in snap["decisions"]:
                assert d["status"] == "applied"
                assert d["blackout_ms"] > 0.0
                assert "el.q" in d["signals"]
            assert snap["bindings"]["el.q"]["generation"] == 2
            client = m["Client"](app.broker, "el.q")
            r = await asyncio.gather(*[
                client.search_until_matched({"id": f"e{i}", "rating": 1500},
                                            timeout=10.0) for i in range(4)])
            matched = [x for x in r if x.status == "matched"]
            assert len(matched) + rt.engine.pool_size() == 4
            assert len(matched) >= 2
            await _settle_check(pkg, app, san)
            snap = app.placement.snapshot()
            return {"kernels": kernels,
                    "decisions": _decisions(snap["decisions"]),
                    "bindings": snap["bindings"],
                    "ticks": snap["ticks"],
                    "migrations": snap["migrations"],
                    "gauge": sorted(k for k in app.metrics.gauges
                                    if "blackout" in k)}
        finally:
            await app.stop()


async def test_controller_promote_demote_audited_with_blackout():
    """Injected signal views drive a promotion (D = 1 → 2: the engine
    rebuilds onto the sharded kernel set) and a demotion back, each
    audited with its signals and blackout, and traffic matches after; the
    decisions, bindings and kernel sets equal the JAX app's."""
    assert await _promote_demote("port") == await _promote_demote("jax")


_DEG = {"queues": [{"name": "deg.q"}],
        "engine": {"pool_capacity": 128, "pool_block": 32,
                   "batch_buckets": (8,), "top_k": 4,
                   "breaker_threshold": 1},
        "placement": {"interval_s": 3600.0, "devices": 2}}


async def _refused_degraded(pkg):
    app = _app(pkg, _DEG)
    await app.start()
    try:
        rt = app.runtime("deg.q")
        rt.breaker.record_crash(0.0)
        assert rt.breaker.state != "closed"
        with pytest.raises(RuntimeError, match="degraded") as e:
            await rt.migrate((1,))
        assert rt.placement == (0,)
        return str(e.value)
    finally:
        await app.stop()


async def test_migration_refused_while_degraded():
    assert await _refused_degraded("port") == await _refused_degraded("jax")


_CX = {"queues": [{"name": "cx.q", "rating_threshold": 200.0}],
       "engine": {"pool_capacity": 256, "pool_block": 64,
                  "batch_buckets": (8, 32), "top_k": 4},
       "batcher": {"max_batch": 8, "max_wait_ms": 5.0},
       "overload": {"max_inflight": 128},
       "chaos": {"seed": 11, "queues": ("cx.q",), "fail_steps": (2, 5),
                 "dup_seqs": ((3, 1),)},
       "placement": {"interval_s": 3600.0, "devices": 4},
       "debug_invariants": True}


async def _chaos_migration(pkg):
    app = _app(pkg, _CX)
    with sanitized(pkg) as san:
        await app.start()
        try:
            rt = app.runtime("cx.q")
            client = PKGS[pkg]["Client"](app.broker, "cx.q")

            async def one(i):
                return await client.search_until_matched(
                    {"id": f"c{i}", "rating": 1500 + (i % 13) * 7},
                    timeout=20.0)

            tasks = [asyncio.create_task(one(i)) for i in range(40)]
            await asyncio.sleep(0.05)
            before = rt.engine.quality_report()["samples"]
            await rt.migrate((3,))
            mid = rt.engine.quality_report()["samples"]
            assert mid >= before
            await asyncio.sleep(0.05)
            await rt.migrate((0,))
            results = await asyncio.gather(*tasks)
            matched = [r for r in results if r.status == "matched"]
            ids = [r.player_id for r in matched]
            assert len(ids) == len(set(ids)), "duplicate terminal responses"
            waiting = {r.id for r in rt.engine.waiting()}
            assert len(matched) + len(waiting) == 40
            assert len(matched) >= 30
            assert app.metrics.counters.get("engine_crashes") >= 1
            assert rt.engine.quality_report()["samples"] >= max(mid, 1)
            await _settle_check(pkg, app, san)
            return {"placement": rt.placement,
                    "migrations": app.metrics.counters.get("queue_migrations"),
                    "crashed": app.metrics.counters.get("engine_crashes") >= 1,
                    "accounted": len(matched) + len(waiting)}
        finally:
            await app.stop()


@pytest.mark.chaos
async def test_chaos_fault_around_migration_settlement_clean():
    """A seeded fault schedule firing around two live migrations: nobody
    answered twice, every player matched or waiting, quality monotone,
    the settlement clean, in both apps."""
    assert await _chaos_migration("port") == await _chaos_migration("jax")


# ---- the cross-queue dispatch arbiter --------------------------------------


def _window_keys(m):
    class D:
        def __init__(self, tier, deadline):
            self.tier = tier
            self.deadline = deadline

    wk = m["arbiter"].window_key
    out = [wk([D(2, 50.0), D(1, 900.0), D(1, 30.0)]), wk([D(0, 0.0)]),
           wk([]), wk([D(3, -1.0), D(3, 7.0)])]
    assert out[:3] == [(1, 30.0), (0, float("inf")), (1 << 30, float("inf"))]
    return out


def test_window_key_min_tier_then_deadline():
    assert _window_keys(PKGS["port"]) == _window_keys(PKGS["jax"])


async def _edf_order(m):
    arb = m["arbiter"].DispatchArbiter()
    arb.set_shared({0})
    order: list[str] = []

    async def holder():
        async with arb.slot(0, (0, 1.0)):
            order.append("hold")
            await asyncio.sleep(0.05)

    async def waiter(name, key, delay):
        await asyncio.sleep(delay)
        async with arb.slot(0, key):
            order.append(name)

    await asyncio.gather(
        holder(),
        waiter("late-tier0", (0, 10.0), 0.02),
        waiter("tier2", (2, 1.0), 0.01),
        waiter("tier1-early-deadline", (1, 5.0), 0.015),
        waiter("tier1-late-deadline", (1, 99.0), 0.012),
    )
    assert order == ["hold", "late-tier0", "tier1-early-deadline",
                     "tier1-late-deadline", "tier2"]
    snap = arb.snapshot()
    assert snap["grants"] == 5 and snap["holds"] == 4
    assert not arb.engaged(1)
    async with arb.slot(1, (0, 0.0)):
        pass
    assert arb.snapshot()["grants"] == 5
    return order, arb.snapshot()


async def test_arbiter_grants_waiters_in_edf_order():
    assert await _edf_order(PKGS["port"]) == await _edf_order(PKGS["jax"])


async def _cancelled_waiter(m):
    arb = m["arbiter"].DispatchArbiter()
    arb.set_shared({0})
    done: list[str] = []

    async def holder():
        async with arb.slot(0, (0, 1.0)):
            await asyncio.sleep(0.05)
            done.append("holder")

    async def doomed():
        await asyncio.sleep(0.01)
        async with arb.slot(0, (0, 2.0)):
            done.append("doomed")

    async def survivor():
        await asyncio.sleep(0.02)
        async with arb.slot(0, (3, 99.0)):
            done.append("survivor")

    h = asyncio.create_task(holder())
    d = asyncio.create_task(doomed())
    s = asyncio.create_task(survivor())
    await asyncio.sleep(0.03)
    d.cancel()
    await asyncio.gather(h, s, return_exceptions=True)
    assert done == ["holder", "survivor"]
    async with arb.slot(0, (0, 0.0)):
        done.append("after")
    assert not arb.snapshot()["waiting"]
    return done, arb.snapshot()


async def test_arbiter_cancelled_waiter_does_not_wedge_device():
    assert (await _cancelled_waiter(PKGS["port"])
            == await _cancelled_waiter(PKGS["jax"]))


_AR = {"queues": [{"name": "ar.a", "rating_threshold": 200.0},
                  {"name": "ar.b", "rating_threshold": 200.0}],
       "engine": {"pool_capacity": 128, "pool_block": 32,
                  "batch_buckets": (8,), "top_k": 4},
       "batcher": {"max_batch": 8, "max_wait_ms": 5.0},
       "placement": {"interval_s": 3600.0, "devices": 2, "cooldown_s": 0.0}}


async def _colocated(pkg):
    m = PKGS[pkg]
    app = _app(pkg, _AR)
    with sanitized(pkg) as san:
        await app.start()
        try:
            ctrl = app.placement
            boot = {q: app.runtime(q).placement for q in ("ar.a", "ar.b")}
            dec = ctrl.state.begin("migrate", "ar.b", (0,), now=1.0)
            stats = await app.runtime("ar.b").migrate((0,))
            ctrl.state.complete(dec, 2.0, stats["blackout_s"],
                                stats["transferred"])
            ctrl._feed_arbiter()
            assert ctrl.arbiter.engaged(0)
            ca, cb = (m["Client"](app.broker, q) for q in ("ar.a", "ar.b"))
            results = await asyncio.gather(*(
                [ca.search_until_matched(
                    {"id": f"a{i}", "rating": 1500 + 3 * i}, timeout=10.0)
                 for i in range(6)]
                + [cb.search_until_matched(
                    {"id": f"b{i}", "rating": 1500 + 3 * i}, timeout=10.0)
                   for i in range(6)]))
            matched = [r for r in results if r.status == "matched"]
            waiting = (len(app.runtime("ar.a").engine.waiting())
                       + len(app.runtime("ar.b").engine.waiting()))
            assert len(matched) + waiting == 12
            assert len(matched) >= 8
            assert ctrl.arbiter.grants > 0
            engaged = ctrl.arbiter.snapshot()["shared_devices"]
            dec2 = ctrl.state.begin("migrate", "ar.b", (1,), now=3.0)
            stats2 = await app.runtime("ar.b").migrate((1,))
            ctrl.state.complete(dec2, 4.0, stats2["blackout_s"],
                                stats2["transferred"])
            ctrl._feed_arbiter()
            assert not ctrl.arbiter.engaged(0)
            await _settle_check(pkg, app, san)
            return {"boot": boot, "engaged": engaged,
                    "after": ctrl.arbiter.snapshot()["shared_devices"],
                    "accounted": len(matched) + waiting}
        finally:
            await app.stop()


async def test_arbiter_engages_only_on_colocated_queues():
    """Two queues bound to one device engage the arbiter (the controller
    feeds the shared set) and both still serve; moving one away
    disengages it, in both apps alike."""
    assert await _colocated("port") == await _colocated("jax")


# ---- /debug/placement's payload and refusals --------------------------------


_JS = {"queues": [{"name": "js.q"}],
       "engine": {"pool_capacity": 128, "pool_block": 32,
                  "batch_buckets": (8,), "top_k": 4},
       "placement": {"interval_s": 3600.0, "devices": 2}}


async def _snapshot(pkg):
    app = _app(pkg, _JS)
    await app.start()
    try:
        snap = app.placement.snapshot()
        json.dumps(snap)
        assert snap["n_devices"] == 2
        assert snap["bindings"]["js.q"]["devices"] == [0]
        assert snap["interval_s"] == 3600.0
        assert "arbiter" in snap and "live" in snap
        engine = snap["live"]["js.q"].pop("engine")
        return snap, engine
    finally:
        await app.stop()


async def test_placement_snapshot_is_json_ready():
    """The snapshot is JSON-ready and equals the JAX app's, but for the
    serving engine's class name (``GpuEngine`` against ``TpuEngine``)."""
    mine, engine = await _snapshot("port")
    theirs, jengine = await _snapshot("jax")
    assert mine == theirs
    assert (engine, jengine) == ("GpuEngine", "TpuEngine")


_RF = {"queues": [{"name": "rf.q"}],
       "engine": {"pool_capacity": 128, "pool_block": 32,
                  "batch_buckets": (8,), "top_k": 4},
       "placement": {"interval_s": 3600.0, "devices": 2}}


async def _forced_refusal(pkg):
    app = _app(pkg, _RF)
    await app.start()
    try:
        dec = await app.placement.force("migrate", "rf.q", (0,))
        assert dec is not None and dec["status"] == "refused"
        dec2 = await app.placement.force("migrate", "nope", (1,))
        assert dec2 is not None and dec2["status"] == "refused"
        snap = app.placement.snapshot()
        assert [d["status"] for d in snap["decisions"]] == ["refused",
                                                            "refused"]
        assert snap["refusals"] == 2
        assert app.placement.state.placement("rf.q").status == "stable"
        return _decisions(snap["decisions"]), snap["refusals"]
    finally:
        await app.stop()


async def test_controller_force_refusal_lands_in_audit_ring():
    assert await _forced_refusal("port") == await _forced_refusal("jax")


_PAST = {"queues": [{"name": "px.q", "rating_threshold": 200.0}],
         "engine": {"pool_capacity": 128, "pool_block": 32,
                    "batch_buckets": (8,), "top_k": 4},
         "batcher": {"max_batch": 8, "max_wait_ms": 5.0},
         "placement": {"interval_s": 3600.0, "devices": 10,
                       "cooldown_s": 0.0}}


async def _past_the_inventory(pkg):
    """A binding past the inventory (the JAX tests' 8 virtual devices;
    the port's app given eight CPU entries) fails the engine build: the
    decision fails, the binding stays, the queue serves on."""
    if pkg == "jax":
        app = _app(pkg, _PAST)
    else:
        app = MatchmakingApp(_cfg(pkg, _PAST), device="cpu",
                             devices=("cpu",) * 8)
    await app.start()
    try:
        rt = app.runtime("px.q")
        dec = await app.placement.force("migrate", "px.q", (9,))
        assert dec["status"] == "failed" and rt.placement == (0,)
        client = PKGS[pkg]["Client"](app.broker, "px.q")
        r = await asyncio.gather(*[
            client.search_until_matched({"id": f"x{i}", "rating": 1500 + i},
                                        timeout=10.0) for i in range(2)])
        snap = app.placement.snapshot()
        return ({k: v for k, v in _decisions(snap["decisions"])[0].items()
                 if k != "detail"}, snap["failures"],
                sorted(x.status for x in r), snap["live"]["px.q"]["devices"])
    finally:
        await app.stop()


async def test_migration_past_the_inventory_fails_and_the_source_serves():
    mine = await _past_the_inventory("port")
    assert mine == await _past_the_inventory("jax")
    assert mine[1] == 1 and mine[3] == [0]
