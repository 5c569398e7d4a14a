"""The sharded team and role sets (``ShardedTeamKernelSet``,
``ShardedRoleKernelSet``) against the JAX package's, on the CPU.

Twins of tests/test_teams_device.py's ``TestShardedTeams`` and
``TestRingShardedTeams``, of tests/test_roles_device.py's sharded tests,
and of tests/test_bucketed.py's tournament-merge tests. Each engine-level
twin runs the JAX ``TpuEngine`` (8 virtual CPU devices) and the port's
``GpuEngine`` (a mesh of CPU entries) side by side, arrival by arrival:
the same match members (and, for roles, the same team A), the same
qualities bit for bit, the same pool sizes and ``team_ring_*`` counters.
Step-level twins compare the packed results and the pools bit for bit
with the JAX sharded steps. The frontier helpers (``pack_frontier``,
``merge_frontiers`` both ways) are held to JAX's on gathered buffers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.core.pool import PACKED_ROWS
from matchmaking_tpu.engine import role_kernels as jax_roles
from matchmaking_tpu.engine import sharded as jax_sharded
from matchmaking_tpu.engine import teams as jax_teams
from matchmaking_tpu.engine.cpu import CpuEngine as JaxCpuEngine
from matchmaking_tpu.engine.interface import make_engine as jax_make_engine
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.engine import role_kernels, sharded, teams
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.service.contract import SearchRequest

torch.set_num_threads(1)

SLOTS2 = ("tank", "dps")


def engine_pair(queue_kw, **engine_kw):
    ec = dict(pool_capacity=256, pool_block=64, batch_buckets=(16, 64),
              team_max_matches=32)
    ec.update(engine_kw)
    jcfg = JaxConfig(queues=(JaxQueueConfig(**queue_kw),),
                     engine=JaxEngineConfig(backend="tpu", **ec))
    tcfg = Config(queues=(QueueConfig(**queue_kw),),
                  engine=EngineConfig(backend="gpu", **ec))
    return (jax_make_engine(jcfg, jcfg.queues[0]),
            GpuEngine(tcfg, tcfg.queues[0], device="cpu"))


def req(cls, i, rating, roles=(), thr=None):
    return cls(id=f"p{i}", rating=float(rating), region="eu",
               game_mode="std", rating_threshold=thr, roles=tuple(roles),
               enqueued_at=0.0)


def keyed(out):
    """Per match: sorted member ids per team (teams sorted), team A's
    sorted ids, and the quality."""
    return [(tuple(sorted(tuple(sorted(p.id for p in t)) for t in m.teams)),
             tuple(sorted(p.id for p in m.teams[0])), m.quality)
            for m in out.matches]


def arrivals(jeng, teng, ratings, roles_cycle=None):
    """One arrival a window through both engines; the matches formed."""
    n = 0
    for i, r in enumerate(ratings):
        roles = roles_cycle[i % len(roles_cycle)] if roles_cycle else ()
        mine = keyed(teng.search([req(SearchRequest, i, int(r), roles)],
                                 float(i)))
        theirs = keyed(jeng.search([req(JaxRequest, i, int(r), roles)],
                                   float(i)))
        assert mine == theirs, f"step {i}"
        assert teng.pool_size() == jeng.pool_size(), f"step {i}"
        n += len(mine)
    return n


def assert_ring_counters(jeng, teng):
    for name in ("team_ring_steps", "team_ring_fallback"):
        assert teng.counters.get(name) == jeng.counters.get(name), name


# ---- TestShardedTeams / TestRingShardedTeams twins ---------------------------


@pytest.mark.parametrize("team_size", [2, 5])
def test_sharded_equals_single_device(team_size):
    q = dict(team_size=team_size, rating_threshold=50.0)
    jeng, teng = engine_pair(q, mesh_pool_axis=8)
    _, single = engine_pair(q)
    rng = np.random.default_rng(21)
    ratings = rng.permutation(700)[:90] + 1200
    n = 0
    for i, r in enumerate(ratings):
        mine = keyed(teng.search([req(SearchRequest, i, int(r))], float(i)))
        theirs = keyed(jeng.search([req(JaxRequest, i, int(r))], float(i)))
        one = keyed(single.search([req(SearchRequest, i, int(r))], float(i)))
        assert mine == theirs, f"step {i}"
        assert [m[0] for m in mine] == [m[0] for m in one], f"step {i}"
        n += len(mine)
    assert n >= 3
    assert teng.pool_size() == jeng.pool_size() == single.pool_size()


def test_sharded_team_widening():
    q = dict(team_size=2, rating_threshold=20.0, widen_per_sec=10.0,
             max_threshold=200.0)
    jeng, teng = engine_pair(q, pool_capacity=64, pool_block=16,
                             batch_buckets=(16,), team_max_matches=8,
                             mesh_pool_axis=8)
    for eng, cls in ((jeng, JaxRequest), (teng, SearchRequest)):
        eng.restore([req(cls, i, 1000 + 20 * i) for i in range(3)], 0.0)
    mine = keyed(teng.search([req(SearchRequest, 3, 1060)], 5.0))
    assert mine == keyed(jeng.search([req(JaxRequest, 3, 1060)], 5.0))
    assert len(mine) == 1 and len(mine[0][0][0] + mine[0][0][1]) == 4


@pytest.mark.parametrize("mesh", [2, 4, 8])
def test_ring_equals_replicated_and_oracle(mesh):
    q = dict(team_size=2, rating_threshold=50.0)
    jring, ring = engine_pair(q, mesh_pool_axis=mesh, team_ring_k=128)
    _, rep = engine_pair(q, mesh_pool_axis=mesh)
    jcfg = JaxConfig(queues=(JaxQueueConfig(**q),),
                     engine=JaxEngineConfig(backend="tpu", pool_capacity=256,
                                            pool_block=64,
                                            batch_buckets=(16, 64),
                                            team_max_matches=32))
    cpu = JaxCpuEngine(jcfg, jcfg.queues[0])
    rng = np.random.default_rng(21)
    ratings = rng.permutation(700)[:90] + 1200
    n = 0
    for i, r in enumerate(ratings):
        out_ring = keyed(ring.search([req(SearchRequest, i, int(r))],
                                     float(i)))
        out_rep = keyed(rep.search([req(SearchRequest, i, int(r))],
                                   float(i)))
        out_j = keyed(jring.search([req(JaxRequest, i, int(r))], float(i)))
        out_cpu = cpu.search([req(JaxRequest, i, int(r))], float(i))
        assert out_ring == out_rep == out_j, f"step {i}"
        assert [m[0] for m in out_ring] == [m[0] for m in keyed(out_cpu)]
        n += len(out_ring)
    assert n >= 3
    assert ring.counters["team_ring_steps"] == len(ratings)
    assert "team_ring_fallback" not in ring.counters
    assert_ring_counters(jring, ring)


def prefilled(capacity, n_active, rng, step, role_masks=None):
    arrays = {
        "rating": np.zeros(capacity, np.float32),
        "rd": np.zeros(capacity, np.float32),
        "region": np.zeros(capacity, np.int32),
        "mode": np.zeros(capacity, np.int32),
        "threshold": np.full(capacity, 50.0, np.float32),
        "enqueue_t": np.zeros(capacity, np.float32),
        "active": np.zeros(capacity, bool),
    }
    arrays["rating"][:n_active] = 1500.0 + rng.permutation(n_active) * step
    arrays["region"][:n_active] = 1
    arrays["mode"][:n_active] = 1
    arrays["active"][:n_active] = True
    if role_masks is not None:
        arrays["role_mask"] = np.zeros(capacity, np.int32)
        arrays["role_mask"][:n_active] = [role_masks[i % len(role_masks)]
                                          for i in range(n_active)]
    return arrays


def raw_step_pair(jks, tks, arrays, rows):
    """The fallback and the ring step of both packages on copies of one
    prefilled pool with an all-padding window: four packed results and the
    four pools after."""
    packed = np.zeros((rows, 16), np.float32)
    packed[0] = float(tks.capacity)
    packed[-1] = 1.0  # now
    outs, pools = [], []
    for fn in ("search_step_packed", "search_step_packed_ring"):
        jp, jo = getattr(jks, fn)(jks.place_pool(dict(arrays)),
                                  jnp.asarray(packed))
        tp = tks.place_pool(arrays)
        to = getattr(tks, fn)(tp, torch.from_numpy(packed))
        outs += [np.asarray(jo), to.numpy()]
        pools += [{k: np.asarray(v) for k, v in jp.items()},
                  {k: v.numpy() for k, v in tp.items()}]
    return outs, pools


def test_ring_step_raw_outputs_bit_identical():
    kw = dict(capacity=64, team_size=2, widen_per_sec=0.0,
              max_threshold=400.0, max_matches=8, frontier_k=16)
    jks = jax_teams.ShardedTeamKernelSet(mesh=jax_sharded.pool_mesh(4), **kw)
    tks = teams.ShardedTeamKernelSet(mesh=sharded.pool_mesh(4, device="cpu"),
                                     **kw)
    arrays = prefilled(64, 24, np.random.default_rng(3), 7.0)
    outs, pools = raw_step_pair(jks, tks, arrays, 9)
    assert (outs[0][0] < 64).any()
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    for p in pools[1:]:
        for name in pools[0]:
            np.testing.assert_array_equal(p[name], pools[0][name], name)


def test_ring_falls_back_above_frontier_and_stays_correct():
    q = dict(team_size=2, rating_threshold=50.0)
    jring, ring = engine_pair(q, mesh_pool_axis=4, team_ring_k=8)
    jrep, rep = engine_pair(q, mesh_pool_axis=4)
    rng = np.random.default_rng(7)
    ratings = rng.permutation(900)[:60] + 1000
    for i, r in enumerate(ratings):
        a = keyed(ring.search([req(SearchRequest, i, int(r))], float(i)))
        b = keyed(rep.search([req(SearchRequest, i, int(r))], float(i)))
        c = keyed(jring.search([req(JaxRequest, i, int(r))], float(i)))
        assert a == b == c, f"step {i}"
        assert ring.pool_size() == rep.pool_size() == jring.pool_size()
    assert ring.counters.get("team_ring_fallback", 0) > 0
    assert ring.counters.get("team_ring_steps", 0) > 0
    assert_ring_counters(jring, ring)


# ---- the role twins -------------------------------------------------------------


def role_pair(mesh, ring_k=0):
    q = dict(team_size=2, role_slots=SLOTS2, rating_threshold=50.0)
    return engine_pair(q, batch_buckets=(16,), team_max_matches=16,
                       mesh_pool_axis=mesh, team_ring_k=ring_k)


ROLES_CYCLE = [("tank",), ("dps",), (), ("dps",)]


def test_sharded_role_engine_matches_single_device():
    jeng, teng = role_pair(8)
    _, single = role_pair(1)
    rng = np.random.default_rng(31)
    ratings = rng.permutation(500)[:80] + 1200
    n = 0
    for i, r in enumerate(ratings):
        roles = ROLES_CYCLE[i % 4]
        mine = keyed(teng.search([req(SearchRequest, i, int(r), roles)],
                                 float(i)))
        theirs = keyed(jeng.search([req(JaxRequest, i, int(r), roles)],
                                   float(i)))
        one = keyed(single.search([req(SearchRequest, i, int(r), roles)],
                                  float(i)))
        assert mine == theirs == one, f"step {i}"
        assert teng.pool_size() == single.pool_size() == jeng.pool_size()
        n += len(mine)
    assert n >= 3


@pytest.mark.parametrize("mesh", [2, 4, 8])
def test_ring_sharded_role_engine_bit_identical(mesh):
    jring, ring = role_pair(mesh, ring_k=96)
    _, rep = role_pair(mesh)
    rng = np.random.default_rng(31)
    ratings = rng.permutation(500)[:80] + 1200
    assert arrivals(jring, ring, ratings, ROLES_CYCLE) >= 3
    rng = np.random.default_rng(31)
    ratings = rng.permutation(500)[:80] + 1200
    for i, r in enumerate(ratings):
        rep.search([req(SearchRequest, i, int(r), ROLES_CYCLE[i % 4])],
                   float(i))
    assert ring.pool_size() == rep.pool_size()
    assert ring.counters["team_ring_steps"] == len(ratings)
    assert "team_ring_fallback" not in ring.counters
    assert_ring_counters(jring, ring)


def test_ring_role_step_raw_outputs_bit_identical():
    kw = dict(capacity=64, team_size=2, role_slots=SLOTS2, widen_per_sec=0.0,
              max_threshold=400.0, max_matches=8, frontier_k=16)
    jks = jax_roles.ShardedRoleKernelSet(mesh=jax_sharded.pool_mesh(4), **kw)
    tks = role_kernels.ShardedRoleKernelSet(
        mesh=sharded.pool_mesh(4, device="cpu"), **kw)
    masks = [tks.mask_of(("tank",)), tks.mask_of(("dps",)), tks.mask_of(())]
    assert masks == [jks.mask_of(("tank",)), jks.mask_of(("dps",)),
                     jks.mask_of(())]
    arrays = prefilled(64, 20, np.random.default_rng(5), 6.0, masks)
    outs, pools = raw_step_pair(jks, tks, arrays, 10)
    assert (outs[0][0] < 64).any()
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    for p in pools[1:]:
        for name in pools[0]:
            np.testing.assert_array_equal(p[name], pools[0][name], name)


# ---- the tournament merge on the ring (tests/test_bucketed.py twins) ----------


def tournament_case(rng, cap, k, roles):
    pool = {
        "rating": rng.normal(1500, 40, cap).astype(np.float32),
        "rd": rng.uniform(0, 200, cap).astype(np.float32),
        "region": np.ones(cap, np.int32),
        "mode": np.ones(cap, np.int32),
        "threshold": rng.uniform(100, 180, cap).astype(np.float32),
        "enqueue_t": rng.uniform(0, 5, cap).astype(np.float32),
        "active": np.zeros(cap, bool),
    }
    act = rng.choice(cap, k - 6, replace=False)
    pool["active"][act] = True
    rows = 10 if roles else 9
    packed = np.zeros((rows, 64), np.float32)
    packed[0] = cap
    free = np.where(~pool["active"])[0][:4]
    packed[0, :4] = free
    packed[1, :4] = rng.normal(1500, 40, 4)
    packed[3, :4] = 1
    packed[4, :4] = 1
    packed[5, :4] = 150.0
    packed[7, :4] = 1.0
    packed[-1] = 8.0
    if roles:
        pool["role_mask"] = np.zeros(cap, np.int32)
        pool["role_mask"][act] = rng.integers(1, 4, act.size)
        packed[len(PACKED_ROWS), :4] = rng.integers(1, 4, 4)
    return pool, packed


def tournament_vs_linear(jcls, tcls, n_shards, kw, roles):
    rng = np.random.default_rng(1234)
    pool, packed = tournament_case(rng, kw["capacity"], kw["frontier_k"],
                                   roles)
    results = []
    for merge in ("linear", "tournament"):
        jks = jcls(mesh=jax_sharded.pool_mesh(n_shards),
                   frontier_merge=merge, **kw)
        tks = tcls(mesh=sharded.pool_mesh(n_shards, device="cpu"),
                   frontier_merge=merge, **kw)
        jp, jo = jks.search_step_packed_ring(jks.place_pool(dict(pool)),
                                             jnp.asarray(packed))
        tp = tks.place_pool(pool)
        to = tks.search_step_packed_ring(tp, torch.from_numpy(packed))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        for name, col in tp.items():
            np.testing.assert_array_equal(col.numpy(), np.asarray(jp[name]),
                                          name)
        results.append(to)
    assert torch.equal(results[0], results[1])
    assert int((results[0][0] < kw["capacity"]).sum()) >= 1


@pytest.mark.parametrize("n_shards", [2, 4])
def test_role_ring_tournament_equals_linear(n_shards):
    kw = dict(capacity=512, team_size=2, role_slots=SLOTS2,
              widen_per_sec=0.5, max_threshold=200.0, max_matches=8,
              rounds=8, frontier_k=32)
    tournament_vs_linear(jax_roles.ShardedRoleKernelSet,
                         role_kernels.ShardedRoleKernelSet, n_shards, kw,
                         roles=True)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_team_ring_tournament_equals_linear(n_shards):
    kw = dict(capacity=1024, team_size=2, widen_per_sec=0.5,
              max_threshold=200.0, max_matches=16, rounds=8, frontier_k=32)
    tournament_vs_linear(jax_teams.ShardedTeamKernelSet,
                         teams.ShardedTeamKernelSet, n_shards, kw,
                         roles=False)


# ---- the frontier helpers on gathered buffers ------------------------------------


FIELDS = ("rating", "region", "mode", "threshold", "enqueue_t", "active",
          "role_mask")


def test_pack_and_merge_frontiers_equal_jax_on_gathered_buffers():
    """``pack_frontier`` of each shard's slice (ties in group and rating
    across shards), then ``merge_frontiers`` linear and tournament of the
    gathered buffers: the same f32 rows, columns and global slots as the
    JAX helpers (which run inside ``shard_map``; here each shard's
    frontier is rebuilt with the JAX sort order on the host)."""
    rng = np.random.default_rng(8)
    n, lc, k = 4, 32, 12
    frontiers = []
    for s in range(n):
        pool = {
            "rating": rng.integers(1490, 1496, lc).astype(np.float32),
            "region": rng.integers(1, 3, lc).astype(np.int32),
            "mode": np.ones(lc, np.int32),
            "threshold": rng.uniform(40, 80, lc).astype(np.float32),
            "enqueue_t": rng.uniform(0, 5, lc).astype(np.float32),
            "active": rng.random(lc) < 0.3,
            "role_mask": rng.integers(1, 4, lc).astype(np.int32),
        }
        fr = teams.pack_frontier({f: torch.from_numpy(v)
                                  for f, v in pool.items()},
                                 FIELDS, k, s * lc, n * lc).numpy()
        order, _ = jax_teams.sorted_group_order(
            {f: jnp.asarray(v) for f, v in pool.items()})
        top = np.asarray(order)[:k]
        want = np.stack([pool[f][top].astype(np.float32) for f in FIELDS]
                        + [np.where(pool["active"][top], top + s * lc,
                                    n * lc).astype(np.float32)])
        np.testing.assert_array_equal(fr, want)
        frontiers.append(fr)
    buf = np.stack(frontiers)
    for merge in ("linear", "tournament"):
        mine, mslot = teams.merge_frontiers(torch.from_numpy(buf), FIELDS, n,
                                            merge)
        theirs, jslot = jax_teams.merge_frontiers(jnp.asarray(buf), FIELDS, n,
                                                  merge)
        np.testing.assert_array_equal(mslot.numpy(), np.asarray(jslot))
        for f in FIELDS:
            np.testing.assert_array_equal(mine[f].numpy(),
                                          np.asarray(theirs[f]), f)


def test_sharded_team_sets_check_capacity_and_merge():
    mesh = sharded.pool_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="2\\*\\*24"):
        teams.ShardedTeamKernelSet(capacity=1 << 24, team_size=2,
                                   widen_per_sec=0.0, max_threshold=1.0,
                                   mesh=mesh)
    with pytest.raises(ValueError, match="frontier_merge"):
        teams.ShardedTeamKernelSet(capacity=64, team_size=2,
                                   widen_per_sec=0.0, max_threshold=1.0,
                                   mesh=mesh, frontier_k=8,
                                   frontier_merge="bogus")
    ks = teams.ShardedTeamKernelSet(capacity=63, team_size=2,
                                    widen_per_sec=0.0, max_threshold=1.0,
                                    mesh=mesh, frontier_k=2)
    assert (ks.capacity, ks.local_capacity, ks.frontier_k) == (64, 32, 4)
