"""The sharded 1v1 pool (engine/sharded.py) against the JAX package's, on
the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's mesh is D entries of the CPU (``pool_mesh(D, device="cpu")``),
its kernels the plain versions.

- Twins of tests/test_sharded.py's six tests (both merges where the JAX
  test has both), each run through ``TpuEngine`` and ``GpuEngine``: the
  same pairs window by window, the same qualities (so ELO distances bit
  for bit), the same pools after.
- Step level, D = 1, 2, 4, 8 and both merges: the port's
  ``search_step_packed`` against the JAX sharded step and the port's
  dense step on seeded pools and windows: results and every shard's pool
  bit-equal (ELO), under Glicko-2 slots and pairs as sets and distances
  within 3 ulp (the JAX package's CPU build fuses FMAs; ROADMAP rules).
- Each shard's candidate lists (``block_best`` on its slice with the
  window's slots shifted by −offset: negative and past-the-slice ids)
  against the JAX local set's ``_candidates`` on the same slice.
- The gated rescan equals the dense rescan; the tournament merge equals
  JAX's on gathered buffers; the mesh's device rules; the quality report
  of a sharded engine (the host fold) equals the JAX engine's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.core.pool import PlayerPool as JaxPool
from matchmaking_tpu.engine import kernels as jax_kernels
from matchmaking_tpu.engine import sharded as jax_sharded
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.core.pool import PACKED_ROWS
from matchmaking_tpu_torch.engine import kernels, sharded
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.service.contract import SearchRequest

torch.set_num_threads(1)


# ---- engine twins of tests/test_sharded.py ------------------------------------


def cfgs(n_shards, ring=False, capacity=512):
    kw = dict(pool_capacity=capacity, top_k=4, pool_block=64,
              batch_buckets=(8, 32), mesh_pool_axis=n_shards, ring_merge=ring)
    return (JaxConfig(engine=JaxEngineConfig(backend="tpu", **kw)),
            Config(engine=EngineConfig(backend="gpu", **kw)))


def engines(n_shards, jq=None, tq=None, **kw):
    jcfg, tcfg = cfgs(n_shards, **kw)
    return (TpuEngine(jcfg, jq or JaxQueueConfig(rating_threshold=100.0)),
            GpuEngine(tcfg, tq or QueueConfig(rating_threshold=100.0),
                      device="cpu"))


def both(jeng, teng, rows, now):
    """One window through both engines: (JAX match keys, port match keys)
    with each match's quality, in output order."""
    outs = []
    for eng, cls in ((jeng, JaxRequest), (teng, SearchRequest)):
        out = eng.search([cls(**r) for r in rows], now=now)
        outs.append([(tuple(sorted(p.id for t in m.teams for p in t)),
                      m.quality) for m in out.matches])
    return outs


def jax_pool(eng):
    return {k: np.asarray(v) for k, v in eng._dev_pool.items()}


def assert_pools_equal(jeng, teng):
    jp = jax_pool(jeng)
    for name, col in teng.dev_pool.items():
        np.testing.assert_array_equal(col.numpy(), jp[name], err_msg=name)


def workload(seed=5, n_windows=10, per_window=8):
    rng = np.random.default_rng(seed)
    pid = 0
    for w in range(n_windows):
        rows = [dict(id=f"p{pid + i}", rating=float(rng.normal(1500, 90)))
                for i in range(per_window)]
        pid += per_window
        yield rows, float(w)


@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
def test_sharded_equals_single_device(ring):
    jsingle, tsingle = engines(1)
    jeng, teng = engines(8, ring=ring)
    n = 0
    for rows, now in workload():
        mine, theirs = both(jeng, teng, rows, now)
        assert mine == theirs
        # And the sharded port equals the single-device port.
        single, _ = both(jsingle, tsingle, rows, now)
        assert [k for k, _ in mine] == [k for k, _ in single]
        n += len(mine)
    assert n > 10
    assert teng.pool_size() == jeng.pool_size() == tsingle.pool_size()
    assert_pools_equal(jeng, teng)


def test_sharded_cross_shard_match_and_eviction():
    jeng, teng = engines(8, capacity=64)
    local = teng.kernels.local_capacity
    assert local == jeng.kernels.local_capacity == 8
    filler = [dict(id=f"f{i}", rating=100_000.0 * (i + 1))
              for i in range(local)]
    both(jeng, teng, filler, 0.0)
    both(jeng, teng, [dict(id="a", rating=1500.0)], 1.0)
    slot_a = teng.pool.slot_of("a")
    assert slot_a == jeng.pool.slot_of("a") and slot_a >= local
    mine, theirs = both(jeng, teng, [dict(id="b", rating=1510.0)], 2.0)
    assert mine == theirs and [k for k, _ in mine] == [("a", "b")]
    assert teng.pool_size() == local
    mine, theirs = both(jeng, teng, [dict(id="c", rating=1505.0)], 3.0)
    assert mine == theirs == []
    assert_pools_equal(jeng, teng)


def test_sharded_capacity_rounds_up():
    jeng, teng = engines(8, capacity=100, jq=JaxQueueConfig(),
                         tq=QueueConfig())
    assert teng.kernels.capacity == jeng.kernels.capacity == 104
    assert teng.pool.capacity == 104
    assert [p["rating"].shape[0] for p in teng.dev_pool.shards] == [13] * 8


def test_sharded_widening_and_glicko():
    kw = dict(rating_threshold=50.0, widen_per_sec=10.0, max_threshold=400.0,
              glicko2=True)
    jeng, teng = engines(8, jq=JaxQueueConfig(**kw), tq=QueueConfig(**kw))
    both(jeng, teng, [dict(id="a", rating=1500.0, rating_deviation=0.0,
                           enqueued_at=0.0)], 0.0)
    mine, theirs = both(jeng, teng, [dict(id="b", rating=1580.0,
                                          rating_deviation=0.0,
                                          enqueued_at=0.0)], 10.0)
    assert [k for k, _ in mine] == [k for k, _ in theirs] == [("a", "b")]
    assert mine[0][1] == pytest.approx(theirs[0][1], rel=1e-6)


def test_comms_accounting_ring_scales_sublinearly():
    """The team and role sets' per-device traffic and formation rows equal
    the JAX package's accounting at D = 2, 4, 8, and scale as it does:
    the ring's bytes far below the gather's and independent of the pool,
    its formation rows shrinking with D."""
    from matchmaking_tpu.engine.role_kernels import (
        ShardedRoleKernelSet as JaxRoleSet,
    )
    from matchmaking_tpu.engine.teams import (
        ShardedTeamKernelSet as JaxTeamSet,
    )
    from matchmaking_tpu_torch.engine.role_kernels import ShardedRoleKernelSet
    from matchmaking_tpu_torch.engine.teams import ShardedTeamKernelSet

    def accts(capacity, d, k=64):
        kw = dict(capacity=capacity, team_size=5, widen_per_sec=0.0,
                  max_threshold=400.0, frontier_k=k)
        mine = ShardedTeamKernelSet(
            mesh=sharded.pool_mesh(d, device="cpu"), **kw).comms_accounting()
        theirs = JaxTeamSet(mesh=jax_sharded.pool_mesh(d),
                            **kw).comms_accounting()
        assert mine == theirs
        return mine

    a = {d: accts(8192, d) for d in (2, 4, 8)}
    for acct in a.values():
        assert acct["ring"]["ici_recv_bytes"] * 4 \
            < acct["allgather"]["ici_recv_bytes"]
        assert acct["allgather"]["formation_rows"] == 8192
    assert (a[2]["ring"]["formation_rows"] > a[4]["ring"]["formation_rows"]
            > a[8]["ring"]["formation_rows"])
    big = accts(32768, 4)
    assert big["ring"]["ici_recv_bytes"] == a[4]["ring"]["ici_recv_bytes"]
    assert big["allgather"]["ici_recv_bytes"] \
        == 4 * a[4]["allgather"]["ici_recv_bytes"]
    roles = ("tank", "healer", "dps", "dps", "dps")
    kw = dict(capacity=8192, team_size=5, role_slots=roles,
              widen_per_sec=0.0, max_threshold=400.0, frontier_k=64)
    ra = ShardedRoleKernelSet(mesh=sharded.pool_mesh(4, device="cpu"),
                              **kw).comms_accounting()
    assert ra == JaxRoleSet(mesh=jax_sharded.pool_mesh(4),
                            **kw).comms_accounting()
    assert ra["gather_cols"] == a[4]["gather_cols"] + 1


@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
def test_sharded_exact_tie_stays_consistent(ring):
    jeng, teng = engines(8, ring=ring, capacity=64)
    local = teng.kernels.local_capacity
    steps = [
        ([dict(id=f"f{i}", rating=1e6 + 10_000.0 * i) for i in range(local)],
         0.0),
        ([dict(id="lo", rating=1440.0)], 0.0),
        ([dict(id=f"g{i}", rating=2e6 + 10_000.0 * i)
          for i in range(local - 1)], 0.0),
        ([dict(id="hi", rating=1560.0)], 0.0),
    ]
    for rows, now in steps:
        both(jeng, teng, rows, now)
    mine, theirs = both(jeng, teng, [dict(id="mid", rating=1500.0)], 1.0)
    assert mine == theirs and len(mine) == 1
    winner = (set(mine[0][0]) - {"mid"}).pop()
    loser = "hi" if winner == "lo" else "lo"
    rating = 1440.0 if loser == "lo" else 1560.0
    mine, theirs = both(jeng, teng, [dict(id="x", rating=rating + 1.0)], 2.0)
    assert mine == theirs
    assert [k for k, _ in mine] == [tuple(sorted(("x", loser)))]
    active = int(teng.dev_pool["active"].sum())
    assert active == teng.pool_size() == jeng.pool_size() == 2 * local - 1
    assert_pools_equal(jeng, teng)


# ---- the step, against the JAX sharded step --------------------------------------


P, B = 4096, 256


def seeded_pool(rng, active_frac=0.5):
    pool = JaxPool.empty_device_arrays(P)
    pool["rating"] = rng.normal(1500, 300, P).astype(np.float32)
    pool["rd"] = rng.uniform(0, 350, P).astype(np.float32)
    pool["region"] = rng.integers(0, 3, P).astype(np.int32)
    pool["mode"] = rng.integers(0, 3, P).astype(np.int32)
    pool["threshold"] = rng.uniform(50, 150, P).astype(np.float32)
    pool["enqueue_t"] = rng.uniform(0, 10, P).astype(np.float32)
    pool["active"] = rng.random(P) < active_frac
    return pool


def seeded_window(rng, pool, n_valid=200, now=12.0):
    """A packed f32[9, B] window into free slots (rows of ``PACKED_ROWS``,
    then ``now``); padding lanes carry the sentinel slot."""
    packed = np.zeros((len(PACKED_ROWS) + 1, B), np.float32)
    packed[0] = P
    free = np.sort(rng.choice(np.where(~pool["active"])[0], n_valid,
                              replace=False))
    n = free.size
    packed[0, :n] = free
    packed[1, :n] = rng.normal(1500, 300, n)
    packed[2, :n] = rng.uniform(0, 350, n)
    packed[3, :n] = rng.integers(0, 3, n)
    packed[4, :n] = rng.integers(0, 3, n)
    packed[5, :n] = rng.uniform(50, 150, n)
    packed[6, :n] = rng.uniform(0, 10, n)
    packed[7, :n] = 1.0
    packed[8] = now
    return packed


def step_pair(d, ring, glicko2, widen=2.0):
    kw = dict(capacity=P, top_k=8, pool_block=256, glicko2=glicko2,
              widen_per_sec=widen, max_threshold=300.0, ring=ring)
    return (jax_sharded.ShardedKernelSet(mesh=jax_sharded.pool_mesh(d), **kw),
            sharded.ShardedKernelSet(mesh=sharded.pool_mesh(d, device="cpu"),
                                     **kw))


def pairs_by_slots(out):
    """{frozenset(q, c): dist} over the formed pairs of a result. Under
    Glicko-2 the JAX CPU distance is not symmetric in its two players (an
    FMA), so a pair of two window players may be held by the other lane
    (test_torch_kernels.pairs_by_slots)."""
    hit = out[0] < P
    return {frozenset((int(a), int(b))): np.float32(x)
            for a, b, x in zip(out[0][hit], out[1][hit], out[2][hit])}


def assert_results(theirs, mine, glicko2):
    """ELO: bit-equal. Glicko-2: the same pairs, distances within 3 ulp."""
    if not glicko2:
        np.testing.assert_array_equal(mine, theirs)
        return
    tp, jp = pairs_by_slots(mine), pairs_by_slots(theirs)
    assert tp.keys() == jp.keys()
    for key, dist in tp.items():
        np.testing.assert_array_max_ulp(dist, jp[key], maxulp=3)


@pytest.mark.parametrize("glicko2", [False, True], ids=["elo", "glicko2"])
@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_step_equals_the_jax_sharded_step(d, ring, glicko2):
    rng = np.random.default_rng(40 + d)
    jks, tks = step_pair(d, ring, glicko2)
    pool = seeded_pool(rng)
    jpool = jks.place_pool(pool)
    tpool = tks.place_pool(pool)
    dense = kernels.KernelSet(capacity=P, top_k=8, pool_block=256,
                              glicko2=glicko2, widen_per_sec=2.0,
                              max_threshold=300.0)
    dpool = kernels.pool_from_reference(pool, "cpu")
    for w in range(2):
        packed = seeded_window(rng, {**pool, "active": tpool[
            "active"].numpy()}, now=12.0 + w)
        jpool, jout = jks.search_step_packed(jpool, jnp.asarray(packed))
        tout = tks.search_step_packed(tpool, torch.from_numpy(packed))
        dout = dense.search_step_packed(dpool, torch.from_numpy(packed))
        assert_results(np.asarray(jout), tout.numpy(), glicko2)
        assert torch.equal(tout, dout)
        assert int((tout[0] < P).sum()) > 10
        for name, col in tpool.items():
            np.testing.assert_array_equal(col.numpy(), np.asarray(jpool[name]),
                                          err_msg=name)
            np.testing.assert_array_equal(col.numpy(), dpool[name].numpy(),
                                          err_msg=name)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_each_shard_candidates_equal_the_jax_local_set(d):
    """The self-mask with shifted slots: each shard's ``block_best`` on
    its slice, with the window's global slots minus the shard's offset
    (negative for the shards after a lane's, past the slice for those
    before), against the JAX local set's ``_candidates`` on that slice.
    Every lane's own slot is active on its shard, so a lane that failed to
    mask itself would come back as its own candidate."""
    rng = np.random.default_rng(7)
    jks, tks = step_pair(d, False, False, widen=0.0)
    pool = seeded_pool(rng, active_frac=0.4)
    packed = seeded_window(rng, pool)
    n = int(packed[7].sum())
    pool["active"][packed[0, :n].astype(np.int64)] = True
    pool["rating"][packed[0, :n].astype(np.int64)] = packed[1, :n]
    lc = tks.local_capacity
    jb = jax_kernels.unpack_batch(jnp.asarray(packed))
    tb = kernels.unpack_batch(torch.from_numpy(packed))
    thr = tb["threshold"]
    now = torch.tensor([12.0])
    for s in range(d):
        part = {k: v[s * lc:(s + 1) * lc] for k, v in pool.items()}
        jv, ji = jks.local._candidates(
            dict(jb, slot=jb["slot"] - s * lc), jb["threshold"],
            {k: jnp.asarray(v) for k, v in part.items()}, jnp.float32(12.0))
        tv, ti = tks.local.candidates(
            dict(tb, slot=tb["slot"] - s * lc), thr,
            kernels.pool_from_reference(part, "cpu"), now)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        own = tb["slot"][:, None] - s * lc
        assert not ((ti == own) & (ti < lc)).any()


def test_gated_rescan_equals_the_dense_rescan():
    rng = np.random.default_rng(11)
    pool = seeded_pool(rng, active_frac=0.3)
    for d, ring in ((2, False), (4, True), (8, False)):
        _, tks = step_pair(d, ring, False)
        dense = kernels.KernelSet(capacity=P, top_k=8, pool_block=256,
                                  glicko2=False, widen_per_sec=2.0,
                                  max_threshold=300.0)
        tpool = tks.place_pool(pool)
        dpool = kernels.pool_from_reference(pool, "cpu")
        live = np.sort(rng.choice(np.where(pool["active"])[0], 150,
                                  replace=False))
        packed = np.zeros((9, B), np.float32)
        packed[0] = P
        packed[0, :150] = live
        for i, f in enumerate(("rating", "rd", "region", "mode", "threshold",
                               "enqueue_t"), start=1):
            packed[i, :150] = pool[f][live]
        packed[7, :150] = 1.0
        packed[8] = 20.0
        # Half the lanes were matched by an earlier window: inactive now.
        gone = torch.from_numpy(live[::2].astype(np.int32))
        tks.evict(tpool, gone)
        kernels.evict(dpool, gone)
        mine = tks.search_step_packed_rescan(tpool, torch.from_numpy(packed))
        want = dense.search_step_packed_rescan(dpool,
                                               torch.from_numpy(packed))
        assert torch.equal(mine, want)
        assert int((mine[0] < P).sum()) > 5
        assert not np.isin(mine[0].numpy(), gone.numpy()).any()
        for name, col in tpool.items():
            assert torch.equal(col, dpool[name]), name


def test_tournament_merge_equals_jax_on_gathered_buffers():
    """The pure tree merge, on frontiers with cross-shard ties (equal group
    and rating), at D = 2..8: the port's index gather and JAX's one-hot
    matmuls give the same rows, bit for bit."""
    rng = np.random.default_rng(1234)
    k = 16

    def key_j(fb):
        return (fb[0].astype(jnp.int32), fb[1], fb[2].astype(jnp.int32))

    def key_t(fb):
        return (fb[0].to(torch.int32), fb[1], fb[2].to(torch.int32))

    for shards in (2, 3, 4, 8):
        bufs = []
        for s in range(shards):
            group = np.sort(rng.integers(0, 4, k)).astype(np.int32)
            rating = (rng.integers(0, 6, k)
                      + rng.random(k).round(1)).astype(np.float32)
            order = np.lexsort((rating, group))
            gslot = (s * 100 + np.arange(k)).astype(np.float32)
            bufs.append(np.stack([group[order].astype(np.float32),
                                  rating[order], gslot,
                                  rng.normal(0, 1, k).astype(np.float32)]))
        theirs = np.asarray(jax_sharded.tournament_merge_topk(
            [jnp.asarray(b) for b in bufs], key_j))
        mine = sharded.tournament_merge_topk(
            [torch.from_numpy(b) for b in bufs], key_t).numpy()
        np.testing.assert_array_equal(mine, theirs)
        cat = np.concatenate(bufs, axis=1)
        order = np.lexsort((cat[2], cat[1], cat[0]))[:k]
        np.testing.assert_array_equal(mine, cat[:, order])


def test_effective_pool_block_min_blocks_equals_jax():
    for capacity in (64, 100, 510, 1024, 4096, 131_072):
        for block in (16, 64, 255, 256, 8192):
            for top_k in (1, 4, 8):
                for mb in (True, False):
                    assert kernels.effective_pool_block(
                        capacity, block, top_k, min_blocks=mb) == \
                        jax_kernels.effective_pool_block(
                            capacity, block, top_k, min_blocks=mb)
    ks = kernels.KernelSet(capacity=512, top_k=8, pool_block=512,
                           glicko2=False, widen_per_sec=0.0,
                           max_threshold=1.0, exact_block=True)
    assert ks.pool_block == 512 and ks.n_blocks == 1


def test_pool_mesh_devices():
    mesh = sharded.pool_mesh(8, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.single_device and not mesh.process
    assert mesh.local_shards == tuple(range(8))
    # An explicit list is taken as it is, repeats included.
    assert sharded.pool_mesh(2, ["cpu", "cpu"], device="cpu").n_shards == 2
    assert sharded.pool_mesh(3, [0, 0, 0], device="cpu").devices \
        == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="devices named"):
        sharded.pool_mesh(4, ["cpu"] * 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices visible"):
            sharded.pool_mesh(2, device="cuda")


def test_engine_devices_and_mesh_shapes():
    """``GpuEngine(devices=...)`` builds the mesh from the list (repeats
    allowed); a single entry places an unsharded pool; the quality report
    of a sharded engine (the host fold, no device accumulator) equals the
    JAX engine's over a workload."""
    _, tcfg = cfgs(4)
    eng = GpuEngine(tcfg, QueueConfig(), device="cpu", devices=[0, 0, 0, 0])
    assert eng.kernels.mesh.n_shards == 4 and eng._quality is None
    assert eng._graphs is None and eng._variants()[:3] == (
        "dense", "dense_nofilter", "rescan")
    _, one = cfgs(1)
    assert GpuEngine(one, QueueConfig(), device="cpu",
                     devices=["cpu"]).device == torch.device("cpu")
    jeng, teng = engines(4)
    for rows, now in workload(seed=9, n_windows=6, per_window=16):
        both(jeng, teng, rows, now)
    teng.flush()
    assert teng.quality_report() == jeng.quality_report()


def test_columnar_window_through_a_sharded_engine():
    """The columnar path (what the service runs) over a sharded pool: the
    same outcome columns as the JAX engine's, and the host quality fold
    equal to its."""
    from matchmaking_tpu.service.contract import (
        RequestColumns as JaxColumns,
    )
    from matchmaking_tpu_torch.service.contract import RequestColumns

    jeng, teng = engines(4, capacity=1024)
    rng = np.random.default_rng(3)
    for w in range(4):
        n = 64
        ids = np.array([f"w{w}p{i}" for i in range(n)], dtype=object)
        cols = dict(ids=ids, rating=rng.normal(1500, 80, n).astype(np.float32),
                    rd=np.zeros(n, np.float32),
                    threshold=np.full(n, 100.0, np.float32),
                    enqueued_at=np.full(n, 1000.0 + w),
                    reply_to=np.array([f"r{i}" for i in ids], dtype=object),
                    correlation_id=np.array([f"c{i}" for i in ids],
                                            dtype=object))
        outs = []
        for eng, cls in ((jeng, JaxColumns), (teng, RequestColumns)):
            region, mode = eng.intern_columns(["eu"] * n, ["ranked"] * n)
            eng.search_columns_async(cls(region=region, mode=mode, **cols),
                                     1000.0 + w)
            (_, out), = eng.flush()
            outs.append(out)
        for name in ("m_id_a", "m_id_b", "m_dist", "m_quality", "q_ids"):
            np.testing.assert_array_equal(getattr(outs[1], name),
                                          getattr(outs[0], name), name)
    assert teng.quality_report() == jeng.quality_report()
    assert_pools_equal(jeng, teng)
