"""The sharded 1v1 bucket frontier (``ShardedKernelSet.bucket_step`` and the
engine's frontier ladder) against the JAX package's, on the CPU.

Twins of tests/test_bucketed.py's frontier tests (JAX on its 8 virtual CPU
devices, the port on a mesh of CPU entries):

- step level (``test_sharded_bucket_frontier_equals_dense``, D = 2, 4): the
  frontier step on a sparse banded pool against the JAX frontier step and
  the dense step: results and pools bit-equal, formation occupancy-shaped;
- the frontier at widths 8, 16 and 128, below ``block_best``'s 512-slot
  tile, against the dense step;
- engine level (``test_engine_sharded_bucket_frontier_matches_flat``,
  ``test_engine_frontier_fallback_above_ladder``): the same stream through
  the JAX and port engines at D = 2 (and the port's flat engine): the same
  match sets, the same ladder moves and counters, and
  ``formation_report()`` equal to the JAX engine's but for the moves'
  wall-clock times; ``frontier_snapshot()`` and the sampler's
  ``frontier_k`` series equal the JAX app's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.engine import sharded as jax_sharded
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.engine import kernels, sharded
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.service.contract import SearchRequest

torch.set_num_threads(1)

P, B = 4096, 256


def banded_pool(rng, active_frac=0.012):
    ratings = np.sort(rng.normal(1500, 300, P).astype(np.float32))
    return {
        "rating": ratings,
        "rd": rng.uniform(0, 200, P).astype(np.float32),
        "region": rng.integers(0, 3, P).astype(np.int32),
        "mode": rng.integers(0, 3, P).astype(np.int32),
        "threshold": rng.uniform(50, 150, P).astype(np.float32),
        "enqueue_t": rng.uniform(0, 10, P).astype(np.float32),
        "active": rng.random(P) < active_frac,
    }


def banded_window(rng, pool, n_valid=100, now=10.0, slots=None):
    """A packed window into free slots (``slots``, or ``n_valid`` drawn at
    random), each lane's rating near its slot's (the banded allocator's
    layout, where buckets stay sparse)."""
    packed = np.zeros((9, B), np.float32)
    packed[0] = P
    free = slots if slots is not None else np.sort(rng.choice(
        np.where(~pool["active"])[0], n_valid, replace=False))
    n = free.size
    packed[0, :n] = free
    packed[1, :n] = pool["rating"][free] + rng.normal(0, 5, n)
    packed[2, :n] = rng.uniform(0, 200, n)
    packed[3, :n] = rng.integers(0, 3, n)
    packed[4, :n] = rng.integers(0, 3, n)
    packed[5, :n] = rng.uniform(50, 120, n)
    packed[6, :n] = rng.uniform(0, 10, n)
    packed[7, :n] = 1.0
    packed[8] = now
    return packed


GEO = dict(capacity=P, top_k=8, pool_block=256, glicko2=False,
           widen_per_sec=1.0, max_threshold=200.0)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_bucket_frontier_equals_dense(n_shards):
    rng = np.random.default_rng(1234)
    pool = banded_pool(rng)
    packed = banded_window(rng, pool)
    jks = jax_sharded.ShardedKernelSet(
        mesh=jax_sharded.pool_mesh(n_shards), bucket_frontier_k=64, **GEO)
    tks = sharded.ShardedKernelSet(
        mesh=sharded.pool_mesh(n_shards, device="cpu"), bucket_frontier_k=64,
        **GEO)
    dense = kernels.KernelSet(**GEO)
    dpool = kernels.pool_from_reference(pool, "cpu")
    dout = dense.search_step_packed(dpool, torch.from_numpy(packed))
    jpool, jout = jks.bucket_step(64)(jks.place_pool(dict(pool)),
                                      jnp.asarray(packed))
    tpool = tks.place_pool(pool)
    tout = tks.bucket_step(64)(tpool, torch.from_numpy(packed))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert torch.equal(tout[:3], dout)
    assert int((dout[1] < P).sum()) > 10
    assert float(tout[3, 0]) < P                  # occupancy-shaped
    for name, col in tpool.items():
        np.testing.assert_array_equal(col.numpy(), np.asarray(jpool[name]),
                                      err_msg=name)
        assert torch.equal(col, dpool[name]), name


@pytest.mark.parametrize("k", [8, 16, 128])
def test_frontier_widths_below_the_kernel_tile(k):
    """``block_best`` over the frontier in blocks of k (8 to 128 rows,
    below the kernel's 512-slot tile): equal to the dense step at D = 4
    while every bucket, the window's lanes included, holds at most k
    players."""
    rng = np.random.default_rng(100 + k)
    pool = banded_pool(rng, active_frac=0.0)
    lanes = []
    for b in range(P // 256):
        take = b * 256 + rng.choice(256, min(k, 40), replace=False)
        n_lanes = min(3, k // 2)
        pool["active"][take[n_lanes:]] = True
        lanes.append(take[:n_lanes])
    packed = banded_window(rng, pool, slots=np.sort(np.concatenate(lanes)))
    counts = np.bincount(np.concatenate([
        np.where(pool["active"])[0],
        packed[0, packed[7] > 0].astype(np.int64)]) // 256, minlength=16)
    assert counts.max() == min(k, 40)
    tks = sharded.ShardedKernelSet(mesh=sharded.pool_mesh(4, device="cpu"),
                                   bucket_frontier_k=128, **GEO)
    dense = kernels.KernelSet(**GEO)
    dpool = kernels.pool_from_reference(pool, "cpu")
    dout = dense.search_step_packed(dpool, torch.from_numpy(packed))
    tpool = tks.place_pool(pool)
    tout = tks.bucket_step(k)(tpool, torch.from_numpy(packed))
    assert torch.equal(tout[:3], dout)
    assert float(tout[3, 0]) == min(16 * k, P)
    assert int((dout[0] < P).sum()) > 4
    for name, col in tpool.items():
        assert torch.equal(col, dpool[name]), name


# ---- engine level -------------------------------------------------------------


def engine_pair(**kw):
    ec = dict(pool_capacity=P, pool_block=256, batch_buckets=(16, 64, 256),
              band_spec="gaussian:1500:300", **kw)
    q = dict(rating_threshold=100.0, widen_per_sec=2.0, max_threshold=200.0)
    jcfg = JaxConfig(engine=JaxEngineConfig(backend="tpu", **ec),
                     queues=(JaxQueueConfig(**q),))
    tcfg = Config(engine=EngineConfig(backend="gpu", **ec),
                  queues=(QueueConfig(**q),))
    return (TpuEngine(jcfg, jcfg.queues[0]),
            GpuEngine(tcfg, tcfg.queues[0], device="cpu"))


def feed(engine, cls):
    """tests/test_bucketed.py ``_feed``: six windows of 120, an expiry
    sweep and a heartbeat after the fourth; the sorted match set."""
    out = []
    local = np.random.default_rng(7)
    for w in range(6):
        reqs = [cls(id=f"w{w}_{i}", rating=float(local.normal(1500, 300)),
                    enqueued_at=1000.0 + w) for i in range(120)]
        res = engine.search(reqs, now=1000.0 + w)
        out.extend((tuple(sorted(p.id for t in m.teams for p in t)),
                    round(m.quality, 5)) for m in res.matches)
        if w == 3:
            engine.expire(1000.0 + w, 0.5)
            engine.heartbeat(1000.0 + w)
    return sorted(out)


def without_times(report):
    return dict(report, frontier_moves=[
        {k: v for k, v in m.items() if k != "t"}
        for m in report["frontier_moves"]])


FRONTIER_COUNTERS = ("bucket_frontier_steps", "bucket_frontier_fallback",
                     "frontier_k_moves")


def test_engine_sharded_bucket_frontier_matches_flat():
    _, flat = engine_pair()
    jeng, teng = engine_pair(bucketed=True, mesh_pool_axis=2,
                             bucket_frontier_k=64)
    want = feed(flat, SearchRequest)
    assert len(want) > 100
    assert feed(teng, SearchRequest) == want == feed(jeng, JaxRequest)
    rep = teng.formation_report()
    assert without_times(rep) == without_times(jeng.formation_report())
    assert rep["mode"] == "bucket_frontier"
    assert rep["frontier_k"] in rep["frontier_ladder"]
    assert rep["frontier_steps"] > 0 and len(teng.frontier_moves) >= 1
    assert rep["formation_touched_frac"] < 0.35
    assert rep["bands"] is not None
    for name in FRONTIER_COUNTERS:
        assert teng.counters.get(name, 0) == jeng.counters.get(name, 0), name
    assert teng.frontier_snapshot() == jeng.frontier_snapshot()
    assert teng.quality_report() == jeng.quality_report()


def test_engine_frontier_fallback_above_ladder():
    _, flat = engine_pair()
    jeng, teng = engine_pair(bucketed=True, mesh_pool_axis=2,
                             bucket_frontier_k=8)
    want = feed(flat, SearchRequest)
    assert feed(teng, SearchRequest) == want == feed(jeng, JaxRequest)
    assert teng.counters.get("bucket_frontier_fallback", 0) > 0
    for name in FRONTIER_COUNTERS:
        assert teng.counters.get(name, 0) == jeng.counters.get(name, 0), name
    assert without_times(teng.formation_report()) == \
        without_times(jeng.formation_report())


def test_frontier_steps_mark_formation_and_plain_sharding_reports_none():
    """A frontier window's device mark is "formation_bucketed", as a
    bucketed one's; a sharded queue without a ladder reports no formation
    and no frontier, as the JAX engine does; a bucketed sharded queue
    takes the default ceiling of 128."""
    _, plain = engine_pair(mesh_pool_axis=2)
    jplain, _ = engine_pair(mesh_pool_axis=2)
    assert plain.formation_report() is None is jplain.formation_report()
    assert plain.frontier_snapshot() is None
    jeng, teng = engine_pair(bucketed=True, mesh_pool_axis=2)
    assert teng._frontier_ladder == jeng._frontier_ladder == (8, 16, 32, 64,
                                                              128)
    reqs = [SearchRequest(id=f"p{i}", rating=1500.0 + i, enqueued_at=1.0)
            for i in range(40)]
    teng.search_async(reqs, now=1.0)
    (tok, _), = teng.flush()
    marks = [name for name, _ in teng.window_marks[tok]]
    assert "formation_bucketed" in marks and "device_step" not in marks


def test_sampler_frontier_series_equal_the_jax_app():
    """The telemetry sampler's ``frontier_k[q]`` and
    ``frontier_k_moves[q]`` come from ``frontier_snapshot``: after the
    same windows through a bucket-frontier queue of both apps, the two
    series equal the JAX app's."""
    import asyncio

    from matchmaking_tpu.config import ObservabilityConfig as JaxObs
    from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
    from matchmaking_tpu.service.broker import Properties as JaxProperties
    from matchmaking_tpu_torch.config import ObservabilityConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    ec = dict(pool_capacity=1024, pool_block=128, batch_buckets=(16, 64),
              band_spec="gaussian:1500:300", bucketed=True, mesh_pool_axis=2,
              bucket_frontier_k=32)
    port = Config(engine=EngineConfig(backend="gpu", **ec),
                  observability=ObservabilityConfig(trace=False,
                                                    snapshot_interval_s=0.0))
    jax = JaxConfig(engine=JaxEngineConfig(backend="tpu", **ec),
                    observability=JaxObs(trace=False,
                                         snapshot_interval_s=0.0))
    rng = np.random.default_rng(5)
    bodies = [f'{{"id":"p{i}","rating":{float(rng.normal(1500, 250)):.1f}}}'
              .encode() for i in range(96)]

    async def run(app, props):
        app.broker.declare_queue("replies")
        await app.start()
        samples = []
        try:
            for b in range(0, len(bodies), 32):
                for i, body in enumerate(bodies[b:b + 32]):
                    app.broker.publish(
                        app.cfg.queues[0].name, body,
                        props(reply_to="replies",
                              correlation_id=f"c{b + i}"))
                got = 0
                for _ in range(400):
                    d = await app.broker.get("replies", timeout=0.05)
                    got += d is not None
                    if d is None and got >= 32:
                        break
                samples.append(app.sample_telemetry(now=1000.0 + b))
        finally:
            await app.stop()
        return samples

    mine = asyncio.run(run(MatchmakingApp(port, device="cpu"), Properties))
    theirs = asyncio.run(run(JaxApp(jax), JaxProperties))
    q = port.queues[0].name
    for a, b in zip(mine, theirs):
        for key in (f"frontier_k[{q}]", f"frontier_k_moves[{q}]"):
            assert a[key] == b[key], key
    assert mine[-1][f"frontier_k_moves[{q}]"] >= 1
