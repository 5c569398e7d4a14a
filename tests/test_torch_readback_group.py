"""Grouped readback (``EngineConfig.readback_group`` k > 1) in the port
against the JAX package's.

The JAX package's five ``tests/test_readback_group.py`` scripts run on
both packages at their sizes: the JAX engine under ``JAX_PLATFORMS=cpu``
(its 8 virtual CPU devices for the sharded case), the port's
``GpuEngine`` on ``device="cpu"`` (a mesh of 8 CPU entries). Pairs and
pool sizes must be equal across the packages and across k = 1-4.

Beyond JAX's scripts, on the port: a window in a group not yet sealed is
not ready on the CPU either; a grouped window's marks are JAX's (dispatch,
h2d, device_step, readback_seal, collect), the seal at or after its last
step, and attribution splits ``readback_group_wait`` as JAX's does on
the same schedule; the rescan tick, a committed speculation and the
object path grouped equal ungrouped; an error at a group's read fails
exactly its windows; team queues and ``close()``.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.engine.interface import make_engine as jax_make_engine
from matchmaking_tpu.service import attribution as jax_attribution
from matchmaking_tpu.service.contract import RequestColumns as JaxColumns
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.engine.interface import make_engine
from matchmaking_tpu_torch.service import attribution
from matchmaking_tpu_torch.service.contract import (
    RequestColumns,
    SearchRequest,
)

torch.set_num_threads(1)

PKGS = ("jax", "torch")


def _cfg(pkg, k, wait_ms=8.0, **engine):
    kw = dict(pool_capacity=256, pool_block=64, batch_buckets=(16,),
              top_k=4, readback_group=k, readback_group_wait_ms=wait_ms)
    kw.update(engine)
    if pkg == "jax":
        return JaxConfig(queues=(JaxQueueConfig(rating_threshold=100.0),),
                         engine=JaxEngineConfig(backend="tpu", **kw))
    return Config(queues=(QueueConfig(rating_threshold=100.0),),
                  engine=EngineConfig(backend="gpu", **kw))


def _engine(pkg, cfg):
    if pkg == "jax":
        return jax_make_engine(cfg, cfg.queues[0])
    return make_engine(cfg, cfg.queues[0], device="cpu")


def _cols(pkg, rng, n, start):
    cls = JaxColumns if pkg == "jax" else RequestColumns
    return cls(
        ids=np.array([f"p{start + i}" for i in range(n)], object),
        rating=rng.normal(1500, 80, size=n).astype(np.float32),
        rd=np.zeros(n, np.float32),
        region=np.zeros(n, np.int32),
        mode=np.zeros(n, np.int32),
        threshold=np.full(n, np.nan, np.float32),
        enqueued_at=np.full(n, 1.0, np.float64),
    )


def _pairs(outs):
    return {frozenset(p) for _, out in outs
            for p in zip(out.m_id_a.tolist(), out.m_id_b.tolist())}


def _run(pkg, k, n_windows=6, window=16, **engine):
    """JAX's ``_run``: dispatch every window, then flush once (the fixed
    collection schedule the equality claim needs)."""
    cfg = _cfg(pkg, k, **engine)
    eng = _engine(pkg, cfg)
    rng = np.random.default_rng(99)
    for w in range(n_windows):
        eng.search_columns_async(_cols(pkg, rng, window, w * window), 1.0 + w)
    pairs = _pairs(eng.flush())
    assert eng.device_error is None
    return pairs, eng.pool_size()


# ---- JAX's five scripts, on both packages ------------------------------------


@pytest.mark.parametrize("k", [2, 3, 4])
def test_grouped_matches_equal_ungrouped(k):
    base = _run("jax", 1)
    assert base[0]
    assert _run("jax", k) == base
    assert _run("torch", 1) == base
    assert _run("torch", k) == base


@pytest.mark.parametrize("pkg", PKGS)
def test_interleaved_collection_smoke(pkg):
    """Interleaved dispatch and collection: nobody matched twice, and
    matched + still waiting = submitted."""
    cfg = _cfg(pkg, 3, wait_ms=1.0)
    eng = _engine(pkg, cfg)
    rng = np.random.default_rng(41)
    matched, queued = [], []
    for w in range(8):
        eng.search_columns_async(_cols(pkg, rng, 16, w * 16), 1.0 + w)
        for _tok, out in eng.collect_ready():
            matched.extend(out.m_id_a.tolist() + out.m_id_b.tolist())
            queued.extend(out.q_ids.tolist())
    for _tok, out in eng.flush():
        matched.extend(out.m_id_a.tolist() + out.m_id_b.tolist())
        queued.extend(out.q_ids.tolist())
    assert eng.device_error is None
    assert len(matched) == len(set(matched)), "player matched twice"
    assert len(matched) + eng.pool_size() == 8 * 16
    assert set(queued) >= {r.id for r in eng.waiting()}


@pytest.mark.parametrize("pkg", PKGS)
def test_partial_group_seals_on_collect(pkg):
    """A lone window (a group of 1 with k = 4) completes through the
    stale seal while ``collect_ready`` is polled."""
    cfg = _cfg(pkg, 4, wait_ms=1.0)
    eng = _engine(pkg, cfg)
    rng = np.random.default_rng(5)
    tok = eng.search_columns_async(_cols(pkg, rng, 16, 0), 1.0)
    got = []
    deadline = time.monotonic() + 30.0
    while not got and time.monotonic() < deadline:
        time.sleep(0.002)
        got = eng.collect_ready()
    assert got and got[0][0] == tok
    assert eng.inflight() == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_flush_seals_open_groups(pkg):
    cfg = _cfg(pkg, 8, wait_ms=10_000.0)  # the wait never runs out
    eng = _engine(pkg, cfg)
    rng = np.random.default_rng(6)
    toks = [eng.search_columns_async(_cols(pkg, rng, 16, 100 * i), 1.0)
            for i in range(3)]
    outs = eng.flush()
    assert [t for t, _ in outs] == toks
    assert eng.inflight() == 0


def _sharded_pairs(pkg, k):
    cfg = _cfg(pkg, k, wait_ms=2.0, pool_block=16, mesh_pool_axis=8)
    eng = _engine(pkg, cfg)
    rng = np.random.default_rng(77)
    for w in range(4):
        eng.search_columns_async(_cols(pkg, rng, 16, w * 16), 1.0 + w)
    pairs = _pairs(eng.flush())
    assert eng.device_error is None
    return pairs


def test_grouped_readback_on_sharded_mesh():
    """The sharded engine (JAX: 8 virtual devices; the port: a mesh of 8
    CPU entries, its merged result on the mesh's home): grouped equals
    ungrouped, and the packages agree."""
    want = _sharded_pairs("jax", 1)
    assert want
    assert _sharded_pairs("jax", 4) == want
    assert _sharded_pairs("torch", 1) == want
    assert _sharded_pairs("torch", 4) == want


# ---- the port's grouped readback, beyond JAX's scripts ------------------------


def test_unsealed_group_is_not_ready_on_the_cpu():
    """On the CPU every result exists at dispatch, but a window whose
    group is open is not ready: only a seal (full, stale or forced) lets
    it through, as on the card."""
    eng = _engine("torch", _cfg("torch", 3, wait_ms=10_000.0))
    rng = np.random.default_rng(8)
    toks = [eng.search_columns_async(_cols("torch", rng, 16, 16 * i), 1.0)
            for i in range(4)]
    # The first three filled a group, sealed at dispatch; the fourth's is
    # open.
    assert [t for t, _ in eng.collect_ready()] == toks[:3]
    assert eng.collect_ready() == [] and eng.inflight() == 1
    assert [t for t, _ in eng.flush()] == toks[3:]
    assert not eng._rb_open


def _marks_run(pkg):
    """Four windows of 16 at k = 3, a pause before the fourth, then the
    stale seal: the window marks of each."""
    eng = _engine(pkg, _cfg(pkg, 3, wait_ms=5.0))
    rng = np.random.default_rng(12)
    toks = []
    for w in range(4):
        if w == 3:
            time.sleep(0.02)
        toks.append(eng.search_columns_async(_cols(pkg, rng, 16, 16 * w),
                                             1.0 + w))
    time.sleep(0.01)
    done = []
    deadline = time.monotonic() + 30.0
    while len(done) < 4 and time.monotonic() < deadline:
        done += eng.collect_ready()
        time.sleep(0.001)
    assert [t for t, _ in done] == toks
    return [eng.window_marks.pop(t) for t in toks]


def test_grouped_window_marks_and_attribution_equal_jax():
    """A grouped window's marks are JAX's names in JAX's order (dispatch,
    h2d, device_step, readback_seal, collect), non-decreasing, the seal at
    or after the last device_step; the first window of a group waits for
    the third (its ``readback_group_wait`` is the longest), and each
    package's attribution splits the same categories, gap for gap."""
    got, want = _marks_run("torch"), _marks_run("jax")
    for g, w in zip(got, want):
        assert [n for n, _ in g] == [n for n, _ in w]
        assert [n for n, _ in g] == ["dispatch", "h2d", "device_step",
                                     "readback_seal", "collect"]
        assert [t for _, t in g] == sorted(t for _, t in g)
        names = [n for n, _ in g]
        step = max(t for n, t in g if n == "device_step")
        assert g[names.index("readback_seal")][1] >= step
        gaps_g, work_g, wait_g = attribution.decompose_marks(g)
        gaps_w, _, _ = jax_attribution.decompose_marks(w)
        assert ([(x["category"], x["kind"]) for x in gaps_g]
                == [(x["category"], x["kind"]) for x in gaps_w])
        assert abs(work_g + wait_g - (g[-1][1] - g[0][1])) <= 1e-9
    waits = [next(x["ms"] for x in attribution.decompose_marks(g)[0]
                  if x["category"] == "readback_group_wait") for g in got]
    # Window 0 waited for windows 1 and 2 to fill its group; window 3's
    # group went stale (5 ms) before it was sealed.
    assert waits[0] >= waits[2]
    assert waits[3] >= 4.0


@pytest.mark.parametrize("k", [1, 3])
def test_util_readback_counts_every_window(k):
    eng = _engine("torch", _cfg("torch", k, wait_ms=1.0))
    rng = np.random.default_rng(4)
    for w in range(7):
        eng.search_columns_async(_cols("torch", rng, 16, 16 * w), 1.0 + w)
    assert len(eng.flush()) == 7
    util, spans = eng.util_report(), eng.span_report()
    assert util["windows"] == spans["windows"] == 7
    assert util["lanes_valid"] == 7 * 16
    assert util["readback_s"] >= 0.0


def _rescan_and_objects(k):
    """Object windows (two chunks each: 24 requests over buckets of 16),
    then two rescan ticks, at k; every outcome and the pool after."""
    cfg = _cfg("torch", k, wait_ms=10_000.0)
    cfg = dataclasses.replace(cfg, queues=(dataclasses.replace(
        cfg.queues[0], widen_per_sec=50.0, max_threshold=400.0),))
    eng = _engine("torch", cfg)
    rng = np.random.default_rng(21)
    for w in range(3):
        reqs = [SearchRequest(id=f"o{w}_{i}",
                              rating=float(rng.normal(1500, 200)),
                              enqueued_at=1.0) for i in range(24)]
        eng.search_async(reqs, 1.0 + w)
    eng.rescan_async(32, 6.0)
    eng.rescan_async(32, 9.0)
    outs = []
    for tok, out in eng.flush():
        if hasattr(out, "matches"):
            outs.append((tok, sorted(tuple(sorted(r.id for r in m.requests()))
                                     for m in out.matches),
                         sorted(r.id for r in out.queued)))
        else:
            outs.append((tok, sorted(_pairs([(tok, out)]), key=sorted),
                         sorted(out.q_ids.tolist())))
    return outs, sorted(r.id for r in eng.waiting())


def test_object_windows_and_rescan_ticks_grouped_equal_ungrouped():
    base = _rescan_and_objects(1)
    assert any(o[1] for o in base[0][3:]), "the rescan ticks matched nobody"
    for k in (2, 3, 4):
        assert _rescan_and_objects(k) == base


def _speculation_commit(k):
    q = QueueConfig(rating_threshold=10.0, widen_per_sec=10.0,
                    max_threshold=200.0)
    cfg = Config(queues=(q,), engine=EngineConfig(
        pool_capacity=64, pool_block=64, batch_buckets=(16,),
        spec_formation=True, spec_max_steps=2, readback_group=k,
        readback_group_wait_ms=10_000.0))
    eng = make_engine(cfg, q, device="cpu")
    rng = np.random.default_rng(7)
    eng.restore([SearchRequest(id=f"s{i}", rating=float(r), enqueued_at=0.0)
                 for i, r in enumerate(rng.normal(1500, 40, 40))], 0.0)
    assert eng.speculate(4.0)
    tok = eng.spec_validate(4.0)
    assert eng.spec_commit(tok, 4.0) is not None
    eng.rescan_async(16, 5.0)
    outs = [(tok, sorted(_pairs([(tok, out)]), key=sorted))
            for tok, out in eng.flush()]
    return outs, eng.pool_size(), eng.quality_report()


def test_speculation_commit_grouped_equals_ungrouped():
    """A committed speculation's held results join the open groups at the
    commit (their device copies were taken behind each pass)."""
    base = _speculation_commit(1)
    assert base[0][0][1]
    for k in (2, 3):
        assert _speculation_commit(k) == base


def test_an_error_at_a_group_read_fails_exactly_its_windows():
    """Windows 0-2 fill one group and windows 3-5 the next: a device error
    at the second group's read reports each of its three windows as
    queued (the mirror still holds them), their tokens in
    ``failed_tokens``; windows 0-2 finalize as usual."""
    eng = _engine("torch", _cfg("torch", 3, wait_ms=10_000.0))
    rng = np.random.default_rng(9)
    cols = [_cols("torch", rng, 16, 16 * w) for w in range(6)]
    toks = [eng.search_columns_async(c, 1.0 + w) for w, c in enumerate(cols)]
    pending = list(eng._pending)
    group = pending[3].chunks[0][1].group
    assert [p.chunks[0][1].group is group for p in pending] == [False] * 3 + [True] * 3
    group.error = RuntimeError("CUDA error: an illegal memory access")
    done = dict(eng.flush())
    assert list(done) == toks
    assert eng.failed_tokens == set(toks[3:])
    assert isinstance(eng.device_error, RuntimeError)
    assert sum(done[t].n_matches for t in toks[:3]) > 0
    for w in range(3, 6):
        assert done[toks[w]].n_matches == 0
        assert done[toks[w]].q_ids.tolist() == cols[w].ids.tolist()
        assert all(pid in eng.pool for pid in cols[w].ids.tolist())


def test_team_queue_reads_each_window_by_itself():
    cfg = Config(queues=(QueueConfig(team_size=2, rating_threshold=200.0),),
                 engine=EngineConfig(pool_capacity=256, pool_block=64,
                                     batch_buckets=(16,), readback_group=3))
    eng = make_engine(cfg, cfg.queues[0], device="cpu")
    assert eng._rb_k == 1
    rng = np.random.default_rng(3)
    tok, _ = eng.search_async(
        [SearchRequest(id=f"t{i}", rating=float(r), enqueued_at=0.0,
                       region="eu", game_mode="ranked")
         for i, r in enumerate(rng.normal(1500, 30, 8))], 1.0)
    assert [t for t, _ in eng.collect_ready()] == [tok]
    names = [n for n, _ in eng.window_marks.pop(tok)]
    assert names == ["dispatch", "h2d", "device_step", "readback_seal",
                     "collect"]


def test_close_drops_open_groups():
    eng = _engine("torch", _cfg("torch", 4, wait_ms=10_000.0))
    eng.search_columns_async(_cols("torch", np.random.default_rng(1), 16, 0),
                             1.0)
    assert eng._rb_open and eng.inflight() == 1
    eng.close()
    assert not eng._rb_open and eng.inflight() == 0



# ---- the service's engine swaps with open groups -------------------------------


_SWAP = {"queues": [{"name": "grp.q", "rating_threshold": 200.0}],
         "engine": {"pool_capacity": 256, "pool_block": 64,
                    "batch_buckets": (8, 32), "top_k": 4,
                    "pipeline_depth": 4, "readback_group": 3,
                    "readback_group_wait_ms": 50.0},
         "batcher": {"max_batch": 8, "max_wait_ms": 5.0},
         "overload": {"max_inflight": 128},
         "chaos": {"fail_steps": [3]},
         "placement": {"interval_s": 3600.0, "devices": 4},
         "debug_invariants": True}


def test_engine_swaps_with_open_groups_lose_no_player(monkeypatch):
    """Config of the service at k = 3 (groups sealed full, after 50 ms or
    at a flush) with a scripted failed step (a revive onto a new engine
    with windows in flight) and two live migrations while players
    arrive: every player is answered, nobody twice; matched + waiting =
    submitted; each engine the service let go has no open group and
    nothing in flight."""
    import asyncio

    from matchmaking_tpu_torch.engine.gpu import GpuEngine
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.client import MatchmakingClient

    closed = []
    real_close = GpuEngine.close

    def close(self):
        closed.append((len(self._rb_open), len(self._pending)))
        real_close(self)

    async def run():
        app = MatchmakingApp(Config.from_dict(_SWAP, backend="gpu"),
                             device="cpu")
        await app.start()
        try:
            rt = app.runtime("grp.q")
            assert rt.engine._rb_k == 3
            client = MatchmakingClient(app.broker, "grp.q")

            async def one(i):
                return await client.search_until_matched(
                    {"id": f"s{i}", "rating": 1500 + (i % 11) * 9},
                    timeout=15.0)

            tasks = [asyncio.create_task(one(i)) for i in range(60)]
            await asyncio.sleep(0.03)
            await rt.migrate((2,))
            await asyncio.sleep(0.03)
            await rt.migrate((1,))
            results = await asyncio.gather(*tasks)
            ids = [r.player_id for r in results if r.status == "matched"]
            assert len(ids) == len(set(ids))
            waiting = {r.id for r in rt.engine.waiting()}
            assert len(ids) + len(waiting) == 60
            assert len(ids) >= 50
            assert app.metrics.counters.get("engine_crashes") == 1
            assert app.metrics.counters.get("queue_migrations") == 2
        finally:
            await app.stop()

    monkeypatch.setattr(GpuEngine, "close", close)
    asyncio.run(run())
    assert len(closed) >= 3
    assert all(c == (0, 0) for c in closed), closed
