"""The port's rescan (threshold widening resolved between waiting pool
members) against the JAX package's, on the CPU.

The engine cases are ``tests/test_rescan.py``'s 1v1 cases, run through
``TpuEngine`` and ``GpuEngine`` side by side on the same stream: the same
pairs, qualities within 1e-6, the same pool. The unit case holds
``KernelSet.search_step_packed_rescan`` to the JAX
``_search_step_packed_rescan`` on one seeded pool and window: the same
slots, ELO distances bit-equal (Glicko-2 within 3 ulp: XLA fuses FMAs on
the CPU), and the same pool afterwards.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.core.pool import PlayerPool as JaxPlayerPool
from matchmaking_tpu.engine.kernels import KernelSet as JaxKernelSet
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.core.pool import POOL_FIELDS
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.engine.kernels import (
    KernelSet,
    pool_from_reference,
    pool_to_numpy,
)
from matchmaking_tpu_torch.service.contract import SearchRequest

torch.set_num_threads(1)

GLICKO_ULP = 3
QUEUE = dict(rating_threshold=10.0, widen_per_sec=10.0, max_threshold=200.0)


def engines(**engine_kw):
    kw = dict(pool_capacity=64, pool_block=64, batch_buckets=(16,))
    kw.update(engine_kw)
    jq, tq = JaxQueueConfig(**QUEUE), QueueConfig(**QUEUE)
    jcfg = JaxConfig(queues=(jq,), engine=JaxEngineConfig(backend="tpu", **kw))
    tcfg = Config(queues=(tq,), engine=EngineConfig(**kw))
    return TpuEngine(jcfg, jq), GpuEngine(tcfg, tq, device="cpu")


def req(i, rating, t=0.0):
    kw = dict(id=f"p{i}", rating=float(rating), enqueued_at=t,
              reply_to=f"rq.p{i}")
    return JaxRequest(**kw), SearchRequest(**kw)


def restore(jeng, teng, rows, now):
    jeng.restore([j for j, _ in rows], now)
    teng.restore([t for _, t in rows], now)


def outcomes(eng):
    """{frozenset pair: quality} over everything flush() returns, and the
    tokens in order."""
    pairs, toks = {}, []
    for tok, out in eng.flush():
        toks.append(tok)
        if hasattr(out, "m_id_a"):
            for a, b, q in zip(out.m_id_a.tolist(), out.m_id_b.tolist(),
                               out.m_quality.tolist()):
                pairs[frozenset((a, b))] = q
        else:
            for m in out.matches:
                pairs[frozenset(r.id for r in m.requests())] = m.quality
    return pairs, toks


def same_outcomes(jeng, teng):
    (jp, jt), (tp, tt) = outcomes(jeng), outcomes(teng)
    assert tt == jt
    assert tp.keys() == jp.keys()
    for k in tp:
        assert abs(tp[k] - jp[k]) <= 1e-6
    assert teng.pool._slot_of == jeng.pool._slot_of
    assert (pool_to_numpy(teng.dev_pool)["active"]
            == np.asarray(jeng._dev_pool["active"])).all()
    return tp


def test_widening_resolves_between_pool_members():
    jeng, teng = engines()
    # Distance 40; both thresholds widen 10/s from base 10.
    restore(jeng, teng, [req(0, 1500.0), req(1, 1540.0)], 0.0)
    assert (teng.rescan_async(16, now=1.0) is not None
            and jeng.rescan_async(16, now=1.0) is not None)
    assert same_outcomes(jeng, teng) == {}     # eff thr 20 < 40: no match
    assert teng.pool_size() == 2
    teng.rescan_async(16, now=4.0)
    jeng.rescan_async(16, now=4.0)
    pairs = same_outcomes(jeng, teng)          # eff thr 50 ≥ 40: a match
    assert pairs.keys() == {frozenset(("p0", "p1"))}
    assert pairs[frozenset(("p0", "p1"))] == pytest.approx(1.0 - 40.0 / 50.0,
                                                           abs=1e-5)
    assert teng.pool_size() == 0


def test_empty_pool_returns_none():
    jeng, teng = engines()
    assert teng.rescan_async(16, now=1.0) is None
    assert jeng.rescan_async(16, now=1.0) is None


def test_rescan_overlapping_a_window_in_flight_never_double_matches():
    """A rescan dispatched while a window is in flight builds its lanes
    from the lagging mirror, which still lists the players that window is
    matching; the device-side active gate makes those lanes no-ops."""
    jeng, teng = engines()
    restore(jeng, teng, [req(0, 1500.0), req(1, 1505.0)], 0.0)
    j2, t2 = req(2, 1502.0)
    jeng.search_async([j2], 0.5)               # in flight: takes p0 (d=2)
    teng.search_async([t2], 0.5)
    tok = teng.rescan_async(16, now=1.0)       # overlapped
    assert tok == jeng.rescan_async(16, now=1.0)
    assert tok in teng.rescan_tokens
    pairs = same_outcomes(jeng, teng)
    assert pairs.keys() == {frozenset(("p0", "p2"))}  # once; p1 untouched
    assert teng.pool_size() == 1
    # The token stays routable until a collector consumes it.
    assert tok in teng.rescan_tokens


def test_multi_chunk_rescan_resolves_the_whole_pool_in_one_tick():
    """pipeline_depth 3 budgets a tick at 3 chunks × 16 lanes ≥ the
    40-player pool; a later chunk cannot re-match what an earlier one
    retired."""
    jeng, teng = engines(pipeline_depth=3)
    rows = []
    for i in range(20):
        rows += [req(2 * i, 5000.0 * i), req(2 * i + 1, 5000.0 * i + 5.0)]
    restore(jeng, teng, rows, 0.0)
    assert teng.rescan_async(64, now=1.0) is not None
    jeng.rescan_async(64, now=1.0)
    assert len(teng._pending[-1].chunks) == 3
    pairs = same_outcomes(jeng, teng)
    assert len(pairs) == 20
    assert all(int(a[1:]) // 2 == int(b[1:]) // 2
               for a, b in (sorted(k) for k in pairs))
    assert teng.pool_size() == 0


def test_rescan_tick_chunk_budget_caps_device_steps():
    """One tick dispatches at most pipeline_depth chunks (2 here); the
    oldest-first pick rolls the remainder into the next tick."""
    jeng, teng = engines()
    rows = []
    for i in range(24):
        rows += [req(2 * i, 5000.0 * i), req(2 * i + 1, 5000.0 * i + 5.0)]
    restore(jeng, teng, rows, 0.0)
    teng.rescan_async(64, now=1.0)
    jeng.rescan_async(64, now=1.0)
    assert len(teng._pending[-1].chunks) == 2     # capped, not 4
    assert len(same_outcomes(jeng, teng)) == 16   # the 32 oldest players
    teng.rescan_async(64, now=2.0)
    jeng.rescan_async(64, now=2.0)
    assert len(same_outcomes(jeng, teng)) == 8
    assert teng.pool_size() == 0


def test_oldest_players_are_rescanned_first():
    jeng, teng = engines(batch_buckets=(4,))
    # Six players, a 4-lane tick: the 4 OLDEST re-submit. Old pair (t=0)
    # distance 60, young pair (t=9) distance 60: at t=10 only the old
    # pair's widened thresholds (110) cover it.
    restore(jeng, teng, [req(0, 1000.0, 0.0), req(1, 1060.0, 0.0)], 0.0)
    restore(jeng, teng, [req(2, 3000.0, 9.0), req(3, 3060.0, 9.0),
                         req(4, 5000.0, 9.0), req(5, 7000.0, 9.0)], 9.0)
    teng.rescan_async(4, now=10.0)
    jeng.rescan_async(4, now=10.0)
    assert same_outcomes(jeng, teng).keys() == {frozenset(("p0", "p1"))}


@pytest.mark.parametrize("glicko2", [False, True])
def test_search_step_packed_rescan_matches_jax(glicko2):
    """One rescan window over a seeded pool: live lanes, lanes whose slot
    is no longer active (a matched player the mirror still lists), and
    padding. Nothing is admitted; the stale lanes match nothing."""
    rng = np.random.default_rng(17)
    P, B = 1024, 64
    geo = dict(capacity=P, top_k=8, pool_block=256, glicko2=glicko2,
               widen_per_sec=5.0, max_threshold=250.0, pair_rounds=8)
    jks, tks = JaxKernelSet(**geo), KernelSet(**geo)
    arrs = JaxPlayerPool.empty_device_arrays(P)
    n = 600
    arrs["rating"][:n] = rng.normal(1500, 300, n).astype(np.float32)
    arrs["rd"][:n] = rng.uniform(0, 350, n).astype(np.float32)
    arrs["threshold"][:n] = rng.choice([50.0, 100.0, 150.0], n)
    arrs["enqueue_t"][:n] = rng.uniform(0, 5, n)
    arrs["active"][:n] = True
    stale = np.arange(0, n, 7)
    arrs["active"][stale] = False
    # The window: 50 pool slots (every 7th among them stale), the mirror's
    # copy of their rows, and 14 padding lanes.
    slots = np.sort(rng.choice(n, 50, replace=False))
    packed = np.zeros((9, B), np.float32)
    packed[0] = P
    packed[0, :50] = slots
    for row, name in ((1, "rating"), (2, "rd"), (5, "threshold"),
                      (6, "enqueue_t")):
        packed[row, :50] = arrs[name][slots]
    packed[7, :50] = 1.0
    now = float(np.float32(9.0))
    packed[8] = now
    jpool = {k: jnp.asarray(v) for k, v in arrs.items()}
    jpool, jout = jks.search_step_packed_rescan(jpool, jnp.asarray(packed))
    tpool = pool_from_reference(arrs, "cpu")
    tout = tks.search_step_packed_rescan(tpool, torch.from_numpy(packed))
    jout, tout = np.asarray(jout), tout.numpy()
    assert tout.shape == (3, B)
    pairs = lambda o: {frozenset((int(a), int(b))): np.float32(d)
                       for a, b, d in zip(o[0], o[1], o[2]) if a < P}
    tp, jp = pairs(tout), pairs(jout)
    assert tp.keys() == jp.keys() and len(tp) >= 5
    stale_set = set(stale.tolist())
    assert not any(s in stale_set for k in tp for s in k)
    for k in tp:
        ia, ib = (np.array([x], np.float32).view(np.int32).astype(np.int64)
                  for x in (tp[k], jp[k]))
        assert abs(int(ia[0] - ib[0])) <= (GLICKO_ULP if glicko2 else 0)
    if not glicko2:
        np.testing.assert_array_equal(tout, jout)
    port = pool_to_numpy(tpool)
    for name, _ in POOL_FIELDS:
        np.testing.assert_array_equal(port[name], np.asarray(jpool[name]),
                                      err_msg=name)
