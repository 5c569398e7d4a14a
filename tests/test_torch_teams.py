"""The team window step (config #3) against the JAX package's, on the CPU.

Step level: the port's ``TeamKernelSet`` and the JAX ``TeamKernelSet``
(JAX on the CPU) take the same seeded pool and windows, three steps in a
row on the same pool, for team sizes 2 and 5, with widening off and on,
over four (region, mode) groups. Slots, spread, limit and the pool after
each step are bit-equal. The widening cases use config #3's rate, 2/s:
JAX on the CPU contracts ``thr + widen · waited`` into a fused
multiply-add, which for a rate of 2 (an exact product) rounds as the
port's two rounded ops do. At another rate the limit may differ by one
ulp: ``test_limit_within_one_ulp_at_other_rates`` holds slots and spread
equal and the limit within 1 ulp, on seeded data where no window sits on
that boundary.

Engine level: ``GpuEngine`` (device="cpu") against ``TpuEngine`` over nine
windows of a 5v5 queue from ``configs/team_5v5.json`` (cut to a 512-slot
pool): the same member teams per match, queued and waiting sets, and the
delegation to the host oracle (a wildcard arrives) and the re-promotion
(it leaves, 5 s pass) at the same windows.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.core.pool import PlayerPool as JaxPool
from matchmaking_tpu.engine import scoring as jax_scoring
from matchmaking_tpu.engine.teams import team_kernel_set as jax_team_set
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config
from matchmaking_tpu_torch.engine import scoring
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.engine.kernels import (
    pool_from_reference,
    pool_to_numpy,
)
from matchmaking_tpu_torch.engine.teams import TeamKernelSet
from matchmaking_tpu_torch.service.contract import SearchRequest

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, B, M = 512, 64, 64


def seeded_pool(rng, capacity, extra=None):
    pool = JaxPool.empty_device_arrays(capacity)
    pool["rating"] = rng.normal(1500, 300, capacity).astype(np.float32)
    pool["rd"] = rng.uniform(0, 350, capacity).astype(np.float32)
    pool["region"] = rng.integers(1, 3, capacity).astype(np.int32)
    pool["mode"] = rng.integers(1, 3, capacity).astype(np.int32)
    pool["threshold"] = rng.choice([60.0, 100.0, 150.0],
                                   capacity).astype(np.float32)
    pool["enqueue_t"] = rng.uniform(0, 30, capacity).astype(np.float32)
    pool["active"] = rng.random(capacity) < 0.6
    for name in extra or ():
        pool[name] = rng.integers(0, 8, capacity).astype(np.int32)
    return pool


def seeded_window(rng, free_slots, now, rows=9, n_max=B - 5, role_mask=False):
    """A packed window (f32[rows, B]) admitting into ``free_slots``; the
    last row is ``now``, padding lanes carry slot P."""
    n = min(n_max, free_slots.size)
    packed = np.zeros((rows, B), np.float32)
    packed[0] = P
    packed[0, :n] = free_slots[:n]
    packed[1, :n] = rng.normal(1500, 300, n)
    packed[2, :n] = rng.uniform(0, 350, n)
    packed[3, :n] = rng.integers(1, 3, n)
    packed[4, :n] = rng.integers(1, 3, n)
    packed[5, :n] = rng.choice([60.0, 100.0, 150.0], n)
    packed[6, :n] = rng.uniform(0, now, n)
    packed[7, :n] = 1.0
    if role_mask:
        packed[8, :n] = rng.integers(0, 8, n)
    packed[-1] = now
    return packed


def run_steps(jax_set, port_set, seed, steps=3, extra=None, ulp_limit=False):
    """``steps`` windows in a row through both steps on one pool; returns
    the matches formed. Outputs and pools compared after every step."""
    rng = np.random.default_rng(seed)
    pool = seeded_pool(rng, P, extra)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpool = pool_from_reference(pool, "cpu", port_set.extra_pool_fields)
    formed = 0
    for step in range(steps):
        now = 30.0 + 5.0 * step
        free = np.nonzero(~pool_to_numpy(tpool)["active"])[0]
        packed = seeded_window(rng, free, now, rows=port_set.pack_rows,
                               role_mask=port_set.is_role)
        jpool, jout = jax_set.search_step_packed(jpool, jnp.asarray(packed))
        jout = np.asarray(jout)
        tout = port_set.search_step_packed(tpool,
                                           torch.from_numpy(packed)).numpy()
        assert tout.shape == jout.shape
        need = port_set.need
        exact = np.arange(jout.shape[0]) != need + 1 if ulp_limit else slice(None)
        np.testing.assert_array_equal(tout[exact].view(np.int32),
                                      jout[exact].view(np.int32))
        if ulp_limit:
            gap = np.abs(tout[need + 1].view(np.int32).astype(np.int64)
                         - jout[need + 1].view(np.int32).astype(np.int64))
            assert gap.max() <= 1
        port_np = pool_to_numpy(tpool)
        for name, col in jpool.items():
            np.testing.assert_array_equal(port_np[name], np.asarray(col),
                                          err_msg=name)
        formed += int((tout[0] < P).sum())
    return formed


@pytest.mark.parametrize("team_size,widen", [(2, 0.0), (2, 2.0), (5, 0.0),
                                             (5, 2.0)])
def test_team_step_bit_equal_to_jax(team_size, widen):
    jax_set = jax_team_set(P, team_size, widen, 300.0, M, 16)
    port_set = TeamKernelSet(capacity=P, team_size=team_size,
                             widen_per_sec=widen, max_threshold=300.0,
                             max_matches=M)
    assert port_set.max_matches == jax_set.max_matches
    assert run_steps(jax_set, port_set, seed=10 * team_size + int(widen)) >= 10


def test_limit_within_one_ulp_at_other_rates():
    jax_set = jax_team_set(P, 5, 3.0, 300.0, M, 16)
    port_set = TeamKernelSet(capacity=P, team_size=5, widen_per_sec=3.0,
                             max_threshold=300.0, max_matches=M)
    assert run_steps(jax_set, port_set, seed=7, ulp_limit=True) >= 10


def test_snake_split_and_signs_are_the_jax_ones():
    rng = np.random.default_rng(3)
    for need in (2, 4, 6, 10):
        assert scoring.snake_signs(need) == jax_scoring.snake_signs(need)
        for _ in range(20):
            ratings = rng.integers(1400, 1420, need).astype(float)  # ties
            mk = lambda cls: [cls(id=f"p{i}", rating=float(r))
                              for i, r in enumerate(ratings)]
            port = scoring.snake_split(mk(SearchRequest))
            jax = jax_scoring.snake_split(mk(JaxRequest))
            assert ([[r.id for r in t] for t in port]
                    == [[r.id for r in t] for t in jax])
            signs = scoring.snake_signs(need)
            diff = sum(s * r for s, r in zip(signs, sorted(ratings)))
            assert abs(diff) <= ratings.max() - ratings.min()


def team_engines():
    path = os.path.join(ROOT, "configs/team_5v5.json")
    small = dict(pool_capacity=P, pool_block=64, batch_buckets=(16, 64),
                 team_max_matches=M)
    jcfg, tcfg = JaxConfig.from_json(path), Config.from_json(path,
                                                             backend="gpu")
    jcfg = dataclasses.replace(jcfg, engine=dataclasses.replace(jcfg.engine,
                                                                **small))
    tcfg = dataclasses.replace(tcfg, engine=dataclasses.replace(tcfg.engine,
                                                                **small))
    jq, tq = jcfg.queues[0], tcfg.queues[0]
    for f in dataclasses.fields(tq):
        assert getattr(tq, f.name) == getattr(jq, f.name), f.name
    assert tq.team_size == 5 and tq.widen_per_sec == 2.0
    return TpuEngine(jcfg, jq), GpuEngine(tcfg, tq, device="cpu")


def teams_of(outcome):
    return [tuple(tuple(r.id for r in team) for team in m.teams)
            for m in outcome.matches]


def team_stream(rng, n_windows, wildcard_at, t=1_700_000_000.0):
    pid = 0
    for w in range(n_windows):
        rows = []
        # Window 0 spans three chunks of the largest bucket (64).
        for i in range(150 if w == 0 else int(rng.integers(20, 60))):
            rows.append(dict(
                id=f"p{pid}", rating=float(rng.normal(1500, 300)),
                region=str(rng.choice(["eu", "na"])),
                game_mode=str(rng.choice(["ranked", "casual"])),
                enqueued_at=t - float(rng.uniform(0, 20)),
                reply_to=f"r{pid}", correlation_id=f"c{pid}"))
            pid += 1
        if w == wildcard_at:
            rows[0].update(region="*", rating=-9000.0)  # never matches
        yield w, rows, t
        t += 2.5 if w != wildcard_at + 1 else 10.0


def test_engine_equals_tpu_engine_with_delegation_and_repromotion():
    jeng, teng = team_engines()
    rng = np.random.default_rng(5)
    wildcard_at, counters, matched = 3, [], 0
    for w, rows, now in team_stream(rng, 9, wildcard_at):
        if w == wildcard_at + 1:
            # The wildcard leaves; after the 5 s quiet period the next
            # window moves both queues back onto the device.
            wid = next(r.id for r in teng.waiting() if r.region == "*")
            assert teng.remove(wid).id == jeng.remove(wid).id == wid
        jout = jeng.search([JaxRequest(**k) for k in rows], now)
        tout = teng.search([SearchRequest(**k) for k in rows], now)
        assert teams_of(tout) == teams_of(jout), w
        for jm, tm in zip(jout.matches, tout.matches):
            assert tm.quality == pytest.approx(jm.quality, abs=1e-6)
            for team in tm.teams:
                assert len(team) == 5
        assert [r.id for r in tout.queued] == [r.id for r in jout.queued]
        assert teng.pool_size() == jeng.pool_size()
        assert teng.counters == {k: v for k, v in jeng.counters.items()
                                 if k.startswith("team_")}
        counters.append(dict(teng.counters))
        matched += len(tout.matches)
    assert counters[wildcard_at - 1] == {}
    assert counters[wildcard_at] == {"team_delegated": 1}
    assert counters[-1] == {"team_delegated": 1, "team_repromoted": 1}
    assert teng._team_delegate is None and teng.dev_pool is not None
    assert matched >= 15
    assert ({r.id for r in teng.waiting()} == {r.id for r in jeng.waiting()})


def test_rescan_forms_widened_matches_like_tpu_engine():
    """Ten waiting players 150 apart in one group: nobody matches on
    arrival (threshold 120); a rescan 20 s later (thresholds widened to
    160) forms the match on both engines."""
    jeng, teng = team_engines()
    t = 1_700_000_000.0
    rows = [dict(id=f"w{i}", rating=1500.0 + 15.0 * i, region="eu",
                 game_mode="ranked", enqueued_at=t) for i in range(11)]
    rows[-1]["rating"] = 1500.0 + 15.0 * 9 + 1.0  # 151 apart from w0
    assert not jeng.search([JaxRequest(**k) for k in rows], t).matches
    assert not teng.search([SearchRequest(**k) for k in rows], t).matches
    jeng.rescan_async(1024, t + 20.0)
    tt = teng.rescan_async(1024, t + 20.0)
    assert tt in teng.rescan_tokens
    (_, jout), = jeng.flush()
    (tok, tout), = teng.flush()
    assert tok == tt
    assert teams_of(tout) == teams_of(jout) and len(tout.matches) == 1
    assert teng.pool_size() == jeng.pool_size() == 1
    with pytest.raises(ValueError, match="columnar"):
        teng.restore_columns(None, t)


def test_delegation_with_a_window_in_flight_and_on_restore():
    """A wildcard arriving while a device window is in flight: the window
    is finalized first (its outcome kept under its token for the next
    flush), then the queue moves to the oracle with the post-match pool —
    as the JAX engine does. Once the wildcard leaves, the health tick
    moves the idle queue back after the quiet period. A checkpoint holding
    a wildcard delegates at restore."""
    jeng, teng = team_engines()
    t = 1_700_000_000.0
    rows = [dict(id=f"a{i}", rating=1500.0 + i, region="eu",
                 game_mode="ranked", enqueued_at=t) for i in range(13)]
    wild = [dict(id="w", rating=1503.0, region="*", game_mode="ranked",
                 enqueued_at=t)]
    outs = {}
    for name, eng, cls in (("jax", jeng, JaxRequest),
                           ("port", teng, SearchRequest)):
        t1, _ = eng.search_async([cls(**k) for k in rows], t)
        t2, _ = eng.search_async([cls(**k) for k in wild], t + 1.0)
        got = eng.flush()
        assert [tok for tok, _ in got] == [t1, t2]
        outs[name] = [teams_of(o) for _, o in got]
        assert eng.counters["team_delegated"] == 1
        assert sorted(r.id for r in eng.waiting()) == ["a10", "a11", "a12",
                                                        "w"]
    assert outs["port"] == outs["jax"] and len(outs["port"][0]) == 1
    # The wildcard leaves; an idle queue's health tick moves it back.
    assert teng.remove("w").id == jeng.remove("w").id == "w"
    assert not teng.heartbeat(t + 3.0) and not jeng.heartbeat(t + 3.0)
    assert teng.heartbeat(t + 7.0) and jeng.heartbeat(t + 7.0)
    assert teng.counters == {"team_delegated": 1, "team_repromoted": 1}
    assert ({r.id for r in teng.waiting()} == {r.id for r in jeng.waiting()}
            == {"a10", "a11", "a12"})
    _, fresh = team_engines()
    fresh.restore([SearchRequest(**k) for k in rows + wild], t + 2.0)
    assert fresh.counters == {"team_delegated": 1} and fresh.dev_pool is None
    assert fresh.pool_size() == 14
