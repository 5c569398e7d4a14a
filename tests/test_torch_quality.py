"""The port's match-quality accounting against the JAX package's.

- ``engine/quality.py`` (bucket rules, the host accumulator, the report and
  the disparity gaps) and ``service/quality.py`` (the per-tier ledger) are
  copies: on the same seeded inputs their outputs are equal exactly.
- ``cuda_kernels.quality_accum_reference`` (what ``quality_accum`` runs on
  CPU tensors, and the kernel's plain twin) against the JAX step
  ``QualityAccumKernel._accum`` on the same state, pool and window result:
  histograms and counts equal; each f32 sum within 1e-5 of the sum of the
  absolute values of its addends (the state's value and the window's
  samples; the two add the samples in another order). Widening rates are
  powers of two: JAX on the CPU fuses ``thr + widen·waited`` into an FMA,
  and a power-of-two rate makes the product exact, so both round alike.
- The engines (``GpuEngine`` on the CPU, ``TpuEngine`` on JAX's CPU
  backend): the same windows give the same ``quality_report`` counts (and
  means within 1e-5 relative); team and role queues and the host oracle
  equal JAX's reports; a delegated queue keeps its oracle's samples when
  it comes back; a JAX checkpoint restores into the port.
- The service: the ledger gets two samples per 1v1 match, and a revive
  keeps the engine's counters.
"""

import asyncio
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import ObservabilityConfig as JaxObs
from matchmaking_tpu.config import QueueConfig as JaxQueue
from matchmaking_tpu.engine import quality as jax_quality
from matchmaking_tpu.engine.cpu import CpuEngine as JaxCpuEngine
from matchmaking_tpu.engine.kernels import QualityAccumKernel as JaxAccum
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service import quality as jax_ledger
from matchmaking_tpu.service.contract import PartyMember as JaxMember
from matchmaking_tpu.service.contract import RequestColumns as JaxColumns
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    Config,
    EngineConfig,
    ObservabilityConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.engine import cuda_kernels, quality
from matchmaking_tpu_torch.engine.cpu import CpuEngine
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.engine.kernels import QualityAccumKernel
from matchmaking_tpu_torch.service import quality as ledger
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.service.contract import (
    PartyMember,
    RequestColumns,
    SearchRequest,
)

# Small tensors: one intra-op thread each leaves the cores to the other
# test workers (several run side by side).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = {
    "default": {},
    "custom": dict(quality_rating_edges=(1200.0, 1450.5, 1500.0, 1777.25),
                   quality_buckets=7,
                   quality_wait_buckets=(0.5, 1.0, 2.5, 10.0)),
}


def spec_pair(name):
    obs = SPECS[name]
    return (jax_quality.QualitySpec.from_config(JaxObs(**obs)),
            quality.QualitySpec.from_config(ObservabilityConfig(**obs)))


def samples(rng, n):
    return dict(rating=rng.normal(1500, 320, n).astype(np.float32),
                quality=np.clip(rng.uniform(-0.1, 1.1, n), 0, 1)
                .astype(np.float32),
                wait_s=rng.exponential(3.0, n) * (rng.random(n) < 0.9),
                spread=rng.uniform(0, 120, n))


def assert_arrays_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


# ---- engine/quality.py and service/quality.py --------------------------------


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_buckets_equal_jax(name):
    jspec, tspec = spec_pair(name)
    assert tspec == quality.QualitySpec(**dataclasses.asdict(jspec))
    rng = np.random.default_rng(1)
    s = samples(rng, 4000)
    edges = np.asarray(tspec.rating_edges, np.float32)
    s["rating"][:len(edges)] = edges  # ties: an edge opens the next bucket
    for fn, arg in (("rating_bucket", "rating"), ("quality_bucket", "quality"),
                    ("wait_bucket", "wait_s")):
        np.testing.assert_array_equal(getattr(tspec, fn)(s[arg]),
                                      getattr(jspec, fn)(s[arg]))
    assert ([tspec.bucket_label(i) for i in range(tspec.n_rating)]
            == [jspec.bucket_label(i) for i in range(jspec.n_rating)])


@pytest.mark.parametrize("name", list(SPECS))
def test_host_accum_report_and_disparity_equal_jax(name):
    jspec, tspec = spec_pair(name)
    jacc, tacc = jax_quality.HostQualityAccum(jspec), quality.HostQualityAccum(
        tspec)
    rng = np.random.default_rng(2)
    for n in (1, 0, 300, 57, 1000):
        s = samples(rng, n)
        jacc.observe(**s)
        tacc.observe(**s)
        assert_arrays_equal(tacc.arrays, jacc.arrays)
    # Scalars broadcast (a team match: one quality and spread, per-member
    # waits).
    jacc.observe([1400.0, 1500.0, 1600.0], 0.75, [1.0, 2.0, 3.0], 40.0)
    tacc.observe([1400.0, 1500.0, 1600.0], 0.75, [1.0, 2.0, 3.0], 40.0)
    assert_arrays_equal(tacc.arrays, jacc.arrays)
    for min_count in (1, 8, 100):
        assert (quality.build_report(tacc.arrays, tspec, min_count)
                == jax_quality.build_report(jacc.arrays, jspec, min_count))
        assert (quality.disparity(tacc.arrays, tspec, min_count)
                == jax_quality.disparity(jacc.arrays, jspec, min_count))
    for p in (10.0, 50.0, 99.0):
        assert (quality.quality_percentile(tacc.arrays, tspec, p)
                == jax_quality.quality_percentile(jacc.arrays, jspec, p))
        assert (quality.wait_percentile(tacc.arrays, tspec, p, bucket=3)
                == jax_quality.wait_percentile(jacc.arrays, jspec, p, bucket=3))
    empty = quality.empty_arrays(tspec)
    assert (quality.build_report(empty, tspec)
            == jax_quality.build_report(jax_quality.empty_arrays(jspec), jspec))
    merged = quality.add_arrays(quality.empty_arrays(tspec), tacc.arrays)
    quality.add_arrays(merged, None)
    assert_arrays_equal(merged, tacc.arrays)


def test_host_accum_per_match_calls_equal_jax():
    """The host oracle's pattern: one ``observe`` a match (two members,
    one quality and spread, per-member waits; now and then a team's five,
    a negative wait, an empty call), 400 of them: after each, the arrays
    are JAX's bit for bit, float sums included."""
    jspec, tspec = spec_pair("default")
    jacc, tacc = jax_quality.HostQualityAccum(jspec), quality.HostQualityAccum(
        tspec)
    rng = np.random.default_rng(11)
    for k in range(400):
        size = 5 if k % 37 == 0 else 0 if k % 53 == 0 else 2
        call = ([float(x) for x in rng.normal(1500.0, 300.0, size)],
                float(rng.random()),
                [float(x) for x in rng.uniform(-0.5, 40.0, size)],
                float(rng.uniform(0.0, 100.0)))
        jacc.observe(*call)
        tacc.observe(*call)
        assert_arrays_equal(tacc.arrays, jacc.arrays)
    assert int(tacc.arrays["count"].sum()) == int(jacc.arrays["count"].sum())


@pytest.mark.parametrize("target", [0.0, 0.6])
def test_ledger_snapshot_equals_jax(target):
    jspec, tspec = spec_pair("default")
    jl = jax_ledger.QualityLedger(jspec, quality_target=target)
    tl = ledger.QualityLedger(tspec, quality_target=target)
    rng = np.random.default_rng(3)
    for w in range(12):
        n = int(rng.integers(0, 80))
        s = samples(rng, n)
        tiers = rng.integers(0, 3, n) if w % 3 else None
        queue = ("q.a", "q.b")[w % 2]
        jl.observe(queue, s["quality"], s["wait_s"], tiers)
        tl.observe(queue, s["quality"], s["wait_s"], tiers)
    jl.observe("q.a", 0.5, 1.25, 2)
    tl.observe("q.a", 0.5, 1.25, 2)
    assert tl.snapshot() == jl.snapshot()
    assert tl.snapshot("q.b") == jl.snapshot("q.b")
    assert tl.queues() == jl.queues()
    for q in ("q.a", "q.b", "q.none"):
        assert tl.slo_counts(q) == jl.slo_counts(q)


# ---- the accumulator step ----------------------------------------------------

P = 2048


def accum_inputs(rng, b, kind):
    """A post-step pool, a nonzero state and a window result f32[3, b]:
    matched lanes pair two distinct pool slots at their rating distance;
    the rest carry the sentinel slot P and dist +inf."""
    pool = {"rating": rng.normal(1500, 300, P).astype(np.float32),
            "enqueue_t": rng.uniform(0, 30, P).astype(np.float32),
            "threshold": rng.choice([0.0, 50.0, 100.0, 150.0], P,
                                    p=[.05, .3, .35, .3]).astype(np.float32)}
    slots = rng.permutation(P)[:2 * b].astype(np.int32)
    q, c = slots[:b], slots[b:]
    dist = np.abs(pool["rating"][q] - pool["rating"][c]).astype(np.float32)
    hit = rng.random(b) < (0.0 if kind == "padding" else 0.7)
    out = np.stack([np.where(hit, q, P), np.where(hit, c, P),
                    np.where(hit, dist, np.inf)]).astype(np.float32)
    return pool, out


def initial_state(rng, n_r, n_q, n_w):
    return {"q_hist": rng.integers(0, 50, (n_r, n_q)).astype(np.int32),
            "w_hist": rng.integers(0, 50, (n_r, n_w)).astype(np.int32),
            "count": rng.integers(0, 500, n_r).astype(np.int32),
            "q_sum": rng.uniform(0, 300, n_r).astype(np.float32),
            "w_sum": rng.uniform(0, 3000, n_r).astype(np.float32),
            "d_sum": rng.uniform(0, 9000, n_r).astype(np.float32)}


def assert_state_close(got, want, state0):
    for k in ("q_hist", "w_hist", "count"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("q_sum", "w_sum", "d_sum"):
        # Every addend is >= 0: their absolute sum is the state's old value
        # plus the window's samples.
        s0 = np.abs(state0[k].astype(np.float64))
        tol = 1e-5 * (s0 + np.abs(np.asarray(want[k], np.float64) - s0))
        assert (np.abs(np.asarray(got[k], np.float64)
                       - np.asarray(want[k], np.float64)) <= tol).all(), k


@pytest.mark.parametrize("widen", [0.0, 2.0])
@pytest.mark.parametrize("kind,b", [("matches", 256), ("matches", 16),
                                    ("padding", 64)])
@pytest.mark.parametrize("name", list(SPECS))
def test_accumulator_equals_jax_step(name, kind, b, widen):
    jspec, tspec = spec_pair(name)
    kw = dict(capacity=P, widen_per_sec=widen, max_threshold=170.0,
              rating_edges=tspec.rating_edges, n_quality=tspec.n_quality,
              wait_edges=tspec.wait_edges)
    jk, tk = JaxAccum(**kw), QualityAccumKernel(**kw)
    rng = np.random.default_rng({"matches": 4, "padding": 5}[kind] + b)
    pool, out = accum_inputs(rng, b, kind)
    state0 = initial_state(rng, tk.n_rating, tk.n_quality, tk.n_wait)
    now = 31.5
    want = jk.accum({k: np.asarray(v) for k, v in state0.items()},
                    pool["rating"], pool["enqueue_t"], pool["threshold"],
                    out, now)
    want = {k: np.asarray(v) for k, v in want.items()}
    # The port's accumulator, in place on a state laid out as the engine's.
    state = tk.init_state("cpu")
    for k, v in state0.items():
        state[k].copy_(torch.from_numpy(v))
    tpool = {k: torch.from_numpy(v) for k, v in pool.items()}
    before = cuda_kernels.LAUNCHES["quality_accum"]
    tk.accum(state, tpool, torch.from_numpy(out), now)
    assert cuda_kernels.LAUNCHES["quality_accum"] == before  # CPU: no launch
    got = tk.arrays(state.flat.numpy())
    assert_state_close(got, want, state0)
    added = int(got["count"].sum() - state0["count"].sum())
    assert added == 2 * int((out[0] < P).sum())
    if kind == "padding":
        assert_arrays_equal(got, state0)


def test_accumulator_sanitizes_sentinel_distance_and_zero_limits():
    """Unmatched lanes carry dist +inf: no NaN may reach a sum; a pair
    whose limit is 0 scores quality 0."""
    tk = QualityAccumKernel(capacity=8, widen_per_sec=0.0, max_threshold=0.0,
                            rating_edges=(1500.0,), n_quality=4,
                            wait_edges=(1.0,))
    state = tk.init_state("cpu")
    pool = {"rating": torch.tensor([1400.0, 1600.0] + [1500.0] * 6),
            "enqueue_t": torch.zeros(8),
            "threshold": torch.tensor([0.0, 80.0] + [100.0] * 6)}
    out = torch.tensor([[0.0, 8.0, 2.0], [1.0, 8.0, 3.0],
                        [200.0, float("inf"), 0.0]])
    tk.accum(state, pool, out, 5.0)
    got = tk.arrays(state.flat.numpy())
    assert np.isfinite(got["d_sum"]).all() and np.isfinite(got["q_sum"]).all()
    assert got["count"].tolist() == [1, 3]
    # Lane 0: limit min(0, 80) = 0 → quality 0 (bucket 0) on both sides;
    # lane 2: d 0 → quality 1 (the top bucket).
    assert got["q_hist"].tolist() == [[1, 0, 0, 0], [1, 0, 0, 2]]
    assert got["w_hist"].tolist() == [[0, 1], [0, 3]]
    np.testing.assert_allclose(got["d_sum"], [200.0, 200.0])


def test_accumulator_refuses_bad_state():
    tk = QualityAccumKernel(capacity=8, widen_per_sec=0.0, max_threshold=0.0,
                            rating_edges=(1500.0,), n_quality=4,
                            wait_edges=(1.0,))
    state = tk.init_state("cpu")
    pool = {k: torch.zeros(8) for k in ("rating", "enqueue_t", "threshold")}
    with pytest.raises(ValueError, match="q_hist"):
        tk.accum(dict(state, q_hist=torch.zeros(2, 5, dtype=torch.int32)),
                 pool, torch.zeros(3, 4), 0.0)
    with pytest.raises(ValueError, match="out"):
        tk.accum(state, pool, torch.zeros(2, 4), 0.0)


def test_accumulator_binds_once_and_checks_tensors_it_was_not_handed():
    """The launch is bound to a state and a pool's columns: the same
    tensors again reuse it (no checks); a new pool (as revive, restore and
    re-promotion build) is checked again, so a wrong-shaped column handed
    in later raises."""
    tk = QualityAccumKernel(capacity=8, widen_per_sec=0.0, max_threshold=0.0,
                            rating_edges=(1500.0,), n_quality=4,
                            wait_edges=(1.0,))
    state = tk.init_state("cpu")
    pool = {k: torch.zeros(8) for k in ("rating", "enqueue_t", "threshold")}
    out = torch.tensor([[0.0], [1.0], [5.0]])
    tk.accum(state, pool, out, 2.0)
    bound = tk._bound
    tk.accum(state, pool, out, 2.0)
    assert tk._bound is bound
    fresh = {k: torch.zeros(8) for k in pool}
    tk.accum(state, fresh, out, 2.0)
    assert tk._bound is not bound and tk._bound.columns[0] is fresh["rating"]
    with pytest.raises(ValueError, match="rating"):
        tk.accum(state, dict(fresh, rating=torch.zeros(9)), out, 2.0)
    assert int(state["count"].sum()) == 6


def test_engine_folds_each_window_at_its_packed_now_row():
    """The engine hands the accumulator the packed window's ``now`` row (a
    tensor: on the card the kernel reads it on the device), never a host
    float; its state equals the plain version fed each window's host
    ``now`` float at the same moment."""
    _, teng = engine_pair()
    real = teng._quality.accum
    shadow = teng._quality.init_state("cpu")
    seen = []

    def spy(state, pool, out, now):
        assert isinstance(now, torch.Tensor) and now.dim() == 1
        assert now.shape[0] == out.shape[1] and bool((now == now[0]).all())
        seen.append(float(now[0]))
        cuda_kernels.quality_accum_reference(
            shadow, pool["rating"], pool["enqueue_t"], pool["threshold"],
            out, float(np.float32(teng._t0_now - teng._t0)),
            widen_per_sec=teng._quality.widen_per_sec,
            max_threshold=teng._quality.max_threshold,
            rating_edges=teng._quality.rating_edges,
            n_quality=teng._quality.n_quality,
            wait_edges=teng._quality.wait_edges)
        real(state, pool, out, now)

    teng._quality.accum = spy
    rng = np.random.default_rng(9)
    for k in range(4):
        now = 200.0 + 0.37 * k
        teng._t0_now = now
        ids = [f"p{k}_{i}" for i in range(64)]
        ratings = rng.normal(1500.0, 220.0, 64).astype(np.float32)
        teng.search_columns_async(columns(RequestColumns, teng, ids, ratings,
                                          now - rng.uniform(0.05, 8.0, 64)),
                                  now)
        teng.flush()
    assert seen == [float(np.float32(200.0 + 0.37 * k - teng._t0))
                    for k in range(4)]
    assert int(shadow["count"].sum()) > 0
    assert torch.equal(teng._q_dev.flat, shadow.flat)


# ---- engines -----------------------------------------------------------------


def engine_pair(capacity=1024, **obs):
    kw = dict(pool_capacity=capacity, pool_block=min(256, capacity),
              batch_buckets=(16, 64, 256), pipeline_depth=2)
    jcfg = JaxConfig(queues=(JaxQueue(rating_threshold=100.0),),
                     engine=JaxEngineConfig(backend="tpu", **kw),
                     observability=JaxObs(**obs))
    tcfg = Config(queues=(QueueConfig(rating_threshold=100.0),),
                  engine=EngineConfig(**kw),
                  observability=ObservabilityConfig(**obs))
    return (TpuEngine(jcfg, jcfg.queues[0]),
            GpuEngine(tcfg, tcfg.queues[0], device="cpu"))


def columns(cls, eng, ids, ratings, enq):
    n = len(ids)
    reg, mode = eng.intern_columns(["*"] * n, ["*"] * n)
    return cls(ids=np.asarray(ids, object),
               rating=np.asarray(ratings, np.float32),
               rd=np.zeros(n, np.float32), region=reg, mode=mode,
               threshold=np.full(n, np.nan, np.float32),
               enqueued_at=np.asarray(enq, np.float64),
               reply_to=np.asarray([""] * n, object),
               correlation_id=np.asarray([""] * n, object))


def host_recompute(spec, outs, rating_of):
    acc = quality.HostQualityAccum(spec)
    for out in outs:
        acc.observe(
            rating=np.asarray([rating_of[i] for i in out.m_id_a.tolist()]
                              + [rating_of[i] for i in out.m_id_b.tolist()],
                              np.float32),
            quality=np.concatenate([out.m_quality, out.m_quality]),
            wait_s=np.concatenate([out.m_wait_a, out.m_wait_b]),
            spread=np.concatenate([out.m_dist, out.m_dist]))
    return acc.arrays


@pytest.mark.parametrize("report_every", [16, 1])
def test_engine_report_equals_tpu_engine_and_reconciles(report_every):
    """Six columnar windows and a rescan (the JAX package's own
    reconciliation recipe) through both engines: the same sample counts,
    per rating bucket too, and means within 1e-5 relative; the port's
    report equals a host recomputation from its own outcomes in every
    count."""
    jeng, teng = engine_pair(quality_report_every=report_every)
    rng = np.random.default_rng(7)
    rating_of, touts, n_matches = {}, [], 0
    for k in range(6):
        now = 100.0 + 0.25 * k
        ratings = rng.normal(1500.0, 220.0, 64).astype(np.float32)
        ids = [f"p{k}_{i}" for i in range(64)]
        rating_of.update(zip(ids, ratings.tolist()))
        enq = now - rng.uniform(0.05, 8.0, 64)
        jeng.search_columns_async(columns(JaxColumns, jeng, ids, ratings, enq),
                                  now)
        teng.search_columns_async(columns(RequestColumns, teng, ids, ratings,
                                          enq), now)
        jeng.flush()
        for _, out in teng.flush():
            touts.append(out)
            n_matches += out.n_matches
    # A rescan: its matches are real matches and land in the state too.
    jeng.rescan_async(512, 130.0)
    teng.rescan_async(512, 130.0)
    jeng.flush()
    for _, out in teng.flush():
        touts.append(out)
        n_matches += out.n_matches
    jrep, trep = jeng.quality_report(), teng.quality_report()
    assert n_matches > 30
    assert trep["samples"] == jrep["samples"] == 2 * n_matches
    assert ([b["count"] for b in trep["buckets"]]
            == [b["count"] for b in jrep["buckets"]])
    for key in ("quality_mean", "wait_mean_s", "spread_mean"):
        assert trep[key] == pytest.approx(jrep[key], rel=1e-5), key
    host = host_recompute(teng._q_spec, touts, rating_of)
    dev = teng.quality_checkpoint()
    np.testing.assert_array_equal(dev["count"], host["count"])
    assert dev["q_hist"].sum() == dev["w_hist"].sum() == host["count"].sum()


def test_engine_report_is_read_behind_finalize_without_flush():
    """Between flushes the report is the last state read back: taken at a
    finalize once its copy has landed (on the CPU, at the next finalize),
    never more than ``quality_report_every`` windows behind."""
    _, teng = engine_pair(quality_report_every=2)
    rng = np.random.default_rng(8)
    samples_seen = []
    for k in range(6):
        ids = [f"p{k}_{i}" for i in range(64)]
        ratings = rng.normal(1500.0, 50.0, 64)
        teng.search_columns_async(columns(RequestColumns, teng, ids, ratings,
                                          np.full(64, 99.0)), 100.0 + k)
        while teng.inflight():
            teng.collect_ready()
        samples_seen.append(teng.quality_report()["samples"])
    assert samples_seen[0] == 0  # the first copy lands at a later finalize
    assert samples_seen == sorted(samples_seen) and samples_seen[-1] > 0
    teng.flush()
    final = teng.quality_report()["samples"]
    assert final >= samples_seen[-1] and final == 2 * teng.spans["matches"]


def test_team_queue_report_equals_tpu_engine():
    """A 2v2 team queue has no device accumulator: one host sample per
    member at finalize, the JAX engine's own."""
    kw = dict(pool_capacity=256, pool_block=64, batch_buckets=(16,),
              pipeline_depth=2)
    jcfg = JaxConfig(queues=(JaxQueue(team_size=2, rating_threshold=200.0),),
                     engine=JaxEngineConfig(backend="tpu", **kw))
    tcfg = Config(queues=(QueueConfig(team_size=2, rating_threshold=200.0),),
                  engine=EngineConfig(**kw))
    jeng = TpuEngine(jcfg, jcfg.queues[0])
    teng = GpuEngine(tcfg, tcfg.queues[0], device="cpu")
    assert teng._quality is None
    now = 50.0
    rng = np.random.default_rng(9)
    for w in range(3):
        rows = [dict(id=f"t{w}_{i}", rating=float(1500.0 + rng.normal(0, 40)),
                     enqueued_at=now - float(rng.uniform(0, 3)))
                for i in range(8)]
        jeng.search_async([JaxRequest(**r) for r in rows], now)
        teng.search_async([SearchRequest(**r) for r in rows], now)
        jeng.flush()
        teng.flush()
        now += 1.0
    jrep, trep = jeng.quality_report(), teng.quality_report()
    assert trep == jrep
    assert trep["samples"] == 4 * teng.spans["matches"] > 0


def test_oracle_report_equals_jax_oracle():
    q = dict(rating_threshold=100.0)
    jeng = JaxCpuEngine(JaxConfig(), JaxQueue(**q))
    teng = CpuEngine(Config(), QueueConfig(**q))
    rng = np.random.default_rng(10)
    now = 10.0
    for w in range(6):
        rows = [dict(id=f"o{w}_{i}", rating=float(rng.normal(1500, 80)),
                     enqueued_at=now - float(rng.uniform(0, 4)))
                for i in range(20)]
        jeng.search([JaxRequest(**r) for r in rows], now)
        teng.search([SearchRequest(**r) for r in rows], now)
        now += 1.5
    assert teng.quality_report() == jeng.quality_report()
    assert teng.quality_report()["samples"] > 20
    assert_arrays_equal(teng.quality_checkpoint(), jeng.quality_checkpoint())
    # The JAX test's two-player case, value by value.
    one = CpuEngine(Config(), QueueConfig(**q))
    out = one.search([SearchRequest(id="a", rating=1500.0, enqueued_at=8.0),
                      SearchRequest(id="b", rating=1530.0, enqueued_at=6.0)],
                     10.0)
    rep = one.quality_report()
    assert rep["samples"] == 2
    assert rep["quality_mean"] == pytest.approx(out.matches[0].quality, abs=1e-6)
    assert rep["wait_mean_s"] == pytest.approx(3.0, abs=1e-6)
    assert rep["spread_mean"] == pytest.approx(30.0, abs=1e-4)


def role_engines():
    path = os.path.join(ROOT, "configs/role_party.json")
    small = dict(pool_capacity=256, pool_block=64, batch_buckets=(16, 64),
                 team_max_matches=32)
    jcfg = JaxConfig.from_json(path)
    tcfg = Config.from_json(path, backend="gpu")
    jcfg = dataclasses.replace(jcfg, engine=dataclasses.replace(jcfg.engine,
                                                                **small))
    tcfg = dataclasses.replace(tcfg, engine=dataclasses.replace(tcfg.engine,
                                                                **small))
    return (TpuEngine(jcfg, jcfg.queues[0]),
            GpuEngine(tcfg, tcfg.queues[0], device="cpu"))


def test_delegated_role_queue_keeps_its_oracle_samples():
    """A party hands the role queue to the host oracle; its matches count,
    and after the re-promotion they are still in the report, which equals
    the JAX engine's at every window."""
    jeng, teng = role_engines()
    rng = np.random.default_rng(11)
    t, pid, party_at, reports = 1_700_000_000.0, 0, 2, []
    for w in range(6):
        rows = []
        for _ in range(int(rng.integers(15, 40))):
            rows.append(dict(
                id=f"p{pid}", rating=float(rng.normal(1500, 150)),
                region="eu", game_mode=str(rng.choice(["ranked", "casual"])),
                roles=tuple(rng.choice(["tank", "healer", "dps"],
                                       int(rng.choice([0, 1, 1, 2])),
                                       replace=False)),
                enqueued_at=t - float(rng.uniform(0, 10))))
            pid += 1
        jreqs = [JaxRequest(**k) for k in rows]
        treqs = [SearchRequest(**k) for k in rows]
        if w == party_at:
            lead = dict(id="party", rating=-5000.0, region="eu",
                        game_mode="ranked", roles=("tank",), enqueued_at=t)
            jreqs.append(JaxRequest(**lead, party=(
                JaxMember("party2", -5000.0, roles=("dps",)),)))
            treqs.append(SearchRequest(**lead, party=(
                PartyMember("party2", -5000.0, roles=("dps",)),)))
        if w == party_at + 1:
            assert teng.remove("party").id == jeng.remove("party").id
            t += 10.0  # past the quiet period: back on the device
        jeng.search(jreqs, t)
        teng.search(treqs, t)
        trep = teng.quality_report()
        assert trep == jeng.quality_report(), w
        reports.append((dict(teng.counters), trep["samples"]))
        t += 3.0
    delegated = reports[party_at]
    assert delegated[0] == {"team_delegated": 1} and delegated[1] > 0
    assert reports[party_at + 1][0] == {"team_delegated": 1,
                                        "team_repromoted": 1}
    assert [s for _, s in reports] == sorted(s for _, s in reports)


def test_jax_checkpoint_restores_into_the_port():
    jeng, _ = engine_pair()
    rng = np.random.default_rng(12)
    for k in range(3):
        ids = [f"c{k}_{i}" for i in range(64)]
        jeng.search_columns_async(columns(
            JaxColumns, jeng, ids, rng.normal(1500, 100, 64),
            np.full(64, 95.0)), 100.0 + k)
        jeng.flush()
    arrays = {k: np.asarray(v) for k, v in jeng.quality_checkpoint().items()}
    _, teng = engine_pair()
    teng.quality_restore(arrays)
    teng.quality_restore(None)
    assert teng.quality_report() == jeng.quality_report()
    assert teng.quality_report()["samples"] > 0


# ---- the service -------------------------------------------------------------


def publish(app, reply_to, player):
    app.broker.declare_queue(reply_to)
    app.broker.publish(app.queue_cfg.name, json.dumps(player).encode(),
                       Properties(reply_to=reply_to,
                                  correlation_id=player["id"]))


async def wait_for(cond, seconds=10.0):
    end = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < end, "condition not reached in time"
        await asyncio.sleep(0.01)


async def test_service_ledger_counts_every_matched_player_across_a_revive():
    """Under the port's sanitizer, every check on, as the JAX twin
    (tests/test_quality.py's chaos crash revive) runs under JAX's."""
    from test_torch_sanitizer import port_sanitized

    with port_sanitized():
        await _ledger_across_a_revive()


async def _ledger_across_a_revive():
    cfg = Config(engine=EngineConfig(pool_capacity=1024, pool_block=256,
                                     batch_buckets=(16, 64)),
                 queues=(QueueConfig(),),
                 observability=ObservabilityConfig(quality_slo_target=0.5))
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    try:
        rng = np.random.default_rng(13)
        for i in range(40):
            publish(app, "rq", {"id": f"s{i}",
                                "rating": float(rng.normal(1500, 60))})
        await wait_for(lambda: app.counters["requests"] == 40)
        await wait_for(lambda: app.engine.inflight() == 0)
        matched = app.counters["players_matched"]
        snap = app.quality.snapshot()["queues"][app.queue_cfg.name]
        assert matched > 0
        assert snap["matched_players"] == matched
        assert sum(t["count"] for t in snap["tiers"].values()) == matched
        assert snap["quality_slo"]["total"] == matched
        before = app.engine.quality_checkpoint()
        assert int(before["count"].sum()) == matched
        # A failed window (two players too far apart to match) revives the
        # engine: its counters carry over.
        old = app.engine
        real = old._fetch

        def failing(pending):
            pending.error = RuntimeError("CUDA error: injected")
            old._fetch = real

        old._fetch = failing
        publish(app, "rq", {"id": "far0", "rating": 9000.0})
        publish(app, "rq", {"id": "far1", "rating": -9000.0})
        await wait_for(lambda: app.counters["revives"] == 1)
        assert app.engine is not old
        after = app.engine.quality_report()["samples"]
        assert after == int(before["count"].sum())
        # The revived engine adds to them.
        publish(app, "rq", {"id": "near", "rating": 9000.5})
        await wait_for(lambda: app.counters["players_matched"] == matched + 2)
        await wait_for(lambda: app.engine.inflight() == 0)
        assert app.engine.quality_checkpoint()["count"].sum() == after + 2
        assert (app.quality.snapshot()["queues"][app.queue_cfg.name]
                ["matched_players"] == matched + 2)
    finally:
        await app.stop()


async def test_service_ledger_counts_every_team_member():
    """A 5v5 queue's object path: the ledger gets one sample per member of
    every published match (one observe per window), and the engine's host
    accumulator holds the same samples.

    The 40 requests are one window, cut by count (``max_batch`` 40, no
    time cut), so the grouping of the sums does not depend on timing. The
    qualities still do (the threshold widens with the wait), and both
    sides round their mean to 6 decimals, so two means a few 1e-8 apart
    can round 1e-6 apart: the means are compared unrounded, from the
    ledger's sum and the accumulator's."""
    cfg = Config.from_json(os.path.join(ROOT, "configs/team_5v5.json"),
                           backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, pool_capacity=256, batch_buckets=(16, 64),
        team_max_matches=32),
        batcher=BatcherConfig(max_batch=40, max_wait_ms=600_000.0))
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    try:
        for i in range(40):
            publish(app, "rq.team", {"id": f"t{i}", "rating": 1500 + 3 * i,
                                     "region": "eu", "game_mode": "ranked"})
        await wait_for(lambda: app.counters["players_matched"] == 40)
        assert app.counters["windows"] == 1
        snap = app.quality.snapshot()["queues"][app.queue_cfg.name]
        assert snap["matched_players"] == 40
        assert sum(t["count"] for t in snap["tiers"].values()) == 40
        rep = app.engine.quality_report()
        assert rep["samples"] == 40
        tier = snap["tiers"]["0"]
        assert tier["quality_mean"] is not None and rep["quality_mean"]
        accum = app.engine.quality_checkpoint()
        assert tier["quality_sum"] / tier["count"] == pytest.approx(
            float(accum["q_sum"].sum()) / int(accum["count"].sum()),
            abs=1e-6)
    finally:
        await app.stop()
