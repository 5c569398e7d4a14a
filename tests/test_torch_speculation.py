"""Speculative formation of the port against the JAX package's.

The JAX package's ``TestCommitEqualsRescan``, ``TestInvalidation`` and
``TestTokenDiscipline`` cases, run against ``GpuEngine(device="cpu")``
(the flat and the bucketed rescan family), with the committed streams
also held to the JAX engine's; the seeded soak (speculation on equals
speculation off in the port, and the JAX engine's stream with speculation
on, op for op); and the service's speculation loop. The JAX soak's drain
and restore go through its checkpoint file; the port's through
``waiting_columns`` and ``restore_columns`` into a fresh engine, in the
same order (the journal drain is not ported yet).
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueue
from matchmaking_tpu.engine.interface import make_engine as jax_make_engine
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu.utils.checkpoint import load_pool, save_pool
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.engine.cpu import CpuEngine
from matchmaking_tpu_torch.engine.interface import make_engine
from matchmaking_tpu_torch.engine.kernels import pool_to_numpy
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.client import MatchmakingClient
from matchmaking_tpu_torch.service.contract import SearchRequest

torch.set_num_threads(1)

#: Engine geometry of each rescan family: the flat (dense) rescan, and the
#: bucketed rescan over spans (four blocks of 64, gaussian bands).
FAMILIES = {
    "flat": dict(pool_capacity=64, pool_block=64, batch_buckets=(16,)),
    "bucketed": dict(pool_capacity=256, pool_block=64, batch_buckets=(16,),
                     bucketed=True, prune_window_blocks=2, prune_chunk=8,
                     band_spec="gaussian:1200:300"),
}


def _q(cls=QueueConfig, **kw):
    return cls(rating_threshold=10.0, widen_per_sec=10.0, max_threshold=200.0,
               **kw)


def _cfg(q, family="flat", jax=False, **ekw):
    ekw.setdefault("spec_formation", True)
    ekw.setdefault("spec_max_steps", 1)
    if jax:
        return JaxConfig(queues=(q,), engine=JaxEngineConfig(
            backend="tpu", **FAMILIES[family], **ekw))
    return Config(queues=(q,), engine=EngineConfig(**FAMILIES[family], **ekw))


def _engine(family="flat", queue_kw=None, **ekw):
    q = _q(**(queue_kw or {}))
    return make_engine(_cfg(q, family, **ekw), q, device="cpu")


def _jax_engine(family="flat", queue_kw=None, **ekw):
    q = _q(JaxQueue, **(queue_kw or {}))
    return jax_make_engine(_cfg(q, family, jax=True, **ekw), q)


def _req(i, rating, t=0.0, cls=SearchRequest):
    return cls(id=f"p{i}", rating=float(rating), enqueued_at=t,
               reply_to=f"rq.p{i}")


def _matches(outs):
    """The ordered match stream of flush() outputs: (id_a, id_b, quality)
    per match, in token order."""
    stream = []
    for _tok, out in outs:
        if hasattr(out, "m_id_a"):
            for j in range(out.n_matches):
                a, b = sorted((out.m_id_a[j], out.m_id_b[j]))
                stream.append((a, b, float(out.m_quality[j])))
        else:
            for m in out.matches:
                ids = tuple(sorted(r.id for t in m.teams for r in t))
                stream.append(ids + (None,))
    return stream


def _live_pool(eng):
    if hasattr(eng, "dev_pool"):
        return pool_to_numpy(eng.dev_pool)
    return {k: np.asarray(v) for k, v in eng._dev_pool.items()}


def _assert_pools_equal(a, b):
    pa, pb = _live_pool(a), _live_pool(b)
    assert set(pa) == set(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


# ---- commit-path bit-exactness ---------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
class TestCommitEqualsRescan:
    def test_single_step_commit_equals_cold_rescan(self, family):
        spec, cold = _engine(family), _engine(family)
        jspec = _jax_engine(family)
        reqs = [(0, 1500.0), (1, 1540.0), (2, 1800.0)]
        spec.restore([_req(i, r) for i, r in reqs], 0.0)
        cold.restore([_req(i, r) for i, r in reqs], 0.0)
        jspec.restore([_req(i, r, cls=JaxRequest) for i, r in reqs], 0.0)

        for e in (spec, jspec):
            assert e.speculate(4.0)
            tok = e.spec_validate(4.0)
            assert tok is not None
            assert e.spec_commit(tok, 4.0) is not None
        cold.rescan_async(16, now=4.0)

        s_stream, c_stream = _matches(spec.flush()), _matches(cold.flush())
        assert s_stream == c_stream == _matches(jspec.flush())
        assert s_stream and s_stream[0][:2] == ("p0", "p1")
        assert spec.pool_size() == cold.pool_size() == 1
        _assert_pools_equal(spec, cold)
        _assert_pools_equal(spec, jspec)
        r = spec.spec_report()
        assert r["spec_hit"] == 1 and r["spec_miss"] == 0
        assert r == jspec.spec_report()
        assert spec.quality_report() == cold.quality_report()
        assert spec.util_report()["spec_commit_share"] == 1.0

    def test_chained_steps_commit_equals_repeated_rescan(self, family):
        """spec_max_steps=2 chains two passes over the snapshot lanes: a
        commit equals two rescan ticks at the same time."""
        rng = np.random.default_rng(7)
        spec = _engine(family, spec_max_steps=2)
        jspec = _jax_engine(family, spec_max_steps=2)
        cold = _engine(family)
        ratings = [1000.0 + float(rng.integers(0, 400)) for _ in range(12)]
        spec.restore([_req(i, r) for i, r in enumerate(ratings)], 0.0)
        cold.restore([_req(i, r) for i, r in enumerate(ratings)], 0.0)
        jspec.restore([_req(i, r, cls=JaxRequest)
                       for i, r in enumerate(ratings)], 0.0)
        for e in (spec, jspec):
            assert e.speculate(6.0)
            e.spec_commit(e.spec_validate(6.0), 6.0)
        cold.rescan_async(16, now=6.0)
        want = _matches(cold.flush())
        cold.rescan_async(16, now=6.0)
        want += _matches(cold.flush())
        got = _matches(spec.flush())
        assert got == want == _matches(jspec.flush())
        assert spec.pool_size() == cold.pool_size()
        _assert_pools_equal(spec, cold)
        assert spec.spec_report()["spec_committed_steps"] == 2

    def test_fallback_is_bit_exact_full_step(self, family):
        """A discarded speculation leaves the live pool untouched: the full
        step after it equals that of an engine that never speculated."""
        spec = _engine(family)
        plain = _engine(family, spec_formation=False)
        reqs = [_req(0, 1500.0), _req(1, 1540.0)]
        spec.restore(reqs, 0.0)
        plain.restore(reqs, 0.0)
        before = _live_pool(spec)
        assert spec.speculate(4.0)
        after = _live_pool(spec)
        for k in before:
            np.testing.assert_array_equal(before[k], after[k], err_msg=k)
        spec.spec_invalidate("test")
        spec.rescan_async(16, now=4.0)
        plain.rescan_async(16, now=4.0)
        assert _matches(spec.flush()) == _matches(plain.flush())
        assert spec.spec_report()["spec_wasted"] == 1
        assert plain.speculate(4.0) is False
        _assert_pools_equal(spec, plain)


# ---- invalidation paths -----------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
class TestInvalidation:
    def _speculating(self, family, **ekw):
        eng = _engine(family, queue_kw=dict(request_timeout_s=30.0), **ekw)
        # Stamped at 1.0 (0.0 means unstamped and never expires); 400 apart
        # > max_threshold 200, so both stay waiting.
        eng.restore([_req(0, 1500.0, 1.0), _req(1, 1900.0, 1.0)], 1.0)
        assert eng.speculate(1.0)
        return eng

    def test_admit_delta_invalidates(self, family):
        eng = self._speculating(family)
        eng.search_async([_req(9, 5000.0)], 1.5)
        assert eng.spec_validate(2.0) is None
        assert eng.spec_report()["spec_wasted"] == 1
        eng.flush()

    def test_columnar_admit_invalidates(self, family):
        eng = self._speculating(family)
        src = _engine(family)
        src.restore([_req(9, 5000.0, 1.0)], 1.0)
        cols, regions, modes = src.waiting_columns()
        reg, mode = eng.intern_columns(list(regions), list(modes))
        eng.search_columns_async(dataclasses.replace(cols, region=reg,
                                                     mode=mode), 1.5)
        assert eng.spec_validate(2.0) is None
        eng.flush()

    def test_expiry_invalidates_but_zero_effect_sweep_does_not(self, family):
        eng = self._speculating(family)
        assert eng.expire(5.0, timeout=30.0) == []
        assert eng.spec_validate(5.0) is not None
        assert eng.speculate(5.0)  # still held
        assert len(eng.expire(40.0, timeout=30.0)) == 2
        assert eng.spec_validate(40.0) is None
        assert eng.spec_report()["spec_wasted"] == 1

    def test_deadline_sweep_zero_effect_preserves_speculation(self, family):
        eng = self._speculating(family)
        assert eng.expire_deadlines(5.0) == []
        assert eng.spec_validate(5.0) is not None

    def test_dedup_only_admission_preserves_speculation(self, family):
        eng = self._speculating(family)
        eng.restore([_req(0, 1500.0)], 1.5)  # a pure dedupe hit
        assert eng.spec_validate(2.0) is not None

    def test_dedup_mixed_with_fresh_invalidates(self, family):
        eng = self._speculating(family)
        eng.restore([_req(0, 1500.0), _req(9, 5000.0)], 1.5)
        assert eng.spec_validate(2.0) is None
        assert eng.spec_report()["spec_wasted"] == 1

    def test_mid_gap_removal_invalidates(self, family):
        eng = self._speculating(family)
        assert eng.remove("p0") is not None
        assert eng.spec_validate(2.0) is None
        assert eng.spec_report()["spec_wasted"] == 1

    def test_removal_of_absent_player_preserves_speculation(self, family):
        eng = self._speculating(family)
        assert eng.remove("ghost") is None
        assert eng.spec_validate(2.0) is not None

    def test_restore_invalidates(self, family):
        eng = self._speculating(family)
        eng.restore([_req(7, 2500.0)], 1.5)
        assert eng.spec_validate(2.0) is None

    def test_staleness_bound_misses(self, family):
        eng = self._speculating(family)
        assert eng.spec_validate(1.2, max_age_s=0.5) is not None
        assert eng.speculate(1.2)  # the same speculation
        assert eng.spec_validate(9.0, max_age_s=0.5) is None
        assert eng.spec_report()["spec_miss"] == 1

    def test_heartbeat_and_warmup_invalidate(self, family):
        eng = self._speculating(family)
        eng.heartbeat(2.0)
        if family == "bucketed":  # the index rebuild changes the pool
            assert eng.spec_validate(2.0) is None
        else:
            assert eng.spec_validate(2.0) is not None
        assert eng.speculate(2.0)
        eng.warmup()
        assert eng.spec_validate(2.0) is None


# ---- validation-token discipline --------------------------------------------


class TestTokenDiscipline:
    def test_commit_without_validate_raises(self):
        eng = _engine()
        eng.restore([_req(0, 1500.0), _req(1, 1540.0)], 0.0)
        assert eng.speculate(4.0)
        with pytest.raises(RuntimeError, match="not freshly validated"):
            eng.spec_commit(eng.pool_mutations, 4.0)

    def test_validate_after_mutate_raises_on_commit(self):
        eng = _engine()
        eng.restore([_req(0, 1500.0), _req(1, 1540.0)], 0.0)
        assert eng.speculate(4.0)
        tok = eng.spec_validate(4.0)
        assert tok is not None
        eng.search_async([_req(9, 5000.0)], 4.5)
        with pytest.raises(RuntimeError, match="discarded speculation"):
            eng.spec_commit(tok, 5.0)
        eng.flush()

    def test_commit_none_token_is_noop(self):
        assert _engine().spec_commit(None, 1.0) is None

    def test_cpu_oracle_keeps_default_noop_seam(self):
        """The host oracle inherits the Engine seam's no-ops."""
        q = _q()
        cpu = CpuEngine(_cfg(q), q)
        assert cpu.speculate(1.0) is False
        assert cpu.spec_validate(1.0) is None
        assert cpu.spec_commit(None, 1.0) is None
        cpu.spec_invalidate("noop")
        assert cpu.spec_report() is None

    def test_off_team_and_tiny_pools_do_not_speculate(self):
        assert _engine(spec_formation=False).speculate(1.0) is False
        eng = _engine()
        assert eng.speculate(1.0) is False  # an empty pool
        eng.restore([_req(0, 1500.0)], 0.0)
        assert eng.speculate(1.0) is False  # one player
        team_q = QueueConfig(team_size=5)
        team = make_engine(_cfg(team_q), team_q, device="cpu")
        assert team.speculate(1.0) is False and team.spec_report() is None


# ---- the seeded soak ----------------------------------------------------------


def _soak_trace(seed: int, rounds: int = 14):
    """The JAX package's soak schedule: admits, redeliveries, removals and
    expiry sweeps, a gap and a cut per round, and one drain and restore
    mid-soak."""
    rng = np.random.default_rng(seed)
    ops, pid, admitted = [], 0, []
    for rnd in range(rounds):
        base = 50.0 * rnd
        admits = []
        for _ in range(int(rng.integers(1, 4))):
            admits.append((f"s{pid}", float(rng.integers(0, 30) * 500
                                             + rng.integers(0, 120)),
                           base + 1.0))
            pid += 1
        admitted += [a[0] for a in admits]
        ops.append(("admit", base + 1.0, admits))
        if rng.random() < 0.4:
            ops.append(("dup", base + 2.0,
                        admitted[int(rng.integers(0, len(admitted)))]))
        if rng.random() < 0.3:
            ops.append(("remove", base + 3.0,
                        admitted[int(rng.integers(0, len(admitted)))]))
        if rng.random() < 0.35:
            ops.append(("expire", base + 4.0))
        ops.append(("gap", base + 6.0))
        if rng.random() < 0.3:
            ops.append(("admit", base + 7.0,
                        [(f"s{pid}", float(rng.integers(0, 30) * 500),
                          base + 7.0)]))
            admitted.append(f"s{pid}")
            pid += 1
        ops.append(("cut", base + 9.0))
        if rnd == rounds // 2:
            ops.append(("drain_restore", base + 9.5))
    return ops


_SOAK_TIMEOUT = 120.0


def _run_soak(ops, tmp_path, spec_on, commit_log, *, jax=False,
              family="flat"):
    """Drive one engine through the soak. With speculation on: speculate
    at each gap, commit or discard at each cut, and log the commits' gap
    times; off: replay the logged commits as cold rescans at those times.
    The drain and restore: the JAX engine through its checkpoint file, the
    port's through ``waiting_columns`` into a fresh engine."""
    kw = dict(queue_kw=dict(request_timeout_s=_SOAK_TIMEOUT),
              spec_formation=spec_on)
    build = (lambda: _jax_engine(family, **kw)) if jax else (
        lambda: _engine(family, **kw))
    cls = JaxRequest if jax else SearchRequest
    eng = build()
    stream, expired_log, removed_log = [], [], []
    gap_t = None
    commits = iter(() if spec_on else commit_log)
    next_commit = next(commits, None)
    for i, op in enumerate(ops):
        kind, t = op[0], op[1]
        if kind == "admit":
            eng.search_async([cls(id=p, rating=r, enqueued_at=e,
                                  reply_to=f"rq.{p}") for p, r, e in op[2]], t)
            stream += _matches(eng.flush())
        elif kind == "dup":
            if op[2] in eng.pool:
                eng.restore([cls(id=op[2], rating=0.0, enqueued_at=t,
                                 reply_to=f"rq.{op[2]}")], t)
                stream += _matches(eng.flush())
        elif kind == "remove":
            r = eng.remove(op[2])
            removed_log.append(op[2] if r is not None else None)
        elif kind == "expire":
            expired_log.append(sorted(
                r.id for r in eng.expire(t, timeout=_SOAK_TIMEOUT)))
        elif kind == "gap":
            gap_t = t
            if spec_on:
                eng.speculate(t)
        elif kind == "cut":
            if spec_on:
                tok = eng.spec_validate(t)
                if tok is not None:
                    eng.spec_commit(tok, t)
                    commit_log.append(gap_t)
            elif next_commit is not None and next_commit == gap_t:
                eng.rescan_async(16, now=next_commit)
                next_commit = next(commits, None)
            stream += _matches(eng.flush())
        elif kind == "drain_restore":
            eng.spec_invalidate("drain")
            eng.flush()
            if jax:
                path = str(tmp_path / f"soak_{spec_on}_{i}.npz")
                save_pool(eng, path, queue_name="soak")
                eng = build()
                load_pool(eng, path, t)
            else:
                cols, regions, modes = eng.waiting_columns()
                eng = build()
                reg, mode = eng.intern_columns(list(regions), list(modes))
                eng.restore_columns(dataclasses.replace(
                    cols, region=reg, mode=mode), t)
            eng.heartbeat(t)
    eng.flush()
    waiting = sorted(p for o in ops if o[0] == "admit" for p, _r, _e in o[2]
                     if p in eng.pool)
    return stream, expired_log, removed_log, waiting, eng.pool_size()


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("seed", [3, 11])
def test_seeded_soak_spec_on_matches_spec_off_and_jax(tmp_path, seed, family):
    """Speculation on gives the stream of speculation off (its commits
    replayed as cold rescans at the same times) and the JAX engine's with
    speculation on, op for op: matches, expiries, removals and the final
    pool; no player lost, none matched twice."""
    ops = _soak_trace(seed)
    commit_log, jax_log = [], []
    on = _run_soak(ops, tmp_path, True, commit_log, family=family)
    off = _run_soak(ops, tmp_path, False, commit_log, family=family)
    jax_on = _run_soak(ops, tmp_path, True, jax_log, jax=True, family=family)
    assert commit_log, "the soak never committed a speculation"
    assert commit_log == jax_log
    assert on == off == jax_on
    stream, expired, removed, waiting, pool_n = on
    matched = [pid for m in stream for pid in m[:2]]
    assert len(matched) == len(set(matched)), "a player in two matches"
    admitted = {p for o in ops if o[0] == "admit" for p, _r, _e in o[2]}
    accounted = (set(matched) | {p for sweep in expired for p in sweep}
                 | {p for p in removed if p is not None} | set(waiting))
    assert accounted == admitted
    assert pool_n == len(waiting)


# ---- the service ----------------------------------------------------------------


def _service_cfg(family, **queue_kw):
    engine = dict(pool_capacity=256, pool_block=64, batch_buckets=(8, 32),
                  top_k=4, spec_formation=True, spec_interval_ms=20.0,
                  spec_max_steps=2, spec_staleness_ms=500.0,
                  health_interval_s=0.2)
    if family == "bucketed":
        engine.update(bucketed=True, band_spec="gaussian:1500:300",
                      prune_chunk=8)
    q = dict(rating_threshold=50.0, widen_per_sec=400.0, max_threshold=2000.0,
             rescan_interval_s=0.0)
    q.update(queue_kw)
    from matchmaking_tpu_torch.config import BatcherConfig

    return Config(queues=(QueueConfig(**q),), engine=EngineConfig(**engine),
                  batcher=BatcherConfig(max_batch=8, max_wait_ms=10.0))


@pytest.mark.parametrize("family", list(FAMILIES))
async def test_service_spec_loop_matches_residents_without_rescan(family):
    """Rescan is off, so only the speculation loop can match two waiting
    players whose thresholds widen into range; the committed window is
    published as a rescan tick's (and the health timer rebuilds a bucketed
    index meanwhile)."""
    app = MatchmakingApp(_service_cfg(family), device="cpu")
    await app.start()
    try:
        client = MatchmakingClient(app.broker, app.queue_cfg.name)
        a = client.submit({"id": "alice", "rating": 1500})
        b = client.submit({"id": "bob", "rating": 1900})
        ra = await client.next_response(a, timeout=15.0)
        rb = await client.next_response(b, timeout=15.0)
        assert {ra.status, rb.status} == {"queued"}
        ra2 = await client.next_response(a, timeout=15.0)
        rb2 = await client.next_response(b, timeout=15.0)
        assert ra2.status == "matched" and rb2.status == "matched"
        assert ra2.match.match_id == rb2.match.match_id
        sr = app.engine.spec_report()
        assert sr["spec_hit"] >= 1
        assert app.counters["spec_commits"] >= 1
        assert app.counters["rescan_matches"] == 1
        assert app.engine.util_report()["spec_commit_share"] > 0.0
        assert app.engine.pool_size() == 0
        assert app.faults() == {}
    finally:
        await app.stop()


async def test_service_stop_with_a_speculation_loses_no_players():
    """Stopping with a speculation held discards it (it owns no player):
    every waiting player is in the engine's ``waiting_columns`` and
    restores into a successor app."""
    cfg = _service_cfg("flat", rating_threshold=1.0, widen_per_sec=0.0)
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, spec_interval_ms=5.0, spec_max_steps=1))
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    client = MatchmakingClient(app.broker, app.queue_cfg.name)
    handles = [client.submit({"id": f"w{i}", "rating": 1000.0 + 300 * i})
               for i in range(4)]
    for h in handles:
        assert (await client.next_response(h, timeout=15.0)).status == "queued"
    await asyncio.sleep(0.1)  # the loop takes a speculation
    assert app.engine.spec_report()["spec_steps"] >= 1
    await app.stop()
    assert app.engine.spec_report()["spec_pending"] == 0
    cols, regions, modes = app.engine.waiting_columns()
    assert len(cols) == 4
    succ = MatchmakingApp(cfg, device="cpu")
    await succ.start()
    try:
        succ.restore_columns(cols, regions, modes, 0.0)
        assert succ.engine.pool_size() == 4
        assert app.faults() == {} and succ.faults() == {}
    finally:
        await succ.stop()
