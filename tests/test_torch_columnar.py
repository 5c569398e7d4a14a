"""The port's pipelined columnar window API against the JAX package's.

The same seeded ``RequestColumns`` go through ``TpuEngine`` (JAX on the
CPU) and ``GpuEngine`` (the port on the CPU, plain versions of the
kernels) with the same dispatch/collect interleaving: at pipeline depth
``d``, ``d`` windows are dispatched back to back and then collected with
``collect_ready`` until nothing is in flight. Configs #1, #2 and #4 come
from the repository's JSON files, cut to ``pool_capacity`` 1024 /
``pool_block`` 256.

Per window: the same matched id pairs (compared as sets: under Glicko-2
the JAX distance is not symmetric in its two players, so a pair can come
back with its sides swapped), ``m_dist`` bit-equal for ELO and within
3 ulp for Glicko-2 (XLA fuses FMAs on the CPU), ``m_quality`` within 1e-6,
the same per-player reply/correlation/enqueue/wait/tier columns, the same
queued ids and rejections, and after every collection the same mirror and
the same device ``active`` flags.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service.contract import RequestColumns as JaxColumns
from matchmaking_tpu_torch.config import Config
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.engine.kernels import pool_to_numpy
from matchmaking_tpu_torch.service.contract import RequestColumns, SearchRequest

# Small tensors: one intra-op thread each leaves the cores to the other
# test workers (several run side by side).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"elo_1v1": "configs/elo_1v1.json",
           "multiqueue_filters": "configs/multiqueue_filters.json",
           "glicko2": "configs/glicko2.json"}
SMALL = dict(pool_capacity=1024, pool_block=256)
T0 = 1_700_000_000.0  # wall-clock magnitude: exercises time rebasing
GLICKO_ULP = 3
MIRROR = ("m_rating", "m_rd", "m_region", "m_mode", "m_threshold",
          "m_thr_override", "m_enqueued", "m_reply", "m_corr", "m_tier",
          "m_deadline")


def engine_pair(name, **engine_kw):
    path = os.path.join(ROOT, CONFIGS[name])
    jcfg = JaxConfig.from_json(path)
    tcfg = Config.from_json(path, backend="gpu")
    kw = dict(SMALL, **engine_kw)
    jcfg = dataclasses.replace(jcfg, engine=dataclasses.replace(jcfg.engine, **kw))
    tcfg = dataclasses.replace(tcfg, engine=dataclasses.replace(tcfg.engine, **kw))
    return (TpuEngine(jcfg, jcfg.queues[0]),
            GpuEngine(tcfg, tcfg.queues[0], device="cpu"))


def columns_pair(jeng, teng, rows):
    """The same rows as JAX columns and port columns, each interned by its
    own engine (both intern the same names in the same order)."""
    n = len(rows)
    names = lambda key: [r.get(key, "*") for r in rows]
    out = []
    for eng, cls in ((jeng, JaxColumns), (teng, RequestColumns)):
        region, mode = eng.intern_columns(names("region"), names("game_mode"))
        out.append(cls(
            ids=np.array([r["id"] for r in rows], object),
            rating=np.array([r["rating"] for r in rows], np.float32),
            rd=np.array([r.get("rating_deviation", 350.0) for r in rows],
                        np.float32),
            region=region, mode=mode,
            threshold=np.array([r.get("rating_threshold", np.nan) for r in rows],
                               np.float32),
            enqueued_at=np.array([r["enqueued_at"] for r in rows], np.float64),
            reply_to=np.array([f"rq.{r['id']}" for r in rows], object),
            correlation_id=np.array([f"c.{r['id']}" for r in rows], object),
            tier=np.array([r.get("tier", 0) for r in rows], np.int32),
            deadline=np.array([r.get("deadline", 0.0) for r in rows],
                              np.float64)))
    assert all(len(c) == n for c in out)
    return out


def stream(rng, n_windows, name, start_id=0, t=T0):
    """Seeded windows of (rows, now)."""
    pid = start_id
    filters = name == "multiqueue_filters"
    out = []
    for _ in range(n_windows):
        rows = []
        for _ in range(int(rng.choice([5, 16, 40, 64, 100]))):
            r = dict(id=f"p{pid}", rating=float(rng.normal(1500, 200)),
                     rating_deviation=float(rng.uniform(0, 350)),
                     enqueued_at=t - float(rng.uniform(0, 10)),
                     tier=int(rng.integers(0, 3)))
            if rng.random() < 0.3:
                r["rating_threshold"] = float(rng.uniform(40, 160))
            if filters:
                r["region"] = str(rng.choice(["eu", "na", "*"]))
                r["game_mode"] = str(rng.choice(["ranked", "casual", "*"]))
            rows.append(r)
            pid += 1
        out.append((rows, t))
        t += float(rng.uniform(0.5, 3.0))
    return out


def drain_by_collect(eng):
    """collect_ready until nothing is in flight (JAX results land
    asynchronously; the port's CPU results are ready at dispatch)."""
    done = []
    for _ in range(100_000):
        done += eng.collect_ready()
        if eng.inflight() == 0:
            return done
    raise AssertionError("windows never landed")


def ulp_diff(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def pairs_of(out):
    return {frozenset((a, b)): j for j, (a, b)
            in enumerate(zip(out.m_id_a.tolist(), out.m_id_b.tolist()))}


def per_player(out):
    """player id → (reply, correlation, enqueue, wait, tier) of its side."""
    got = {}
    for side in "ab":
        for j, pid in enumerate(getattr(out, f"m_id_{side}").tolist()):
            got[pid] = tuple(getattr(out, f"m_{f}_{side}")[j].item()
                             if f in ("enq", "wait", "tier")
                             else getattr(out, f"m_{f}_{side}")[j]
                             for f in ("reply", "corr", "enq", "wait", "tier"))
    return got


def assert_same_columnar(jout, tout, glicko2):
    jp, tp = pairs_of(jout), pairs_of(tout)
    assert tp.keys() == jp.keys()
    for key, tj in tp.items():
        jj = jp[key]
        if glicko2:
            assert ulp_diff(tout.m_dist[tj], jout.m_dist[jj]) <= GLICKO_ULP
        else:
            assert (np.float32(tout.m_dist[tj]).view(np.int32)
                    == np.float32(jout.m_dist[jj]).view(np.int32))
        assert abs(float(tout.m_quality[tj]) - float(jout.m_quality[jj])) <= 1e-6
    assert per_player(tout) == per_player(jout)
    assert len(set(tout.m_match_id.tolist())) == tout.n_matches
    assert tout.q_ids.tolist() == jout.q_ids.tolist()
    assert list(tout.rejected) == list(jout.rejected)


def assert_same_mirror(jeng, teng):
    assert teng.pool._slot_of == jeng.pool._slot_of
    slots = np.array(sorted(teng.pool._slot_of.values()), np.int64)
    for name in MIRROR:
        got, want = getattr(teng.pool, name)[slots], getattr(jeng.pool, name)[slots]
        assert got.tolist() == want.tolist(), name
    active = np.asarray(jeng._dev_pool["active"])
    assert (pool_to_numpy(teng.dev_pool)["active"] == active).all()
    assert teng.pool.deadline_count() == jeng.pool.deadline_count()
    assert teng.pool.tier_counts(3) == jeng.pool.tier_counts(3)


def collected(done):
    return {tok: out for tok, out in done}


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_columnar_windows_match_tpu_engine(name, depth):
    jeng, teng = engine_pair(name)
    glicko2 = teng.queue.glicko2
    rng = np.random.default_rng(31 + depth)
    windows = stream(rng, 8, name)
    matched = 0
    for g in range(0, len(windows), depth):
        toks = []
        for rows, now in windows[g:g + depth]:
            jc, tc = columns_pair(jeng, teng, rows)
            jt, tt = jeng.search_columns_async(jc, now), teng.search_columns_async(tc, now)
            assert jt == tt
            toks.append(tt)
        assert teng.inflight() == jeng.inflight() == len(toks)
        jdone, tdone = collected(drain_by_collect(jeng)), collected(drain_by_collect(teng))
        assert list(tdone) == list(jdone) == toks
        for tok in toks:
            assert_same_columnar(jdone[tok], tdone[tok], glicko2)
            matched += tdone[tok].n_matches
        assert_same_mirror(jeng, teng)
        assert teng.pool_size() == jeng.pool_size()
    assert matched >= 20


def test_rescan_tick_overlapping_windows_matches_tpu_engine():
    """Config #4 (widening): a rescan tick dispatched between two windows
    in flight, collected with them; both engines form the same matches and
    no player is matched twice."""
    jeng, teng = engine_pair("glicko2")
    rng = np.random.default_rng(5)
    windows = stream(rng, 6, "glicko2")
    seen: set[str] = set()
    for i in range(0, len(windows), 2):
        toks = []
        (rows_a, t_a), (rows_b, t_b) = windows[i], windows[i + 1]
        jc, tc = columns_pair(jeng, teng, rows_a)
        toks.append((jeng.search_columns_async(jc, t_a),
                     teng.search_columns_async(tc, t_a)))
        toks.append((jeng.rescan_async(64, t_a + 5.0),
                     teng.rescan_async(64, t_a + 5.0)))
        jc, tc = columns_pair(jeng, teng, rows_b)
        toks.append((jeng.search_columns_async(jc, t_b),
                     teng.search_columns_async(tc, t_b)))
        assert all(j == t for j, t in toks)
        jdone, tdone = collected(drain_by_collect(jeng)), collected(drain_by_collect(teng))
        for _, tok in toks:
            assert_same_columnar(jdone[tok], tdone[tok], glicko2=True)
            for pid in (tdone[tok].m_id_a.tolist() + tdone[tok].m_id_b.tolist()):
                assert pid not in seen
                seen.add(pid)
        rescan_tok = toks[1][1]
        assert rescan_tok in teng.rescan_tokens and rescan_tok in jeng.rescan_tokens
        teng.rescan_tokens.discard(rescan_tok)
        jeng.rescan_tokens.discard(rescan_tok)
        assert_same_mirror(jeng, teng)
    assert len(seen) >= 20


def test_dedup_and_pool_full_match_tpu_engine():
    """Redelivered ids are dropped, the overflow past capacity is
    rejected ``pool_full``; both engines agree (test_columnar.py's case)."""
    kw = dict(pool_capacity=4, pool_block=4, batch_buckets=(4,))
    jeng, teng = engine_pair("elo_1v1", **kw)
    far = lambda ids, ratings: [dict(id=i, rating=r, enqueued_at=T0)
                                for i, r in zip(ids, ratings)]
    for rows in (far("abcd", [0.0, 1000.0, 2000.0, 3000.0]),
                 far("aef", [0.0, 4000.0, 5000.0]),
                 far(["g", "g"], [9000.0, 9000.0])):
        jc, tc = columns_pair(jeng, teng, rows)
        jeng.search_columns_async(jc, T0)
        teng.search_columns_async(tc, T0)
        (_, jout), = jeng.flush()
        (_, tout), = teng.flush()
        assert_same_columnar(jout, tout, glicko2=False)
        assert_same_mirror(jeng, teng)
    assert dict(tout.rejected) == {"g": "pool_full"}


def test_restore_columns_with_duplicates_matches_tpu_engine():
    jeng, teng = engine_pair("elo_1v1")
    rows = [dict(id=f"w{i % 12}", rating=1000.0 + 200.0 * i, enqueued_at=T0)
            for i in range(16)]  # four ids twice (a replayed checkpoint)
    jc, tc = columns_pair(jeng, teng, rows)
    jeng.restore_columns(jc, T0)
    teng.restore_columns(tc, T0)
    assert teng.pool_size() == jeng.pool_size() == 12
    assert_same_mirror(jeng, teng)
    # Restoring again adds nothing; a close arrival then matches w0.
    teng.restore_columns(tc, T0)
    assert teng.pool_size() == 12
    jc, tc = columns_pair(jeng, teng, [dict(id="x", rating=1001.0,
                                            enqueued_at=T0 + 1)])
    jeng.search_columns_async(jc, T0 + 1)
    teng.search_columns_async(tc, T0 + 1)
    (_, jout), = jeng.flush()
    (_, tout), = teng.flush()
    assert_same_columnar(jout, tout, glicko2=False)
    assert {tout.m_id_a[0], tout.m_id_b[0]} == {"x", "w0"}


def test_expire_and_deadlines_match_tpu_engine():
    jeng, teng = engine_pair("elo_1v1")
    rows = [dict(id=f"p{i}", rating=1000.0 * i, enqueued_at=T0 + 100.0,
                 deadline=(T0 + 150.0 if i % 5 == 0 else 0.0))
            for i in range(40)]
    for r in rows[:7]:
        r["enqueued_at"] = T0 + 1.0  # stale
    rows[7]["enqueued_at"] = 0.0     # unstamped: never expires
    jc, tc = columns_pair(jeng, teng, rows)
    jeng.restore_columns(jc, T0 + 100.0)
    teng.restore_columns(tc, T0 + 100.0)
    assert teng.deadline_count() == jeng.deadline_count() == 8
    texp = sorted(r.id for r in teng.expire(T0 + 100.0, 50.0))
    assert texp == sorted(r.id for r in jeng.expire(T0 + 100.0, 50.0))
    assert texp == sorted(f"p{i}" for i in range(7))
    assert_same_mirror(jeng, teng)
    assert teng.expire_deadlines(T0 + 149.0) == []
    tdl = teng.expire_deadlines(T0 + 150.0)
    assert ([r.id for r in tdl]
            == [r.id for r in jeng.expire_deadlines(T0 + 150.0)])
    assert sorted(r.id for r in tdl) == sorted(f"p{i}" for i in range(10, 40, 5))
    assert all(r.deadline_at == T0 + 150.0 for r in tdl)
    assert teng.deadline_count() == 0
    assert_same_mirror(jeng, teng)
    # Gone on the device too: an exact-rating arrival queues.
    jc, tc = columns_pair(jeng, teng, [dict(id="x", rating=10_000.0,
                                            enqueued_at=T0 + 151.0)])
    jeng.search_columns_async(jc, T0 + 151.0)
    teng.search_columns_async(tc, T0 + 151.0)
    (_, jout), = jeng.flush()
    (_, tout), = teng.flush()
    assert_same_columnar(jout, tout, glicko2=False)
    assert tout.q_ids.tolist() == ["x"]


def test_expiry_refused_with_a_window_in_flight():
    _, teng = engine_pair("elo_1v1")
    _, tc = columns_pair(teng, teng, [dict(id="a", rating=1500.0, enqueued_at=T0)])
    teng.search_columns_async(tc, T0)
    for call in (lambda: teng.expire(T0 + 100.0, 1.0),
                 lambda: teng.expire_deadlines(T0 + 100.0),
                 lambda: teng.remove("a"),
                 lambda: teng.search([], T0)):
        with pytest.raises(RuntimeError, match="in flight"):
            call()
    assert [tok for tok, _ in teng.flush()] == [0]
    assert teng.expire(T0 + 100.0, 1.0)[0].id == "a"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_columnar_and_object_paths_form_the_same_pairs(name):
    """Inside the port: the same stream through ``search`` (object path)
    and ``search_columns_async`` + ``flush`` (columnar path) of two
    engines gives the same pairs, qualities, queued ids and pool."""
    _, obj = engine_pair(name)
    _, col = engine_pair(name)
    rng = np.random.default_rng(8)
    for rows, now in stream(rng, 6, name):
        reqs = [SearchRequest(
            id=r["id"], rating=r["rating"],
            rating_deviation=r["rating_deviation"],
            region=r.get("region", "*"), game_mode=r.get("game_mode", "*"),
            rating_threshold=r.get("rating_threshold"),
            enqueued_at=r["enqueued_at"], tier=r["tier"],
            reply_to=f"rq.{r['id']}", correlation_id=f"c.{r['id']}")
            for r in rows]
        oout = obj.search(reqs, now)
        _, tc = columns_pair(col, col, rows)
        col.search_columns_async(tc, now)
        (_, cout), = col.flush()
        opairs = {frozenset(r.id for r in m.requests()): m.quality
                  for m in oout.matches}
        cpairs = {k: float(cout.m_quality[j]) for k, j in pairs_of(cout).items()}
        assert opairs.keys() == cpairs.keys()
        for k in opairs:
            assert abs(opairs[k] - cpairs[k]) <= 1e-5
        assert [r.id for r in oout.queued] == cout.q_ids.tolist()
        # The same players wait; their slots may differ (the object path
        # frees a window's matched slots in two calls, the columnar in one).
        assert set(obj.pool._slot_of) == set(col.pool._slot_of)


def test_readback_groups_and_util_report():
    """Each window is read back by itself: ``readback_group`` > 1 is
    refused. On the CPU every window is ready once dispatched, and the span
    and util reports count every window."""
    path = os.path.join(ROOT, CONFIGS["elo_1v1"])
    tcfg = Config.from_json(path, backend="gpu")
    tcfg = dataclasses.replace(tcfg, engine=dataclasses.replace(
        tcfg.engine, readback_group=3, **SMALL))
    with pytest.raises(ValueError, match="readback_group"):
        GpuEngine(tcfg, tcfg.queues[0], device="cpu")
    _, eng = engine_pair("elo_1v1", readback_group=1)
    windows = [(rows[:16], now) for rows, now
               in stream(np.random.default_rng(2), 7, "elo_1v1")]
    toks = []
    for rows, now in windows:
        _, tc = columns_pair(eng, eng, rows)
        toks.append(eng.search_columns_async(tc, now))
    assert eng.inflight() == 7
    got = eng.collect_ready()
    assert [tok for tok, _ in got] == toks and eng.inflight() == 0
    assert eng.flush() == []
    spans, util = eng.span_report(), eng.util_report()
    assert spans["windows"] == 7
    assert spans["requests"] == sum(len(rows) for rows, _ in windows)
    assert util["windows"] == 7 and 0.0 <= util["idle_fraction"] <= 1.0
    assert util["lanes_valid"] == spans["requests"]
    assert util["readback_s"] >= 0.0
    assert eng.heartbeat(T0) is False
    for key in ("dedupe", "alloc", "pack", "h2d", "step", "finalize",
                "dispatch", "turnaround"):
        assert spans[f"{key}_ms_avg"] >= 0.0


def test_device_failure_is_parked_on_its_window(monkeypatch):
    """A failure while reading a window back does not raise at collection:
    the window reports its players as queued (the mirror still holds them),
    its token lands in ``failed_tokens`` and the error in
    ``device_error``; the windows before it are unaffected."""
    _, teng = engine_pair("elo_1v1")
    rng = np.random.default_rng(3)
    (rows_a, t_a), (rows_b, t_b) = stream(rng, 2, "elo_1v1")
    _, tc = columns_pair(teng, teng, rows_a)
    ok = teng.search_columns_async(tc, t_a)
    _, tc = columns_pair(teng, teng, rows_b)
    bad = teng.search_columns_async(tc, t_b)
    real = teng._fetch

    def failing(pending):
        if pending.token == bad:
            pending.error = RuntimeError("CUDA error: an illegal memory access")
        else:
            real(pending)

    monkeypatch.setattr(teng, "_fetch", failing)
    done = dict(teng.collect_ready())
    assert set(done) == {ok, bad}
    assert teng.failed_tokens == {bad}
    assert isinstance(teng.device_error, RuntimeError)
    assert done[bad].n_matches == 0
    assert done[bad].q_ids.tolist() == [r["id"] for r in rows_b]
    assert all(pid in teng.pool for pid in done[bad].q_ids.tolist())


def test_match_ids_minted_in_one_range():
    from matchmaking_tpu_torch.service.contract import new_match_id, new_match_ids

    first = new_match_id()
    ids = new_match_ids(3)
    assert ids.dtype == object and len(new_match_ids(0)) == 0
    prefix, n = first[:-12], int(first[-12:], 16)
    assert ids.tolist() == [f"{prefix}{k:012x}" for k in range(n + 1, n + 4)]
    assert new_match_id() == f"{prefix}{n + 4:012x}"
