"""The slice as a whole: the port's ``GpuEngine`` (on the CPU, plain
versions of the kernels) against the JAX package's ``TpuEngine`` (JAX on
the CPU) on the same seeded request stream.

Configs #1, #2 and #4 are loaded from the repository's own JSON files and
cut to ``pool_capacity`` 1024 / ``pool_block`` 256. Per window: identical
matched id pairs, identical queued ids, identical ``pool_size``, quality
within 1e-6. Under Glicko-2 the JAX distance is not symmetric in its two
players (see test_torch_kernels.pairs_by_slots), so a pair can come back
with its two sides swapped: pairs are compared as unordered id sets.

The sequential ``CpuEngine`` oracle is only held equal on uncontended
windows, as tests/test_oracle_equiv.py does: under contention it picks
winners in arrival order, the batched engines in score order.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.engine.cpu import CpuEngine
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.engine.interface import make_engine
from matchmaking_tpu_torch.service.contract import SearchRequest

# Small tensors: one intra-op thread each leaves the cores to the other
# test workers (several run side by side).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"elo_1v1": "configs/elo_1v1.json",
           "multiqueue_filters": "configs/multiqueue_filters.json",
           "glicko2": "configs/glicko2.json"}
SMALL = dict(pool_capacity=1024, pool_block=256)
T0 = 1_700_000_000.0  # wall-clock magnitude: exercises time rebasing


def engine_pair(name, **engine_kw):
    path = os.path.join(ROOT, CONFIGS[name])
    jcfg = JaxConfig.from_json(path)
    tcfg = Config.from_json(path, backend="gpu")
    assert jcfg.engine.backend == "tpu" and tcfg.engine.backend == "gpu"
    kw = dict(SMALL, **engine_kw)
    jcfg = dataclasses.replace(jcfg, engine=dataclasses.replace(jcfg.engine, **kw))
    tcfg = dataclasses.replace(tcfg, engine=dataclasses.replace(tcfg.engine, **kw))
    jq, tq = jcfg.queues[0], tcfg.queues[0]
    for f in dataclasses.fields(tq):  # every field the port carries agrees
        assert getattr(tq, f.name) == getattr(jq, f.name), f.name
    return TpuEngine(jcfg, jq), GpuEngine(tcfg, tq, device="cpu")


def stream(rng, n_windows, name, start_id=0, t=T0):
    """Seeded windows of (jax requests, port requests, now)."""
    pid = start_id
    filters = name == "multiqueue_filters"
    out = []
    for w in range(n_windows):
        size = int(rng.choice([5, 16, 40, 64, 100]))
        rows = []
        for _ in range(size):
            kw = dict(id=f"p{pid}", rating=float(rng.normal(1500, 200)),
                      rating_deviation=float(rng.uniform(0, 350)),
                      enqueued_at=t - float(rng.uniform(0, 10)),
                      reply_to=f"r{pid}", correlation_id=f"c{pid}")
            if rng.random() < 0.3:
                kw["rating_threshold"] = float(rng.uniform(40, 160))
            if filters:
                kw["region"] = str(rng.choice(["eu", "na", "*"]))
                kw["game_mode"] = str(rng.choice(["ranked", "casual", "*"]))
            rows.append(kw)
            pid += 1
        out.append(([JaxRequest(**k) for k in rows],
                    [SearchRequest(**k) for k in rows], t))
        t += float(rng.uniform(0.5, 3.0))
    return out


def summary(outcome):
    pairs = {frozenset(r.id for r in m.requests()): m.quality
             for m in outcome.matches}
    return (pairs, [r.id for r in outcome.queued],
            [(r.id, code) for r, code in outcome.rejected])


def assert_same_outcome(jout, tout):
    jp, jq, jr = summary(jout)
    tp, tq, tr = summary(tout)
    assert tp.keys() == jp.keys()
    for k in tp:
        assert abs(tp[k] - jp[k]) <= 1e-6
    assert tq == jq
    assert tr == jr


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gpu_engine_matches_tpu_engine(name):
    jeng, teng = engine_pair(name)
    rng = np.random.default_rng(31)
    matched = 0
    for jreqs, treqs, now in stream(rng, 8, name):
        jout, tout = jeng.search(jreqs, now), teng.search(treqs, now)
        assert_same_outcome(jout, tout)
        assert teng.pool_size() == jeng.pool_size()
        matched += len(tout.matches)
    assert matched >= 20
    assert ({r.id for r in teng.waiting()} == {r.id for r in jeng.waiting()})


def test_pool_full_rejection():
    jeng, teng = engine_pair("elo_1v1", pool_capacity=256, pool_block=64)
    # Ratings 1000 apart with the default threshold: nobody ever matches.
    rows = [dict(id=f"x{i}", rating=1000.0 * i, enqueued_at=T0)
            for i in range(300)]
    for chunk in (rows[:200], rows[200:]):
        jout = jeng.search([JaxRequest(**k) for k in chunk], T0)
        tout = teng.search([SearchRequest(**k) for k in chunk], T0)
        assert_same_outcome(jout, tout)
    assert [code for _, code in tout.rejected] == ["pool_full"] * 44
    assert teng.pool_size() == jeng.pool_size() == 256


def test_redelivery_dedupe_remove_and_expire():
    jeng, teng = engine_pair("elo_1v1")
    rng = np.random.default_rng(4)
    windows = stream(rng, 4, "elo_1v1")
    for jreqs, treqs, now in windows:
        assert_same_outcome(jeng.search(jreqs, now), teng.search(treqs, now))
    # Redelivery: waiting ids, and an id twice in one window, are skipped.
    waiting = sorted(r.id for r in teng.waiting())
    assert waiting
    dup_rows = [dict(id=i, rating=1500.0) for i in waiting[:3]]
    dup_rows += [dict(id="fresh", rating=-5000.0)] * 2
    now = windows[-1][2] + 1.0
    jout = jeng.search([JaxRequest(**k) for k in dup_rows], now)
    tout = teng.search([SearchRequest(**k) for k in dup_rows], now)
    assert_same_outcome(jout, tout)
    assert [r.id for r in tout.queued] == ["fresh"] and not tout.matches
    # Cancel one waiting player on both sides.
    jr, tr = jeng.remove(waiting[0]), teng.remove(waiting[0])
    assert tr.id == jr.id == waiting[0]
    assert teng.remove("nobody") is None and jeng.remove("nobody") is None
    assert teng.pool_size() == jeng.pool_size()
    # Expire everyone who waited longer than 5 s.
    later = now + 4.0
    jexp = sorted(r.id for r in jeng.expire(later, 5.0))
    texp = sorted(r.id for r in teng.expire(later, 5.0))
    assert texp == jexp and texp
    assert teng.pool_size() == jeng.pool_size()
    # The pools stay in step afterwards.
    for jreqs, treqs, t in stream(rng, 3, "elo_1v1", start_id=10_000,
                                  t=later + 1.0):
        assert_same_outcome(jeng.search(jreqs, t), teng.search(treqs, t))
        assert teng.pool_size() == jeng.pool_size()


@pytest.mark.parametrize("name", ["elo_1v1", "glicko2"])
def test_restore_from_jax_waiting(name):
    """The engine-level carry: the JAX engine's ``waiting()`` becomes port
    requests (``dataclasses.asdict``) for ``GpuEngine.restore``; then the
    restored port engine and a JAX engine restored from the same list
    answer the same stream identically."""
    src, _ = engine_pair(name)
    rng = np.random.default_rng(9)
    for jreqs, _, now in stream(rng, 4, name):
        src.search(jreqs, now)
    carried = src.waiting()
    assert len(carried) >= 10
    jeng, teng = engine_pair(name)
    jeng.restore(carried, now)
    teng.restore([SearchRequest(**dataclasses.asdict(r)) for r in carried], now)
    assert teng.pool_size() == jeng.pool_size() == len(carried)
    assert ([dataclasses.asdict(r) for r in teng.waiting()]
            == [dataclasses.asdict(r) for r in jeng.waiting()])
    for jreqs, treqs, t in stream(rng, 4, name, start_id=5_000, t=now + 1.0):
        assert_same_outcome(jeng.search(jreqs, t), teng.search(treqs, t))
        assert teng.pool_size() == jeng.pool_size()


def test_uncontended_windows_match_cpu_oracle():
    """Isolated rating islands (one feasible partner each), fed in windows
    of 7: the port, the JAX device engine and the sequential oracle form
    the same pairs."""
    cfg = JaxConfig(engine=JaxEngineConfig(backend="cpu", **SMALL))
    oracle = CpuEngine(cfg, JaxQueueConfig())
    jeng = TpuEngine(dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, backend="tpu")),
        JaxQueueConfig())
    teng = GpuEngine(Config(engine=EngineConfig(**SMALL)), QueueConfig(),
                     device="cpu")
    rows = []
    for i in range(40):
        base = 10000.0 * (i + 1) - 200_000.0
        rows.append(dict(id=f"a{i}", rating=base, rating_threshold=20.0))
        rows.append(dict(id=f"b{i}", rating=base + 5.0, rating_threshold=20.0))
    order = np.random.default_rng(1).permutation(len(rows))
    rows = [rows[i] for i in order]
    got = {"oracle": set(), "jax": set(), "port": set()}
    for s in range(0, len(rows), 7):
        w = rows[s:s + 7]
        for key, eng, cls in (("oracle", oracle, JaxRequest),
                              ("jax", jeng, JaxRequest),
                              ("port", teng, SearchRequest)):
            got[key] |= set(summary(eng.search([cls(**k) for k in w],
                                               float(s)))[0])
    expected = {frozenset((f"a{i}", f"b{i}")) for i in range(40)}
    assert got["oracle"] == got["jax"] == got["port"] == expected
    assert teng.pool_size() == 0


def test_backend_selection():
    cfg = Config(engine=EngineConfig(**SMALL))
    assert isinstance(make_engine(cfg, cfg.queues[0], device="cpu"), GpuEngine)
    tpu_cfg = Config.from_json(os.path.join(ROOT, CONFIGS["elo_1v1"]))
    assert tpu_cfg.engine.backend == "tpu"  # the JAX name is not reinterpreted
    with pytest.raises(ValueError, match="backend"):
        make_engine(tpu_cfg, tpu_cfg.queues[0], device="cpu")
    # Team and role queues (configs #3 and #5) build a GpuEngine too, with
    # their own steps; role slots without teams are refused.
    for path, step in (("configs/team_5v5.json", "TeamKernelSet"),
                       ("configs/role_party.json", "RoleKernelSet")):
        team_cfg = Config.from_json(os.path.join(ROOT, path), backend="gpu")
        eng = make_engine(team_cfg, team_cfg.queues[0], device="cpu")
        assert isinstance(eng, GpuEngine)
        assert type(eng.kernels).__name__ == step
    with pytest.raises(ValueError, match="team_size"):
        GpuEngine(cfg, QueueConfig(role_slots=("tank",)), device="cpu")
