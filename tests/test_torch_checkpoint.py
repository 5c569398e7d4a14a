"""The port's pool checkpoints and drain sidecars (utils/checkpoint.py)
against the JAX package's, on the CPU.

- ``save_pool`` from the JAX package's ``TpuEngine`` loads into the port's
  ``GpuEngine(device="cpu")``, and the reverse: the waiting columns
  (``engine_waiting_columns``) equal row for row, names, NaN thresholds,
  tiers and deadlines included; both engines then pair the same window
  alike.
- The backlog and admission sidecars written by either package read by
  the other, and a byte changed in either is refused by its CRC.
- The host oracle (``CpuEngine``) goes through ``waiting()``: its columns
  equal the JAX oracle's, its snapshot loads into the card's engine, and
  ``load_pool`` restores an oracle through request objects.
"""

import dataclasses

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.engine.cpu import CpuEngine as JaxCpuEngine
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service import contract as jax_contract
from matchmaking_tpu.service.broker import Delivery as JaxDelivery
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.utils import checkpoint as jax_ck
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.engine.cpu import CpuEngine
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.service import contract
from matchmaking_tpu_torch.service.broker import Delivery, Properties
from matchmaking_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

SMALL = dict(pool_capacity=1024, pool_block=256, batch_buckets=(16, 64))
NOW = 1_700_000_000.0


def _requests(seed, n, prefix="w"):
    """Seeded waiting players: far apart (nobody matches at restore),
    with regions, modes, own thresholds, tiers, deadlines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(contract.SearchRequest(
            id=f"{prefix}{i}", rating=float(1000 + 37 * i),
            rating_deviation=float(rng.uniform(30, 300)),
            region=["*", "eu", "na"][int(rng.integers(0, 3))],
            game_mode=["*", "ranked"][int(rng.integers(0, 2))],
            rating_threshold=(None if rng.random() < 0.5
                              else float(rng.uniform(5, 30))),
            reply_to=f"rq.{i}", correlation_id=f"c{i}",
            enqueued_at=NOW - float(rng.uniform(0, 50)),
            tier=int(rng.integers(0, 3)),
            deadline_at=0.0 if rng.random() < 0.6 else NOW + 100.0))
    return out


def _jax(reqs):
    return [jax_contract.SearchRequest(**dataclasses.asdict(r)) for r in reqs]


def _rows(ckmod, engine):
    """id → the checkpoint's view of the player (NaN threshold → None)."""
    cols, regions, modes = ckmod.engine_waiting_columns(engine)
    out = {}
    for i, pid in enumerate(cols.ids.tolist()):
        thr = float(cols.threshold[i])
        out[pid] = (float(cols.rating[i]), float(cols.rd[i]), regions[i],
                    modes[i], None if thr != thr else thr,
                    float(cols.enqueued_at[i]), cols.reply_to[i],
                    cols.correlation_id[i], int(cols.tier[i]),
                    float(cols.deadline[i]))
    return out


def _engines():
    mine = GpuEngine(Config(engine=EngineConfig(**SMALL)),
                     QueueConfig(rating_threshold=50.0), device="cpu")
    theirs = TpuEngine(JaxConfig(engine=JaxEngineConfig(backend="tpu",
                                                        **SMALL)),
                       JaxQueueConfig(rating_threshold=50.0))
    return mine, theirs


def _pairs(outcome):
    return sorted(tuple(sorted(m.result().players)) for m in outcome.matches)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_pool_loads_into_the_other_packages_engine(tmp_path, writer):
    reqs = _requests(0, 200)
    mine, theirs = _engines()
    path = str(tmp_path / "q.npz")
    if writer == "jax":
        theirs.restore(_jax(reqs), NOW)
        assert jax_ck.save_pool(theirs, path, queue_name="q") == 200
        assert ck.load_pool(mine, path, NOW) == 200
        # The reader's own file, back into a twin of the writer's engine.
        other = str(tmp_path / "back.npz")
        ck.save_pool(mine, other)
        twin = _engines()[1]
        jax_ck.load_pool(twin, other, NOW)
        assert _rows(jax_ck, twin) == _rows(jax_ck, theirs)
    else:
        mine.restore(reqs, NOW)
        assert ck.save_pool(mine, path, queue_name="q") == 200
        assert jax_ck.load_pool(theirs, path, NOW) == 200
    assert _rows(ck, mine) == _rows(jax_ck, theirs)
    assert len(_rows(ck, mine)) == 200
    # The loaded pools serve alike: one window of arrivals between the
    # waiting players pairs the same partners on both engines.
    window = [contract.SearchRequest(id=f"n{i}", rating=float(1000 + 37 * i
                                                              + 5),
                                     enqueued_at=NOW)
              for i in range(0, 200, 7)]
    got = mine.search(window, NOW + 1.0)
    want = theirs.search(_jax(window), NOW + 1.0)
    assert _pairs(got) == _pairs(want) and _pairs(got)


def test_load_pool_skips_players_already_waiting(tmp_path):
    reqs = _requests(1, 50)
    mine, _ = _engines()
    mine.restore(reqs[:20], NOW)
    path = str(tmp_path / "q.npz")
    src = _engines()[0]
    src.restore(reqs, NOW)
    ck.save_pool(src, path)
    assert ck.load_pool(mine, path, NOW) == 50
    assert mine.pool_size() == 50


def _deliveries(cls, props_cls):
    return [cls(body=b'{"id":"p%d","rating":1500}' % i,
                properties=props_cls(reply_to=f"r{i}", correlation_id=f"c{i}",
                                     headers={"x-tier": "1", "x-n": i,
                                              "x-obj": object()}),
                queue="q", delivery_tag=i, redelivered=bool(i % 2))
            for i in range(5)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_backlog_sidecar_reads_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "_backlog.json")
    if writer == "jax":
        n = jax_ck.save_backlog(path, {"q": _deliveries(JaxDelivery,
                                                        JaxProperties)})
    else:
        n = ck.save_backlog(path, {"q": _deliveries(Delivery, Properties)})
    assert n == 5
    mine, theirs = ck.load_backlog(path), jax_ck.load_backlog(path)
    assert mine == theirs
    assert mine["q"][3]["body"] == b'{"id":"p3","rating":1500}'
    assert mine["q"][3]["redelivered"] and mine["q"][3]["headers"]["x-n"] == 3
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace('"reply_to": "r2"', '"reply_to": "r9"'))
    with pytest.raises(ValueError, match="CRC mismatch"):
        ck.load_backlog(path)
    # An empty handoff still writes the file.
    assert ck.save_backlog(path, {}) == 0 and ck.load_backlog(path) == {}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_admission_sidecar_reads_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "_admission.json")
    state = {"q": {"credit_fraction": 0.5, "shed_by_tier": [1, 2, 3]},
             "r": {"credit_fraction": 1.0}}
    (jax_ck if writer == "jax" else ck).save_admission(path, state)
    assert ck.load_admission(path) == jax_ck.load_admission(path) == state
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("0.5", "0.9"))
    with pytest.raises(ValueError, match="CRC mismatch"):
        ck.load_admission(path)
    with pytest.raises(ValueError, match="CRC mismatch"):
        jax_ck.load_admission(path)


def test_cpu_engine_goes_through_waiting(tmp_path):
    reqs = _requests(2, 60)
    oracle = CpuEngine(Config(), QueueConfig(rating_threshold=50.0))
    oracle.restore(reqs, NOW)
    joracle = JaxCpuEngine(JaxConfig(), JaxQueueConfig(rating_threshold=50.0))
    joracle.restore(_jax(reqs), NOW)
    assert _rows(ck, oracle) == _rows(jax_ck, joracle)
    path = str(tmp_path / "oracle.npz")
    assert ck.save_pool(oracle, path) == 60
    mine, theirs = _engines()
    ck.load_pool(mine, path, NOW)
    jax_ck.load_pool(theirs, path, NOW)
    assert _rows(ck, mine) == _rows(ck, oracle) == _rows(jax_ck, theirs)
    # load_pool into an oracle: request objects.
    back = CpuEngine(Config(), QueueConfig(rating_threshold=50.0))
    assert ck.load_pool(back, path, NOW) == 60
    assert _rows(ck, back) == _rows(ck, oracle)
