"""The host oracle: the port's ``CpuEngine`` against the JAX package's, on
the same seeded request streams (no device, no tolerance).

Streams for a 1v1 queue (filters and wildcards, Glicko-2), a 5v5 team
queue (wildcards: several overlapping compatibility groups) and a role
queue with parties of 1-3 and declared roles. Per window: the same
matches, as teams of player ids (match ids are random), the same quality,
queued and rejected requests; then the same waiting pool, ``restore``
into a fresh engine (the full scan after a restore), ``rescan``,
``expire`` and ``expire_deadlines``.
"""

import dataclasses

import numpy as np
import pytest

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import QueueConfig as JaxQueue
from matchmaking_tpu.engine.cpu import CpuEngine as JaxCpuEngine
from matchmaking_tpu.service.contract import PartyMember as JaxMember
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config, QueueConfig
from matchmaking_tpu_torch.engine.cpu import CpuEngine
from matchmaking_tpu_torch.service.contract import PartyMember, SearchRequest

SLOTS = ("tank", "healer", "dps", "dps", "dps")
QUEUES = {
    "1v1": dict(rating_threshold=80.0, glicko2=True, widen_per_sec=5.0,
                max_threshold=250.0),
    "team": dict(team_size=5, rating_threshold=120.0, widen_per_sec=2.0,
                 max_threshold=300.0),
    "role": dict(team_size=5, rating_threshold=150.0, role_slots=SLOTS),
}


def oracles(kind):
    q = QUEUES[kind]
    return (JaxCpuEngine(JaxConfig(), JaxQueue(**q)),
            CpuEngine(Config(), QueueConfig(**q)))


def stream(kind, rng, n_windows, t=1_700_000_000.0):
    """Seeded windows of (kwargs rows, now); a row's "party" holds member
    kwargs."""
    pid = 0
    for _ in range(n_windows):
        rows = []
        for _ in range(int(rng.integers(5, 30))):
            kw = dict(id=f"p{pid}", rating=float(rng.normal(1500, 120)),
                      rating_deviation=float(rng.uniform(0, 350)),
                      region=str(rng.choice(["eu", "na", "*"], p=[.45, .45, .1])),
                      game_mode=str(rng.choice(["ranked", "*"], p=[.9, .1])),
                      enqueued_at=t - float(rng.uniform(0, 10)),
                      deadline_at=(t + 20.0 if rng.random() < 0.2 else 0.0))
            if rng.random() < 0.2:
                kw["rating_threshold"] = float(rng.uniform(60, 200))
            if kind == "role":
                kw["roles"] = tuple(rng.choice(["tank", "healer", "dps"],
                                               int(rng.choice([0, 1, 1, 2])),
                                               replace=False))
                if rng.random() < 0.25:
                    kw["party"] = [dict(
                        id=f"p{pid}m{j}", rating=kw["rating"] + float(
                            rng.normal(0, 20)),
                        roles=(str(rng.choice(["tank", "healer", "dps"])),))
                        for j in range(int(rng.integers(1, 3)))]
            elif kind == "team" and rng.random() < 0.03:
                kw["party"] = [dict(id=f"p{pid}m0", rating=1500.0)]
            rows.append(kw)
            pid += 1
        yield rows, t
        t += float(rng.uniform(0.5, 3.0))


def build(cls, member_cls, rows):
    return [cls(**{**k, "party": tuple(member_cls(**m)
                                       for m in k.get("party", ()))})
            for k in rows]


def teams_of(outcome):
    return [tuple(tuple(pid for r in team for pid in r.all_ids())
                  for team in m.teams) for m in outcome.matches]


def assert_same(jout, tout):
    assert teams_of(tout) == teams_of(jout)
    assert [m.quality for m in tout.matches] == [m.quality for m in jout.matches]
    assert [r.id for r in tout.queued] == [r.id for r in jout.queued]
    assert ([(r.id, c) for r, c in tout.rejected]
            == [(r.id, c) for r, c in jout.rejected])


def waiting_of(eng):
    return [dataclasses.asdict(r) for r in eng.waiting()]


@pytest.mark.parametrize("kind", list(QUEUES))
def test_oracle_equals_jax_oracle(kind):
    jeng, teng = oracles(kind)
    rng = np.random.default_rng({"1v1": 1, "team": 2, "role": 3}[kind])
    matches = 0
    for rows, now in stream(kind, rng, 10):
        jout = jeng.search(build(JaxRequest, JaxMember, rows), now)
        tout = teng.search(build(SearchRequest, PartyMember, rows), now)
        assert_same(jout, tout)
        assert teng.pool_size() == jeng.pool_size()
        assert teng.deadline_count() == jeng.deadline_count()
        matches += len(tout.matches)
    assert matches >= 3
    assert waiting_of(teng) == waiting_of(jeng)
    assert teng.has_wildcards() == jeng.has_wildcards()
    assert teng.has_parties() == jeng.has_parties()
    # A restore forces full scans: a fresh pair of oracles restored from
    # the waiting pool answers the next windows the same.
    j2, t2 = oracles(kind)
    j2.restore(jeng.waiting(), now)
    t2.restore(teng.waiting(), now)
    assert t2._team_full_scan == j2._team_full_scan
    for rows, t in stream(kind, rng, 3, t=now + 1.0):
        rows = [dict(k, id="r" + k["id"], party=[
            dict(m, id="r" + m["id"]) for m in k.get("party", ())])
            for k in rows]  # fresh ids
        assert_same(j2.search(build(JaxRequest, JaxMember, rows), t),
                    t2.search(build(SearchRequest, PartyMember, rows), t))
    later = now + 30.0
    assert_same(j2.rescan(64, later), t2.rescan(64, later))
    assert ([r.id for r in t2.expire_deadlines(later)]
            == [r.id for r in j2.expire_deadlines(later)])
    assert ([r.id for r in t2.expire(later, 25.0)]
            == [r.id for r in j2.expire(later, 25.0)])
    assert waiting_of(t2) == waiting_of(j2)
    assert t2.remove("nobody") is None
