"""The port's online invariant checker (utils/invariants.py) against the
JAX package's, on the CPU.

- On hand-built outcomes (columnar and object, parties included) both
  checkers raise the same ``InvariantViolation`` text for a double match,
  a player twice in one match and a wrong team size, and a re-queue
  releases the hold in both.
- Through the port's app with ``debug_invariants``: a collected window
  that hands back an earlier window's match (a forced double match) is
  caught at its publish; the window is nacked and counted as an outcome
  error, and the forged match is never published.
"""

import asyncio
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from matchmaking_tpu.engine.interface import ColumnarOutcome as JaxColumnar
from matchmaking_tpu.engine.interface import Match as JaxMatch
from matchmaking_tpu.engine.interface import SearchOutcome as JaxOutcome
from matchmaking_tpu.service.contract import PartyMember as JaxMember
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu.utils import invariants as jax_inv
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    Config,
    ObservabilityConfig,
)
from matchmaking_tpu_torch.engine.interface import ColumnarOutcome, Match
from matchmaking_tpu_torch.engine.interface import SearchOutcome
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.service.contract import PartyMember, SearchRequest
from matchmaking_tpu_torch.utils import invariants

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG1 = os.path.join(ROOT, "configs", "elo_1v1.json")
Q = "matchmaking.search"


def _columnar(cls, pairs, queued):
    """A ColumnarOutcome with only the columns the checker reads."""
    fields = {f.name: np.empty(0) for f in dataclasses.fields(cls)}
    fields.update(
        m_id_a=np.array([a for a, _, _ in pairs], object),
        m_id_b=np.array([b for _, b, _ in pairs], object),
        m_match_id=np.array([m for _, _, m in pairs], object),
        q_ids=np.array(queued, object))
    return cls(**fields)


def _req(cls, member_cls, pid, party=()):
    return cls(id=pid, rating=1500.0,
               party=tuple(member_cls(id=m, rating=1500.0) for m in party))


def _objects(pkg, matches, queued):
    req, member, match, outcome = (
        (JaxRequest, JaxMember, JaxMatch, JaxOutcome) if pkg == "jax"
        else (SearchRequest, PartyMember, Match, SearchOutcome))
    return outcome(
        matches=[match(match_id=mid, teams=tuple(
            tuple(_req(req, member, *r) for r in team) for team in teams),
            quality=1.0) for mid, teams in matches],
        queued=[_req(req, member, *r) for r in queued])


def _both(team_size, feed):
    """Run ``feed(checker, pkg)`` on both checkers; returns each one's
    violation text (or None)."""
    out = []
    for pkg, mod in (("port", invariants), ("jax", jax_inv)):
        checker = mod.InvariantChecker(team_size)
        try:
            feed(checker, pkg)
            out.append(None)
        except mod.InvariantViolation as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("case", ["double_match", "repeat_in_match",
                                  "team_size", "requeue_releases",
                                  "party_double_match"])
def test_checker_raises_as_jax_does(case):
    def feed(checker, pkg):
        cols = ColumnarOutcome if pkg == "port" else JaxColumnar
        if case == "double_match":
            checker.observe_outcome(_columnar(cols, [("a", "b", "m1")], ["c"]))
            checker.observe_outcome(_columnar(cols, [("c", "a", "m2")], []))
        elif case == "repeat_in_match":
            checker.observe_outcome(_columnar(cols, [("a", "a", "m1")], []))
        elif case == "team_size":
            checker.observe_outcome(_objects(pkg, [
                ("m1", ((("a",), ("b",)), (("c",),)))], []))
        elif case == "requeue_releases":
            checker.observe_outcome(_columnar(cols, [("a", "b", "m1")], []))
            checker.observe_outcome(_columnar(cols, [], ["a", "b"]))
            checker.observe_outcome(_objects(pkg, [], [("c", ("d",))]))
            checker.observe_outcome(_columnar(cols, [("a", "b", "m2")], []))
        else:  # a party member matched again through its leader's copy
            checker.observe_outcome(_objects(pkg, [
                ("m1", ((("a", ("x",)),), (("b", ("y",)),)))], []))
            checker.observe_outcome(_objects(pkg, [
                ("m2", ((("x",), ("c",)), (("d",), ("e",))))], []))

    team = 2 if case in ("team_size", "party_double_match") else 1
    mine, theirs = _both(team, feed)
    assert mine == theirs
    if case == "requeue_releases":
        assert mine is None
    else:
        assert mine is not None


def _cfg():
    cfg = Config.from_json(CONFIG1, backend="gpu")
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, pool_capacity=1024,
                                        pool_block=256, batch_buckets=(16, 64)),
        batcher=BatcherConfig(max_batch=2, max_wait_ms=50.0),
        observability=ObservabilityConfig(trace=False),
        debug_invariants=True)


async def test_app_catches_a_forced_double_match():
    app = MatchmakingApp(_cfg(), device="cpu")
    await app.start()
    rt = app.runtime(Q)
    eng = rt.engine
    seen: list = []

    def forge(pairs):
        # The first collected window is kept; the second window's outcome
        # is replaced by it: its players matched a second time.
        out = []
        for tok, o in pairs:
            if not seen:
                seen.append(o)
            elif len(seen) == 1:
                seen.append(o)
                o = seen[0]
            out.append((tok, o))
        return out

    real_ready, real_flush = eng.collect_ready, eng.flush
    eng.collect_ready = lambda: forge(real_ready())
    eng.flush = lambda: forge(real_flush())
    answers: dict = {}

    async def on_reply(d):
        answers.setdefault(d.properties.correlation_id, []).append(
            json.loads(d.body))

    app.broker.declare_queue("inv.replies")
    app.broker.basic_consume("inv.replies", on_reply, prefetch=1_000_000)
    try:
        for batch in ((("a", 1500.0), ("b", 1501.0)),
                      (("c", 1700.0), ("d", 1701.0))):
            for pid, rating in batch:
                app.broker.publish(Q, json.dumps(
                    {"id": pid, "rating": rating}).encode(), Properties(
                    reply_to="inv.replies", correlation_id=pid))
            for _ in range(200):
                await asyncio.sleep(0.02)
                if len(seen) == (1 if batch[0][0] == "a" else 2) and (
                        rt.counters["outcome_errors"] or batch[0][0] == "a"):
                    break
        for _ in range(50):
            await asyncio.sleep(0.02)
            if rt.counters["outcome_errors"]:
                break
    finally:
        eng.collect_ready, eng.flush = real_ready, real_flush
        await app.stop()
    assert rt.counters["outcome_errors"] == 1
    assert "outcome_errors" in app.faults()
    # The forged window published nothing: a and b hold one match each
    # (its redelivered players c and d are matched by a later window).
    for pid in ("a", "b"):
        assert [r["status"] for r in answers[pid]].count("matched") == 1
