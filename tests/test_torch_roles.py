"""The role-queue window step (config #5) against the JAX package's, on
the CPU.

Step level: the port's ``RoleKernelSet`` and the JAX one (JAX on the CPU)
on the same seeded pool (role masks included) and three windows in a row,
for two and five role slots, with widening off and at 2/s (an exact
product: see tests/test_torch_teams.py on the fused multiply-add). Slots,
spread, limit, split bits and the pool after each step are bit-equal.
``_cover_split`` (the Hall check over the 1 + k² splits) is compared on
every combination of member masks for team size 2, and on seeded masks for
team size 5.

Engine level: ``GpuEngine`` (device="cpu") against ``TpuEngine`` over
eight windows of a role queue from ``configs/role_party.json`` (cut to a
256-slot pool) with declared roles: the same teams per match (the split
too), queued sets and pool, and a party that hands the queue to the host
oracle and, once it leaves, back at the same windows.
"""

import dataclasses
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.engine.role_kernels import role_kernel_set as jax_role_set
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service.contract import PartyMember as JaxMember
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.engine.role_kernels import RoleKernelSet
from matchmaking_tpu_torch.service.contract import PartyMember, SearchRequest
from test_torch_teams import M, P, run_steps, teams_of

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS5 = ("tank", "healer", "dps", "dps", "dps")
SLOTS2 = ("tank", "dps")


def sets(slots, widen=0.0):
    jax_set = jax_role_set(P, len(slots), slots, widen, 300.0, M, 16)
    port_set = RoleKernelSet(capacity=P, team_size=len(slots),
                             role_slots=slots, widen_per_sec=widen,
                             max_threshold=300.0, max_matches=M)
    return jax_set, port_set


@pytest.mark.parametrize("slots,widen", [(SLOTS2, 0.0), (SLOTS2, 2.0),
                                         (SLOTS5, 0.0)])
def test_role_step_bit_equal_to_jax(slots, widen):
    jax_set, port_set = sets(slots, widen)
    assert port_set.pack_rows == jax_set.pack_rows == 10
    assert port_set.full_mask == jax_set.full_mask
    for roles in [(), ("tank",), ("dps", "tank"), ("healer",), ("bard",)]:
        assert port_set.mask_of(roles) == jax_set.mask_of(roles)
    formed = run_steps(jax_set, port_set, seed=len(slots) + int(widen),
                       extra=("role_mask",))
    assert formed >= (10 if len(slots) == 2 else 2)


@pytest.mark.parametrize("slots", [SLOTS2, ("dps", "dps")])
def test_cover_split_every_mask_team_of_two(slots):
    jax_set, port_set = sets(slots)
    n_masks = jax_set.full_mask + 1
    masks = np.array(list(itertools.product(range(n_masks), repeat=4)),
                     np.int32)
    j_ok, j_split = jax_set._cover_split(jnp.asarray(masks))
    t_ok, t_split = port_set._cover_split(torch.from_numpy(masks))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(t_split.numpy(), np.asarray(j_split))
    assert 0 < int(t_ok.sum()) < len(masks)


def test_cover_split_seeded_masks_team_of_five():
    jax_set, port_set = sets(SLOTS5)
    masks = np.random.default_rng(1).integers(0, 8, (4096, 10)).astype(np.int32)
    j_ok, j_split = jax_set._cover_split(jnp.asarray(masks))
    t_ok, t_split = port_set._cover_split(torch.from_numpy(masks))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(t_split.numpy(), np.asarray(j_split))
    # Swap repairs (split ≠ the base 0b11111) are among the answers.
    assert (t_split.numpy()[t_ok.numpy()] != 31).any()


def role_engines():
    path = os.path.join(ROOT, "configs/role_party.json")
    small = dict(pool_capacity=256, pool_block=64, batch_buckets=(16, 64),
                 team_max_matches=32)
    jcfg, tcfg = JaxConfig.from_json(path), Config.from_json(path,
                                                             backend="gpu")
    jcfg = dataclasses.replace(jcfg, engine=dataclasses.replace(jcfg.engine,
                                                                **small))
    tcfg = dataclasses.replace(tcfg, engine=dataclasses.replace(tcfg.engine,
                                                                **small))
    jq, tq = jcfg.queues[0], tcfg.queues[0]
    assert tq.role_slots == tuple(jq.role_slots) == SLOTS5
    return TpuEngine(jcfg, jq), GpuEngine(tcfg, tq, device="cpu")


def role_rows(rng, n, start, t):
    rows = []
    for i in range(n):
        k = int(rng.choice([0, 1, 1, 1, 2]))
        rows.append(dict(
            id=f"p{start + i}", rating=float(rng.normal(1500, 150)),
            region="eu", game_mode=str(rng.choice(["ranked", "casual"])),
            roles=tuple(rng.choice(["tank", "healer", "dps"], k,
                                   replace=False)),
            enqueued_at=t - float(rng.uniform(0, 10))))
    return rows


def test_engine_equals_tpu_engine_with_party_delegation():
    jeng, teng = role_engines()
    rng = np.random.default_rng(8)
    t, pid, party_at, matched, counters = 1_700_000_000.0, 0, 3, 0, []
    for w in range(8):
        rows = role_rows(rng, int(rng.integers(15, 40)), pid, t)
        pid += len(rows)
        jreqs = [JaxRequest(**k) for k in rows]
        treqs = [SearchRequest(**k) for k in rows]
        if w == party_at:  # a 2-player party far from everyone
            lead = dict(id="party", rating=-5000.0, region="eu",
                        game_mode="ranked", roles=("tank",), enqueued_at=t)
            jreqs.append(JaxRequest(**lead, party=(
                JaxMember("party2", -5000.0, roles=("dps",)),)))
            treqs.append(SearchRequest(**lead, party=(
                PartyMember("party2", -5000.0, roles=("dps",)),)))
        if w == party_at + 1:
            assert teng.remove("party").id == jeng.remove("party").id
            t += 10.0  # past the 5 s quiet period
        jout, tout = jeng.search(jreqs, t), teng.search(treqs, t)
        assert teams_of(tout) == teams_of(jout), w
        assert [r.id for r in tout.queued] == [r.id for r in jout.queued]
        assert teng.pool_size() == jeng.pool_size()
        counters.append(dict(teng.counters))
        assert teng.counters == {k: v for k, v in jeng.counters.items()
                                 if k.startswith("team_")}
        matched += len(tout.matches)
        t += 3.0
    assert counters[party_at - 1] == {}
    assert counters[party_at] == {"team_delegated": 1}
    assert counters[party_at + 1] == {"team_delegated": 1,
                                      "team_repromoted": 1}
    assert matched >= 6
    assert ([dataclasses.asdict(r) for r in teng.waiting()]
            == [dataclasses.asdict(r) for r in jeng.waiting()])
