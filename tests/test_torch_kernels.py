"""The port's dense window step vs the JAX package's ``KernelSet``.

Same seeded pool and windows into both: ``KernelSet.search_step`` (port,
CPU tensors, plain versions of the kernels) against the JAX
``KernelSet._search_step``, five windows chained on the pool. Matched slot
pairs must be equal, distances equal (ELO bit-exact; Glicko-2 within the
3 ulp explained in test_torch_block_best.py), and after every step the
port's pool must equal the JAX pool field by field.

Every packed step (dense, without filters, pruned, rescan; the team and
role steps) reads the window's time on the device from the packed
window's last row, as the JAX steps read ``packed[8, 0]``: held to the
JAX packed steps at two times on the same window.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchmaking_tpu.core.pool import PlayerPool as JaxPlayerPool
from matchmaking_tpu.engine.kernels import KernelSet as JaxKernelSet
from matchmaking_tpu.engine.kernels import _admit_block as jax_admit_block
from matchmaking_tpu.engine.kernels import greedy_pair as jax_greedy_pair
from matchmaking_tpu_torch.core.pool import POOL_FIELDS
from matchmaking_tpu_torch.engine.kernels import (
    DevicePool,
    KernelSet,
    admit,
    fresh_pool,
    greedy_pair,
    packed_now,
    pool_from_reference,
    pool_to_numpy,
    unpack_batch,
)

# Small tensors: one intra-op thread each leaves the cores to the other
# test workers (several run side by side).
torch.set_num_threads(1)

GLICKO_ULP = 3


def ulp_diff(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def seeded_pool(rng, capacity, n, filters):
    arrs = JaxPlayerPool.empty_device_arrays(capacity)
    arrs["rating"][:n] = rng.normal(1500, 300, n).astype(np.float32)
    arrs["rd"][:n] = rng.uniform(0, 350, n).astype(np.float32)
    if filters:
        arrs["region"][:n] = rng.integers(0, 3, n)
        arrs["mode"][:n] = rng.integers(0, 2, n)
    arrs["threshold"][:n] = rng.choice([50.0, 100.0, 150.0], n)
    arrs["enqueue_t"][:n] = rng.uniform(0, 5, n)
    arrs["active"][:n] = True
    return arrs


def seeded_window(rng, b, n_valid, start_slot, capacity, filters):
    """An f32[9, b] packed window (core.pool.PACKED_ROWS + now row) with
    ``n_valid`` real lanes and sentinel padding after them."""
    packed = np.zeros((9, b), np.float32)
    packed[0] = capacity
    packed[0, :n_valid] = np.arange(start_slot, start_slot + n_valid)
    packed[1, :n_valid] = rng.normal(1500, 300, n_valid)
    packed[2, :n_valid] = rng.uniform(0, 350, n_valid)
    if filters:
        packed[3, :n_valid] = rng.integers(0, 3, n_valid)
        packed[4, :n_valid] = rng.integers(0, 2, n_valid)
    packed[5, :n_valid] = rng.choice([50.0, 100.0, 150.0], n_valid)
    packed[6, :n_valid] = rng.uniform(0, 5, n_valid)
    packed[7, :n_valid] = 1.0
    return packed


def jax_batch(packed):
    return {
        "slot": jnp.asarray(packed[0].astype(np.int32)),
        "rating": jnp.asarray(packed[1]),
        "rd": jnp.asarray(packed[2]),
        "region": jnp.asarray(packed[3].astype(np.int32)),
        "mode": jnp.asarray(packed[4].astype(np.int32)),
        "threshold": jnp.asarray(packed[5]),
        "enqueue_t": jnp.asarray(packed[6]),
        "valid": jnp.asarray(packed[7] > 0),
    }


def pairs_by_slots(q, c, d, capacity):
    """{frozenset(q, c): dist} over formed pairs. Under Glicko-2 the JAX
    CPU distance is not symmetric in its two players (its FMA-fused
    ``a*a + b*b`` rounds differently with the operands swapped), so when two
    window players propose each other the JAX engine can give the pair to
    either lane, where the port's symmetric tie goes to the lower lane —
    the same pair, held by the other lane."""
    hit = q < capacity
    return {frozenset((int(a), int(b))): np.float32(x)
            for a, b, x in zip(q[hit], c[hit], d[hit])}


CASES = {
    "elo": dict(glicko2=False, widen=0.0, filters=False),
    "glicko2": dict(glicko2=True, widen=0.0, filters=False),
    "widen": dict(glicko2=False, widen=7.0, filters=False),
    "filters": dict(glicko2=False, widen=0.0, filters=True),
    "glicko2_widen_filters": dict(glicko2=True, widen=5.0, filters=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_search_step_chain_matches_jax(case):
    c = CASES[case]
    rng = np.random.default_rng(21)
    P, B = 1024, 64
    geo = dict(capacity=P, top_k=8, pool_block=256, glicko2=c["glicko2"],
               widen_per_sec=c["widen"], max_threshold=250.0, pair_rounds=8)
    jks, tks = JaxKernelSet(**geo), KernelSet(**geo)
    assert (tks.pool_block, tks.n_blocks) == (jks.pool_block, jks.n_blocks)
    pool_np = seeded_pool(rng, P, 400, c["filters"])
    jpool = {k: jnp.asarray(v) for k, v in pool_np.items()}
    tpool = pool_from_reference(pool_np, "cpu")
    matched_total = 0
    for w in range(5):
        n_valid = B if w % 2 == 0 else 40  # a ragged window too
        packed = seeded_window(rng, B, n_valid, 400 + w * B, P, c["filters"])
        now = float(np.float32(5.0 + 2.0 * w))
        packed[8] = now
        jpool, jq, jc, jd = jks._search_step(jpool, jax_batch(packed),
                                             jnp.float32(now))
        tpacked = torch.from_numpy(packed)
        tq, tc, td = tks.search_step(tpool, unpack_batch(tpacked),
                                     packed_now(tpacked))
        jq, jc, jd = np.asarray(jq), np.asarray(jc), np.asarray(jd)
        tq, tc, td = tq.numpy(), tc.numpy(), td.numpy()
        if c["glicko2"]:
            # Same pairs and distances; the lane that holds a pair of two
            # window players may differ (see pairs_by_slots).
            tp, jp = pairs_by_slots(tq, tc, td, P), pairs_by_slots(jq, jc, jd, P)
            assert tp.keys() == jp.keys()
            assert max((ulp_diff(tp[k], jp[k]) for k in tp),
                       default=0) <= GLICKO_ULP
        else:
            np.testing.assert_array_equal(tq, jq)
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(td, jd)
        hit = jq < P
        matched_total += int(hit.sum())
        assert (td[tq == P] == np.inf).all()
        port_np = pool_to_numpy(tpool)
        for name, _ in POOL_FIELDS:
            np.testing.assert_array_equal(port_np[name], np.asarray(jpool[name]),
                                          err_msg=f"window {w} field {name}")
    assert matched_total >= 20  # the windows form real matches


def test_packed_step_layout():
    """search_step_packed returns f32[3, B] = (q_slot, c_slot, dist)."""
    rng = np.random.default_rng(2)
    P = 1024
    tks = KernelSet(capacity=P, top_k=8, pool_block=256, glicko2=False,
                    widen_per_sec=0.0, max_threshold=400.0)
    pool = pool_from_reference(seeded_pool(rng, P, 300, False), "cpu")
    packed = torch.from_numpy(seeded_window(rng, 64, 64, 300, P, False))
    out = tks.search_step_packed(pool, packed)
    assert out.shape == (3, 64) and out.dtype == torch.float32
    hit = out[0] < P
    assert hit.any()
    assert (out[2][~hit] == float("inf")).all()


def test_skip_filters_equals_filtered_step_on_all_any_window():
    rng = np.random.default_rng(8)
    P, B = 1024, 64
    geo = dict(capacity=P, top_k=8, pool_block=256, glicko2=True,
               widen_per_sec=3.0, max_threshold=300.0)
    pool_np = seeded_pool(rng, P, 500, filters=True)  # pool has filters
    packed = torch.from_numpy(seeded_window(rng, B, B, 500, P, filters=False))
    packed[8] = 4.0
    outs = []
    for skip in (False, True):
        pool = pool_from_reference(pool_np, "cpu")
        out = KernelSet(**geo).search_step_packed(pool, packed,
                                                  skip_filters=skip)
        outs.append((out, pool_to_numpy(pool)))
    assert torch.equal(outs[0][0], outs[1][0])
    for name, _ in POOL_FIELDS:
        np.testing.assert_array_equal(outs[0][1][name], outs[1][1][name])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_pair_matches_jax(seed):
    """Pairing alone, on candidate lists full of exact score ties and
    shared endpoints, with and without a permuted ``rid`` tie-break."""
    rng = np.random.default_rng(seed)
    B, K, P = 48, 6, 256
    vals = -rng.integers(0, 5, (B, K)).astype(np.float32)
    vals[rng.random((B, K)) < 0.2] = -np.inf
    idxs = rng.integers(0, 80, (B, K)).astype(np.int32)
    idxs[np.isinf(vals)] = P
    self_slot = rng.permutation(80)[:B].astype(np.int32)
    self_slot[-4:] = P  # padding lanes
    vals[-4:] = -np.inf
    vals[idxs == self_slot[:, None]] = -np.inf  # no request proposes itself
    for rid in (None, rng.permutation(B).astype(np.int32)):
        jq, jc, jd = jax_greedy_pair(
            jnp.asarray(vals), jnp.asarray(idxs), jnp.asarray(self_slot), P,
            rounds=4, rid=None if rid is None else jnp.asarray(rid))
        tq, tc, td = greedy_pair(
            torch.from_numpy(vals), torch.from_numpy(idxs),
            torch.from_numpy(self_slot), P, rounds=4,
            rid=None if rid is None else torch.from_numpy(rid))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        formed = tq.numpy() < P
        assert formed.sum() >= 5
        ends = np.concatenate([tq.numpy()[formed], tc.numpy()[formed]])
        assert len(set(ends.tolist())) == ends.size  # conflict-free


@pytest.mark.parametrize("n_valid", [64, 40, 0])
def test_admit_with_padding_matches_jax(n_valid):
    """Sync-free admission: padding lanes (slot = capacity) write into the
    pool's spare element, and the pool's visible slots equal the JAX
    ``_admit_block`` on the same numpy inputs."""
    rng = np.random.default_rng(5)
    P, B = 1024, 64
    pool_np = seeded_pool(rng, P, 300, filters=True)
    packed = seeded_window(rng, B, n_valid, 300, P, filters=True)
    packed[1, n_valid:] = 7777.0  # padding lanes carry values of their own
    jpool = jax_admit_block({k: jnp.asarray(v) for k, v in pool_np.items()},
                            0, P, jax_batch(packed))
    tpool = pool_from_reference(pool_np, "cpu")
    admit(tpool, unpack_batch(torch.from_numpy(packed)))
    port_np = pool_to_numpy(tpool)
    for name, _ in POOL_FIELDS:
        assert port_np[name].shape == (P,)
        np.testing.assert_array_equal(port_np[name], np.asarray(jpool[name]),
                                      err_msg=name)
    assert int(port_np["active"].sum()) == 300 + n_valid


def test_admit_refuses_a_pool_without_its_spare():
    pool = {k: v.clone() for k, v in fresh_pool(256, "cpu").items()}
    packed = torch.from_numpy(seeded_window(np.random.default_rng(0), 16, 8,
                                            0, 256, False))
    with pytest.raises(ValueError, match="spare"):
        admit(pool, unpack_batch(packed))


@pytest.mark.parametrize("make", ["fresh_pool", "pool_from_reference"])
def test_device_pool_columns_view_the_spare_tensors(make):
    """Each column is the first ``capacity`` elements of ``pool.full``,
    and a write to the spare element shows in no column."""
    P = 256
    pool = (fresh_pool(P, "cpu") if make == "fresh_pool" else
            pool_from_reference(seeded_pool(np.random.default_rng(3), P, 100,
                                            True), "cpu"))
    assert isinstance(pool, DevicePool) and set(pool) == set(pool.full)
    for name, _ in POOL_FIELDS:
        full = pool.full[name]
        assert full.shape == (P + 1,) and pool[name].shape == (P,)
        assert pool[name].data_ptr() == full.data_ptr()
        before = pool[name].clone()
        full[P] = 1
        assert torch.equal(pool[name], before)
        full[0] = 1
        assert bool(pool[name][0] == 1)


# ---- the window's time, read on the device from the packed window ----------

NOW_VARIANTS = ("dense", "nofilter", "pruned", "rescan")


def assert_step_outputs(tout, jout, glicko2, capacity):
    """ELO: every lane bit for bit. Glicko-2: the same pairs, distances
    within GLICKO_ULP (see pairs_by_slots)."""
    if not glicko2:
        np.testing.assert_array_equal(tout.view(np.int32), jout.view(np.int32))
        return
    tp = pairs_by_slots(tout[0], tout[1], tout[2], capacity)
    jp = pairs_by_slots(jout[0], jout[1], jout[2], capacity)
    assert tp.keys() == jp.keys()
    assert max((ulp_diff(tp[k], jp[k]) for k in tp), default=0) <= GLICKO_ULP


@pytest.mark.parametrize("glicko2", [False, True], ids=["elo", "glicko2"])
@pytest.mark.parametrize("variant", NOW_VARIANTS)
def test_packed_steps_read_now_from_row_8_like_jax(variant, glicko2):
    """Each packed 1v1 step (dense, without filters, pruned, rescan) reads
    the window's time from row 8 on the device, as the JAX steps read
    ``packed[8, 0]``: at two times 20 s apart its result and pool equal
    the JAX packed step's on the same window. Everyone is enqueued at 20 s
    with a threshold of 0.5, widening 7/s: at 6 s nobody has waited, at 26
    s everyone has; the window with only row 8 moved matches more players,
    so the step follows row 8 and no other time reaches it."""
    P, B = 1024, 64
    rng = np.random.default_rng(41 + NOW_VARIANTS.index(variant) * 2 + glicko2)
    geo = dict(capacity=P, top_k=8, pool_block=128, glicko2=glicko2,
               widen_per_sec=7.0, max_threshold=250.0, pair_rounds=8)
    prune = (dict(prune_window_blocks=3, prune_chunk=16)
             if variant == "pruned" else {})
    jks, tks = JaxKernelSet(**geo, **prune), KernelSet(**geo, **prune)
    filters = variant != "nofilter"
    pool_np = seeded_pool(rng, P, 500, filters=True)
    # Everyone enqueued at t = 20 with a threshold of 0.5: at t = 6 nobody
    # has waited (limit 0.5), at t = 26 everyone has waited 6 s (42.5).
    pool_np["threshold"][:] = 0.5
    pool_np["enqueue_t"][:] = 20.0
    if variant == "rescan":  # waiting players, as the mirror lists them
        slots = np.sort(rng.choice(500, 48, replace=False))
        packed = np.zeros((9, B), np.float32)
        packed[0] = P
        packed[0, :48] = slots
        for row, name in ((1, "rating"), (2, "rd"), (3, "region"),
                          (4, "mode"), (5, "threshold"), (6, "enqueue_t")):
            packed[row, :48] = pool_np[name][slots]
        packed[7, :48] = 1.0
    else:
        packed = seeded_window(rng, B, 56, 500, P, filters)
        packed[5, :56] = 0.5
        packed[6, :56] = 20.0
    jstep = {"dense": jks.search_step_packed,
             "nofilter": jks.search_step_packed_nofilter,
             "pruned": jks.search_step_packed,
             "rescan": jks.search_step_packed_rescan}[variant]
    tstep = {"dense": tks.search_step_packed,
             "nofilter": lambda pool, p: tks.search_step_packed(
                 pool, p, skip_filters=True),
             "pruned": tks.search_step_packed,
             "rescan": tks.search_step_packed_rescan}[variant]
    outs = []
    for now in (6.0, 26.0):
        packed[8] = now
        jpool, jout = jstep({k: jnp.asarray(v) for k, v in pool_np.items()},
                            jnp.asarray(packed))
        tpool = pool_from_reference(pool_np, "cpu")
        tout = tstep(tpool, torch.from_numpy(packed.copy())).numpy()
        assert_step_outputs(tout, np.asarray(jout), glicko2, P)
        port_np = pool_to_numpy(tpool)
        for name, _ in POOL_FIELDS:
            np.testing.assert_array_equal(port_np[name],
                                          np.asarray(jpool[name]), name)
        outs.append(tout)
    assert (outs[1][0] < P).sum() > (outs[0][0] < P).sum()


@pytest.mark.parametrize("kind", ["team", "role"])
def test_team_and_role_steps_read_now_from_their_last_row_like_jax(kind):
    """The team and role steps read the window's time from the packed
    window's last row (row 8 of the team window, row 9 of the role
    window): at two times 30 s apart (widening 2/s) their results and
    pools equal the JAX steps' bit for bit, and differ from each other."""
    from matchmaking_tpu.engine.role_kernels import (
        role_kernel_set as jax_role_set,
    )
    from matchmaking_tpu.engine.teams import team_kernel_set as jax_team_set
    from matchmaking_tpu_torch.engine.role_kernels import RoleKernelSet
    from matchmaking_tpu_torch.engine.teams import TeamKernelSet

    P, B, M = 512, 64, 64
    slots5 = ("tank", "healer", "dps", "dps", "dps")
    if kind == "team":
        jset = jax_team_set(P, 5, 2.0, 300.0, M, 16)
        tset = TeamKernelSet(capacity=P, team_size=5, widen_per_sec=2.0,
                             max_threshold=300.0, max_matches=M)
    else:
        jset = jax_role_set(P, 5, slots5, 2.0, 300.0, M, 16)
        tset = RoleKernelSet(capacity=P, team_size=5, role_slots=slots5,
                             widen_per_sec=2.0, max_threshold=300.0,
                             max_matches=M)
    rng = np.random.default_rng(47 + (kind == "role"))
    pool_np = JaxPlayerPool.empty_device_arrays(P)
    pool_np["rating"] = rng.normal(1500, 200, P).astype(np.float32)
    pool_np["region"] = rng.integers(1, 3, P).astype(np.int32)
    pool_np["mode"] = rng.integers(1, 3, P).astype(np.int32)
    pool_np["threshold"] = rng.choice([20.0, 40.0, 60.0], P).astype(np.float32)
    pool_np["enqueue_t"] = rng.uniform(0, 5, P).astype(np.float32)
    pool_np["active"] = rng.random(P) < 0.6
    if tset.is_role:
        pool_np["role_mask"] = rng.integers(1, 8, P).astype(np.int32)
    free = np.nonzero(~pool_np["active"])[0][:B - 4]
    packed = np.zeros((tset.pack_rows, B), np.float32)
    packed[0] = P
    packed[0, :free.size] = free
    packed[1, :free.size] = rng.normal(1500, 200, free.size)
    packed[3, :free.size] = rng.integers(1, 3, free.size)
    packed[4, :free.size] = rng.integers(1, 3, free.size)
    packed[5, :free.size] = 40.0
    packed[6, :free.size] = rng.uniform(0, 5, free.size)
    packed[7, :free.size] = 1.0
    if tset.is_role:
        packed[8, :free.size] = rng.integers(1, 8, free.size)
    outs = []
    for now in (6.0, 36.0):
        packed[-1] = now
        jpool, jout = jset.search_step_packed(
            {k: jnp.asarray(v) for k, v in pool_np.items()},
            jnp.asarray(packed))
        tpool = pool_from_reference(pool_np, "cpu", tset.extra_pool_fields)
        tout = tset.search_step_packed(tpool,
                                       torch.from_numpy(packed.copy())).numpy()
        np.testing.assert_array_equal(tout.view(np.int32),
                                      np.asarray(jout).view(np.int32))
        port_np = pool_to_numpy(tpool)
        for name, col in jpool.items():
            np.testing.assert_array_equal(port_np[name], np.asarray(col), name)
        outs.append(tout)
    assert (outs[1][0] < P).sum() > (outs[0][0] < P).sum()
