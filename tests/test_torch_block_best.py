"""The port's block-best candidate stage vs the JAX package's.

``cuda_kernels.block_best_reference`` (the plain twin of the hand-written
CUDA kernel, which is what ``block_best`` runs on CPU tensors) against the
Pallas kernel ``pallas_block_best`` in interpret mode and against the XLA
scan ``KernelSet._candidates``, on the same seeded inputs.

Tolerances: candidate slots must be equal position by position, and ELO
values bit-equal (|Δrating| is one exactly rounded op on both sides). Under
Glicko-2 the values may differ by at most ``GLICKO_ULP`` ulp: the port
rounds every f32 op on its own (as the CUDA kernel does), while the JAX CPU
compiler fuses ``a*a + b*b`` and ``1 + G*x`` into FMAs and lowers
``1 / x**0.5`` to ``pow(x, -0.5)`` — three ops that each may land one ulp
apart, measured at most 3 ulp apart in the distance over 2e5 random pairs.

The kernel itself only runs on the card: tests/test_torch_cuda.py holds it
bit-equal to the plain version there and skips elsewhere (``chip_smoke.py``
makes the same check at full width).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchmaking_tpu.core.pool import PlayerPool as JaxPlayerPool
from matchmaking_tpu.engine.kernels import KernelSet as JaxKernelSet
from matchmaking_tpu.engine.kernels import _effective_threshold
from matchmaking_tpu.engine.pallas_kernels import (
    pack_batch_rows,
    pack_pool_rows,
    pallas_block_best,
)
from matchmaking_tpu_torch.engine import cuda_kernels, scoring
from matchmaking_tpu_torch.engine.kernels import (
    effective_pool_block,
    pool_from_reference,
)

# Small tensors: one intra-op thread each leaves the cores to the other
# test workers (several run side by side).
torch.set_num_threads(1)

GLICKO_ULP = 3


def ordered(x):
    """f32 array → int64 keys whose differences count ulps across signs."""
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def assert_vals(port, ref, ulp):
    port, ref = np.asarray(port), np.asarray(ref)
    finite = np.isfinite(ref)
    assert (finite == np.isfinite(port)).all()
    assert (port[~finite] == ref[~finite]).all()
    diff = np.abs(ordered(port[finite]) - ordered(ref[finite]))
    assert diff.max(initial=0) <= ulp, f"max {diff.max()} ulp > {ulp}"


def make_pool(rng, capacity, active_n, filters, thr=100.0):
    arrs = JaxPlayerPool.empty_device_arrays(capacity)
    arrs["rating"][:active_n] = rng.normal(1500, 300, active_n).astype(np.float32)
    arrs["rd"][:active_n] = rng.uniform(0, 350, active_n).astype(np.float32)
    if filters:
        arrs["region"][:active_n] = rng.integers(0, 3, active_n)
        arrs["mode"][:active_n] = rng.integers(0, 2, active_n)
    arrs["threshold"][:active_n] = thr
    arrs["enqueue_t"][:active_n] = rng.uniform(0, 5, active_n)
    arrs["active"][:active_n] = True
    return arrs


def make_batch(rng, b, start_slot, filters, thr=100.0):
    return {
        "slot": np.arange(start_slot, start_slot + b, dtype=np.int32),
        "rating": rng.normal(1500, 300, b).astype(np.float32),
        "rd": rng.uniform(0, 350, b).astype(np.float32),
        "region": (rng.integers(0, 3, b) if filters
                   else np.zeros(b)).astype(np.int32),
        "mode": (rng.integers(0, 2, b) if filters
                 else np.zeros(b)).astype(np.int32),
        "threshold": np.full(b, thr, np.float32),
        "enqueue_t": rng.uniform(0, 5, b).astype(np.float32),
        "valid": np.ones(b, bool),
    }


def now_tensor(now):
    """The window's time as the port's kernels take it: a one-element f32
    tensor (the packed window's now row)."""
    return torch.tensor([now], dtype=torch.float32)


def port_candidates(ks, pool_np, batch_np, q_thr_eff, now, filters=True):
    pool = pool_from_reference(pool_np, "cpu")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch_np.items()}
    v, i = cuda_kernels.block_best(
        pool, batch, torch.from_numpy(np.array(q_thr_eff, np.float32)),
        now_tensor(now),
        pool_block=ks.pool_block, glicko2=ks.glicko2, filters=filters,
        widen_per_sec=ks.widen_per_sec, max_threshold=ks.max_threshold,
        g_coeff=scoring.G_COEFF_F32)
    return v.numpy(), i.numpy()


def jax_candidates(ks, pool_np, batch_np, q_thr_eff, now):
    pool = {k: jnp.asarray(v) for k, v in pool_np.items()}
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    xla_v, xla_i = ks._candidates(batch, q_thr_eff, pool, jnp.float32(now))
    pal_v, pal_i = pallas_block_best(
        pack_pool_rows(pool), pack_batch_rows(batch, q_thr_eff),
        jnp.float32(now), super_blk=ks.pool_block, sub_blk=2048, b_tile=256,
        capacity=ks.capacity, glicko2=ks.glicko2,
        widen_per_sec=ks.widen_per_sec, max_threshold=ks.max_threshold,
        interpret=True)
    return ((np.asarray(xla_v), np.asarray(xla_i)),
            (np.asarray(pal_v), np.asarray(pal_i)))


CASES = {
    "elo": dict(glicko2=False, widen=0.0, filters=False),
    "glicko2": dict(glicko2=True, widen=0.0, filters=False),
    "widen": dict(glicko2=False, widen=7.0, filters=False),
    "filters": dict(glicko2=False, widen=0.0, filters=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_pallas_and_xla(case):
    c = CASES[case]
    rng = np.random.default_rng(7)
    P, B = 1024, 64
    ks = JaxKernelSet(capacity=P, top_k=8, pool_block=256,
                      glicko2=c["glicko2"], widen_per_sec=c["widen"],
                      max_threshold=300.0)
    assert effective_pool_block(P, 256, 8) == ks.pool_block
    pool = make_pool(rng, P, 700, c["filters"])
    batch = make_batch(rng, B, 700, c["filters"])
    now = 9.0
    q_thr = np.asarray(_effective_threshold(
        jnp.asarray(batch["threshold"]), jnp.asarray(batch["enqueue_t"]),
        jnp.float32(now), c["widen"], 300.0))
    pv, pi = port_candidates(ks, pool, batch, q_thr, now)
    ulp = GLICKO_ULP if c["glicko2"] else 0
    for ref_v, ref_i in jax_candidates(ks, pool, batch, q_thr, now):
        assert pv.shape == ref_v.shape == (B, ks.n_blocks)
        np.testing.assert_array_equal(pi, ref_i)
        assert_vals(pv, ref_v, ulp)
    assert np.isfinite(pv).mean() > 0.5  # the data exercises real candidates
    if not c["filters"]:
        # All-ANY window: the no-filter variant is identical.
        nv, ni = port_candidates(ks, pool, batch, q_thr, now, filters=False)
        np.testing.assert_array_equal(ni, pi)
        np.testing.assert_array_equal(nv, pv)


def test_reference_small_ragged_bucket():
    """B=16 against 4 blocks of 64 (a geometry where no dimension is a
    multiple of the kernel's 32-row CTA or 1,024-slot tile)."""
    rng = np.random.default_rng(11)
    P, B = 256, 16
    ks = JaxKernelSet(capacity=P, top_k=4, pool_block=64, glicko2=False,
                      widen_per_sec=0.0, max_threshold=400.0)
    pool = make_pool(rng, P, 100, filters=True)
    batch = make_batch(rng, B, 100, filters=True)
    pv, pi = port_candidates(ks, pool, batch, batch["threshold"], 1.0)
    for ref_v, ref_i in jax_candidates(ks, pool, batch, batch["threshold"], 1.0):
        assert pv.shape == (B, 4)
        np.testing.assert_array_equal(pi, ref_i)
        assert_vals(pv, ref_v, 0)


def test_exact_ties_take_the_first_slot():
    """Equidistant candidates (1490 and 1510 around a 1500 request, in both
    orders, repeated across a block) tie exactly: the lowest slot wins."""
    P, B = 512, 8
    ks = JaxKernelSet(capacity=P, top_k=4, pool_block=128, glicko2=False,
                      widen_per_sec=0.0, max_threshold=400.0)
    pool = JaxPlayerPool.empty_device_arrays(P)
    ratings = np.array([1510.0, 1490.0, 1600.0, 1490.0, 1510.0], np.float32)
    for blk in range(4):
        base = blk * 128 + 3 * blk  # shift the tie pattern per block
        pool["rating"][base:base + 5] = ratings
        pool["active"][base:base + 5] = True
    pool["threshold"][:] = 100.0
    batch = make_batch(np.random.default_rng(0), B, P, filters=False)
    batch["slot"][:] = P  # not in the pool
    batch["rating"][:] = 1500.0
    pv, pi = port_candidates(ks, pool, batch, batch["threshold"], 0.0)
    expect = np.array([blk * 128 + 3 * blk for blk in range(4)])
    np.testing.assert_array_equal(pi, np.broadcast_to(expect, (B, 4)))
    assert (pv == -10.0).all()
    for ref_v, ref_i in jax_candidates(ks, pool, batch, batch["threshold"], 0.0):
        np.testing.assert_array_equal(pi, ref_i)
        assert_vals(pv, ref_v, 0)


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(3)
    pool = pool_from_reference(make_pool(rng, 256, 10, False), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(rng, 16, 10, False).items()}
    kw = dict(pool_block=64, glicko2=False, filters=True, widen_per_sec=0.0,
              max_threshold=400.0, g_coeff=scoring.G_COEFF_F32)
    thr = batch["threshold"]
    with pytest.raises(ValueError, match="must divide"):
        cuda_kernels.block_best(pool, batch, thr, now_tensor(0.0),
                                **dict(kw, pool_block=100))
    with pytest.raises(ValueError, match="slot"):
        cuda_kernels.block_best(pool, dict(batch, slot=batch["slot"].long()),
                                thr, now_tensor(0.0), **kw)
    with pytest.raises(ValueError, match="rating"):
        cuda_kernels.block_best(dict(pool, rating=pool["rating"][::2]),
                                batch, thr, now_tensor(0.0), **kw)
    with pytest.raises(ValueError, match="now"):  # a host float: refused
        cuda_kernels.block_best(pool, batch, thr, 0.0, **kw)
    before = cuda_kernels.LAUNCHES["block_best"]
    cuda_kernels.block_best(pool, batch, thr, now_tensor(0.0), **kw)
    assert cuda_kernels.LAUNCHES["block_best"] == before  # CPU: no launch


PLAN_SHAPES = ([(b, 16, 8192) for b in (16, 64, 256, 1024)]
               + [(1, 16, 8192), (33, 16, 8192), (16, 4, 64), (1, 8, 128),
                  (33, 2, 1536), (5, 8, 125), (100, 4, 4096)])


@pytest.mark.parametrize("sm_count", [132, 16])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_grid_covers_each_pair_once(shape, sm_count):
    """Every CTA (x, y) of the plan scores rows of group y against the
    slots of cluster rank x % S of block x // S; together they must cover
    every (row, block, slot) exactly once."""
    n_rows, n_blocks, pool_block = shape
    plan = cuda_kernels.plan_grid(n_rows, n_blocks, pool_block, sm_count)
    # One plan per window shape, computed once (the wrapper's host cost).
    assert cuda_kernels.plan_grid(n_rows, n_blocks, pool_block, sm_count) is plan
    rows, s = plan.rows_per_cta, plan.cluster
    assert rows in cuda_kernels.ROWS_PER_CTA
    assert s in (1, 2, 4, 8) and pool_block % s == 0
    assert s == 1 or (pool_block // s) % cuda_kernels.RECORD_ALIGN == 0
    gx, gy = plan.grid
    assert gx == n_blocks * s
    row_hits = np.zeros(n_rows, int)
    slot_hits = np.zeros(n_blocks * pool_block, int)
    slice_ = pool_block // s
    for y in range(gy):
        row_hits[y * rows:min(n_rows, (y + 1) * rows)] += 1
    assert (gy - 1) * rows < n_rows  # no CTA row group is wholly empty
    for x in range(gx):
        blk, rank = divmod(x, s)
        lo = blk * pool_block + rank * slice_
        slot_hits[lo:lo + slice_] += 1
    assert (row_hits == 1).all() and (slot_hits == 1).all()
    if gx * gy < 2 * sm_count:  # short of two CTAs per SM: split no further
        assert rows == 8
        assert s == 8 or not (pool_block % (2 * s) == 0
                              and (pool_block // (2 * s)) % 16 == 0)


def split_merge(pool, batch, q_thr, now, kw, cluster):
    """The kernel's decomposition in plain PyTorch: each cluster rank's
    slice of every block alone, then the merge of the partials (larger
    value, or on equal values the lower slot)."""
    capacity = pool["rating"].shape[0]
    slice_ = kw["pool_block"] // cluster
    rank = (torch.arange(capacity) % kw["pool_block"]) // slice_
    best = None
    for q in range(cluster):
        part = dict(pool, active=pool["active"] & (rank == q))
        v, i = cuda_kernels.block_best_reference(part, batch, q_thr, now, **kw)
        if best is None:
            best = (v, i)
            continue
        bv, bi = best
        take = (v > bv) | ((v == bv) & (i < bi))
        best = (torch.where(take, v, bv), torch.where(take, i, bi))
    return best


@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("case", list(CASES) + ["tie"])
def test_cluster_split_and_merge_equals_whole_block(case, cluster):
    rng = np.random.default_rng(17)
    P, B, blk = 1024, 48, 256
    if case == "tie":
        # 1510 and 1490 around 1500 in every quarter of each block, so the
        # tie spans the cluster's slices: the lowest slot must win.
        c = dict(glicko2=False, widen=0.0, filters=False)
        pool_np = JaxPlayerPool.empty_device_arrays(P)
        firsts = []
        for b in range(P // blk):
            for j, r in enumerate((1510.0, 1490.0, 1490.0, 1510.0)):
                s = b * blk + j * (blk // 4) + 3 + b
                pool_np["rating"][s] = r
                pool_np["active"][s] = True
            firsts.append(b * blk + 3 + b)
        pool_np["threshold"][:] = 100.0
        batch_np = make_batch(rng, B, P, filters=False)
        batch_np["slot"][:] = P
        batch_np["rating"][:] = 1500.0
    else:
        c = CASES[case]
        pool_np = make_pool(rng, P, 700, c["filters"])
        batch_np = make_batch(rng, B, 680, c["filters"])
    pool = pool_from_reference(pool_np, "cpu")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch_np.items()}
    q_thr = batch["threshold"]
    kw = dict(pool_block=blk, glicko2=c["glicko2"], filters=True,
              widen_per_sec=c["widen"], max_threshold=300.0,
              g_coeff=scoring.G_COEFF_F32)
    whole = cuda_kernels.block_best_reference(pool, batch, q_thr,
                                              now_tensor(6.0), **kw)
    merged = split_merge(pool, batch, q_thr, now_tensor(6.0), kw, cluster)
    assert torch.equal(merged[1], whole[1])
    assert torch.equal(merged[0].view(torch.int32), whole[0].view(torch.int32))
    if case == "tie":
        assert torch.equal(whole[1], torch.tensor(firsts, dtype=torch.int32)
                           .expand(B, P // blk))
    else:
        assert torch.isfinite(whole[0]).float().mean() > 0.5


@pytest.mark.parametrize("x", [0.1, -0.0, 1500.123456789, 1e-46, 3.4028235e38,
                               3.4028235677973366e38, 1e39, -1e39,
                               float("inf"), float("nan")])
def test_f32_rounds_like_a_torch_cast(x):
    """The wrapper's host-side f32 rounding (the kernel's scalar arguments)
    equals a cast to torch.float32, bit for bit."""
    want = torch.tensor(x, dtype=torch.float32)
    got = torch.tensor(cuda_kernels._f32(x), dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
