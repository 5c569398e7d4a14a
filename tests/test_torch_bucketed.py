"""The port's bucketed formation against the JAX package's.

- The step (``KernelSet(bucketed=True).search_step_packed``) against the
  JAX ``_search_step_bucketed`` (through its ``search_step_packed``, the
  span scan in XLA on the CPU) on the same seeded pool, bucket index and
  window: the f32[4, B] result (slots exact, ELO distances bit-equal,
  Glicko-2 distances within 3 ulp with mutual pairs compared as sets, the
  touched row exact), the pool and every index column equal, and the
  index counts equal to the JAX exact rebuild. The port's bucketed rows
  0-2 equal the port's dense step bit for bit.
- The fallback of an unbanded pool, a hot bucket, widening that widens
  the candidate buckets, the bucketed rescan, the indexed admit and evict
  (a slot evicted twice counts once) and the index rebuild.
- The mirror's segment counts against the JAX ``PlayerPool``'s.
- The engine: ``GpuEngine(device="cpu")`` bucketed against the JAX
  ``TpuEngine`` bucketed and the port's flat engine on one stream with
  expiry and a heartbeat rebuild; ``formation_report()`` against JAX's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
from matchmaking_tpu.config import QueueConfig as JaxQueue
from matchmaking_tpu.core.pool import PlayerPool as JaxPool
from matchmaking_tpu.engine.kernels import KernelSet as JaxKernelSet
from matchmaking_tpu.engine.kernels import _effective_threshold
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.core.pool import PlayerPool, band_edges_from_spec
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.engine.kernels import (
    INDEX_FIELDS,
    KernelSet,
    fresh_pool,
    pool_from_reference,
    pool_to_numpy,
)
from matchmaking_tpu_torch.service.contract import SearchRequest

torch.set_num_threads(1)

P, BLOCK, B = 4096, 256, 256
GLICKO_ULP = 3
INDEX = tuple(name for name, _ in INDEX_FIELDS)


@functools.lru_cache(maxsize=None)
def kernel_sets(glicko2, widen, w=8, chunk=64):
    """(JAX bucketed, port bucketed, port dense) of one geometry."""
    kw = dict(capacity=P, top_k=8, pool_block=BLOCK, glicko2=glicko2,
              widen_per_sec=widen, max_threshold=200.0)
    return (JaxKernelSet(**kw, bucketed=True, prune_window_blocks=w,
                         prune_chunk=chunk),
            KernelSet(**kw, bucketed=True, prune_window_blocks=w,
                      prune_chunk=chunk),
            KernelSet(**kw))


def seeded_pool(rng, banded, active_frac=0.7):
    ratings = rng.normal(1500, 300, P).astype(np.float32)
    if banded:  # the banded allocator's layout
        ratings = np.sort(ratings)
    return {
        "rating": ratings,
        "rd": rng.uniform(0, 200, P).astype(np.float32),
        "region": rng.integers(0, 3, P).astype(np.int32),
        "mode": rng.integers(0, 3, P).astype(np.int32),
        "threshold": rng.uniform(50, 150, P).astype(np.float32),
        "enqueue_t": rng.uniform(0, 10, P).astype(np.float32),
        "active": rng.random(P) < active_frac,
    }


def with_index(jks, pool):
    """The pool with its exact bucket index (the JAX ``_index_rebuild``),
    as host numpy: what the engine keeps incrementally."""
    jp = {k: jnp.asarray(v) for k, v in pool.items()}
    jp.update({k: jnp.asarray(v) for k, v in jks.init_index_arrays().items()})
    return {k: np.array(v) for k, v in jks.index_rebuild(jp).items()}


def jax_rebuild(jks, pool_np):
    return {k: np.asarray(v) for k, v in jks.index_rebuild(
        {k: jnp.array(v) for k, v in pool_np.items()}).items()}


def seeded_packed(rng, pool, n_valid, now, layout="random", wildcard=False):
    """f32[9, B]: arrivals into free slots, then padding. ``layout``
    "random" draws N(1500, 300) ratings; "banded" draws each lane's rating
    near its slot's (a banded pool); "narrow" places 100 lanes in blocks
    7-8 with ratings N(1500, 20) and threshold 20 (spans of 3 blocks)."""
    packed = np.zeros((9, B), np.float32)
    packed[0] = P
    if layout == "narrow":
        free = np.nonzero(~pool["active"][7 * BLOCK:9 * BLOCK])[0][:100]
        free = (free + 7 * BLOCK).astype(np.int32)
    else:
        free = np.nonzero(~pool["active"])[0]
        free = np.sort(free[rng.choice(free.size, min(n_valid, free.size),
                                       replace=False)])
    n = free.size
    packed[0, :n] = free
    if layout == "banded":
        packed[1, :n] = pool["rating"][free] + rng.normal(0, 5, n)
    elif layout == "narrow":
        packed[1, :n] = rng.normal(1500, 20, n)
    else:
        packed[1, :n] = rng.normal(1500, 300, n)
    packed[2, :n] = rng.uniform(0, 200, n)
    if not wildcard:
        packed[3, :n] = rng.integers(0, 3, n)
        packed[4, :n] = rng.integers(0, 3, n)
    packed[5, :n] = 20.0 if layout == "narrow" else rng.uniform(50, 120, n)
    packed[6, :n] = rng.uniform(0, 10, n)
    packed[7, :n] = 1.0
    packed[8] = now
    return packed


def ulp_diff(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def pair_dists(out):
    """frozenset of the two slots → distance, over matched lanes."""
    q, c, d = out[0].astype(np.int64), out[1].astype(np.int64), out[2]
    return {frozenset((int(a), int(b))): float(x)
            for a, b, x in zip(q, c, d) if a < P}


def assert_outputs(got, want, glicko2):
    """ELO: every row bit-equal. Glicko-2: the same pairs (as sets) within
    GLICKO_ULP, and the touched row equal."""
    assert got.shape == want.shape
    if not glicko2:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        return
    gp, wp = pair_dists(got), pair_dists(want)
    assert gp.keys() == wp.keys()
    for k, d in gp.items():
        assert ulp_diff(d, wp[k]) <= GLICKO_ULP, k
    np.testing.assert_array_equal(got[3:], want[3:])


def assert_pools(got, want):
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def run_step(jks, tks, pool_np, packed, skip_filters=False, rescan=False):
    """One step of each side on the same pool and window: (JAX pool, JAX
    out, port pool, port out), host numpy."""
    if rescan:
        jfn, tfn = jks.search_step_packed_rescan, tks.search_step_packed_rescan
        targs = ()
    elif skip_filters:
        jfn, tfn = jks.search_step_packed_nofilter, tks.search_step_packed
        targs = (True,)
    else:
        jfn, tfn = jks.search_step_packed, tks.search_step_packed
        targs = ()
    jpool, jout = jfn({k: jnp.asarray(v) for k, v in pool_np.items()},
                      jnp.asarray(packed))
    tpool = pool_from_reference(pool_np, "cpu", tks.extra_pool_fields)
    tout = tfn(tpool, torch.from_numpy(packed), *targs)
    return ({k: np.asarray(v) for k, v in jpool.items()}, np.asarray(jout),
            pool_to_numpy(tpool), tout.numpy())


# ---- the step --------------------------------------------------------------------

STEP_CASES = [(g, widen, layout) for g in (False, True) for widen in (0.0, 5.0)
              for layout in ("random", "banded", "narrow")]


@pytest.mark.parametrize("glicko2,widen,layout", STEP_CASES)
def test_bucketed_step_equals_jax(glicko2, widen, layout):
    jks, tks, dense = kernel_sets(glicko2, widen)
    rng = np.random.default_rng(200 + 8 * glicko2 + 4 * (widen > 0)
                                + STEP_CASES.index((glicko2, widen, layout)))
    matched = 0
    for trial in range(2):
        now = 10.0 + trial
        pool = with_index(jks, seeded_pool(rng, banded=True))
        packed = seeded_packed(rng, pool, 200, now, layout)
        jpool, jout, tpool, tout = run_step(jks, tks, pool, packed)
        assert_outputs(tout, jout, glicko2)
        assert_pools(tpool, jpool)
        np.testing.assert_array_equal(tpool["bidx_count"],
                                      jax_rebuild(jks, jpool)["bidx_count"])
        if layout == "narrow":  # spans of 3 blocks: the span path
            assert (tout[3] == 8 * BLOCK).all()
        matched += int((tout[0] < P).sum())
        # The port's dense step on the same window: rows 0-2 bit for bit.
        dpool = pool_from_reference({k: v for k, v in pool.items()
                                     if k not in INDEX}, "cpu")
        dout = dense.search_step_packed(dpool, torch.from_numpy(packed)).numpy()
        np.testing.assert_array_equal(tout[:3].view(np.int32),
                                      dout.view(np.int32))
        for f, col in pool_to_numpy(dpool).items():
            np.testing.assert_array_equal(tpool[f], col, err_msg=f)
    assert matched > 40


@pytest.mark.parametrize("glicko2", [False, True])
def test_bucketed_nofilter_step_equals_jax(glicko2):
    """The all-ANY variant (region/mode tests dropped) on an all-ANY
    window."""
    jks, tks, _ = kernel_sets(glicko2, 2.0)
    rng = np.random.default_rng(231 + glicko2)
    pool = with_index(jks, seeded_pool(rng, banded=True))
    packed = seeded_packed(rng, pool, 100, 6.0, "narrow", wildcard=True)
    jpool, jout, tpool, tout = run_step(jks, tks, pool, packed,
                                        skip_filters=True)
    assert_outputs(tout, jout, glicko2)
    assert_pools(tpool, jpool)
    assert (tout[0] < P).sum() > 10


def test_bucketed_unbanded_pool_falls_back_dense():
    """A random slot layout: every block spans the whole rating range, the
    window takes the dense fallback (row 3 = capacity), still exact."""
    jks, tks, _ = kernel_sets(False, 1.0, w=2)
    rng = np.random.default_rng(1234)
    pool = with_index(jks, seeded_pool(rng, banded=False))
    packed = seeded_packed(rng, pool, 200, 12.0)
    before = 0 if tks.span_steps is None else int(tks.span_steps.item())
    jpool, jout, tpool, tout = run_step(jks, tks, pool, packed)
    assert_outputs(tout, jout, False)
    assert_pools(tpool, jpool)
    assert (tout[3] == P).all()
    assert int(tks.span_steps.item()) == before  # no span path


def test_bucketed_hot_bucket_touches_a_fraction():
    """One hot bucket (blocks 4-5 occupied): formation scores a narrow span
    around it, far below the pool, and stays exact."""
    jks, tks, _ = kernel_sets(False, 1.0, w=6)
    rng = np.random.default_rng(1235)
    pool = seeded_pool(rng, banded=True, active_frac=0.0)
    hot = slice(4 * BLOCK, 6 * BLOCK)
    pool["active"][hot] = rng.random(2 * BLOCK) < 0.9
    pool = with_index(jks, pool)
    packed = np.zeros((9, B), np.float32)
    packed[0] = P
    free = (np.nonzero(~pool["active"][hot])[0][:40] + hot.start).astype(np.int32)
    n = free.size
    packed[0, :n] = free
    packed[1, :n] = pool["rating"][free] + rng.normal(0, 3, n)
    packed[2, :n] = rng.uniform(0, 100, n)
    packed[5, :n] = rng.uniform(50, 100, n)
    packed[7, :n] = 1.0
    packed[8] = 5.0
    jpool, jout, tpool, tout = run_step(jks, tks, pool, packed)
    assert_outputs(tout, jout, False)
    assert_pools(tpool, jpool)
    assert (tout[0] < P).sum() > 5
    assert tout[3, 0] < P / 2


def test_bucketed_widening_widens_the_candidate_buckets():
    """The same waiting players, young and aged: the admissible span width
    grows with the effective thresholds (the JAX kernel's own widths), and
    each cut equals the JAX step's, the young one on the span path."""
    jks, tks, _ = kernel_sets(False, 1.0, w=12, chunk=32)
    rng = np.random.default_rng(1236)
    pool = seeded_pool(rng, banded=True, active_frac=0.0)
    mid = slice(6 * BLOCK, 10 * BLOCK)
    pool["active"][mid] = rng.random(4 * BLOCK) < 0.5
    pool["threshold"][:] = 20.0
    pool["enqueue_t"][:] = 0.0
    pool = with_index(jks, pool)
    packed = np.zeros((9, B), np.float32)
    packed[0] = P
    free = (np.nonzero(~pool["active"][mid])[0][:60] + mid.start).astype(np.int32)
    n = free.size
    packed[0, :n] = free
    packed[1, :n] = pool["rating"][free] + rng.normal(0, 2, n)
    packed[5, :n] = 20.0
    packed[7, :n] = 1.0

    def span_widths(now):
        jb = {name: jnp.asarray(packed[i]) for i, name in enumerate(
            ("slot", "rating", "rd", "region", "mode", "threshold",
             "enqueue_t"))}
        jb["slot"] = jb["slot"].astype(jnp.int32)
        jb["region"] = jb["region"].astype(jnp.int32)
        jb["mode"] = jb["mode"].astype(jnp.int32)
        jb["valid"] = jnp.asarray(packed[7] > 0)
        qte = _effective_threshold(jb["threshold"], jb["enqueue_t"],
                                   jnp.float32(now), jks.widen_per_sec,
                                   jks.max_threshold)
        sb, qte_s, _ = jks._sort_batch(jb, qte)
        jp = {k: jnp.asarray(v) for k, v in pool.items()}
        imin, imax, ird = jks._incoming_stats(sb)
        _, _, width = jks._chunk_windows(
            sb, qte_s, jnp.minimum(jp["bidx_min"], imin),
            jnp.maximum(jp["bidx_max"], imax), jnp.maximum(jp["bidx_rd"], ird))
        w = np.asarray(width)
        return w[w > 0]

    assert span_widths(120.0).max() > span_widths(1.0).max()
    touched = []
    for now in (1.0, 120.0):
        packed[8] = now
        jpool, jout, tpool, tout = run_step(jks, tks, pool, packed)
        assert_outputs(tout, jout, False)
        assert_pools(tpool, jpool)
        touched.append(float(tout[3, 0]))
    assert touched[0] < P


@pytest.mark.parametrize("rescan", [False, True])
def test_dict_steps_equal_packed_steps(rescan):
    """``search_step`` / ``search_step_rescan`` (batch dicts) run the
    bucketed step and rescan that the packed calls run: the same rows 0-2
    and the same pool and index."""
    from matchmaking_tpu_torch.engine.kernels import packed_now, unpack_batch

    jks, tks, _ = kernel_sets(True, 2.0)
    rng = np.random.default_rng(241 + rescan)
    pool = seeded_pool(rng, True)
    packed = seeded_packed(rng, pool, 100, 9.0, "narrow")
    if rescan:  # the narrow window's players, already in the pool
        pool["active"][packed[0, :100].astype(np.int64)] = True
    pool = with_index(jks, pool)
    a, b = (pool_from_reference(pool, "cpu", tks.extra_pool_fields)
            for _ in range(2))
    p = torch.from_numpy(packed)
    if rescan:
        want = tks.search_step_packed_rescan(a, p)
        got = tks.search_step_rescan(b, unpack_batch(p), packed_now(p))
    else:
        want = tks.search_step_packed(a, p)
        got = tks.search_step(b, unpack_batch(p), packed_now(p))
    for row, t in zip(want, got):
        np.testing.assert_array_equal(t.to(torch.float32).numpy().view(np.int32),
                                      row.numpy().view(np.int32))
    assert_pools(pool_to_numpy(b), pool_to_numpy(a))
    assert (want[0] < P).sum() > 5


# ---- the bucketed rescan ---------------------------------------------------------


@pytest.mark.parametrize("glicko2,layout", [(False, "banded"), (True, "banded"),
                                            (False, "narrow"),
                                            (True, "narrow")])
def test_bucketed_rescan_equals_jax_and_flat(glicko2, layout):
    """The no-admission bucketed rescan against the JAX one and against the
    port's flat rescan: the same matches and pool, a few stale lanes (slots
    already inactive) riding along gated off, index counts exact."""
    jks, tks, _ = kernel_sets(glicko2, 2.0)
    flat = KernelSet(capacity=P, top_k=8, pool_block=BLOCK, glicko2=glicko2,
                     widen_per_sec=2.0, max_threshold=200.0)
    rng = np.random.default_rng(300 + 2 * glicko2 + (layout == "narrow"))
    pool = seeded_pool(rng, banded=True)
    if layout == "narrow":
        pool["threshold"][:] = 10.0
    pool = with_index(jks, pool)
    packed = np.zeros((9, B), np.float32)
    packed[0] = P
    act = np.nonzero(pool["active"])[0]
    act = (act[7 * BLOCK * 7 // 10:][:220] if layout == "narrow"
           else act[:220]).astype(np.int32)
    n = act.size
    packed[0, :n] = act
    for row, name in enumerate(("rating", "rd", "region", "mode", "threshold",
                                "enqueue_t"), start=1):
        packed[row, :n] = pool[name][act]
    stale = np.nonzero(~pool["active"])[0][:8].astype(np.int32)
    packed[0, n:n + 8] = stale
    packed[7, :n + 8] = 1.0
    packed[8] = 14.0
    jpool, jout, tpool, tout = run_step(jks, tks, pool, packed, rescan=True)
    assert_outputs(tout, jout, glicko2)
    assert_pools(tpool, jpool)
    np.testing.assert_array_equal(tpool["bidx_count"],
                                  jax_rebuild(jks, jpool)["bidx_count"])
    if layout == "narrow":
        assert (tout[3] == 8 * BLOCK).all()  # the span path
    fpool = pool_from_reference({k: v for k, v in pool.items()
                                 if k not in INDEX}, "cpu")
    fout = flat.search_step_packed_rescan(fpool, torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(tout[:3].view(np.int32), fout.view(np.int32))
    assert (tout[0] < P).sum() > 10


# ---- the index -------------------------------------------------------------------


@pytest.mark.parametrize("glicko2", [False, True])
def test_indexed_admit_and_evict_keep_counts_exact(glicko2):
    """``admit_packed`` (restores) and ``evict`` (remove, expiry) against
    the JAX indexed admit and evict: equal pools and index; counts equal
    an exact rebuild, bounds hold the rebuild's; a second eviction of the
    same slots counts nothing."""
    jks, tks, _ = kernel_sets(glicko2, 0.0)
    rng = np.random.default_rng(400 + glicko2)
    pool = with_index(jks, seeded_pool(rng, banded=True, active_frac=0.3))
    packed = seeded_packed(rng, pool, 100, 0.0)
    jp = jks.admit_packed({k: jnp.asarray(v) for k, v in pool.items()},
                          jnp.asarray(packed))
    jp = {k: np.asarray(v) for k, v in jp.items()}
    tp = pool_from_reference(pool, "cpu", tks.extra_pool_fields)
    tks.admit_packed(tp, torch.from_numpy(packed))
    assert_pools(pool_to_numpy(tp), jp)
    exact = jax_rebuild(jks, jp)
    np.testing.assert_array_equal(jp["bidx_count"], exact["bidx_count"])
    assert (jp["bidx_min"] <= exact["bidx_min"]).all()
    assert (jp["bidx_max"] >= exact["bidx_max"]).all()
    victims = np.nonzero(jp["active"])[0][:16].astype(np.int32)
    ev = np.full(jks.evict_bucket, P, np.int32)
    ev[:victims.size] = victims
    for _ in range(2):  # the second eviction finds them inactive
        jp = {k: np.asarray(v) for k, v in jks.evict(
            {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(ev)).items()}
        tks.evict(tp, torch.from_numpy(np.concatenate([victims, [P]])))
        assert_pools(pool_to_numpy(tp), jp)
        np.testing.assert_array_equal(
            jp["bidx_count"], jax_rebuild(jks, jp)["bidx_count"])


@pytest.mark.parametrize("glicko2,banded", [(False, True), (True, False)])
def test_index_rebuild_equals_jax(glicko2, banded):
    """The exact rebuild (ELO keeps ``bidx_rd`` too), over a pool with
    empty blocks, and the empty pool's index (+inf / -inf bounds)."""
    jks, tks, _ = kernel_sets(glicko2, 0.0)
    rng = np.random.default_rng(500 + glicko2)
    pool = seeded_pool(rng, banded)
    pool["active"][3 * BLOCK:5 * BLOCK] = False
    want = with_index(jks, pool)
    tp = pool_from_reference(with_index(jks, {**pool, "active": ~pool["active"]}),
                             "cpu", tks.extra_pool_fields)
    tp["active"].copy_(torch.from_numpy(pool["active"]))
    tks.index_rebuild(tp)
    assert_pools(pool_to_numpy(tp), want)
    empty = fresh_pool(P, "cpu", tks.extra_pool_fields)
    tks.index_rebuild(empty)
    init = jks.init_index_arrays()
    for name in INDEX:
        np.testing.assert_array_equal(empty[name].numpy(), init[name])


def test_bucketed_set_shapes_and_default_span():
    """The index columns have one element per block; W defaults to a
    quarter of the blocks (at least 2), as in the JAX set."""
    jks = JaxKernelSet(capacity=P, top_k=8, pool_block=BLOCK, glicko2=False,
                       widen_per_sec=0.0, max_threshold=200.0, bucketed=True)
    tks = KernelSet(capacity=P, top_k=8, pool_block=BLOCK, glicko2=False,
                    widen_per_sec=0.0, max_threshold=200.0, bucketed=True)
    assert tks.prune_window_blocks == jks.prune_window_blocks == 4
    pool = fresh_pool(P, "cpu", tks.extra_pool_fields)
    assert {name: pool[name].shape[0] for name in INDEX} == dict.fromkeys(
        INDEX, P // BLOCK)
    assert KernelSet(capacity=512, top_k=8, pool_block=256, glicko2=False,
                     widen_per_sec=0.0, max_threshold=200.0,
                     bucketed=True).prune_window_blocks == 2


# ---- the mirror's segment counts ---------------------------------------------------


@pytest.mark.parametrize("spec,segments", [("gaussian:1500:300", 16), ("", 8)])
def test_segment_counts_equal_jax(spec, segments):
    """A seeded stream of allocations and releases (repeats included):
    the port's per-segment counts and peak equal the JAX pool's."""
    cap = 1024
    edges = band_edges_from_spec(spec, segments) if spec else None
    jp = JaxPool(cap, 100.0, band_edges=edges, segments=segments)
    tp = PlayerPool(cap, 100.0, band_edges=edges, segments=segments)
    rng = np.random.default_rng(segments)
    waiting, pid = [], 0
    for step in range(30):
        n = min(int(rng.integers(1, 40)), tp.free_count())
        ratings = rng.normal(1500, 300, n)
        ids = [f"s{pid + i}" for i in range(n)]
        pid += n
        slots = tp.allocate([SearchRequest(id=i, rating=float(r))
                             for i, r in zip(ids, ratings)])
        assert slots == jp.allocate([JaxRequest(id=i, rating=float(r))
                                     for i, r in zip(ids, ratings)])
        waiting += slots
        if step % 3 == 2:
            out = [waiting.pop(int(rng.integers(0, len(waiting))))
                   for _ in range(min(len(waiting), 25))]
            for pool in (jp, tp):
                pool.release(out)
                pool.release(out[:3])  # idempotent
        np.testing.assert_array_equal(tp.segment_counts(), jp.segment_counts())
        assert tp.segment_max() == jp.segment_max()
    assert tp.segment_counts().sum() == len(tp)
    assert PlayerPool(cap, 100.0).segment_counts() is None
    assert PlayerPool(cap, 100.0).segment_max() == 0


# ---- the engine ------------------------------------------------------------------


def engines(**over):
    kw = dict(pool_capacity=P, pool_block=BLOCK, batch_buckets=(16, 64, 256),
              band_spec="gaussian:1500:300", **over)
    q = dict(rating_threshold=100.0, widen_per_sec=2.0, max_threshold=200.0)
    jcfg = JaxConfig(engine=JaxEngineConfig(backend="tpu", **kw),
                     queues=(JaxQueue(**q),))
    tcfg = Config(engine=EngineConfig(**kw), queues=(QueueConfig(**q),))
    return (TpuEngine(jcfg, jcfg.queues[0]),
            GpuEngine(tcfg, tcfg.queues[0], device="cpu"))


def feed(engine, cls, narrow=False):
    """The JAX package's stream (six windows of 120, an expiry sweep and a
    heartbeat after the fourth): the sorted (players, quality) of every
    match. ``narrow`` draws N(1500, 40) ratings (windows on the span
    path)."""
    out = []
    local = np.random.default_rng(7)
    for w in range(6):
        reqs = [cls(id=f"w{w}_{i}", rating=float(local.normal(
                    1500, 40 if narrow else 300)), enqueued_at=1000.0 + w)
                for i in range(120)]
        res = engine.search(reqs, now=1000.0 + w)
        out.extend((tuple(sorted(m.result().players)), round(m.quality, 5))
                   for m in res.matches)
        if w == 3:
            engine.expire(1000.0 + w, 0.5)
            engine.heartbeat(1000.0 + w)
    return sorted(out)


@pytest.mark.parametrize("narrow", [False, True])
def test_engine_bucketed_equals_jax_and_flat(narrow):
    """One stream through the JAX bucketed engine, the port's bucketed
    engine and the port's flat engine (the same bands): the same matches
    and qualities; the bucketed device pools (index included) and
    formation reports equal."""
    jeng, teng = engines(bucketed=True, prune_window_blocks=8,
                         prune_chunk=16 if narrow else 128)
    _, flat = engines()
    want = feed(jeng, JaxRequest, narrow)
    assert feed(teng, SearchRequest, narrow) == want
    assert feed(flat, SearchRequest, narrow) == want
    assert len(want) > 100
    assert_pools(pool_to_numpy(teng.dev_pool),
                 {k: np.asarray(v) for k, v in jeng._dev_pool.items()})
    assert teng.formation_report() == jeng.formation_report()
    assert teng.pool._slot_of == jeng.pool._slot_of
    span = teng.prune_report()
    assert span["windows"] == 6
    assert (span["span_windows"] > 0) == narrow
    assert flat.formation_report() is None


def test_engine_formation_report_equals_jax():
    """``formation_report`` after object windows, a rescan and a restore:
    the JAX engine's non-sharded fields (bucket occupancy included) and
    the touched fraction of a narrow stream below 1."""
    jeng, teng = engines(bucketed=True, prune_window_blocks=6, prune_chunk=16)
    t = 2000.0
    local = np.random.default_rng(17)
    for w in range(3):
        rows = [dict(id=f"r{w}_{i}", rating=float(local.normal(1500, 30)),
                     enqueued_at=t) for i in range(64)]
        for e, cls in ((jeng, JaxRequest), (teng, SearchRequest)):
            e.search([cls(**r) for r in rows], t + w)
    extra = [dict(id=f"x{i}", rating=float(local.normal(1500, 30)),
                  enqueued_at=t) for i in range(40)]
    jeng.restore([JaxRequest(**r) for r in extra], t + 3)
    teng.restore([SearchRequest(**r) for r in extra], t + 3)
    for e in (jeng, teng):
        e.rescan_async(256, t + 30.0)
        e.flush()
    rep = teng.formation_report()
    assert rep == jeng.formation_report()
    assert rep["mode"] == "bucketed" and rep["buckets"] == P // BLOCK
    assert sum(rep["bucket_occupancy"]) == teng.pool_size()
    assert 0.0 < rep["formation_touched_frac"] < 1.0


def test_engine_refuses_the_frontier_and_serves_bucketed():
    # On one device the bucket frontier (a sharded step) is no ladder, as
    # in the JAX engine; bucketed formation serves the queue.
    jeng, teng = engines(bucketed=True, bucket_frontier_k=64)
    assert teng._frontier_ladder == jeng._frontier_ladder == ()
    assert teng.formation_report() == jeng.formation_report()
    _, teng = engines(bucketed=True)
    assert teng.kernels.bucketed
    teng.warmup()  # every variant; no window counted
    assert teng.prune_report() == {"windows": 0, "span_windows": 0}
    assert teng.formation_report()["windows"] == 0
