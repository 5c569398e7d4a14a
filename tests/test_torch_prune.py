"""The port's rating-banded pruned step against the JAX package's.

- The banded allocator: ``band_edges_from_spec`` and the ``PlayerPool``
  slot sequence (spills and full bands included) equal the JAX ones: the
  pairs depend on the slot layout.
- ``cuda_kernels.block_best_span_reference`` (what the span launch runs on
  CPU tensors, and the kernel's plain twin) equals the dense candidate
  lists on a band-coherent pool when the spans come from the pruned
  step's own bounds, and is the dense result when the window is
  infeasible.
- The pruned step (``KernelSet.search_step_packed`` with
  ``prune_window_blocks``) against the JAX ``_search_step_pruned`` (through
  its ``search_step_packed``) on the same seeded pool and window: slots and
  the pool exact, ELO distances bit-equal, Glicko-2 distances within 3 ulp
  (XLA fuses FMAs on the CPU; its distance is then not symmetric, so a
  mutual pair between two window lanes may come back with its sides
  swapped: pairs are compared as sets). And the port's pruned step equals
  the port's dense step bit for bit.
- The engine: ``GpuEngine`` (CPU) with ``band_spec`` and pruning against
  the JAX engine with the same config.
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
from matchmaking_tpu.core.pool import PoolFullError as JaxPoolFull
from matchmaking_tpu.core.pool import band_edges_from_spec as jax_edges
from matchmaking_tpu.engine.kernels import KernelSet as JaxKernelSet
from matchmaking_tpu.engine.tpu import TpuEngine
from matchmaking_tpu.service.contract import SearchRequest as JaxRequest
from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.core.pool import (
    PlayerPool,
    PoolFullError,
    band_edges_from_spec,
)
from matchmaking_tpu_torch.engine import cuda_kernels, scoring
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.engine.kernels import (
    KernelSet,
    admit,
    packed_now,
    pool_from_reference,
    pool_to_numpy,
    unpack_batch,
)
from matchmaking_tpu_torch.service.contract import SearchRequest

# Small tensors: one intra-op thread each leaves the cores to the other
# test workers (several run side by side).
torch.set_num_threads(1)

P, BLOCK, CHUNK, W = 4096, 256, 32, 6
GLICKO_ULP = 3


def now_tensor(now):
    """The window's time as the port's steps take it: a one-element f32
    tensor (the packed window's now row)."""
    return torch.tensor([now], dtype=torch.float32)


# ---- the banded allocator ------------------------------------------------------


@pytest.mark.parametrize("spec,n", [("", 16), ("uniform:0:1600", 16),
                                    ("uniform:-5:3.5", 7),
                                    ("gaussian:1500:300", 16),
                                    ("gaussian:1500:300", 1),
                                    ("gaussian:1200.5:80", 32)])
def test_band_edges_equal_jax(spec, n):
    assert band_edges_from_spec(spec, n) == jax_edges(spec, n)


@pytest.mark.parametrize("spec", ["uniform:5:5", "nope:1:2"])
def test_band_edges_refuse_bad_specs(spec):
    with pytest.raises(ValueError):
        band_edges_from_spec(spec, 8)


def test_banded_pool_refuses_unsorted_edges():
    with pytest.raises(ValueError, match="ascending"):
        PlayerPool(64, 100.0, band_edges=[3.0, 1.0])


def _reqs(cls, ids, ratings):
    return [cls(id=i, rating=float(r)) for i, r in zip(ids, ratings)]


@pytest.mark.parametrize("capacity,bands,spec", [
    (160, 16, "uniform:0:1600"), (1024, 16, "gaussian:1500:300"),
    (96, 4, "gaussian:1500:100")])
def test_banded_slot_sequence_equals_jax(capacity, bands, spec):
    """A seeded stream of windows and releases that fills bands and spills
    (a narrow rating cluster), down to a full pool: every window gets the
    JAX allocator's slots, in order, and the bands the same free heads."""
    edges = jax_edges(spec, bands)
    jp, tp = JaxPool(capacity, 100.0, band_edges=edges), PlayerPool(
        capacity, 100.0, band_edges=edges)
    rng = np.random.default_rng(capacity + bands)
    pid, waiting = 0, []
    for step in range(40):
        n = int(rng.integers(1, 24))
        n = min(n, tp.free_count())
        if n and step % 5 != 4:
            if step % 3 == 0:  # a cluster: fills its band, spills around it
                ratings = rng.normal(1500, 5, n)
            else:
                ratings = rng.normal(1500, 300, n)
            ids = [f"b{pid + i}" for i in range(n)]
            pid += n
            if step % 2:
                jslots = jp.allocate(_reqs(JaxRequest, ids, ratings))
                tslots = tp.allocate(_reqs(SearchRequest, ids, ratings))
            else:
                jslots = jp.allocate(_reqs(JaxRequest, ids, ratings))
                tslots = tp.allocate_columns(_columns(tp, ids, ratings)).tolist()
            assert tslots == list(jslots), step
            waiting += tslots
        if waiting and step % 4 == 3:
            out = [waiting.pop(int(rng.integers(0, len(waiting))))
                   for _ in range(min(len(waiting), int(rng.integers(1, 12))))]
            jp.release(out)
            tp.release(out)
            jp.release(out[:2])  # idempotent
            tp.release(out[:2])
        assert tp.band_report() == jp.band_report()
        assert tp.free_count() == jp.free_count()
    # Fill what is left: every band full, spills to the last slot.
    n = tp.free_count()
    ids = [f"f{i}" for i in range(n)]
    ratings = rng.normal(1500, 300, n)
    assert (tp.allocate(_reqs(SearchRequest, ids, ratings))
            == jp.allocate(_reqs(JaxRequest, ids, ratings)))
    assert tp.free_count() == 0 and sorted(tp._slot_of.values()) == list(
        range(capacity))
    with pytest.raises(PoolFullError):
        tp.allocate(_reqs(SearchRequest, ["x"], [1500.0]))
    with pytest.raises(JaxPoolFull):
        jp.allocate(_reqs(JaxRequest, ["x"], [1500.0]))


def _columns(pool, ids, ratings):
    from matchmaking_tpu_torch.service.contract import RequestColumns

    n = len(ids)
    return RequestColumns(
        ids=np.asarray(ids, object), rating=np.asarray(ratings, np.float32),
        rd=np.zeros(n, np.float32), region=np.zeros(n, np.int32),
        mode=np.zeros(n, np.int32), threshold=np.full(n, np.nan, np.float32),
        enqueued_at=np.zeros(n))


def test_unbanded_pool_has_no_band_report():
    assert PlayerPool(64, 100.0).band_report() is None
    assert PlayerPool(64, 100.0, band_edges=[]).band_report() is None


# ---- kernel sets, pools and windows ------------------------------------------


@functools.lru_cache(maxsize=None)
def kernel_sets(glicko2, widen, w=W, chunk=CHUNK):
    kw = dict(capacity=P, top_k=8, pool_block=BLOCK, glicko2=glicko2,
              widen_per_sec=widen, max_threshold=200.0)
    return (JaxKernelSet(**kw, prune_window_blocks=w, prune_chunk=chunk),
            KernelSet(**kw, prune_window_blocks=w, prune_chunk=chunk),
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


def seeded_packed(rng, pool, b, n_valid, now, wildcard=False, banded=False):
    """f32[9, b]: ``n_valid`` arrivals into free slots, then padding. With
    ``banded`` (a pool sorted by rating) each arrival takes the free slot
    nearest to its rating's place, as the banded allocator would."""
    free = np.nonzero(~pool["active"])[0][:n_valid]
    n = free.size
    packed = np.zeros((9, b), np.float32)
    packed[0] = P
    packed[1, :n] = rng.normal(1500, 300, n)
    if banded:
        taken = pool["active"].copy()
        for i in range(n):
            at = int(np.searchsorted(pool["rating"], packed[1, i]))
            cand = np.nonzero(~taken)[0]
            free[i] = cand[np.argmin(np.abs(cand - at))]
            taken[free[i]] = True
    packed[0, :n] = free
    packed[2, :n] = rng.uniform(0, 200, n)
    if not wildcard:
        packed[3, :n] = rng.integers(0, 3, n)
        packed[4, :n] = rng.integers(0, 3, n)
    packed[5, :n] = rng.uniform(50, 150, n)
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
    """Exact lanes for ELO; for Glicko-2 the same pairs (as sets) within
    GLICKO_ULP."""
    if not glicko2:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        return
    gp, wp = pair_dists(got), pair_dists(want)
    assert gp.keys() == wp.keys()
    for k, d in gp.items():
        assert ulp_diff(d, wp[k]) <= GLICKO_ULP, k


def run_pruned(jax_set, port_set, pool_np, packed, now, skip_filters):
    jpool, jout = (jax_set.search_step_packed_nofilter if skip_filters
                   else jax_set.search_step_packed)(
        {k: jnp.asarray(v) for k, v in pool_np.items()}, jnp.asarray(packed))
    tpool = pool_from_reference(pool_np, "cpu")
    assert packed[8, 0] == np.float32(now)  # the steps read row 8
    tout = port_set.search_step_packed(tpool, torch.from_numpy(packed),
                                       skip_filters)
    return ({k: np.asarray(v) for k, v in jpool.items()}, np.asarray(jout),
            pool_to_numpy(tpool), tout.numpy())


CASES = [(g, widen, banded, skip) for g in (False, True)
         for widen in (0.0, 2.0) for banded in (True, False)
         for skip in (False, True)]


@pytest.mark.parametrize("glicko2,widen,banded,skip_filters", CASES)
def test_pruned_step_equals_jax(glicko2, widen, banded, skip_filters):
    jks, tks, dense = kernel_sets(glicko2, widen)
    rng = np.random.default_rng(100 + 8 * glicko2 + 4 * (widen > 0) + 2 * banded
                                + skip_filters)
    matched = 0
    for trial in range(2):
        now = 10.0 + trial
        pool = seeded_pool(rng, banded)
        packed = seeded_packed(rng, pool, 256, 200, now, wildcard=skip_filters,
                               banded=banded)
        jpool, jout, tpool, tout = run_pruned(jks, tks, pool, packed, now,
                                              skip_filters)
        assert_outputs(tout, jout, glicko2)
        for f in jpool:
            np.testing.assert_array_equal(tpool[f], jpool[f], err_msg=f)
        matched += int((tout[0] < P).sum())
        # The port's dense step on the same window: bit for bit.
        dpool = pool_from_reference(pool, "cpu")
        dout = dense.search_step_packed(dpool, torch.from_numpy(packed),
                                        skip_filters).numpy()
        np.testing.assert_array_equal(tout.view(np.int32), dout.view(np.int32))
        for f, col in pool_to_numpy(dpool).items():
            np.testing.assert_array_equal(tpool[f], col, err_msg=f)
    assert matched > 40


def test_banded_windows_take_the_span_path_and_unbanded_fall_back():
    _, tks, _ = kernel_sets(False, 0.0, w=3)
    for banded, expect in ((True, 1), (False, 0)):
        rng = np.random.default_rng(21)
        pool = seeded_pool(rng, banded, active_frac=0.7)
        # A narrow window placed where its ratings live on a banded pool
        # (the middle blocks): its chunks' spans fit three blocks.
        packed = seeded_packed(rng, pool, 128, 100, 5.0)
        mid = np.nonzero(~pool["active"][7 * BLOCK:9 * BLOCK])[0][:100]
        packed[0, :100] = mid + 7 * BLOCK
        packed[1, :100] = rng.normal(1500, 20, 100)
        packed[5, :100] = 20.0
        before = (0 if tks.span_steps is None else int(tks.span_steps.item()))
        tks.search_step_packed(pool_from_reference(pool, "cpu"),
                               torch.from_numpy(packed))
        assert int(tks.span_steps.item()) - before == expect, banded


@pytest.mark.parametrize("glicko2", [False, True])
def test_empty_padding_and_full_width(glicko2):
    """All-padding windows on an empty pool (the ±inf bound sentinels), a
    window of one, and W = n_blocks (the pruned plumbing, every block)."""
    jks, tks, _ = kernel_sets(glicko2, 2.0)
    jfull, tfull, _ = kernel_sets(glicko2, 2.0, w=10_000, chunk=16)
    assert tfull.prune_window_blocks == tfull.n_blocks == jfull.n_blocks
    rng = np.random.default_rng(31)
    empty = seeded_pool(rng, True)
    empty["active"][:] = False
    for pool, n_valid, sets in ((empty, 0, (jks, tks)), (empty, 1, (jks, tks)),
                                (seeded_pool(rng, True), 60, (jfull, tfull)),
                                (seeded_pool(rng, True), 0, (jfull, tfull))):
        packed = seeded_packed(rng, pool, 64, n_valid, 7.0)
        jpool, jout, tpool, tout = run_pruned(*sets, pool, packed, 7.0, False)
        assert_outputs(tout, jout, glicko2)
        for f in jpool:
            np.testing.assert_array_equal(tpool[f], jpool[f], err_msg=f)
        if n_valid <= 1:
            assert (tout[0] == P).all()


def test_dict_step_equals_packed_step():
    """``search_step`` (batch dict) and ``search_step_packed`` run one
    pruned step."""
    _, tks, _ = kernel_sets(True, 2.0)
    rng = np.random.default_rng(41)
    pool = seeded_pool(rng, True)
    packed = seeded_packed(rng, pool, 256, 180, 9.0)
    a, b = pool_from_reference(pool, "cpu"), pool_from_reference(pool, "cpu")
    want = tks.search_step_packed(a, torch.from_numpy(packed))
    got = tks.search_step(b, unpack_batch(torch.from_numpy(packed)),
                          packed_now(torch.from_numpy(packed)))
    for row, t in zip(want, got):
        np.testing.assert_array_equal(t.to(torch.float32).numpy().view(np.int32),
                                      row.numpy().view(np.int32))
    for f, col in pool_to_numpy(a).items():
        np.testing.assert_array_equal(pool_to_numpy(b)[f], col)


@pytest.mark.parametrize("glicko2", [False, True])
def test_bounds_after_admission_equal_live_and_incoming(glicko2):
    """The port takes the blocks' bounds after admission; the JAX step
    merges the pre-admission pool's bounds with the window's own
    (``_incoming_stats``): they are equal."""
    jks, tks, _ = kernel_sets(glicko2, 0.0)
    rng = np.random.default_rng(51)
    pool = seeded_pool(rng, True)
    packed = seeded_packed(rng, pool, 256, 230, 3.0)
    jb = {k: jnp.asarray(v) for k, v in unpack_batch(
        torch.from_numpy(packed)).items()}
    lmin, lmax, lrd = jks._live_stats({k: jnp.asarray(v)
                                       for k, v in pool.items()})
    imin, imax, ird = jks._incoming_stats(jb)
    tpool = pool_from_reference(pool, "cpu")
    admit(tpool, unpack_batch(torch.from_numpy(packed)))
    bmin, bmax, brd = tks._live_stats(tpool)
    np.testing.assert_array_equal(bmin.numpy(), np.minimum(lmin, imin))
    np.testing.assert_array_equal(bmax.numpy(), np.maximum(lmax, imax))
    if glicko2:
        np.testing.assert_array_equal(brd.numpy(), np.maximum(lrd, ird))
    else:
        assert brd is None


@pytest.mark.parametrize("glicko2", [False, True])
def test_chunk_windows_equal_jax(glicko2):
    """Span starts and feasibility from the same sorted window and bounds
    (the bounds may differ in reach by an FMA's rounding on the JAX side,
    which the 0.1 % + 0.5 inflation swamps here)."""
    jks, tks, _ = kernel_sets(glicko2, 2.0)
    rng = np.random.default_rng(61)
    for banded in (True, False):
        pool = seeded_pool(rng, banded)
        packed = seeded_packed(rng, pool, 256, 200, 4.0)
        batch = unpack_batch(torch.from_numpy(packed))
        order = torch.sort(torch.where(batch["valid"], batch["rating"],
                                       float("inf")), stable=True).indices
        sb = {k: v.index_select(0, order) for k, v in batch.items()}
        qte = cuda_kernels.effective_threshold(sb["threshold"], sb["enqueue_t"],
                                               now_tensor(4.0), 2.0, 200.0)
        tpool = pool_from_reference(pool, "cpu")
        admit(tpool, sb)
        bounds = tks._live_stats(tpool)
        dstart, feasible = tks._chunk_windows(sb, qte, *bounds)
        jsb = {k: jnp.asarray(v.numpy()) for k, v in sb.items()}
        brd = bounds[2] if glicko2 else torch.zeros(tks.n_blocks)
        jd, jf, _ = jks._chunk_windows(jsb, jnp.asarray(qte.numpy()),
                                       jnp.asarray(bounds[0].numpy()),
                                       jnp.asarray(bounds[1].numpy()),
                                       jnp.asarray(brd.numpy()))
        np.testing.assert_array_equal(dstart.numpy(), np.asarray(jd))
        assert bool(feasible) == bool(jf)


# ---- the span launch's plain version -------------------------------------------


@pytest.mark.parametrize("glicko2,filters", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_span_reference_equals_dense_on_banded_pool(glicko2, filters):
    _, tks, _ = kernel_sets(glicko2, 2.0)
    rng = np.random.default_rng(71 + 2 * glicko2 + filters)
    pool_np = seeded_pool(rng, True)
    packed = seeded_packed(rng, pool_np, 256, 256, 6.0, wildcard=not filters,
                           banded=True)
    packed[5] = 20.0
    packed = packed[:, np.argsort(packed[1], kind="stable")]  # sorted window
    batch = unpack_batch(torch.from_numpy(packed))
    pool = pool_from_reference(pool_np, "cpu")
    admit(pool, batch)
    now = now_tensor(6.0)
    qte = cuda_kernels.effective_threshold(batch["threshold"],
                                           batch["enqueue_t"], now, 2.0, 200.0)
    dstart, feasible = tks._chunk_windows(batch, qte, *tks._live_stats(pool))
    assert bool(feasible)
    kw = dict(pool_block=BLOCK, glicko2=glicko2, filters=filters,
              widen_per_sec=2.0, max_threshold=200.0,
              g_coeff=scoring.G_COEFF_F32)
    dense = cuda_kernels.block_best_reference(pool, batch, qte, now, **kw)
    for flag in (True, False):
        span = cuda_kernels.Span(dstart, CHUNK, W, torch.tensor([flag]))
        got = cuda_kernels.block_best(pool, batch, qte, now, span=span, **kw)
        assert torch.equal(got[1], dense[1])
        assert torch.equal(got[0].view(torch.int32), dense[0].view(torch.int32))
    # Spans that miss candidates: the plain version scores only the spans
    # (-inf / capacity elsewhere), and every block when infeasible.
    wrong = torch.zeros_like(dstart)
    got = cuda_kernels.block_best_span_reference(
        pool, batch, qte, now, cuda_kernels.Span(wrong, CHUNK, 4,
                                                 torch.tensor([True])), **kw)
    assert torch.equal(got[0][:, :4].view(torch.int32),
                       dense[0][:, :4].view(torch.int32))
    assert (got[0][:, 4:] == float("-inf")).all() and (got[1][:, 4:] == P).all()
    got = cuda_kernels.block_best_span_reference(
        pool, batch, qte, now, cuda_kernels.Span(wrong, CHUNK, 4,
                                                 torch.tensor([False])), **kw)
    assert torch.equal(got[1], dense[1])


def test_span_launch_checks_its_arguments():
    rng = np.random.default_rng(81)
    pool_np = seeded_pool(rng, True)
    batch = unpack_batch(torch.from_numpy(seeded_packed(rng, pool_np, 64, 40,
                                                        1.0)))
    pool = pool_from_reference(pool_np, "cpu")
    kw = dict(pool_block=BLOCK, glicko2=False, filters=False,
              widen_per_sec=0.0, max_threshold=200.0, g_coeff=0.0)
    ok = torch.tensor([True])
    starts = torch.zeros(2, dtype=torch.int32)
    for span, msg in ((cuda_kernels.Span(starts, 24, 4, ok), "chunk_rows"),
                      (cuda_kernels.Span(starts, 32, 17, ok), "span_blocks"),
                      (cuda_kernels.Span(starts.long(), 32, 4, ok),
                       "span_start"),
                      (cuda_kernels.Span(starts[:1], 32, 4, ok), "span_start"),
                      (cuda_kernels.Span(starts, 32, 4, torch.tensor(True)),
                       "feasible")):
        with pytest.raises(ValueError, match=msg):
            cuda_kernels.block_best(pool, batch, batch["threshold"],
                                    now_tensor(1.0), span=span, **kw)


@pytest.mark.parametrize("n_rows,chunk", [(1024, 128), (1024, 32), (256, 16),
                                          (64, 8), (16, 4), (1024, 24)])
def test_plan_grid_fits_rows_per_cta_to_the_chunk(n_rows, chunk):
    for sm in (132, 16):
        plan = cuda_kernels.plan_grid(n_rows, 16, 8192, sm, chunk)
        assert plan.rows_per_cta in cuda_kernels.ROWS_PER_CTA
        if chunk >= 8:
            assert chunk % plan.rows_per_cta == 0
        assert (plan.grid[1] - 1) * plan.rows_per_cta < n_rows
    # Without a chunk the dense launch's plan is unchanged.
    assert (cuda_kernels.plan_grid(n_rows, 16, 8192, 132)
            == cuda_kernels.plan_grid(n_rows, 16, 8192, 132, 0))


# ---- the engine -----------------------------------------------------------------


def engines(prune, widen=2.0):
    kw = dict(pool_capacity=P, pool_block=BLOCK, batch_buckets=(16, 64, 256),
              prune_window_blocks=W if prune else 0,
              band_spec="gaussian:1500:300")
    q = dict(rating_threshold=100.0, widen_per_sec=widen, max_threshold=200.0)
    jcfg = JaxConfig(engine=JaxEngineConfig(backend="tpu", **kw),
                     queues=(JaxQueue(**q),))
    tcfg = Config(engine=EngineConfig(**kw), queues=(QueueConfig(**q),))
    return (TpuEngine(jcfg, jcfg.queues[0]),
            GpuEngine(tcfg, tcfg.queues[0], device="cpu"))


def test_engine_pruned_equals_jax_engine_and_port_dense():
    """The same stream through the JAX engine and the port's, both pruned
    and banded (the recipe of the JAX package's own test), and the port's
    dense engine with the same bands: the same matches and qualities,
    slot layouts and device pools."""
    jeng, teng = engines(True)
    _, dense = engines(False)
    assert teng.kernels.prune_window_blocks == W
    assert teng.pool.band_report() == jeng.pool.band_report()
    t, total = 1000.0, 0
    local = np.random.default_rng(7)
    for w in range(6):
        rows = [dict(id=f"w{w}_{i}", rating=float(local.normal(1500, 300)),
                     enqueued_at=t + w) for i in range(120)]
        outs = [e.search([cls(**r) for r in rows], t + w)
                for e, cls in ((jeng, JaxRequest), (teng, SearchRequest),
                               (dense, SearchRequest))]
        keyed = [sorted((tuple(sorted(m.result().players)), round(m.quality, 5))
                        for m in o.matches) for o in outs]
        assert keyed[1] == keyed[0] == keyed[2], w
        total += len(keyed[1])
        assert teng.pool._slot_of == jeng.pool._slot_of == dense.pool._slot_of
        active = pool_to_numpy(teng.dev_pool)["active"]
        np.testing.assert_array_equal(active,
                                      np.asarray(jeng._dev_pool["active"]))
    assert total > 100
    rep = teng.prune_report()
    assert rep["windows"] >= 6 and 0 <= rep["span_windows"] <= rep["windows"]
    assert dense.prune_report() is None


def test_warmup_counts_no_pruned_window():
    """``warmup()`` runs every variant's all-padding window; none of them is
    a window of traffic, so the pruned counts stay at zero and the first
    window counts as the first."""
    _, teng = engines(True)
    teng.warmup()
    assert teng.prune_report() == {"windows": 0, "span_windows": 0}
    teng.search([SearchRequest(id="a", rating=1500.0, enqueued_at=1.0),
                 SearchRequest(id="b", rating=1510.0, enqueued_at=1.0)], 1.0)
    assert teng.prune_report()["windows"] == 1
