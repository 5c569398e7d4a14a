"""The hand-written CUDA kernels against their plain PyTorch versions, and
the engine paths on CUDA tensors (the 1v1 step, dense and pruned, the team
and role steps, the quality accumulator) against the same code on the CPU,
on the card. Every test here is marked ``gpu`` and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none, but for the quality state's float sums. The kernels
round every f32 op on their own (explicit ``__f*_rn`` intrinsics, built
with ``--fmad=false``) exactly as the eager plain versions do, so values
are compared bit for bit and slots exactly; the team and role steps are
sorts, minima and ORs, exact on both devices. ``quality_accum`` sums its
samples in another order than the plain version's ``index_add_``: its
histograms and counts are exact, its sums within 1e-5 of the sum of their
addends' magnitudes (every addend is >= 0, so of the sum itself).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from matchmaking_tpu_torch.config import (
    Config,
    EngineConfig,
    ObservabilityConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.engine import cuda_kernels, scoring
from matchmaking_tpu_torch.engine.gpu import GpuEngine, _Readback
from matchmaking_tpu_torch.engine.kernels import (
    INDEX_FIELDS,
    KernelSet,
    QualityAccumKernel,
    admit,
    fresh_pool,
    unpack_batch,
)
from matchmaking_tpu_torch.engine.quality import QualitySpec
from matchmaking_tpu_torch.service.contract import RequestColumns, SearchRequest

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def inputs(seed, capacity, rows, active_frac, filters, device):
    rng = np.random.default_rng(seed)
    n = int(capacity * active_frac)
    pool = {
        "rating": rng.normal(1500, 300, capacity).astype(np.float32),
        "rd": rng.uniform(0, 350, capacity).astype(np.float32),
        "region": (rng.integers(0, 3, capacity) if filters
                   else np.zeros(capacity)).astype(np.int32),
        "mode": (rng.integers(0, 2, capacity) if filters
                 else np.zeros(capacity)).astype(np.int32),
        "threshold": rng.choice([50.0, 100.0, 150.0], capacity).astype(np.float32),
        "enqueue_t": rng.uniform(0, 5, capacity).astype(np.float32),
        "active": np.arange(capacity) < n,
    }
    batch = {
        "slot": np.arange(n - rows // 2, n - rows // 2 + rows, dtype=np.int32),
        "rating": rng.normal(1500, 300, rows).astype(np.float32),
        "rd": rng.uniform(0, 350, rows).astype(np.float32),
        "region": (rng.integers(0, 3, rows) if filters
                   else np.zeros(rows)).astype(np.int32),
        "mode": (rng.integers(0, 2, rows) if filters
                 else np.zeros(rows)).astype(np.int32),
        "valid": rng.random(rows) < 0.9,
    }
    q_thr = rng.choice([50.0, 100.0, 150.0], rows).astype(np.float32)
    to = lambda d: {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    return to(pool), to(batch), torch.from_numpy(q_thr).to(device)


def now_on(device, now):
    """The window's time as the kernels take it: a one-element f32 tensor
    on the card (the packed window's now row)."""
    return torch.tensor([now], dtype=torch.float32, device=device)


def assert_bit_equal(kernel, plain):
    (kv, ki), (rv, ri) = kernel, plain
    assert torch.equal(ki, ri)
    assert torch.equal(kv.view(torch.int32), rv.view(torch.int32))


# The four kernel instances (glicko2 x filters), each with widening off and
# on. A case without filter data also runs the no-filter instance.
CASES = {
    "elo": dict(glicko2=False, widen=0.0, filters=False),
    "widen": dict(glicko2=False, widen=7.0, filters=False),
    "glicko2": dict(glicko2=True, widen=0.0, filters=False),
    "glicko2_widen": dict(glicko2=True, widen=5.0, filters=False),
    "filters": dict(glicko2=False, widen=0.0, filters=True),
    "filters_widen": dict(glicko2=False, widen=7.0, filters=True),
    "glicko2_filters": dict(glicko2=True, widen=0.0, filters=True),
    "all": dict(glicko2=True, widen=5.0, filters=True),
}

#: (capacity, pool_block, rows): ragged shapes, then the main path's pool
#: (P = 131,072 in blocks of 8,192) at every window bucket and two odd B.
GEOMETRIES = ([(16384, 4096, 100), (256, 64, 16), (1024, 128, 1),
               (3072, 1536, 33), (1000, 125, 20)]
              + [(131072, 8192, b) for b in (1, 16, 33, 64, 256, 1024)])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_kernel_bit_equal_to_plain(cuda, case, geometry):
    capacity, pool_block, rows = geometry
    c = CASES[case]
    pool, batch, q_thr = inputs(3, capacity, rows, 0.7, c["filters"], cuda)
    kw = dict(pool_block=pool_block, glicko2=c["glicko2"], filters=True,
              widen_per_sec=c["widen"], max_threshold=250.0,
              g_coeff=scoring.G_COEFF_F32)
    now = now_on(cuda, 9.0)
    before = cuda_kernels.LAUNCHES["block_best"]
    got = cuda_kernels.block_best(pool, batch, q_thr, now, **kw)
    want = cuda_kernels.block_best_reference(pool, batch, q_thr, now, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["block_best"] == before + 1
    assert got[0].shape == (rows, capacity // pool_block)
    assert_bit_equal(got, want)
    if not c["filters"]:
        nf = cuda_kernels.block_best(pool, batch, q_thr, now,
                                     **dict(kw, filters=False))
        assert_bit_equal(nf, want)


def test_exact_ties_take_the_first_slot(cuda):
    capacity, pool_block = 4096, 1024
    pool, batch, q_thr = inputs(0, capacity, 40, 0.0, False, cuda)
    pool["rating"].fill_(9000.0)
    pool["threshold"].fill_(100.0)
    for blk in range(4):
        base = blk * pool_block + 37 * blk + 5
        # Both orders of the two equidistant ratings, spread over lanes.
        for j, r in enumerate((1510.0, 1490.0, 1490.0, 1510.0)):
            pool["rating"][base + 33 * j] = r
            pool["active"][base + 33 * j] = True
    batch["rating"].fill_(1500.0)
    batch["valid"].fill_(True)
    batch["slot"].fill_(capacity)
    q_thr.fill_(100.0)
    kw = dict(pool_block=pool_block, glicko2=False, filters=True,
              widen_per_sec=0.0, max_threshold=400.0,
              g_coeff=scoring.G_COEFF_F32)
    now = now_on(cuda, 0.0)
    v, i = cuda_kernels.block_best(pool, batch, q_thr, now, **kw)
    expect = torch.tensor([blk * pool_block + 37 * blk + 5 for blk in range(4)],
                          dtype=torch.int32, device=cuda)
    assert torch.equal(i, expect.expand(40, 4))
    assert (v == -10.0).all()
    assert_bit_equal((v, i), cuda_kernels.block_best_reference(
        pool, batch, q_thr, now, **kw))


def test_wrapper_refuses_mixed_devices(cuda):
    pool, batch, q_thr = inputs(1, 1024, 16, 0.5, False, cuda)
    with pytest.raises(ValueError, match="slot"):
        cuda_kernels.block_best(pool, dict(batch, slot=batch["slot"].cpu()),
                                q_thr, now_on(cuda, 0.0), pool_block=256,
                                glicko2=False,
                                filters=True, widen_per_sec=0.0,
                                max_threshold=400.0, g_coeff=0.0)


def test_engine_on_card_matches_engine_on_cpu(cuda):
    """The whole window path on the card (kernel, admission, pairing and
    eviction on CUDA tensors) against the same engine on the CPU."""
    cfg = Config(engine=EngineConfig(pool_capacity=8192, pool_block=2048),
                 queues=(QueueConfig(glicko2=True, widen_per_sec=5.0,
                                     max_threshold=250.0),))
    engines = [GpuEngine(cfg, cfg.queues[0], device=d) for d in (cuda, "cpu")]
    rng = np.random.default_rng(12)
    pid = 0
    for w in range(6):
        reqs = []
        for _ in range(int(rng.integers(20, 300))):
            reqs.append(SearchRequest(
                id=f"p{pid}", rating=float(rng.normal(1500, 200)),
                rating_deviation=float(rng.uniform(0, 350)),
                region=str(rng.choice(["eu", "na", "*"])),
                enqueued_at=100.0 + w - float(rng.uniform(0, 5))))
            pid += 1
        outs = [e.search(reqs, 100.0 + w) for e in engines]
        pairs = [{frozenset(r.id for r in m.requests()) for m in o.matches}
                 for o in outs]
        assert pairs[0] == pairs[1]
        assert ([r.id for r in outs[0].queued]
                == [r.id for r in outs[1].queued])
        assert engines[0].pool_size() == engines[1].pool_size()


@pytest.mark.parametrize("prune", [0, 2])
@pytest.mark.parametrize("skip_filters", [False, True])
def test_search_step_packed_does_not_sync(cuda, skip_filters, prune):
    """Admission, block_best (the dense launch, or the pruned step's sort,
    bounds, spans and span launch), pairing and eviction of one window,
    and the quality accumulator behind it, run without a device→host
    synchronisation."""
    P, B = 16384, 256
    ks = KernelSet(capacity=P, top_k=8, pool_block=4096, glicko2=True,
                   widen_per_sec=5.0, max_threshold=250.0,
                   prune_window_blocks=prune, prune_chunk=64)
    spec = QualitySpec()
    acc = QualityAccumKernel(capacity=P, widen_per_sec=5.0,
                             max_threshold=250.0,
                             rating_edges=spec.rating_edges,
                             n_quality=spec.n_quality,
                             wait_edges=spec.wait_edges)
    state = acc.init_state(cuda)
    pool = fresh_pool(P, cuda)
    rng = np.random.default_rng(4)

    def window(start, n_valid):
        packed = np.zeros((9, B), np.float32)
        packed[0] = P
        packed[0, :n_valid] = np.arange(start, start + n_valid)
        packed[1, :n_valid] = rng.normal(1500, 300, n_valid)
        packed[2, :n_valid] = rng.uniform(0, 350, n_valid)
        packed[5, :n_valid] = 100.0
        packed[6, :n_valid] = rng.uniform(0, 5, n_valid)
        packed[7, :n_valid] = 1.0
        packed[8] = 6.0
        return torch.from_numpy(packed).to(cuda)

    ks.admit_packed(pool, window(0, B))
    step = window(B, 200)  # padding lanes too
    ks.search_step_packed(pool, window(2 * B, 10), skip_filters)  # build
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ks.search_step_packed(pool, step, skip_filters)
        acc.accum(state, pool, out, step[-1])  # now: the packed row
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (out[0] < P).sum() > 0  # it formed matches
    assert int(state["count"].sum()) == 2 * int((out[0] < P).sum())
    if prune:
        assert ks.pruned_steps == 2 and ks.span_steps is not None


def widening_cfg(capacity=16384, pool_block=4096, **engine):
    return Config(engine=EngineConfig(pool_capacity=capacity,
                                      pool_block=pool_block, **engine),
                  queues=(QueueConfig(glicko2=True, widen_per_sec=5.0,
                                      max_threshold=250.0),))


def columns(rng, eng, n, start, now):
    """A seeded columnar window (all-wildcard region/mode)."""
    region, mode = eng.intern_columns(["*"] * n, ["*"] * n)
    ids = np.array([f"p{start + i}" for i in range(n)], object)
    return RequestColumns(
        ids=ids, rating=rng.normal(1500, 300, n).astype(np.float32),
        rd=rng.uniform(0, 350, n).astype(np.float32), region=region,
        mode=mode, threshold=np.full(n, np.nan, np.float32),
        enqueued_at=now - rng.uniform(0, 10, n),
        reply_to=np.array([f"rq.{i}" for i in ids], object),
        correlation_id=ids.copy())


PRUNED = dict(prune_window_blocks=2, prune_chunk=128,
              band_spec="gaussian:1500:300")
#: Bucketed formation on the same geometry (four blocks, spans of two).
BUCKETED = dict(bucketed=True, prune_window_blocks=2, prune_chunk=16,
                band_spec="gaussian:1500:300")


@pytest.mark.parametrize("engine", [{}, PRUNED, BUCKETED],
                         ids=["dense", "pruned", "bucketed"])
def test_columnar_dispatch_rescan_and_restore_do_not_sync(cuda, engine):
    """restore_columns, search_columns_async and rescan_async queue their
    device work (pinned staging, non-blocking copies, events, the quality
    accumulator behind each step; the pruned or bucketed step with
    ``engine``, whose index updates and heartbeat rebuild too) with no
    device→host synchronisation; the results then collect as usual, and
    the quality report counts every matched player."""
    cfg = widening_cfg(**engine)
    eng = GpuEngine(cfg, cfg.queues[0], device=cuda)
    eng.warmup()
    rng = np.random.default_rng(5)
    fill = columns(rng, eng, 4000, 0, 100.0)
    w1 = columns(rng, eng, 1024, 10_000, 101.0)
    w2 = columns(rng, eng, 300, 20_000, 102.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.restore_columns(fill, 100.0)
        t1 = eng.search_columns_async(w1, 101.0)
        eng.heartbeat(101.5)
        t2 = eng.search_columns_async(w2, 102.0)
        t3 = eng.rescan_async(2048, 104.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng.inflight() == 3
    outs = dict(eng.flush())
    assert list(outs) == [t1, t2, t3]
    assert outs[t1].n_matches > 0 and outs[t3].n_matches > 0
    assert not eng.failed_tokens and eng.device_error is None
    assert eng.quality_report()["samples"] == 2 * sum(
        o.n_matches for o in outs.values())


@pytest.mark.parametrize("engine", [{}, BUCKETED], ids=["dense", "bucketed"])
def test_window_marks_do_not_sync(cuda, engine):
    """The trace marks of a window are host stamps: two windows of two
    chunks each and a rescan tick dispatched under sync debug mode record
    dispatch, (h2d, device_step or formation_bucketed) per chunk and
    readback_seal with no device→host synchronisation; the collection
    adds collect."""
    cfg = widening_cfg(batch_buckets=(64, 512), **engine)
    eng = GpuEngine(cfg, cfg.queues[0], device=cuda)
    eng.warmup()
    rng = np.random.default_rng(9)
    fill = columns(rng, eng, 4000, 0, 100.0)
    w1 = columns(rng, eng, 1024, 10_000, 101.0)
    w2 = columns(rng, eng, 600, 20_000, 102.0)
    eng.restore_columns(fill, 100.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t1 = eng.search_columns_async(w1, 101.0)
        t2 = eng.search_columns_async(w2, 102.0)
        t3 = eng.rescan_async(1024, 104.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng.flush()
    step = "formation_bucketed" if engine else "device_step"
    for tok in (t1, t2):
        names = [n for n, _ in eng.window_marks.pop(tok)]
        assert names == (["dispatch"] + ["h2d", step] * 2
                         + ["readback_seal", "collect"]), names
    assert [n for n, _ in eng.window_marks.pop(t3)] == ["readback_seal",
                                                        "collect"]


def test_pinned_readback_waits_for_its_event(cuda):
    """The result copy is queued behind the device's work: before its
    event completes the pinned buffer is not the result; ``numpy()`` waits
    on the event and then equals a synchronous ``.cpu()`` of the same
    tensor."""
    out = torch.arange(3 * 1024, dtype=torch.float32,
                       device=cuda).reshape(3, 1024)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time ahead of the copy
    rb = _Readback(out)
    assert not rb.ready()
    got = rb.numpy()
    assert rb.ready()
    np.testing.assert_array_equal(got, out.cpu().numpy())
    # A window's own result: the step's output read back both ways.
    eng = GpuEngine(widening_cfg(), widening_cfg().queues[0], device=cuda)
    rng = np.random.default_rng(6)
    eng.restore_columns(columns(rng, eng, 3000, 0, 50.0), 50.0)
    batch = eng.pool.batch_arrays_cols(columns(rng, eng, 256, 5000, 51.0),
                                       np.arange(3000, 3256, dtype=np.int32),
                                       256, eng._rel_base(51.0))
    eng.pool.allocate_columns(columns(rng, eng, 256, 5000, 51.0))
    packed = eng._stage(batch, 1.0).to(cuda, non_blocking=True)
    step = eng.kernels.search_step_packed(eng.dev_pool, packed)
    np.testing.assert_array_equal(_Readback(step).numpy(), step.cpu().numpy())


def test_quality_readback_is_never_read_before_its_event(cuda):
    """The periodic copy of the quality state is queued at a finalize and
    taken at a later one only once its event has fired: while it is in
    flight, finalize keeps the last state read back and the report does
    not move; ``flush()`` then reads the state at once."""
    cfg = Config(engine=EngineConfig(pool_capacity=16384, pool_block=4096),
                 queues=(QueueConfig(),),
                 observability=ObservabilityConfig(quality_report_every=1))
    eng = GpuEngine(cfg, cfg.queues[0], device=cuda)
    eng.warmup()
    rng = np.random.default_rng(10)
    eng.restore_columns(columns(rng, eng, 3000, 0, 10.0), 10.0)
    eng.search_columns_async(columns(rng, eng, 512, 5000, 11.0), 11.0)
    eng.flush()
    first = eng.quality_report()["samples"]
    assert first > 0
    eng.search_columns_async(columns(rng, eng, 512, 6000, 12.0), 12.0)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s ahead of the state's copy
    (_, out), = eng.collect_ready()  # its finalize queues the copy
    pending = eng._q_sync
    assert pending is not None and not pending.ready()

    class Guard:
        """The copy in flight, refusing a read before its event."""

        taken = 0

        def ready(self):
            return pending.ready()

        def numpy(self):
            assert pending.event.query(), "read before its event"
            Guard.taken += 1
            return pending.numpy()

    eng._q_sync = Guard()
    eng._quality_sync_finalize()  # in flight: nothing is taken
    assert isinstance(eng._q_sync, Guard) and Guard.taken == 0
    assert eng.quality_report()["samples"] == first
    torch.cuda.synchronize()
    eng._quality_sync_finalize()  # landed: taken, and a new copy queued
    assert Guard.taken == 1
    assert eng.quality_report()["samples"] == first + 2 * out.n_matches
    eng.flush()
    assert eng.quality_report()["samples"] == first + 2 * out.n_matches


def quality_window(rng, capacity, b, matched, device):
    """Pool columns and a window result f32[3, b]: ``matched`` lanes pair
    distinct slots at their true distance, the rest hold the sentinels."""
    rating = rng.normal(1500, 300, capacity).astype(np.float32)
    enq = rng.uniform(0, 30, capacity).astype(np.float32)
    thr = rng.choice([0.0, 50.0, 100.0, 150.0], capacity).astype(np.float32)
    slots = rng.permutation(capacity)[:2 * b]
    q, c = slots[:b], slots[b:]
    hit = np.arange(b) < matched
    out = np.empty((3, b), np.float32)
    out[0] = np.where(hit, q, capacity)
    out[1] = np.where(hit, c, capacity)
    out[2] = np.where(hit, np.abs(rating[q] - rating[c]), np.inf)
    to = lambda a: torch.from_numpy(a).to(device)
    return {"rating": to(rating), "enqueue_t": to(enq),
            "threshold": to(thr)}, to(rng.permuted(out, axis=1))


def assert_quality_state(got, want):
    for name in ("q_hist", "w_hist", "count"):
        assert torch.equal(got[name], want[name]), name
    for name in ("q_sum", "w_sum", "d_sum"):
        np.testing.assert_allclose(got[name].cpu().numpy(),
                                   want[name].cpu().numpy(), rtol=1e-5,
                                   atol=0.0, err_msg=name)


#: Rating edges, quality buckets and wait edges of the kernel tests: the
#: default spec's (7 rating and 22 wait edges, what the engine runs), and
#: none, one and 32 rating edges (the most the kernel takes), each with 32
#: wait edges.
WAIT_32 = tuple(float(e) for e in np.geomspace(1e-3, 60.0, 32, dtype=np.float32))
EDGES = {"default": (QualitySpec().rating_edges, QualitySpec().n_quality,
                     QualitySpec().wait_edges),
         "rating0": ((), 20, WAIT_32), "rating1": ((1500.0,), 20, WAIT_32),
         "rating32": (tuple(float(e) for e in np.linspace(
             600.0, 2400.0, 32, dtype=np.float32)), 20, WAIT_32)}


@pytest.mark.parametrize("widen", [0.0, 2.0])
@pytest.mark.parametrize("edges", list(EDGES))
@pytest.mark.parametrize("b", [1, 16, 33, 256, 1000, 1024])
def test_quality_accum_equals_plain(cuda, b, edges, widen):
    """Windows of real-looking matches (zero thresholds among them), a
    window with fewer and one with none, folded into one state by the
    kernel and by the plain version on the same CUDA tensors: histograms
    and counts equal, sums within 1e-5 relative, the state accumulating
    across windows. B up to 256 launches one CTA, larger B a cluster of 8
    (256 is the last one-CTA bucket). The kernel reads ``now`` from a
    device tensor. A second state fed the same
    launches ends bit-equal (the sums' order is fixed)."""
    rating_edges, n_quality, wait_edges = EDGES[edges]
    capacity = 131072 if b >= 1000 else 4096
    acc = QualityAccumKernel(capacity=capacity, widen_per_sec=widen,
                             max_threshold=250.0, rating_edges=rating_edges,
                             n_quality=n_quality, wait_edges=wait_edges)
    got, again, want = (acc.init_state(cuda) for _ in range(3))
    rng = np.random.default_rng(capacity + b)
    kw = dict(widen_per_sec=widen, max_threshold=250.0,
              rating_edges=acc.rating_edges, n_quality=n_quality,
              wait_edges=acc.wait_edges)
    before = cuda_kernels.LAUNCHES["quality_accum"]
    matches = (max(1, b // 2), b // 3, 0)
    for w, matched in enumerate(matches):
        pool, out = quality_window(rng, capacity, b, matched, cuda)
        now = torch.full((b,), 30.0 + w, device=cuda)
        acc.accum(got, pool, out, now)
        acc.accum(again, pool, out, now)
        cuda_kernels.quality_accum_reference(
            want, pool["rating"], pool["enqueue_t"], pool["threshold"], out,
            30.0 + w, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["quality_accum"] == before + 6
    assert int(got["count"].sum()) == 2 * sum(matches)
    assert_quality_state(got, want)
    assert torch.equal(got.flat, again.flat)


def test_quality_accum_refuses_what_it_cannot_take(cuda):
    """33 edges, unsorted edges and a host ``now`` are refused before any
    launch; a wrong-shaped pool column handed in later is caught by the
    re-check that a new pool triggers."""
    spec = QualitySpec()
    before = cuda_kernels.LAUNCHES["quality_accum"]
    pool, out = quality_window(np.random.default_rng(1), 4096, 16, 8, cuda)
    now = torch.full((1,), 30.0, device=cuda)
    for rating_edges, what in ((tuple(range(33)), "at most 32"),
                               ((1600.0, 1400.0), "ascend")):
        acc = QualityAccumKernel(capacity=4096, widen_per_sec=0.0,
                                 max_threshold=250.0,
                                 rating_edges=rating_edges,
                                 n_quality=spec.n_quality,
                                 wait_edges=spec.wait_edges)
        with pytest.raises(ValueError, match=what):
            acc.accum(acc.init_state(cuda), pool, out, now)
    acc = QualityAccumKernel(capacity=4096, widen_per_sec=0.0,
                             max_threshold=250.0,
                             rating_edges=spec.rating_edges,
                             n_quality=spec.n_quality,
                             wait_edges=spec.wait_edges)
    state = acc.init_state(cuda)
    with pytest.raises(ValueError, match="now"):
        acc.accum(state, pool, out, 30.0)
    acc.accum(state, pool, out, now)
    with pytest.raises(ValueError, match="rating"):
        acc.accum(state, dict(pool, rating=torch.zeros(4097, device=cuda)),
                  out, now)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["quality_accum"] == before + 1


def span_inputs(seed, glicko2, filters, device, *, capacity=131072,
                block=8192, rows=1024, chunk=128, w=6):
    """A band-coherent pool at full width (ratings ascending by slot, as
    the gaussian bands lay them out), a rating-sorted window admitted into
    free slots, its effective thresholds, and the pruned step's own spans
    and feasibility for it."""
    from matchmaking_tpu_torch.engine.kernels import pool_from_reference

    rng = np.random.default_rng(seed)
    ks = KernelSet(capacity=capacity, top_k=8, pool_block=block,
                   glicko2=glicko2, widen_per_sec=2.0, max_threshold=250.0,
                   prune_window_blocks=w, prune_chunk=chunk)
    codes = lambda n, k: (rng.integers(0, k, n) if filters
                          else np.zeros(n)).astype(np.int32)
    active = rng.random(capacity) < 0.76
    pool = pool_from_reference({
        "rating": np.sort(rng.normal(1500, 300, capacity)).astype(np.float32),
        "rd": rng.uniform(0, 100, capacity).astype(np.float32),
        "region": codes(capacity, 3), "mode": codes(capacity, 2),
        "threshold": np.full(capacity, 30.0, np.float32),
        "enqueue_t": rng.uniform(0, 5, capacity).astype(np.float32),
        "active": active}, device)
    valid = np.arange(rows) < rows - 5  # padding sorts last
    ratings = np.sort(rng.normal(1500, 60, rows)).astype(np.float32)
    # Each arrival takes a free slot at its rating's place in the pool, as
    # the banded allocator would (distinct, in rating order).
    free = np.nonzero(~active)[0]
    at = np.searchsorted(free, np.searchsorted(pool["rating"].cpu().numpy()
                                               [:capacity], ratings))
    at = np.maximum.accumulate(at - np.arange(rows)) + np.arange(rows)
    batch = {
        "slot": np.where(valid, free[np.minimum(at, free.size - 1)], capacity),
        "rating": ratings,
        "rd": rng.uniform(0, 100, rows), "region": codes(rows, 3),
        "mode": codes(rows, 2), "threshold": np.full(rows, 30.0),
        "enqueue_t": rng.uniform(0, 5, rows), "valid": valid}
    batch = {k: torch.from_numpy(v.astype(
        np.bool_ if k == "valid" else np.int32 if k in ("slot", "region",
                                                         "mode")
        else np.float32)).to(device) for k, v in batch.items()}
    admit(pool, batch)
    q_thr = cuda_kernels.effective_threshold(
        batch["threshold"], batch["enqueue_t"], now_on(device, 9.0), 2.0,
        250.0)
    start, feasible = ks._chunk_windows(batch, q_thr, *ks._live_stats(pool))
    return ks, pool, batch, q_thr, start, feasible


@pytest.mark.parametrize("glicko2,filters", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_span_launch_equals_plain_at_full_width(cuda, glicko2, filters):
    """The span launch of all four instances at P = 131,072, B = 1,024,
    chunks of 128 and W = 6, feasible and infeasible, against its plain
    version on the same CUDA tensors; feasible, it equals the dense
    launch too (the spans hold every candidate)."""
    ks, pool, batch, q_thr, start, feasible = span_inputs(
        40 + 2 * glicko2 + filters, glicko2, filters, cuda)
    assert bool(feasible)
    kw = dict(pool_block=ks.pool_block, glicko2=glicko2, filters=filters,
              widen_per_sec=2.0, max_threshold=250.0,
              g_coeff=scoring.G_COEFF_F32)
    now = now_on(cuda, 9.0)
    dense = cuda_kernels.block_best(pool, batch, q_thr, now, **kw)
    for flag in (True, False):
        span = cuda_kernels.Span(start, 128, 6,
                                 torch.tensor([flag], device=cuda))
        got = cuda_kernels.block_best(pool, batch, q_thr, now, span=span, **kw)
        want = cuda_kernels.block_best_span_reference(pool, batch, q_thr, now,
                                                      span, **kw)
        assert_bit_equal(got, want)
        assert_bit_equal(got, dense)
    # Spans that miss candidates: only the span's blocks are scored.
    span = cuda_kernels.Span(torch.zeros_like(start), 128, 3,
                             torch.tensor([True], device=cuda))
    got = cuda_kernels.block_best(pool, batch, q_thr, now, span=span, **kw)
    assert_bit_equal(got, cuda_kernels.block_best_span_reference(
        pool, batch, q_thr, now, span, **kw))
    assert (got[1][:, 3:] == ks.capacity).all()


def test_span_launch_at_chunk_16_equals_plain_at_full_width(cuda):
    """The bucketed step's span launch of config #1 (chunks of 16 rows,
    so ``plan_grid`` takes 16 rows a CTA; W = 6) at P = 131,072 and
    B = 1,024, feasible and not, against its plain version and, feasible,
    the dense launch."""
    for glicko2, filters in ((False, False), (True, True)):
        ks, pool, batch, q_thr, start, feasible = span_inputs(
            60 + glicko2, glicko2, filters, cuda, chunk=16)
        assert bool(feasible) and start.shape == (64,)
        plan = cuda_kernels.plan_grid(1024, 16, 8192, cuda_kernels.sm_count(
            torch.cuda.current_device()), 16)
        assert plan.rows_per_cta == 16
        kw = dict(pool_block=ks.pool_block, glicko2=glicko2, filters=filters,
                  widen_per_sec=2.0, max_threshold=250.0,
                  g_coeff=scoring.G_COEFF_F32)
        now = now_on(cuda, 9.0)
        dense = cuda_kernels.block_best(pool, batch, q_thr, now, **kw)
        for flag in (True, False):
            span = cuda_kernels.Span(start, 16, 6,
                                     torch.tensor([flag], device=cuda))
            got = cuda_kernels.block_best(pool, batch, q_thr, now, span=span,
                                          **kw)
            assert_bit_equal(got, cuda_kernels.block_best_span_reference(
                pool, batch, q_thr, now, span, **kw))
            assert_bit_equal(got, dense)


@pytest.mark.parametrize("engine", [{}, BUCKETED], ids=["dense", "bucketed"])
def test_speculation_on_card_leaves_the_live_pool_and_commits_a_rescan(
        cuda, engine):
    """A speculation (its graphs replayed on the spare pool) leaves the
    live pool bit-equal; its commit equals two cold rescan ticks of a twin
    engine at the same time, queued back to back (pairs, distances, pools,
    quality states);
    speculating and committing queue no device→host synchronisation."""
    cfg = widening_cfg(**engine, spec_formation=True, spec_max_steps=2)
    spec, cold = (GpuEngine(cfg, cfg.queues[0], device=cuda)
                  for _ in range(2))
    rng = np.random.default_rng(6)
    fill = columns(rng, spec, 3000, 0, 100.0)
    for eng in (spec, cold):
        eng.warmup()
        eng.restore_columns(fill, 100.0)
    assert "spec/1024" in spec.graph_report()["graphs"]
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in spec.dev_pool.full.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert spec.speculate(130.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for k, v in before.items():
        assert torch.equal(spec.dev_pool.full[k], v), k
    launched = dict(cuda_kernels.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok = spec.spec_validate(130.0)
        spec.spec_commit(tok, 130.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # One quality fold a held chunk (two chunks of 1,024, two passes) at
    # the commit; no block_best launch.
    assert cuda_kernels.LAUNCHES["quality_accum"] - launched[
        "quality_accum"] == spec.spec_report()["spec_committed_steps"] == 4
    assert cuda_kernels.LAUNCHES["block_best"] == launched["block_best"]
    (_, got), = spec.flush()
    # Two ticks queued back to back pick the same players, as the two
    # passes do (the mirror lags until the flush).
    for _ in range(2):
        cold.rescan_async(2048, 130.0)
    want = [o for _, o in cold.flush()]
    for name in ("m_id_a", "m_id_b"):
        assert getattr(got, name).tolist() == sum(
            (getattr(o, name).tolist() for o in want), [])
    np.testing.assert_array_equal(
        got.m_dist.view(np.int32),
        np.concatenate([o.m_dist for o in want]).view(np.int32))
    assert got.n_matches > 0
    assert_same_engines(spec, cold)


def test_pruned_engine_on_card_equals_cpu(cuda):
    """A banded, pruned engine on the card and on the CPU: the same pairs
    and pool over windows of 1,024 (the span path and the fallback), and
    the span counter read once at the end."""
    cfg = widening_cfg(capacity=65536, pool_block=4096,
                       **dict(PRUNED, prune_window_blocks=6))
    engines = [GpuEngine(cfg, cfg.queues[0], device=d) for d in (cuda, "cpu")]
    rng = np.random.default_rng(11)
    fill = columns(rng, engines[0], 40_000, 0, 50.0)
    for e in engines:
        e.restore_columns(fill, 50.0)
    for w in range(4):
        cols = columns(rng, engines[0], 1024, 100_000 + 2000 * w, 51.0 + w)
        pairs = []
        for e in engines:
            e.search_columns_async(cols, 51.0 + w)
            (_, o), = e.flush()
            pairs.append({frozenset(p) for p in zip(o.m_id_a.tolist(),
                                                    o.m_id_b.tolist())})
        assert pairs[0] == pairs[1] and pairs[0]
        assert engines[0].pool._slot_of == engines[1].pool._slot_of
    assert engines[0].prune_report() == engines[1].prune_report()
    assert (engines[0].quality_report()["samples"]
            == engines[1].quality_report()["samples"])


@pytest.mark.parametrize("depth", [1, 2])
def test_columnar_pairs_equal_object_pairs_on_card(cuda, depth):
    """The same stream through the columnar path on the card (``depth``
    windows dispatched before each collection) and on the CPU: the same
    pairs and pool. The object path on the card forms the first window's
    pairs too."""
    cfg = widening_cfg()
    obj, col, cpu = (GpuEngine(cfg, cfg.queues[0], device=d)
                     for d in (cuda, cuda, "cpu"))
    rng = np.random.default_rng(9)
    windows = []
    for w in range(6):
        n = int(rng.integers(20, 1500))  # 1,500 lanes span two chunks
        windows.append((columns(rng, col, n, w * 10_000, 200.0 + w),
                        200.0 + w))
    pairs = {"obj": [], "col": [], "cpu": []}
    for w, (cols, now) in enumerate(windows):
        reqs = [SearchRequest(id=cols.ids[i], rating=float(cols.rating[i]),
                              rating_deviation=float(cols.rd[i]),
                              enqueued_at=float(cols.enqueued_at[i]),
                              reply_to=cols.reply_to[i],
                              correlation_id=cols.correlation_id[i])
                for i in range(len(cols))]
        out = obj.search(reqs, now)
        pairs["obj"].append({frozenset(r.id for r in m.requests())
                             for m in out.matches})
        for name, eng in (("col", col), ("cpu", cpu)):
            eng.search_columns_async(cols, now)
            if (w + 1) % depth == 0 or w == len(windows) - 1:
                for _, o in eng.flush():
                    pairs[name].append({frozenset(p) for p in zip(
                        o.m_id_a.tolist(), o.m_id_b.tolist())})
    assert pairs["col"] == pairs["cpu"]
    assert sum(len(p) for p in pairs["col"]) > 500
    # From the same pool, the object and columnar windows form the same
    # pairs. After that their slot layouts part (as the JAX package's do:
    # the object finalize frees a window's matched slots in two calls, the
    # columnar one in one), and with the layout the best-per-block lists.
    assert pairs["col"][0] == pairs["obj"][0]
    assert set(col.pool._slot_of) == set(cpu.pool._slot_of)


# ---- team and role steps (configs #3 and #5) --------------------------------

SLOTS5 = ("tank", "healer", "dps", "dps", "dps")


def team_step(kind, capacity, max_matches):
    from matchmaking_tpu_torch.engine.role_kernels import RoleKernelSet
    from matchmaking_tpu_torch.engine.teams import TeamKernelSet

    if kind == "team":  # config #3's queue
        return TeamKernelSet(capacity=capacity, team_size=5,
                             widen_per_sec=2.0, max_threshold=300.0,
                             max_matches=max_matches)
    return RoleKernelSet(capacity=capacity, team_size=5, role_slots=SLOTS5,
                         widen_per_sec=0.0, max_threshold=400.0,
                         max_matches=max_matches)


def team_inputs(ks, seed, batch, device):
    """A seeded pool ~70 % full (3 regions × 2 modes, ratings N(1500,
    300)) and a packed window of ``batch`` arrivals into free slots."""
    rng = np.random.default_rng(seed)
    P = ks.capacity
    pool = {
        "rating": rng.normal(1500, 300, P).astype(np.float32),
        "rd": np.zeros(P, np.float32),
        "region": rng.integers(1, 4, P).astype(np.int32),
        "mode": rng.integers(1, 3, P).astype(np.int32),
        "threshold": np.full(P, 120.0, np.float32),
        "enqueue_t": rng.uniform(0, 30, P).astype(np.float32),
        "active": rng.random(P) < 0.7,
    }
    if ks.is_role:
        pool["role_mask"] = rng.integers(1, 8, P).astype(np.int32)
    free = np.nonzero(~pool["active"])[0]
    packed = np.zeros((ks.pack_rows, batch), np.float32)
    packed[0] = P
    n = min(batch - 3, free.size)
    packed[0, :n] = free[:n]
    packed[1, :n] = rng.normal(1500, 300, n)
    packed[3, :n] = rng.integers(1, 4, n)
    packed[4, :n] = rng.integers(1, 3, n)
    packed[5, :n] = 120.0
    packed[6, :n] = 30.0
    packed[7, :n] = 1.0
    if ks.is_role:
        packed[8, :n] = rng.integers(1, 8, n)
    packed[-1] = 35.0
    return (kernels_pool(pool, ks, device),
            torch.from_numpy(packed).to(device))


def kernels_pool(arrays, ks, device):
    from matchmaking_tpu_torch.engine.kernels import pool_from_reference

    return pool_from_reference(arrays, device, ks.extra_pool_fields)


@pytest.mark.parametrize("kind", ["team", "role"])
def test_team_and_role_steps_do_not_sync(cuda, kind):
    """Admission, the sort, window formation, the Hall check (role), the
    selection rounds, extraction and eviction of one window, then a
    window dispatched by the engine, without a device→host sync."""
    ks = team_step(kind, 16384, 1024)
    pool, packed = team_inputs(ks, 1, 1024, cuda)
    ks.search_step_packed(pool, team_inputs(ks, 2, 256, cuda)[1])
    torch.cuda.synchronize()  # built: the role tables are on the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ks.search_step_packed(pool, packed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (out[0] < ks.capacity).sum() > 0
    queue = (QueueConfig(team_size=5, rating_threshold=120.0,
                         widen_per_sec=2.0, max_threshold=300.0)
             if kind == "team" else
             QueueConfig(team_size=5, rating_threshold=150.0,
                         role_slots=SLOTS5))
    cfg = Config(engine=EngineConfig(pool_capacity=16384), queues=(queue,))
    eng = GpuEngine(cfg, queue, device=cuda)
    eng.warmup()
    rng = np.random.default_rng(3)
    reqs = [SearchRequest(id=f"p{i}", rating=float(rng.normal(1500, 100)),
                          region="eu", game_mode="ranked",
                          roles=(("tank",), ("healer",), ("dps",))[i % 3],
                          enqueued_at=100.0) for i in range(1000)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok, _ = eng.search_async(reqs, 101.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    (got, out), = eng.flush()
    assert got == tok and out.matches and eng.counters == {}


@pytest.mark.parametrize("kind,capacity,max_matches",
                         [("team", 65536, 512), ("role", 16384, 1024)])
def test_team_and_role_steps_on_card_equal_cpu_at_full_width(
        cuda, kind, capacity, max_matches):
    """Configs #3 (P = 65,536, 512 matches a step) and #5 (P = 16,384): two
    windows of 1,024 in a row on the card and on the CPU; outputs and the
    pool bit-equal."""
    from matchmaking_tpu_torch.engine.kernels import pool_to_numpy

    ks = team_step(kind, capacity, max_matches)
    pools, outs = {}, {}
    for dev in (cuda, torch.device("cpu")):
        pool, packed = team_inputs(ks, 7, 1024, dev)
        first = ks.search_step_packed(pool, packed)
        later = team_inputs(ks, 8, 1024, dev)[1]
        later[-1] = 40.0  # the second window's time
        second = ks.search_step_packed(pool, later)
        outs[dev.type] = [first.cpu().numpy(), second.cpu().numpy()]
        pools[dev.type] = pool_to_numpy(pool)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for name, col in pools["cpu"].items():
        np.testing.assert_array_equal(pools["cuda"][name], col, err_msg=name)
    assert (outs["cuda"][0][0] < capacity).sum() > (
        100 if kind == "team" else 10)


def test_delegated_window_never_touches_the_device_pool(cuda):
    """A wildcard hands a 5v5 queue to the host oracle: the device pool is
    dropped and no step runs while delegated (the steps are made to raise);
    after the quiet period the queue is back on a fresh device pool."""
    queue = QueueConfig(team_size=5, rating_threshold=120.0)
    cfg = Config(engine=EngineConfig(pool_capacity=4096), queues=(queue,))
    eng = GpuEngine(cfg, queue, device=cuda)
    pinned = [SearchRequest(id=f"p{i}", rating=1000.0 * i, region="eu",
                            game_mode="ranked", enqueued_at=1.0)
              for i in range(8)]
    eng.search(pinned, 1.0)
    ks = eng.kernels

    def refuse(*_a, **_k):
        raise AssertionError("a device step ran while delegated")

    real = ks.search_step_packed, ks.admit_packed
    ks.search_step_packed = ks.admit_packed = refuse
    try:
        out = eng.search([SearchRequest(id="w", rating=0.0, region="*",
                                        enqueued_at=2.0)], 2.0)
        assert eng.counters == {"team_delegated": 1} and eng.dev_pool is None
        assert [r.id for r in out.queued] == ["w"]
        tok, _ = eng.search_async([SearchRequest(
            id="x", rating=1.0, region="eu", game_mode="ranked",
            enqueued_at=3.0)], 3.0)
        assert [t for t, _ in eng.flush()] == [tok]
        assert eng.rescan_async(1024, 4.0) is None
        assert eng.remove("w").id == "w"
    finally:
        ks.search_step_packed, ks.admit_packed = real
    assert eng.heartbeat(20.0)  # quiet, no wildcard left: back on the card
    assert eng.counters == {"team_delegated": 1, "team_repromoted": 1}
    assert eng.dev_pool is not None and eng.pool_size() == 9
    assert int(eng.dev_pool["active"].sum()) == 9


# ---- the window step as one CUDA graph per (variant, bucket) -----------------

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
#: Config #1's pruning (band_spec, six blocks a chunk, chunks of 128).
PRUNE_1 = dict(prune_window_blocks=6, prune_chunk=128,
               band_spec="gaussian:1500:300")
#: Config #1 bucketed, with the JAX bench's geometry (chunks of 16).
BUCKETED_1 = dict(bucketed=True, prune_window_blocks=6, prune_chunk=16,
                  band_spec="gaussian:1500:300")


def graph_and_eager(cuda, name, **engine):
    """Two engines of config ``name`` (a file under configs/, at its full
    width) on the card, both warmed up: one replays its captured steps,
    the other runs the same steps eagerly (its graph set taken away, which
    only a test does)."""
    cfg = Config.from_json(os.path.join(CONFIGS, name + ".json"),
                           backend="gpu")
    if engine:
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, **engine))
    queue = cfg.queues[0]
    graphed = GpuEngine(cfg, queue, device=cuda)
    graphed.warmup()
    eager = GpuEngine(cfg, queue, device=cuda)
    eager._graphs = None
    eager.warmup()
    return graphed, eager


def named_columns(rng, n, start, now, filtered):
    """A seeded columnar window with region and mode names (wildcards
    only, or a mix of names and wildcards)."""
    ids = np.array([f"p{start + i}" for i in range(n)], object)
    pick = lambda names: (np.array(names, object)[rng.integers(0, len(names), n)]
                          if filtered else np.full(n, "*", object))
    cols = RequestColumns(
        ids=ids, rating=rng.normal(1500, 300, n).astype(np.float32),
        rd=rng.uniform(30, 350, n).astype(np.float32), region=None,
        mode=None, threshold=np.full(n, np.nan, np.float32),
        enqueued_at=now - rng.uniform(0, 20, n),
        reply_to=np.array([f"rq.{i}" for i in ids], object),
        correlation_id=ids.copy())
    return cols, pick(("eu", "na", "*")), pick(("ranked", "casual", "*"))


def interned(eng, window):
    cols, regions, modes = window
    region, mode = eng.intern_columns(regions.tolist(), modes.tolist())
    return dataclasses.replace(cols, region=region, mode=mode)


def assert_same_engines(graphed, eager):
    """Pool columns bit-equal, the host mirrors equal, the quality states
    (1v1) bit-equal."""
    torch.cuda.synchronize()
    for name, col in eager.dev_pool.full.items():
        assert torch.equal(graphed.dev_pool.full[name].view(torch.int8),
                           col.view(torch.int8)), name
    assert graphed.pool._slot_of == eager.pool._slot_of
    if eager._q_dev is not None:
        assert torch.equal(graphed._q_dev.flat, eager._q_dev.flat)


def assert_same_columnar(got, want):
    for name in ("m_id_a", "m_id_b", "q_ids", "m_reply_a", "m_corr_b"):
        assert getattr(got, name).tolist() == getattr(want, name).tolist(), name
    for name in ("m_dist", "m_quality"):
        np.testing.assert_array_equal(getattr(got, name).view(np.int32),
                                      getattr(want, name).view(np.int32))
    assert got.rejected == want.rejected


@pytest.mark.parametrize("name,engine", [("elo_1v1", {}),
                                         ("elo_1v1", PRUNE_1),
                                         ("glicko2", {}),
                                         ("elo_1v1", BUCKETED_1)],
                         ids=["elo_1v1", "elo_1v1_pruned", "glicko2",
                              "elo_1v1_bucketed"])
def test_replay_bit_equal_to_eager_1v1_at_full_width(cuda, name, engine):
    """Configs #1 (dense and pruned) and #4 at P = 131,072 with 100k
    waiting: at every bucket, a filtered window (the filter variant), a
    wildcard one (the variant without filters) and a rescan tick of the
    bucket's size go through the replayed graphs and through the eager
    steps; the outcomes (pairs, distances and qualities bit for bit, the
    queued ids), the pools and the quality states are equal. Then a window
    of two chunks of 1,024 and a rescan tick of two chunks, each chunk
    replaying one graph before the window's readbacks are queued: each
    chunk reads back its own result. No window captures again."""
    graphed, eager = graph_and_eager(cuda, name, **engine)
    captures = graphed.graph_report()["captures"]
    assert captures == 4 * 3
    rng = np.random.default_rng(50)
    fill = named_columns(rng, 100_000, 0, 100.0, True)
    for eng in (graphed, eager):
        eng.restore_columns(interned(eng, fill), 100.0)
    t, start = 101.0, 1_000_000
    plan = [(b, f, 1) for b in graphed.buckets for f in (True, False)]
    for bucket, filtered, chunks in plan + [(1024, False, 2)]:
        window = named_columns(rng, bucket * chunks, start, t, filtered)
        start += bucket * chunks
        outs = []
        for eng in (graphed, eager):
            tok = eng.search_columns_async(interned(eng, window), t)
            (got_tok, out), = eng.flush()
            assert got_tok == tok
            outs.append(out)
        assert_same_columnar(*outs)
        assert_same_engines(graphed, eager)
        ticks = []
        for eng in (graphed, eager):
            tok = eng.rescan_async(bucket * chunks, t + 0.25)
            (_, out), = eng.flush()
            eng.rescan_tokens.discard(tok)
            ticks.append(out)
        assert_same_columnar(*ticks)
        assert_same_engines(graphed, eager)
        t += 0.5
    assert graphed.graph_report()["captures"] == captures
    assert graphed.prune_report() == eager.prune_report()
    assert graphed.formation_report() == eager.formation_report()
    assert graphed.quality_report()["samples"] > 0


def team_requests(rng, n, start, now, roles):
    return [SearchRequest(
        id=f"p{start + i}", rating=float(rng.normal(1500, 300)),
        region=("eu", "na", "apac")[i % 3], game_mode=("ranked", "casual")[i % 2],
        roles=(("tank",), ("healer",), ("dps",), ("dps", "healer"), ())[i % 5]
        if roles else (),
        enqueued_at=now - float(rng.uniform(0, 20))) for i in range(n)]


def match_rows(out):
    return [(tuple(r.id for r in m.teams[0]), tuple(r.id for r in m.teams[1]),
             np.float32(m.quality).view(np.int32).item()) for m in out.matches]


@pytest.mark.parametrize("name,waiting", [("team_5v5", 50_000),
                                          ("role_party", 12_000)])
def test_replay_bit_equal_to_eager_team_and_role_at_full_width(
        cuda, name, waiting):
    """Configs #3 (P = 65,536) and #5 (P = 16,384), ``waiting`` players
    restored: a window of every bucket, then a rescan tick, through the
    replayed graph and the eager step: the same matches (teams, members
    and quality bit for bit), queued players and pools. No window captures
    again."""
    graphed, eager = graph_and_eager(cuda, name)
    captures = graphed.graph_report()["captures"]
    assert captures == 4
    rng = np.random.default_rng(51)
    roles = name == "role_party"
    fill = team_requests(rng, waiting, 0, 100.0, roles)
    for eng in (graphed, eager):
        eng.restore(fill, 100.0)
    t, start = 101.0, 1_000_000
    for bucket in graphed.buckets:
        reqs = team_requests(rng, bucket, start, t, roles)
        start += bucket
        outs = [eng.search(reqs, t) for eng in (graphed, eager)]
        assert match_rows(outs[0]) == match_rows(outs[1])
        assert ([r.id for r in outs[0].queued]
                == [r.id for r in outs[1].queued])
        assert_same_engines(graphed, eager)
        t += 0.5
    ticks = []
    for eng in (graphed, eager):
        tok = eng.rescan_async(1024, t + 30.0)
        (_, out), = eng.flush()
        eng.rescan_tokens.discard(tok)
        ticks.append(out)
    assert match_rows(ticks[0]) == match_rows(ticks[1])
    assert_same_engines(graphed, eager)
    assert graphed.counters == {} and match_rows(outs[0])
    assert graphed.graph_report()["captures"] == captures


def test_two_chunks_of_one_bucket_read_back_their_own(cuda):
    """A window of 2,048 lanes is two chunks of bucket 1,024, both replays
    of one graph queued before the window's readbacks: each chunk's result
    is its own (the eager step's), not the second chunk's twice."""
    graphed, eager = graph_and_eager(cuda, "elo_1v1", pool_capacity=16384,
                                     pool_block=4096)
    rng = np.random.default_rng(52)
    fill = named_columns(rng, 10_000, 0, 10.0, False)
    window = named_columns(rng, 2048, 100_000, 11.0, False)
    outs = []
    for eng in (graphed, eager):
        eng.restore_columns(interned(eng, fill), 10.0)
        eng.search_columns_async(interned(eng, window), 11.0)
        outs.append(eng._pending[-1])
        (_, out), = eng.flush()
        outs[-1] = (outs[-1].raw, out)
    (graph_raw, graph_out), (eager_raw, eager_out) = outs
    assert len(graph_raw) == 2
    for got, want in zip(graph_raw, eager_raw):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(graph_raw[0], graph_raw[1])
    assert_same_columnar(graph_out, eager_out)
    assert graphed.graph_report()["graphs"]["dense_nofilter/1024"][
        "replays"] == 2


def test_replay_after_the_pool_is_replaced_writes_the_new_pool(cuda):
    """Replacing the engine's device pool drops every graph (they hold the
    old pool's addresses); the next window captures anew and admits into
    the new pool, leaving the old one as it was."""
    from matchmaking_tpu_torch.engine.kernels import fresh_pool as fresh

    cfg = widening_cfg()
    eng = GpuEngine(cfg, cfg.queues[0], device=cuda)
    eng.warmup()
    assert len(eng.graph_report()["graphs"]) == 4 * 3
    old = eng.dev_pool
    eng.dev_pool = fresh(eng.kernels.capacity, cuda)
    assert eng.graph_report()["graphs"] == {}
    rng = np.random.default_rng(53)
    eng.search_columns_async(columns(rng, eng, 500, 0, 10.0), 10.0)
    (_, out), = eng.flush()
    assert int(eng.dev_pool["active"].sum()) == eng.pool_size() == (
        500 - 2 * out.n_matches)
    assert int(old["active"].sum()) == 0
    assert list(eng.graph_report()["graphs"]) == ["dense_nofilter/1024"]


@pytest.mark.parametrize("kind", ["dense", "pruned", "team", "role",
                                  "bucketed"])
def test_warmup_captures_every_pair_and_replays_never_capture(cuda, kind):
    """``warmup()`` captures one graph per (variant, bucket); windows of
    every bucket and rescan ticks afterwards only replay them, and each
    replay counts its kernels' launches."""
    if kind in ("team", "role"):
        queue = (QueueConfig(team_size=5, rating_threshold=120.0,
                             widen_per_sec=2.0, max_threshold=300.0)
                 if kind == "team" else
                 QueueConfig(team_size=5, rating_threshold=150.0,
                             role_slots=SLOTS5))
        cfg = Config(engine=EngineConfig(pool_capacity=16384,
                                         team_max_matches=512),
                     queues=(queue,))
        variants = [kind]
    elif kind == "bucketed":
        cfg = widening_cfg(**BUCKETED, spec_formation=True)
        variants = ["bucketed", "bucketed_nofilter", "bucketed_rescan",
                    "spec"]
    else:
        cfg = widening_cfg(**(PRUNED if kind == "pruned" else {}))
        base = "pruned" if kind == "pruned" else "dense"
        variants = [base, base + "_nofilter", "rescan"]
    eng = GpuEngine(cfg, cfg.queues[0], device=cuda)
    eng.warmup()
    rep = eng.graph_report()
    want = {f"{v}/{b}" for v in variants for b in eng.buckets}
    assert set(rep["graphs"]) == want and rep["captures"] == len(want)
    for g in rep["graphs"].values():
        assert g["replays"] == 0 and g["capture_ms"] > 0
        assert g["memory_bytes"] > 0
    rng = np.random.default_rng(54)
    before = dict(cuda_kernels.LAUNCHES)
    t = 10.0
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for bucket in eng.buckets:
            if kind in ("team", "role"):
                eng.search(team_requests(rng, bucket, int(t) * 10_000, t,
                                         kind == "role"), t)
            else:
                for filtered in (True, False):
                    eng.search_columns_async(interned(eng, named_columns(
                        rng, bucket, int(t * 10) * 10_000, t, filtered)), t)
                    eng.flush()
            tok = eng.rescan_async(bucket, t + 0.25)
            if tok is not None:
                eng.flush()
                eng.rescan_tokens.discard(tok)
            t += 1.0
        torch.cuda.synchronize()
    rep = eng.graph_report()
    assert rep["captures"] == len(want)
    replays = sum(g["replays"] for g in rep["graphs"].values())
    assert replays >= len(eng.buckets)
    launched = {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items()}
    one_v_one = kind in ("dense", "pruned", "bucketed")
    assert launched == {"block_best": replays if one_v_one else 0,
                        "quality_accum": replays if one_v_one else 0}
    # What the device ran inside the replays, counted by the profiler: one
    # of each hand kernel per 1v1 replay, none on a team or role step.
    ran = {name: sum(e.count for e in prof.key_averages()
                     if name in e.key and str(e.device_type).endswith("CUDA"))
           for name in ("prep_kernel", "block_best_kernel",
                        "quality_accum_kernel")}
    assert ran == dict.fromkeys(ran, replays if one_v_one else 0)
    if kind in ("pruned", "bucketed"):
        # Every replay of a pruned (bucketed) traffic graph is a pruned
        # window; the warm-up before each capture is none, and a rescan
        # counts as none.
        assert eng.prune_report()["windows"] == sum(
            g["replays"] for k, g in rep["graphs"].items()
            if not k.split("/")[0].endswith("rescan"))


# ---- the breaker's probe, close, and chaos on the card ----------------------

def full_width_engine(cuda, engine=None, **kw):
    """Config #1 at full width on the card with 100k waiting and one
    window of 1,024 through it (so the quality state holds matches)."""
    cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                           backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, **(engine or {})), **kw)
    eng = GpuEngine(cfg, cfg.queues[0], device=cuda)
    rng = np.random.default_rng(61)
    eng.restore_columns(interned(eng, named_columns(rng, 100_000, 0, 100.0,
                                                    False)), 100.0)
    eng.search_columns_async(interned(eng, named_columns(
        rng, 1024, 1_000_000, 101.0, False)), 101.0)
    eng.flush()
    return eng


def device_state(eng):
    """Every pool and index column (the views: no spare element) and the
    quality state, as raw bytes."""
    torch.cuda.synchronize()
    state = {k: v.view(torch.int8).clone() for k, v in eng.dev_pool.items()}
    state["quality"] = eng._q_dev.flat.view(torch.int8).clone()
    return state


def assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("engine", [{}, BUCKETED_1], ids=["dense", "bucketed"])
def test_probe_at_full_width_leaves_pool_index_and_quality_bit_equal(
        cuda, engine):
    """``probe()`` on a full pool: one replay of the base step's graph at
    the smallest bucket (one ``block_best`` and one ``quality_accum``
    launch, and one more of each in the eager run before the graph's
    capture, where the probe captures it) leaves every pool column, the
    bucket index and the quality state bit-equal, and the prune and
    formation reports as they were."""
    eng = full_width_engine(cuda, engine)
    before = device_state(eng)
    reports = (eng.prune_report(), eng.formation_report(),
               eng.quality_report())
    launches = dict(cuda_kernels.LAUNCHES)
    captures = eng.graph_report()["captures"]
    for _ in range(2):  # the second probe replays the graph the first made
        eng.probe()
    runs = 2 + eng.graph_report()["captures"] - captures
    assert {k: v - launches[k] for k, v in cuda_kernels.LAUNCHES.items()} == {
        "block_best": runs, "quality_accum": runs}
    assert_same_state(device_state(eng), before)
    assert (eng.prune_report(), eng.formation_report(),
            eng.quality_report()) == reports


def test_close_returns_memory_allocated(cuda):
    """An engine with every graph captured and the spare pool of
    speculation made holds device memory; ``close()`` gives it back: the
    allocated bytes return to within 5 % of the engine's share of what
    was allocated before it was built."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = full_width_engine(cuda, {"spec_formation": True})
    eng.warmup()
    assert eng.speculate(102.0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    assert held > 131_072 * 4 * 8
    eng.close()
    gc.collect()
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - base) <= 0.05 * held


def test_a_chaos_failed_dispatch_touches_no_device_state(cuda):
    """A dispatch the chaos hook fails raises before its chunk touches
    anything: the device pool, the index, the quality state and the mirror
    are as they were, and the next dispatch runs."""
    from matchmaking_tpu_torch.config import ChaosConfig
    from matchmaking_tpu_torch.utils.chaos import (
        ChaosInjectedError,
        EngineChaosHook,
    )

    eng = full_width_engine(cuda, BUCKETED_1)
    eng.chaos_hook = EngineChaosHook(ChaosConfig(fail_steps=(0,)))
    before = device_state(eng)
    slots = dict(eng.pool._slot_of)
    free = eng.pool.band_report()
    rng = np.random.default_rng(62)
    window = interned(eng, named_columns(rng, 1024, 2_000_000, 103.0, False))
    with pytest.raises(ChaosInjectedError):
        eng.search_columns_async(window, 103.0)
    assert eng.inflight() == 0
    assert_same_state(device_state(eng), before)
    assert eng.pool._slot_of == slots and eng.pool.band_report() == free
    eng.search_columns_async(window, 103.5)
    (_, out), = eng.flush()
    assert out.n_matches > 0


def test_columnar_dispatch_with_qos_columns_does_not_sync(cuda):
    """Overload control's columns (tier, deadline) ride the columnar
    dispatch and restore with no device→host synchronisation; the mirror
    counts them per tier."""
    cfg = widening_cfg()
    eng = GpuEngine(cfg, cfg.queues[0], device=cuda)
    eng.warmup()
    rng = np.random.default_rng(63)

    def qos(cols, now):
        n = len(cols)
        return dataclasses.replace(
            cols, tier=rng.integers(0, 3, n).astype(np.int32),
            deadline=np.where(rng.random(n) < 0.3, now + 30.0, 0.0))

    fill = qos(columns(rng, eng, 4000, 0, 100.0), 100.0)
    w1 = qos(columns(rng, eng, 1024, 10_000, 101.0), 101.0)
    w2 = qos(columns(rng, eng, 300, 20_000, 102.0), 102.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.restore_columns(fill, 100.0)
        eng.search_columns_async(w1, 101.0)
        counts = eng.pool_tier_counts(3)
        eng.search_columns_async(w2, 102.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sum(counts) == 5024
    outs = eng.flush()
    assert len(outs) == 2 and not eng.failed_tokens
    tiers = np.concatenate([fill.tier, w1.tier, w2.tier])
    matched = sum(o.n_matches for _, o in outs)
    assert sum(eng.pool_tier_counts(3)) == len(tiers) - 2 * matched


def journal_dir_at_full_width(tmp_path, cfg):
    """A crashed queue's journal directory at config #1's width: a
    compaction snapshot of 100k waiting players, then a tail of two
    windows' admissions (2,048 players) and the terminals of 1,000 of the
    snapshot's players, abandoned as a crash leaves it."""
    from matchmaking_tpu_torch.utils import checkpoint, journal

    src = GpuEngine(cfg, cfg.queues[0], device="cpu")
    rng = np.random.default_rng(71)
    fill = named_columns(rng, 100_000, 0, 100.0, True)
    src.restore_columns(interned(src, fill), 100.0)
    j = journal.PoolJournal(str(tmp_path), cfg.queues[0].name)
    anchor, snap = j.compact_begin()
    checkpoint.save_pool(src, snap)
    j.compact_finish(anchor, snap)
    for w in range(2):
        cols, regions, modes = named_columns(rng, 1024, 200_000 + 1024 * w,
                                             101.0, True)
        j.append_admits([
            [pid, float(r), float(d), reg, mode, None, float(e), rep, pid, 0,
             0.0]
            for pid, r, d, reg, mode, e, rep in zip(
                cols.ids.tolist(), cols.rating.tolist(), cols.rd.tolist(),
                regions.tolist(), modes.tolist(), cols.enqueued_at.tolist(),
                cols.reply_to.tolist())])
    j.append_terminals([(f"p{i}", b"matched", 1e12)
                        for i in range(0, 100_000, 100)])
    j.commit()
    j.abandon()
    return journal.PoolJournal(str(tmp_path), cfg.queues[0].name).recovered


def recover_into(eng, rec, now):
    """The service's recovery steps (``_QueueRuntime.recover_from_journal``)
    on an engine: the snapshot, the removes, the tail, the heartbeat."""
    from matchmaking_tpu_torch.utils import checkpoint, journal

    eng.spec_invalidate("journal replay")
    n = checkpoint.load_pool(eng, rec.snapshot, now)
    eng.remove_many(sorted(rec.removed))
    eng.restore([journal.row_to_request(rec.waiting[p])
                 for p in sorted(rec.waiting)], now)
    eng.heartbeat(now)
    return n


@pytest.mark.parametrize("engine", [{}, BUCKETED_1], ids=["dense", "bucketed"])
def test_journal_recovery_at_full_width_is_sync_free_and_equals_cpu(
        cuda, tmp_path, engine):
    """A journal's recovery (100k from the snapshot through
    ``restore_columns``, 1,000 removes, 2,048 from the tail, the
    heartbeat) onto a warmed-up engine on the card queues its device work
    with no device→host synchronisation; its pool columns (the bucket
    index too) and mirror equal a CPU engine's recovery of the same files,
    and (bucketed) the index equals its own host rebuild."""
    cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                           backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, **engine))
    rec = journal_dir_at_full_width(tmp_path, cfg)
    assert not rec.clean and len(rec.removed) == 1000
    assert len(rec.waiting) == 2048
    card = GpuEngine(cfg, cfg.queues[0], device=cuda)
    card.warmup()
    host = GpuEngine(cfg, cfg.queues[0], device="cpu")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert recover_into(card, rec, 150.0) == 100_000
    finally:
        torch.cuda.set_sync_debug_mode(0)
    recover_into(host, rec, 150.0)
    assert card.pool_size() == host.pool_size() == 101_048
    assert card.pool._slot_of == host.pool._slot_of
    torch.cuda.synchronize()
    for name, col in host.dev_pool.full.items():
        assert torch.equal(card.dev_pool.full[name].cpu().view(torch.int8),
                           col.view(torch.int8)), name
    if engine:
        names = [n for n, _ in INDEX_FIELDS]
        held = {k: card.dev_pool[k].clone() for k in names}
        card.kernels.index_rebuild(card.dev_pool)
        for k in names:
            assert torch.equal(held[k], card.dev_pool[k]), k
    # The recovered engine serves: a window matches on the card.
    rng = np.random.default_rng(72)
    card.search_columns_async(interned(card, named_columns(
        rng, 1024, 900_000, 151.0, False)), 151.0)
    (_, out), = card.flush()
    assert out.n_matches > 0 and card.device_error is None


def test_capture_survives_a_collection_of_older_graphs(cuda):
    """A cyclic garbage collection that frees an older engine (and so
    destroys its captured graphs, a CUDA call a capturing stream forbids)
    cannot land inside a capture: with the collector forced to run at
    every allocation, a new engine still captures every graph, and its
    windows replay."""
    import gc

    cfg = widening_cfg()
    old = GpuEngine(cfg, cfg.queues[0], device=cuda)
    old.warmup()
    cycle = [old]
    cycle.append(cycle)  # only the cyclic collector frees it
    del old, cycle
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng = GpuEngine(cfg, cfg.queues[0], device=cuda)
        real_step_fn, collecting = eng._step_fn, []

        def step_fn(variant):
            fn = real_step_fn(variant)

            def run(pool, packed):
                if torch.cuda.is_current_stream_capturing():
                    collecting.append(gc.isenabled())
                return fn(pool, packed)
            return run
        eng._step_fn = step_fn
        eng.warmup()
    finally:
        gc.set_threshold(*thresholds)
    assert collecting and not any(collecting) and gc.isenabled()
    rng = np.random.default_rng(73)
    eng.restore_columns(columns(rng, eng, 4000, 0, 100.0), 100.0)
    eng.search_columns_async(columns(rng, eng, 1024, 10_000, 101.0), 101.0)
    (_, out), = eng.flush()
    assert out.n_matches > 0 and eng.device_error is None
    assert eng.graph_report()["captures"] == len(eng.graph_report()["graphs"])


def test_telemetry_scrape_and_capture_do_not_sync(cuda):
    """Config #1's service at full width on the card with 100k waiting and
    two windows of 1,024 in flight (dispatched on the runtime's engine,
    not collected): under sync debug mode a telemetry tick
    (``sample_telemetry``, the burn monitors included), a ``/metrics``
    report (``build_report``, which reads ``util_report``,
    ``quality_report`` and ``formation_report``), its Prometheus text and
    an incident capture (a ``breaker_trip`` stamped on the spine) read no
    device memory."""
    import asyncio

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.observability import (
        _flatten_prom,
        build_report,
    )

    cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                           backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        observability=ObservabilityConfig(slo_target_ms=100.0))

    async def run():
        app = MatchmakingApp(cfg, device=cuda)
        await app.start()
        try:
            rt = app.runtime(cfg.queues[0].name)
            eng = rt.engine
            rng = np.random.default_rng(71)
            eng.restore_columns(interned(eng, named_columns(
                rng, 100_000, 0, 100.0, False)), 100.0)
            windows = [interned(eng, named_columns(
                rng, 1024, 1_000_000 + 2048 * k, 101.0 + k, False))
                for k in range(2)]
            app.sample_telemetry(now=1.0)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for k, w in enumerate(windows):
                    eng.search_columns_async(w, 101.0 + k)
                assert eng.inflight() == 2
                vals = app.sample_telemetry(now=2.0)
                report = build_report(app)
                text = _flatten_prom(report)
                app.events.append("breaker_trip", rt.queue_cfg.name,
                                  "fixture trip")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            outs = eng.flush()
        finally:
            await app.stop()
        return app, vals, report, text, outs

    app, vals, report, text, outs = asyncio.run(run())
    q = cfg.queues[0].name
    assert len(outs) == 2 and all(o.n_matches > 0 for _, o in outs)
    assert vals[f"pool_size[{q}]"] > 100_000
    assert report["pools"][q] == vals[f"pool_size[{q}]"]
    assert f'matchmaking_pool_size{{queue="{q}"}}' in text
    assert app.incidents.by_class == {"breaker_trip": 1}


def test_a_graph_captured_under_the_profiler_replays_bit_equal(cuda):
    """A window step whose CUDA graph is captured while torch.profiler
    traces the card (CPU and CUDA activities, as ``/debug/profile`` runs
    it) replays bit-equal to the eager step: config #1 at full width, 100k
    waiting, the first window of each of two buckets captured inside the
    profile, then three more windows of those buckets replayed after it
    (every window filtered: one variant); the profile names the step's
    kernels."""
    import torch.profiler as tp

    cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                           backend="gpu")
    queue = cfg.queues[0]
    graphed = GpuEngine(cfg, queue, device=cuda)
    eager = GpuEngine(cfg, queue, device=cuda)
    eager._graphs = None
    rng = np.random.default_rng(81)
    fill = named_columns(rng, 100_000, 0, 100.0, False)
    for eng in (graphed, eager):
        eng.restore_columns(interned(eng, fill), 100.0)
    plan = [(1024, True), (64, True), (1024, False), (64, False),
            (1024, False)]  # (window size, inside the profile)
    t, start = 101.0, 1_000_000
    prof = tp.profile(activities=[tp.ProfilerActivity.CPU,
                                  tp.ProfilerActivity.CUDA])
    prof.start()
    for n, profiled in plan:
        if not profiled and prof is not None:
            torch.cuda.synchronize()
            prof.stop()
            names = {e.key for e in prof.key_averages()}
            prof = None
        window = named_columns(rng, n, start, t, True)
        start += n
        outs = []
        for eng in (graphed, eager):
            eng.search_columns_async(interned(eng, window), t)
            (_, out), = eng.flush()
            outs.append(out)
        assert_same_columnar(*outs)
        assert_same_engines(graphed, eager)
        t += 0.5
    assert graphed.graph_report()["captures"] == 2
    for kernel in ("prep_kernel", "block_best_kernel", "quality_accum_kernel"):
        assert any(kernel in name for name in names), kernel


def test_replication_attach_with_windows_in_flight_at_full_width(cuda,
                                                                  tmp_path):
    """Config #1's service at full width on the card (100k waiting, the
    journal on) with two windows of 1,024 in flight when replication
    attaches (``start_replication`` on the live queue): under
    ``_pool_lock`` the windows are collected before the baseline, so the
    baseline is the pool at its seq, the stream after it has no gap, and
    once later traffic is collected the standby's shadow equals the
    pool."""
    import asyncio
    import json

    from matchmaking_tpu_torch.config import (
        DurabilityConfig,
        ReplicationConfig,
    )
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.replication import (
        RT_REPL_SNAPSHOT,
        ReplicationHub,
    )

    cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                           backend="gpu")
    # A third pipeline slot: two windows held in flight leave the batcher
    # (and _pool_lock) free.
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True,
                                        pipeline_depth=3),
        durability=DurabilityConfig(journal_dir=str(tmp_path / "j")),
        replication=ReplicationConfig(role="primary"))
    q = cfg.queues[0].name
    rng = np.random.default_rng(73)
    bodies = [json.dumps({"id": f"w{i}", "rating": float(r)}).encode()
              for i, r in enumerate(rng.normal(1500.0, 300.0, 4096))]

    async def publish(app, lo, hi):
        for i in range(lo, hi):
            app.broker.publish(q, bodies[i], Properties(
                reply_to="r", correlation_id=f"w{i}"))
        await asyncio.sleep(0.02)

    async def run():
        hub = ReplicationHub(lease_s=60.0)
        app = MatchmakingApp(dataclasses.replace(
            cfg, replication=ReplicationConfig()), device=cuda,
            replication_hub=hub)
        await app.start()
        app.broker.declare_queue("r")
        rt = app.runtime(q)
        eng = rt.engine
        try:
            eng.restore_columns(interned(eng, named_columns(
                rng, 100_000, 0, 100.0, False)), 100.0)
            link, sent = hub.link(q), {}
            real_send = link.send

            def send(seq, rtype, payload):
                sent.setdefault(seq, rtype)
                real_send(seq, rtype, payload)
            link.send = send
            real = eng.collect_ready
            eng.collect_ready = lambda: []  # hold the windows in flight
            await publish(app, 0, 1024)
            await publish(app, 1024, 2048)
            for _ in range(500):
                if eng.inflight() == 2:
                    break
                await asyncio.sleep(0.01)
            assert eng.inflight() == 2
            app.cfg = cfg  # replication on, mid-life
            await rt.start_replication()
            eng.collect_ready = real
            assert eng.inflight() == 0
            base = min(sent)
            assert sent[base] == RT_REPL_SNAPSHOT
            # The baseline is the pool after the held windows' matches.
            assert rt.last_baseline["players"] == eng.pool_size() > 90_000
            standby = hub.standby(q)
            await publish(app, 2048, 4096)
            for _ in range(1000):
                standby.pump()
                if (rt.replication.quiescent and eng.inflight() == 0
                        and rt._batcher.depth == 0
                        and app.broker.queue_depth(q) == 0
                        and not rt._pool_lock.locked()):
                    break
                await asyncio.sleep(0.01)
            standby.pump()
            return (sorted(sent), base, standby.applied_seq, rt.journal.seq,
                    set(standby.shadow.waiting), set(eng.pool._slot_of),
                    app.faults())
        finally:
            await app.stop()

    seqs, base, applied, jseq, shadow, pool, faults = asyncio.run(run())
    assert faults == {}
    assert seqs == list(range(base, base + len(seqs)))
    assert applied == jseq == seqs[-1]
    assert shadow == pool and len(pool) > 90_000


@pytest.mark.parametrize("raised", [True, False])
def test_socket_baseline_of_100k_at_full_width(cuda, tmp_path, raised):
    """Config #1's service at full width on the card: 100k waiting, then
    replication attaches over a UDS socket pair (a loopback
    ``SocketReplicationHub``). The baseline's frame is ~13 MB: with the
    frame and send buffer limits raised to 32 MiB it crosses and the
    standby's shadow equals the pool; with the defaults (4 MiB) it is
    dropped and counted (``backpressure_dropped``), every retransmission
    again, and the standby never rebases or acks."""
    import asyncio
    import json
    import shutil
    import tempfile
    import time

    from matchmaking_tpu_torch.config import (
        DurabilityConfig,
        NetConfig,
        ReplicationConfig,
    )
    from matchmaking_tpu_torch.net.link import SocketReplicationHub
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                           backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        durability=DurabilityConfig(journal_dir=str(tmp_path / "j")),
        replication=ReplicationConfig(role="primary"))
    q = cfg.queues[0].name
    net = (NetConfig(transport="socket", max_frame_bytes=32 << 20,
                     send_buffer_bytes=32 << 20) if raised
           else NetConfig(transport="socket"))
    rng = np.random.default_rng(74)
    base_dir = tempfile.mkdtemp(prefix="mmn")

    async def run():
        hub = SocketReplicationHub(net=net, lease_s=60.0, base_dir=base_dir)
        app = MatchmakingApp(dataclasses.replace(
            cfg, replication=ReplicationConfig()), device=cuda,
            replication_hub=hub)
        await app.start()
        rt = app.runtime(q)
        eng = rt.engine
        try:
            eng.restore_columns(interned(eng, named_columns(
                rng, 100_000, 0, 100.0, False)), 100.0)
            # Two far-apart arrivals: the journal has records (the baseline
            # summarizes a seq > 0) and the pool holds 100,002.
            app.broker.declare_queue("r")
            for pid, rating in (("far0", 9000.0), ("far1", 20000.0)):
                app.broker.publish(q, json.dumps(
                    {"id": pid, "rating": rating}).encode(),
                    Properties(reply_to="r", correlation_id=pid))
            end = time.monotonic() + 30.0
            while not (eng.pool_size() == 100_002 and eng.inflight() == 0
                       and rt.journal.seq > 0) and time.monotonic() < end:
                await asyncio.sleep(0.02)
            standby = hub.standby(q)
            app.cfg = cfg  # replication on: the baseline goes out
            await rt.start_replication()
            end = time.monotonic() + (60.0 if raised else 3.0)
            while time.monotonic() < end:
                standby.pump()
                if raised and rt.replication.quiescent:
                    break
                await asyncio.sleep(0.02)
            standby.pump()
            link = dict(hub.link(q).counters)
            return (rt.last_baseline, standby.applied_seq, rt.journal.seq,
                    rt.replication.acked_seq, set(standby.shadow.waiting),
                    set(eng.pool._slot_of), link, app.faults())
        finally:
            await app.stop()
            hub.close()

    try:
        base, applied, jseq, acked, shadow, pool, link, faults = asyncio.run(
            run())
    finally:
        shutil.rmtree(base_dir, ignore_errors=True)
    said = (base, applied, jseq, acked, len(shadow), link)
    assert faults == {}, faults
    assert base["players"] == len(pool) == 100_002, said
    assert base["bytes"] > NetConfig().send_buffer_bytes, said
    assert link.get("send_errors", 0) == link.get("frame_errors", 0) == 0, said
    if raised:
        assert applied == jseq == acked, said
        assert shadow == pool, said
        assert link.get("liveness_lost", 0) == 0, said
    else:
        assert link["backpressure_dropped"] >= 2, said
        assert applied == acked == 0 and shadow == set(), said


def _compute_apps():
    """One line per CUDA context on the card (nvidia-smi). Processes may
    run in a pid namespace of their own, whose pids nvidia-smi does not
    print: count the lines."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout
    return [line for line in out.splitlines() if line.strip()]


def test_cpu_engine_worker_creates_no_cuda_context(cuda):
    """The supervisor's CPU-engine worker (``MM_ENGINE_BACKEND=cpu``) never
    creates a CUDA context, while the device worker's process holds one:
    the card's compute apps gain exactly one context while both serve."""
    import json
    import socket
    import time
    import urllib.request

    from matchmaking_tpu_torch.service.multiproc import WorkerSupervisor

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = Config(queues=(QueueConfig(name="w0"), QueueConfig(name="w1")),
                 engine=EngineConfig(backend="gpu", pool_capacity=4096,
                                     pool_block=1024,
                                     batch_buckets=(16, 64)),
                 metrics_port=port)
    sup = WorkerSupervisor(cfg, 2)
    before = _compute_apps()
    try:
        sup.start()
        health = []
        for i in range(2):
            end = time.monotonic() + 180
            while True:
                sup.poll()
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port + i}/healthz",
                            timeout=2) as r:
                        health.append(json.loads(r.read()))
                    break
                except OSError:
                    assert time.monotonic() < end, f"worker {i} not ready"
                    time.sleep(0.1)
        assert [sorted({q["engine"] for q in h["queues"].values()})
                for h in health] == [["GpuEngine"], ["CpuEngine"]]
        assert len(_compute_apps()) == len(before) + 1
        procs = [w.proc for w in sup.workers]
        sup.stop(term_timeout_s=60.0)
        assert [p.returncode for p in procs] == [0, 0]
    finally:
        sup.stop()


def test_serve_over_fake_amqp_at_full_width_matches_a_burst(cuda,
                                                           monkeypatch):
    """``serve`` over ``amqp://`` (the port's fake pika) with config #1 at
    P = 131,072: a seeded burst of 1,024 from a client ``AmqpBroker`` is
    answered, each request with one terminal answer at most and at least
    one answer, nobody in two matches, and the service's windows launch
    block_best and quality_accum."""
    import asyncio
    import json
    import time
    import uuid

    from matchmaking_tpu_torch.service import app as app_mod
    from matchmaking_tpu_torch.service.amqp_transport import AmqpBroker
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.testing import fake_pika

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for k in list(os.environ):
        if k.startswith("MM_"):
            monkeypatch.delenv(k)
    url = f"amqp://card-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("MM_CONFIG_JSON",
                       os.path.join(root, "configs", "elo_1v1.json"))
    monkeypatch.setenv("MM_BROKER_URL", url)
    caught = []
    real_start = app_mod.MatchmakingApp.start

    async def start(self):
        caught.append(self)
        await real_start(self)
    monkeypatch.setattr(app_mod.MatchmakingApp, "start", start)
    rng = np.random.default_rng(41)
    ratings = np.repeat(rng.normal(1500.0, 300.0, 512), 2)

    async def run():
        stop = asyncio.Event()
        task = asyncio.ensure_future(app_mod.serve(stop,
                                                   pika_module=fake_pika))
        got = {}
        try:
            end = time.monotonic() + 180
            while not caught or not caught[0]._first._tag:
                assert not task.done() and time.monotonic() < end
                await asyncio.sleep(0.01)
            app = caught[0]
            assert isinstance(app.engine, GpuEngine)
            assert app.cfg.engine.pool_capacity == 131_072
            client = AmqpBroker(url, pika_module=fake_pika)
            client.declare_queue("card.replies")

            async def on_reply(d):
                got.setdefault(d.properties.correlation_id, []).append(
                    json.loads(d.body))
                client.ack(tag, d.delivery_tag)
            tag = client.basic_consume("card.replies", on_reply)
            for k in list(cuda_kernels.LAUNCHES):
                cuda_kernels.LAUNCHES[k] = 0
            for i in range(1024):
                client.publish(app.queue_cfg.name, json.dumps(
                    {"id": f"c{i}", "rating": float(ratings[i])}).encode(),
                    Properties(reply_to="card.replies",
                               correlation_id=f"c{i}"))
            end = time.monotonic() + 120
            while len(got) < 1024 and time.monotonic() < end:
                await asyncio.sleep(0.01)
            launches = dict(cuda_kernels.LAUNCHES)
            client.close()
            assert app.faults() == {}
            return got, launches
        finally:
            stop.set()
            await task

    got, launches = asyncio.run(run())
    assert len(got) == 1024
    matches = {}
    for corr, answers in got.items():
        terminal = {(a["status"], (a.get("match") or {}).get("match_id"))
                    for a in answers if a["status"] != "queued"}
        assert len(terminal) <= 1 and {s for s, _ in terminal} <= {"matched"}
        for _, mid in terminal:
            matches.setdefault(mid, set()).add(corr)
    assert matches and all(len(v) == 2 for v in matches.values())
    assert launches["block_best"] > 0
    assert launches["quality_accum"] == launches["block_best"]


# ---- the sharded pool (engine/sharded.py) on one card ----------------------
#
# A mesh may repeat a device: (cuda:0,) * D stands in for D cards, every
# shard's launches queuing on the one card.


def test_pool_mesh_refuses_too_few_distinct_cards(cuda):
    """With no explicit list a mesh takes distinct visible cards and
    refuses more shards than there are (the JAX ``pool_mesh`` rule); an
    explicit list may repeat one card."""
    from matchmaking_tpu_torch.engine import sharded

    n = torch.cuda.device_count()
    assert sharded.pool_mesh(n).devices == tuple(
        torch.device("cuda", i) for i in range(n))
    with pytest.raises(ValueError, match="CUDA devices visible"):
        sharded.pool_mesh(n + 1)
    mesh = sharded.pool_mesh(n + 1, [0] * (n + 1))
    assert mesh.single_device and mesh.n_shards == n + 1


class OneShardEngine(GpuEngine):
    """A sharded engine of one shard: ``mesh_pool_axis`` 1 takes the dense
    step (as in the JAX engine), so only this stand-in measures the
    sharded step at D = 1."""

    def _kernel_set(self, queue):
        from matchmaking_tpu_torch.engine import sharded

        self._sharded = True
        ec = self.cfg.engine
        return sharded.sharded_kernel_set(
            capacity=ec.pool_capacity, top_k=ec.top_k,
            pool_block=ec.pool_block, glicko2=queue.glicko2,
            widen_per_sec=queue.widen_per_sec,
            max_threshold=queue.max_threshold, n_shards=1,
            ring=ec.ring_merge, pair_rounds=ec.pair_rounds,
            device_ids=self.devices, device=str(self.device))


def sharded_columns(rng, n, start, now):
    ids = np.array([f"p{start + i}" for i in range(n)], object)
    return RequestColumns(
        ids=ids, rating=rng.normal(1500, 300, n).astype(np.float32),
        rd=np.full(n, 350.0, np.float32), region=np.zeros(n, np.int32),
        mode=np.zeros(n, np.int32), threshold=np.full(n, np.nan, np.float32),
        enqueued_at=now - rng.uniform(0, 20, n),
        reply_to=np.array([f"rq.{i}" for i in ids], object),
        correlation_id=ids.copy())


@pytest.mark.parametrize("d,ring", [(1, False), (2, False), (4, True),
                                    (8, False)])
def test_sharded_engine_on_one_card_equals_dense(cuda, d, ring):
    """Config #1's geometry (P = 131,072, blocks of 8,192) with 20k
    waiting, sharded D ways on the one card: its captured steps, the same
    steps eagerly and the dense engine take the same windows (and a rescan
    tick) in lockstep; pairs, distances (bit for bit), queued ids and the
    concatenated pools are equal, and each window launches block_best D
    times and quality_accum never."""
    from matchmaking_tpu_torch.engine import cuda_kernels as ck

    def make(sharded=False):
        cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                               backend="gpu")
        if not sharded:
            return GpuEngine(cfg, cfg.queues[0], device=cuda)
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, mesh_pool_axis=d, ring_merge=ring))
        cls = OneShardEngine if d == 1 else GpuEngine
        return cls(cfg, cfg.queues[0], device=cuda, devices=("cuda:0",) * d)

    dense = make()
    graphed = make(sharded=True)
    eager = make(sharded=True)
    eager._graphs = None
    assert graphed._graphs is not None and graphed._quality is None
    rng = np.random.default_rng(60 + d)
    fill = sharded_columns(rng, 20_000, 0, 100.0)
    for e in (dense, graphed, eager):
        e.warmup()
        e.restore_columns(fill, 100.0)
    for w in range(4):
        window = sharded_columns(rng, 1024, 100_000 + 1024 * w, 101.0 + w)
        outs = []
        for e in (dense, graphed, eager):
            before = ck.LAUNCHES["block_best"], ck.LAUNCHES["quality_accum"]
            e.search_columns_async(window, 101.0 + w)
            (_, out), = e.flush()
            outs.append(out)
            if e is not dense:
                assert ck.LAUNCHES["block_best"] - before[0] == d
                assert ck.LAUNCHES["quality_accum"] == before[1]
        for out in outs[1:]:
            assert_same_columnar(out, outs[0])
        ticks = []
        for e in (dense, graphed, eager):
            e.rescan_async(1024, 101.5 + w)
            (_, out), = e.flush()
            ticks.append(out)
        for out in ticks[1:]:
            assert_same_columnar(out, ticks[0])
    torch.cuda.synchronize()
    for name, col in dense.dev_pool.items():
        for e in (graphed, eager):
            assert torch.equal(e.dev_pool[name], col), name
    assert graphed.quality_report() == eager.quality_report()


def test_shard_block_best_with_shifted_slots_equals_plain(cuda):
    """Each shard's launch takes the window's global slots minus its
    offset: ids below 0 and past the slice must never self-mask. Bit-equal
    to the plain version at ragged shapes and at config #1's shard slices
    (D = 2, 4, 8 of 131,072)."""
    for capacity, block, d, rows in ((16384, 4096, 4, 100),
                                     (256, 64, 4, 16), (3072, 1536, 2, 33),
                                     (131072, 8192, 2, 1024),
                                     (131072, 8192, 4, 1024),
                                     (131072, 8192, 8, 1024)):
        lc = capacity // d
        pool, batch, q_thr = inputs(3, capacity, rows, 0.7, True, cuda)
        # Window slots anywhere in the pool (every shard's and none).
        g = torch.Generator(device="cpu").manual_seed(capacity + d)
        batch["slot"] = torch.randint(0, capacity + 1, (rows,), generator=g,
                                      dtype=torch.int32).to(cuda)
        kw = dict(pool_block=min(block, lc), glicko2=True, filters=True,
                  widen_per_sec=5.0, max_threshold=250.0,
                  g_coeff=scoring.G_COEFF_F32)
        for s in range(d):
            part = {k: v[s * lc:(s + 1) * lc].contiguous()
                    for k, v in pool.items()}
            shifted = dict(batch, slot=batch["slot"] - s * lc)
            now = now_on(cuda, 10.0)
            got = cuda_kernels.block_best(part, shifted, q_thr, now, **kw)
            want = cuda_kernels.block_best_reference(part, shifted, q_thr,
                                                     now, **kw)
            assert_bit_equal(got, want)
            own = shifted["slot"][:, None]
            assert not ((got[1] == own) & (got[1] < lc)).any()


@pytest.mark.parametrize("k", [8, 16, 32, 64, 128])
def test_frontier_launch_equals_plain_below_the_tile(cuda, k):
    """The bucket frontier's launch: ``block_best`` over the merged
    frontier in blocks of k (below the kernel's 512-slot tile), bit-equal
    to its plain version, on config #1's geometry sharded 4 ways."""
    from matchmaking_tpu_torch.engine import sharded

    ks = sharded.ShardedKernelSet(
        capacity=131072, top_k=8, pool_block=8192, glicko2=False,
        widen_per_sec=0.0, max_threshold=400.0,
        mesh=sharded.pool_mesh(4, [0] * 4), bucket_frontier_k=128)
    pool, batch, q_thr = inputs(5, 131072, 256, 0.001, True, cuda)
    arrays = {n: v.cpu().numpy() for n, v in pool.items()}
    spool = ks.place_pool(arrays)
    fpool, gslot = ks.frontier_pool(spool, k)
    assert fpool["rating"].shape[0] == 16 * k
    batch["slot"] = torch.where(pool["active"])[0][:256].to(torch.int32)
    rows = batch["slot"].shape[0]
    batch = {n: v[:rows].contiguous() for n, v in batch.items()}
    fbatch = dict(batch, slot=ks.frontier_rows(gslot, batch["slot"], k))
    kw = dict(pool_block=k, glicko2=False, filters=True, widen_per_sec=0.0,
              max_threshold=400.0, g_coeff=scoring.G_COEFF_F32)
    now = now_on(cuda, 3.0)
    got = cuda_kernels.block_best(fpool, fbatch, q_thr[:rows], now, **kw)
    want = cuda_kernels.block_best_reference(fpool, fbatch, q_thr[:rows],
                                             now, **kw)
    assert_bit_equal(got, want)


@pytest.mark.parametrize("kind", ["team", "role"])
def test_sharded_team_and_role_steps_on_card_equal_single(cuda, kind):
    """The sharded fallback and ring steps (both merges) on a 4-way mesh of
    the one card against the single-device step on the card: packed
    results and pools bit-equal (the ring with the waiting players within
    the frontier)."""
    from matchmaking_tpu_torch.engine import sharded
    from matchmaking_tpu_torch.engine.kernels import pool_to_numpy
    from matchmaking_tpu_torch.engine.role_kernels import ShardedRoleKernelSet
    from matchmaking_tpu_torch.engine.teams import ShardedTeamKernelSet

    single = team_step(kind, 4096, 256)
    pool, packed = team_inputs(single, 2, 64, cuda)
    active = pool["active"].clone()
    keep = torch.nonzero(active)[:, 0][:400]
    pool["active"].zero_()
    pool["active"][keep] = True  # 400 waiting: within a 512-row frontier
    arrays = pool_to_numpy(pool)
    want_out = single.search_step_packed(pool, packed)
    want_pool = pool_to_numpy(pool)
    kw = dict(capacity=4096, team_size=5, widen_per_sec=single.widen_per_sec,
              max_threshold=single.max_threshold, max_matches=256,
              mesh=sharded.pool_mesh(4, [0] * 4), frontier_k=512)
    for merge in ("linear", "tournament"):
        ks = (ShardedRoleKernelSet(role_slots=SLOTS5, frontier_merge=merge,
                                   **kw) if kind == "role"
              else ShardedTeamKernelSet(frontier_merge=merge, **kw))
        for fn in ("search_step_packed", "search_step_packed_ring"):
            spool = ks.place_pool(arrays)
            out = getattr(ks, fn)(spool, packed)
            assert torch.equal(out, want_out), (merge, fn)
            for name, col in want_pool.items():
                assert np.array_equal(spool[name].cpu().numpy(), col), name
    assert (want_out[0] < 4096).sum() > 0


def test_sharded_steps_do_not_sync(cuda):
    """The sharded traffic step (both merges), its rescan and the bucket
    frontier on a 4-way mesh of the one card run without a device→host
    synchronisation."""
    from matchmaking_tpu_torch.engine import sharded

    pool, batch, q_thr = inputs(7, 16384, 256, 0.02, False, cuda)
    arrays = {n: v.cpu().numpy() for n, v in pool.items()}
    packed = torch.zeros((9, 256), dtype=torch.float32, device=cuda)
    free = torch.nonzero(~pool["active"])[:, 0][:200]
    packed[0] = 16384
    packed[0, :200] = free.to(torch.float32)
    packed[1, :200] = batch["rating"][:200]
    packed[5, :200] = 100.0
    packed[7, :200] = 1.0
    packed[8] = 4.0
    for ring in (False, True):
        ks = sharded.ShardedKernelSet(
            capacity=16384, top_k=8, pool_block=4096, glicko2=False,
            widen_per_sec=2.0, max_threshold=250.0,
            mesh=sharded.pool_mesh(4, [0] * 4), ring=ring,
            bucket_frontier_k=64)
        for step in (ks.search_step_packed, ks.search_step_packed_rescan,
                     ks.bucket_step(64)):
            spool = ks.place_pool(arrays)
            step(spool, packed)  # builds and warms
            spool = ks.place_pool(arrays)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                step(spool, packed)
            finally:
                torch.cuda.set_sync_debug_mode(0)


def test_process_mesh_of_one_over_nccl_equals_dense(cuda):
    """``init_distributed`` joins a group of one over NCCL; the process
    mesh's sharded step (its merge an ``all_gather_into_tensor``) equals
    the dense step on the same pool and window, bit for bit."""
    import socket

    from matchmaking_tpu_torch.engine import distributed, sharded
    from matchmaking_tpu_torch.engine.kernels import pool_from_reference

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert distributed.init_distributed(f"127.0.0.1:{port}", 1, 0) == (0, 1)
    try:
        pool, batch, _ = inputs(8, 16384, 256, 0.5, False, cuda)
        arrays = {n: v.cpu().numpy() for n, v in pool.items()}
        packed = torch.zeros((9, 256), dtype=torch.float32, device=cuda)
        free = torch.nonzero(~pool["active"])[:, 0][:256]
        packed[0] = free.to(torch.float32)
        packed[1] = batch["rating"]
        packed[5] = 100.0
        packed[7] = 1.0
        packed[8] = 2.0
        geo = dict(capacity=16384, top_k=8, pool_block=4096, glicko2=False,
                   widen_per_sec=0.0, max_threshold=250.0)
        dense = KernelSet(**geo)
        dpool = pool_from_reference(arrays, cuda)
        want = dense.search_step_packed(dpool, packed)
        for ring in (False, True):
            ks = sharded.ShardedKernelSet(
                mesh=distributed.global_pool_mesh(cuda), ring=ring, **geo)
            spool = ks.place_pool(arrays)
            assert torch.equal(ks.search_step_packed(spool, packed), want)
            for name, col in dpool.items():
                assert torch.equal(spool[name], col), name
    finally:
        distributed.shutdown_distributed()


# ---- placement and device-loss failover on the card -------------------------


def elo_cfg(**engine):
    """Config #1 at its full width (P = 131,072), engine keys replaced."""
    cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                           backend="gpu")
    return dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, **engine))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def test_migration_beside_a_capturing_queue_equals_twins(cuda):
    """Queue A is rebuilt onto another logical device of the one card
    (``rebuild_engine``, the migration's mechanism: its restore queues
    20k players' copies) while queue B on the same card has a window in
    flight, or is about to capture the graph of a bucket it has not used
    yet. B's windows equal those of a twin that never saw a migration
    beside it, and A's those of a twin rebuilt at the same points with no
    queue beside it, bit for bit; B captured every bucket it used."""
    from matchmaking_tpu_torch.control.executor import rebuild_engine

    cfg = elo_cfg()

    def make():
        return GpuEngine(cfg, cfg.queues[0], device=cuda,
                         devices=(cuda,))

    a, b, twin_a, twin_b = make(), make(), make(), make()
    rng = np.random.default_rng(70)
    fill_a = sharded_columns(rng, 20_000, 0, 100.0)
    fill_b = sharded_columns(rng, 20_000, 50_000, 100.0)
    for e, fill in ((a, fill_a), (twin_a, fill_a), (b, fill_b),
                    (twin_b, fill_b)):
        e.restore_columns(fill, 100.0)
    # B's window sizes: each new bucket's first use captures its graph.
    sizes = (1024, 16, 256, 64, 1024, 8)
    for w, n in enumerate(sizes):
        now = 101.0 + w
        win_a = sharded_columns(rng, 512, 200_000 + 1024 * w, now)
        win_b = sharded_columns(rng, n, 400_000 + 1024 * w, now)
        if w % 2 == 0:
            b.search_columns_async(win_b, now)  # in flight during the move
        old = a
        a, _ = rebuild_engine(old, make, now=now, columns=True)
        old.close()
        if w % 2 == 1:
            b.search_columns_async(win_b, now)  # captures after the restore
        old = twin_a
        twin_a, _ = rebuild_engine(old, make, now=now, columns=True)
        old.close()
        a.search_columns_async(win_a, now)
        twin_a.search_columns_async(win_a, now)
        twin_b.search_columns_async(win_b, now)
        for got, want in ((a, twin_a), (b, twin_b)):
            (_, out), = got.flush()
            (_, ref), = want.flush()
            assert_same_columnar(out, ref)
            assert_same_engines(got, want)
    report = b.graph_report()
    if report is not None:
        buckets = {int(name.split("/")[1]) for name in report["graphs"]}
        assert buckets >= {16, 64, 256, 1024}, sorted(report["graphs"])


def test_failover_demotion_on_one_card_equals_a_dense_engine(cuda):
    """Config #1 sharded two ways on ``(cuda:0,) × 2`` through the app's
    runtime: a ``ChaosDeviceLostError`` at a window's dispatch, then the
    runtime's own ``_revive`` demotes the queue to (0,); its windows after
    the loss (the lost one again, then three more) equal those of a dense
    engine restored from the same mirror, bit for bit, with one
    ``block_best`` and one ``quality_accum`` launch a window (besides the
    eager run before a first-use capture), and the quality counters
    carried across the rebuild."""
    import asyncio

    from matchmaking_tpu_torch.config import ChaosConfig
    from matchmaking_tpu_torch.engine import cuda_kernels as ck
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.utils.chaos import ChaosDeviceLostError

    cfg = dataclasses.replace(
        elo_cfg(mesh_pool_axis=2),
        chaos=ChaosConfig(device_lost_steps=(3,)))
    app = MatchmakingApp(cfg, device=cuda, devices=(cuda,) * 2)
    from matchmaking_tpu_torch.control.executor import restore_columns

    async def run():
        await app.start()
        try:
            lost_window(app.runtime(cfg.queues[0].name))
        finally:
            await app.stop()

    def lost_window(rt):
        # Every step below runs on the loop without yielding, so the
        # runtime's collector never takes a window.
        assert type(rt.engine.kernels).__name__ == "ShardedKernelSet"
        rng = np.random.default_rng(71)
        rt.engine.restore_columns(sharded_columns(rng, 20_000, 0, 100.0),
                                  100.0)
        windows = [sharded_columns(rng, 1024, 100_000 + 1024 * w, 101.0 + w)
                   for w in range(7)]
        for w in range(3):
            rt.engine.search_columns_async(windows[w], 101.0 + w)
            rt.engine.flush()
        with pytest.raises(ChaosDeviceLostError) as lost:
            rt.engine.search_columns_async(windows[3], 104.0)
        mirror = rt.engine.waiting_columns()
        quality = rt.engine.quality_checkpoint()
        rt._record_engine_crash(104.0, lost.value)
        rt._revive(104.0)
        assert rt.placement == (0,)
        assert type(rt.engine.kernels).__name__ == "KernelSet"
        assert [e["to_devices"] for e in rt.failover_log] == [[0]]
        assert rt.failover_log[0]["restored"] == len(mirror[0])
        dense = GpuEngine(elo_cfg(), cfg.queues[0], device=cuda)
        restore_columns(dense, *mirror, 104.0)
        dense.quality_restore(quality)
        assert_same_engines(rt.engine, dense)
        for w in range(3, 7):
            before = dict(ck.LAUNCHES)
            captures = rt.engine.graph_report()["captures"] \
                if cuda.type == "cuda" else 0
            rt.engine.search_columns_async(windows[w], 101.0 + w)
            (_, out), = rt.engine.flush()
            if cuda.type == "cuda":
                # A first-use capture runs the step once eagerly first.
                warm = rt.engine.graph_report()["captures"] - captures
                assert {k: ck.LAUNCHES[k] - before[k] - warm
                        for k in before} == {"block_best": 1,
                                             "quality_accum": 1}
            dense.search_columns_async(windows[w], 101.0 + w)
            (_, ref), = dense.flush()
            assert_same_columnar(out, ref)
        assert_same_engines(rt.engine, dense)
        assert rt.engine.quality_report() == dense.quality_report()
        assert rt.engine.quality_report()["samples"] > 0

    asyncio.run(run())


def test_each_placement_action_returns_the_old_engines_memory(cuda):
    """Through the controller's audited path on ``("cuda:0",) × 4``:
    migrate (0) → (1), promote to (1, 2), demote to (1), migrate back to
    (0), config #1 at full width with 20k waiting. After each action the
    old engine is freed (no reference survives its ``close()``), and once
    back on one device the allocated bytes equal the boot's within 5 %
    and the reserved bytes, cache emptied, are no more than the boot's
    plus 5 %."""
    import asyncio
    import gc
    import weakref

    from matchmaking_tpu_torch.config import PlacementConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    cfg = dataclasses.replace(elo_cfg(), placement=PlacementConfig(
        interval_s=3600.0, devices=4, max_shard=2, cooldown_s=0.0))
    app = MatchmakingApp(cfg, device=cuda, devices=(cuda,) * 4)
    q = cfg.queues[0].name

    def measure():
        gc.collect()
        _sync(cuda)
        if cuda.type != "cuda":
            return 0, 0
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    async def run():
        await app.start()
        try:
            rt = app.runtime(q)
            rng = np.random.default_rng(72)
            rt.engine.restore_columns(sharded_columns(rng, 20_000, 0, 100.0),
                                      100.0)
            rt.engine.search_columns_async(
                sharded_columns(rng, 1024, 100_000, 101.0), 101.0)
            rt.engine.flush()
            boot = measure()
            steps = []
            for kind, target in (("migrate", (1,)), ("promote", (1, 2)),
                                 ("demote", (1,)), ("migrate", (0,))):
                old = weakref.ref(rt.engine)
                dec = await app.placement.force(kind, q, target)
                assert dec["status"] == "applied", dec
                assert rt.placement == target
                steps.append(measure())
                assert old() is None, f"{kind}: the old engine is alive"
            return boot, steps
        finally:
            await app.stop()

    boot, steps = asyncio.run(run())
    if cuda.type == "cuda":
        alloc, reserved = steps[-1]
        assert abs(alloc - boot[0]) <= 0.05 * boot[0], (boot, steps)
        assert reserved <= 1.05 * boot[1], (boot, steps)


def test_sanitized_columnar_soak_is_clean_on_the_card(cuda, tmp_path):
    """A short config #1 soak on the card (full pool width, the journal on
    with fsync "window", an in-process standby) under the port's async
    sanitizer, every check on, at the JAX fixture's 2.0 s stall threshold:
    no finding (lock order, awaits under ``_pool_lock`` other than the
    sanctioned backpressure wait, loop stalls, the settlement, journal,
    replication and speculation twins), every request answered, nobody
    in two matches, the standby's shadow the pool, one ``block_best`` and
    one ``quality_accum`` launch a window."""
    import asyncio
    import json

    from matchmaking_tpu_torch.config import (
        DurabilityConfig,
        ReplicationConfig,
    )
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.replication import ReplicationHub
    from matchmaking_tpu_torch.testing.sanitizer import AsyncSanitizer

    cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                           backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        durability=DurabilityConfig(journal_dir=str(tmp_path / "j"),
                                    fsync="window"),
        replication=ReplicationConfig(role="primary", owner="hostA",
                                      pump_interval_s=0.02))
    q = cfg.queues[0].name
    n, burst = 4096, 512
    rng = np.random.default_rng(74)
    bodies = [json.dumps({"id": f"s{i}", "rating": float(r)}).encode()
              for i, r in enumerate(rng.normal(1500.0, 300.0, n))]

    async def run():
        hub = ReplicationHub(lease_s=60.0)
        app = MatchmakingApp(cfg, device=cuda, replication_hub=hub)
        await app.start()
        app.broker.declare_queue("r")
        rt = app.runtime(q)
        standby = hub.standby(q, owner="hostB")
        try:
            cuda_kernels.LAUNCHES.update(block_best=0, quality_accum=0)
            windows0 = rt.engine.spans["windows"]
            for b in range(0, n, burst):
                for i in range(b, b + burst):
                    app.broker.publish(q, bodies[i], Properties(
                        reply_to="r", correlation_id=f"s{i}"))
                await asyncio.sleep(0.005)
                standby.pump()
            answers: dict = {}
            for _ in range(3000):
                while (d := await app.broker.get("r", timeout=0.001)):
                    answers.setdefault(d.properties.correlation_id,
                                       []).append(json.loads(d.body))
                standby.pump()
                if (len(answers) == n and rt.engine.inflight() == 0
                        and rt._settler is None and rt.replication.quiescent):
                    break
                await asyncio.sleep(0.01)
            standby.pump()
            return (answers, rt.engine.spans["windows"] - windows0,
                    dict(cuda_kernels.LAUNCHES), set(standby.shadow.waiting),
                    set(rt.engine.pool._slot_of), app.faults())
        finally:
            await app.stop()

    san = AsyncSanitizer(stall_threshold_s=2.0)
    with san.installed():
        answers, windows, launches, shadow, pool, faults = asyncio.run(run())
    san.assert_clean()
    assert faults == {}
    assert len(answers) == n
    matched: dict = {}
    for cid, rs in answers.items():
        assert [r["status"] for r in rs] in (
            ["queued"], ["matched"], ["queued", "matched"]), (cid, rs)
        for r in rs:
            if r["status"] == "matched":
                assert r["player_id"] not in matched
                matched[r["player_id"]] = r["match"]["match_id"]
    assert matched and shadow == pool
    assert windows > 0
    assert launches == {"block_best": windows, "quality_accum": windows}
    assert san.settlement_report()["settled"] >= n


# ---- the kernels as operators, the captured-graph audit, entry() ----------


@pytest.mark.parametrize("span", [False, True], ids=["dense", "span"])
def test_kernel_operators_on_the_card_equal_the_plain_versions(cuda, span):
    """``torch.ops.mm_torch.block_best`` and ``quality_accum`` called on
    CUDA tensors launch the kernels (counted) and equal the plain versions
    bit for bit (the quality sums within the file's tolerance); a trace of
    each on the card holds the operator as one node."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from matchmaking_tpu_torch.analysis import recompile

    pool, batch, q_thr = inputs(4, 16384, 64, 0.7, True, cuda)
    kw = dict(pool_block=4096, glicko2=True, filters=True, widen_per_sec=5.0,
              max_threshold=250.0, g_coeff=scoring.G_COEFF_F32)
    now = now_on(cuda, 9.0)
    sp = (cuda_kernels.Span(torch.tensor([0, 2], dtype=torch.int32,
                                         device=cuda), 32, 2,
                            torch.tensor([True], device=cuda))
          if span else None)
    args = (*(pool[n] for n in cuda_kernels._POOL_NAMES),
            *(batch[n] for n in cuda_kernels._BATCH_NAMES), q_thr, now,
            None if sp is None else sp.span_start,
            None if sp is None else sp.feasible,
            0 if sp is None else sp.chunk_rows,
            0 if sp is None else sp.span_blocks, *kw.values())
    before = cuda_kernels.LAUNCHES["block_best"]
    got = torch.ops.mm_torch.block_best(*args)
    assert cuda_kernels.LAUNCHES["block_best"] == before + 1
    want = (cuda_kernels.block_best_span_reference(pool, batch, q_thr, now,
                                                   sp, **kw)
            if span else cuda_kernels.block_best_reference(pool, batch,
                                                           q_thr, now, **kw))
    assert_bit_equal(got, want)
    gm = make_fx(lambda *a: torch.ops.mm_torch.block_best(*a))(*args)
    assert recompile.kernel_nodes(gm)["block_best"] == 1

    spec = QualitySpec()
    qk = QualityAccumKernel(capacity=16384, widen_per_sec=5.0,
                            max_threshold=250.0,
                            rating_edges=spec.rating_edges,
                            n_quality=spec.n_quality,
                            wait_edges=spec.wait_edges)
    vals, idx = got
    hit = idx[:, 0] < 16384
    out = torch.stack([torch.where(hit, batch["slot"].float(), 16384.0),
                       idx[:, 0].float(),
                       torch.where(hit, -vals[:, 0], float("inf"))])
    state, ref = qk.init_state(cuda), qk.init_state(cuda)
    qkw = dict(widen_per_sec=5.0, max_threshold=250.0,
               rating_edges=qk.rating_edges, n_quality=qk.n_quality,
               wait_edges=qk.wait_edges)
    before = cuda_kernels.LAUNCHES["quality_accum"]
    torch.ops.mm_torch.quality_accum(
        state.flat, pool["rating"], pool["enqueue_t"], pool["threshold"],
        out, now, *qkw.values())
    assert cuda_kernels.LAUNCHES["quality_accum"] == before + 1
    cuda_kernels.quality_accum_reference(
        ref, pool["rating"], pool["enqueue_t"], pool["threshold"], out, 9.0,
        **qkw)
    for name in ("q_hist", "w_hist", "count"):
        assert torch.equal(state[name], ref[name]), name
    for name in ("q_sum", "w_sum", "d_sum"):
        assert bool(((state[name] - ref[name]).abs()
                     <= 1e-5 * ref[name].abs() + 1e-6).all()), name


@pytest.mark.parametrize("engine", [{}, PRUNED, BUCKETED],
                         ids=["dense", "pruned", "bucketed"])
def test_captured_graph_debug_dump_counts_equal_launches(cuda, engine):
    """Each captured step, read back through ``debug_dump``: its
    ``block_best`` prep and scorer and ``quality_accum`` kernel nodes equal
    the launches a replay counts (``StepGraph.launches``), and so do the
    kernel operator nodes of the step's trace on the card; no host node,
    no copy to the host; the engine's own graphs still replay."""
    from matchmaking_tpu_torch.analysis import recompile

    cfg = widening_cfg(**engine)
    eng = GpuEngine(cfg, cfg.queues[0], device=cuda)
    eng.warmup()
    for variant in eng._variants():
        launches = eng._graphs.get(variant, eng.buckets[0]).launches
        empty = eng._stage(eng.pool.batch_arrays([], [], eng.buckets[0]), 0.0)
        traced = recompile.trace(eng._step_fn(variant),
                                 (eng._pool_for(variant), empty.to(cuda)))
        assert recompile.kernel_nodes(traced) == {
            "block_best": launches.get("block_best", 0),
            "quality_accum": launches.get("quality_accum", 0)}
        for bucket in (eng.buckets[0], eng.buckets[-1]):
            rep = eng.graph_audit(variant, bucket)
            assert rep["problems"] == [], (variant, bucket, rep)
            assert rep["launches"] == {"block_best": 1, "quality_accum": 1}
            assert rep["own_kernel_nodes"] == {
                "prep_kernel": 1, "block_best_kernel": 1,
                "quality_accum_kernel": 1}
            assert rep["kernel_nodes"] > 3
    rng = np.random.default_rng(9)
    eng.restore_columns(columns(rng, eng, 2000, 0, 100.0), 100.0)
    tok = eng.search_columns_async(columns(rng, eng, 64, 5000, 101.0), 101.0)
    assert tok is not None
    eng.flush()


def test_entry_replays_bit_equal_to_eager_and_the_cpu(cuda):
    from matchmaking_tpu_torch import entry

    def run(device):
        fn, (pool, packed) = entry.entry(device=device)
        return fn(pool, packed), pool

    graphs, step, rpool = entry.captured_entry(cuda)
    before = cuda_kernels.LAUNCHES["block_best"]
    replayed = graphs.replay(step).clone()
    assert cuda_kernels.LAUNCHES["block_best"] == before + 1
    eager, epool = run(cuda)
    cpu, cpool = run("cpu")
    for got, want in ((replayed, eager), (replayed.cpu(), cpu)):
        assert torch.equal(got.cpu().view(torch.int32),
                           want.cpu().view(torch.int32))
    for name in cpool:
        assert torch.equal(rpool[name].cpu(), epool[name].cpu()), name
        assert torch.equal(rpool[name].cpu(), cpool[name]), name
    assert int((cpu[0] < 8192).sum()) > 0


# ---- grouped readback on the card --------------------------------------------

def grouped_pair(cuda, k, engine=None, wait_ms=10_000.0, **cfg_kw):
    """Config #1 at full width (P = 131,072), one engine reading back each
    window by itself and one grouping ``k``, both warmed up and restored
    with the same 100k waiting."""
    cfg = Config.from_json(os.path.join(CONFIGS, "elo_1v1.json"),
                           backend="gpu")
    engines = []
    for group in (1, k):
        c = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, readback_group=group,
            readback_group_wait_ms=wait_ms, **(engine or {})), **cfg_kw)
        eng = GpuEngine(c, c.queues[0], device=cuda)
        eng.warmup()
        engines.append(eng)
    rng = np.random.default_rng(70)
    fill = named_columns(rng, 100_000, 0, 100.0, False)
    for eng in engines:
        eng.restore_columns(interned(eng, fill), 100.0)
    return engines


@pytest.mark.parametrize("engine", [{}, PRUNE_1, BUCKETED_1],
                         ids=["dense", "pruned", "bucketed"])
def test_grouped_readback_equals_ungrouped_at_full_width(cuda, engine):
    """Config #1 with 100k waiting: 10 windows of 1,024 (two of them
    filtered, one of 2,048 lanes: two chunks of one graph), then a rescan
    tick of two chunks, all dispatched before one flush, at k = 1 and
    k = 3: the same outcomes (pairs, distances and qualities bit for bit,
    queued ids), pools, quality states and reports. The k = 3 engine
    queued no synchronisation; its groups of three sealed at dispatch."""
    ungrouped, grouped = grouped_pair(cuda, 3, engine)
    rng = np.random.default_rng(71)
    windows = [named_columns(rng, 2048 if w == 5 else 1024,
                             1_000_000 + 4096 * w, 101.0 + 0.1 * w,
                             w in (2, 7)) for w in range(10)]
    outs = []
    for eng in (ungrouped, grouped):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for w, window in enumerate(windows):
                eng.search_columns_async(interned(eng, window),
                                         101.0 + 0.1 * w)
            eng.rescan_async(2048, 102.5)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs.append([o for _, o in eng.flush()])
    assert len(outs[0]) == len(outs[1]) == 11
    for got, want in zip(outs[1], outs[0]):
        assert_same_columnar(got, want)
    assert sum(o.n_matches for o in outs[0]) > 0
    assert_same_engines(grouped, ungrouped)
    assert grouped.prune_report() == ungrouped.prune_report()
    assert grouped.formation_report() == ungrouped.formation_report()
    assert not grouped._rb_open


def test_speculation_commit_grouped_equals_ungrouped_on_card(cuda):
    """A held speculation's results (device copies taken behind each pass)
    join the open groups at the commit: the committed window equals the
    ungrouped engine's, bit for bit."""
    ungrouped, grouped = grouped_pair(
        cuda, 3, dict(BUCKETED_1, spec_formation=True, spec_max_steps=2))
    outs = []
    for eng in (ungrouped, grouped):
        assert eng.speculate(130.0)
        tok = eng.spec_validate(130.0)
        eng.spec_commit(tok, 130.0)
        (_, out), = eng.flush()
        outs.append(out)
    assert_same_columnar(outs[1], outs[0])
    assert outs[0].n_matches > 0
    assert_same_engines(grouped, ungrouped)


def test_a_groups_rows_are_not_overwritten_by_the_next_replay(cuda):
    """Two windows of bucket 1,024 in one group of two: the second
    window's replay of the same graph (which rewrites its static output)
    is queued before the group is sealed, yet each row read back is its
    own window's result, equal to the ungrouped engine's."""
    ungrouped, grouped = grouped_pair(cuda, 2)
    rng = np.random.default_rng(72)
    windows = [named_columns(rng, 1024, 1_000_000 + 2048 * w,
                             101.0 + 0.1 * w, False) for w in range(2)]
    raws = []
    for eng in (ungrouped, grouped):
        for w, window in enumerate(windows):
            eng.search_columns_async(interned(eng, window), 101.0 + 0.1 * w)
        pending = list(eng._pending)
        eng.flush()
        raws.append([p.raw[0] for p in pending])
    g = grouped._graphs.get("dense_nofilter", 1024)
    assert g.replays >= 2
    for got, want in zip(raws[1], raws[0]):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(raws[1][0], raws[1][1])


def test_graph_audit_unchanged_with_grouped_readback(cuda):
    """The group's device copy stays outside the captured graphs: every
    variant's graph audits to the same kernel, memset and own-kernel
    nodes at k = 3 as at k = 1."""
    ungrouped, grouped = grouped_pair(cuda, 3)
    for variant in ungrouped._variants():
        for bucket in (ungrouped.buckets[0], ungrouped.buckets[-1]):
            want = ungrouped.graph_audit(variant, bucket)
            got = grouped.graph_audit(variant, bucket)
            assert got["problems"] == [] == want["problems"]
            for key in ("kernel_nodes", "memset_nodes", "own_kernel_nodes",
                        "launches"):
                assert got[key] == want[key], (variant, bucket, key)


class _FailingEvent:
    """A group's event whose read reports a device fault."""

    def query(self):
        return True

    def synchronize(self):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


def test_a_device_fault_in_a_group_fails_its_windows_and_a_revive_restores(
        cuda):
    """Windows 0-2 fill one group, 3-5 the next; the second group's read
    faults: windows 3-5 are reported queued with their tokens in
    ``failed_tokens`` (0-2 finalize as usual), and a successor engine
    rebuilt from the mirror (``control.executor.rebuild_engine``) holds
    every waiting player and serves a window."""
    from matchmaking_tpu_torch.control.executor import rebuild_engine

    _, eng = grouped_pair(cuda, 3)
    rng = np.random.default_rng(73)
    windows = [interned(eng, named_columns(rng, 1024, 1_000_000 + 1024 * w,
                                           101.0 + 0.1 * w, False))
               for w in range(6)]
    toks = [eng.search_columns_async(c, 101.0 + 0.1 * w)
            for w, c in enumerate(windows)]
    group = eng._pending[3].chunks[0][1].group
    assert [p.chunks[0][1].group is group for p in eng._pending] == (
        [False] * 3 + [True] * 3)
    torch.cuda.synchronize()
    group.event = _FailingEvent()
    done = dict(eng.flush())
    assert eng.failed_tokens == set(toks[3:])
    assert isinstance(eng.device_error, RuntimeError)
    assert sum(done[t].n_matches for t in toks[:3]) > 0
    for w in range(3, 6):
        assert done[toks[w]].q_ids.tolist() == windows[w].ids.tolist()
        assert all(pid in eng.pool for pid in windows[w].ids.tolist())
    waiting = eng.pool_size()
    successor, stats = rebuild_engine(
        eng, lambda: GpuEngine(eng.cfg, eng.queue, device=cuda), now=103.0,
        columns=True)
    eng.close()
    assert successor.pool_size() == waiting == stats["transferred"]
    successor.search_columns_async(interned(successor, named_columns(
        rng, 1024, 2_000_000, 103.5, False)), 103.5)
    (_, out), = successor.flush()
    assert out.n_matches > 0 and successor.device_error is None


def test_stage_profiler_graphs_equal_eager_and_wide_candidate_passes(cuda):
    """``scripts/torch_profile_step.py`` on the card at config #1's width:
    every stage graph's first replay equals its eager call at B = 1,024
    (the script raises otherwise), one block_best launch in the scoring
    stages' graphs and none elsewhere; the candidate pass equals its plain
    version at B = 2,048 and 4,096 (equal slots, bit-equal values)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_profile_step", os.path.join(root, "scripts",
                                           "torch_profile_step.py"))
    step = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(step)
    res = step.profile(131_072, 8192, 1024, 100_000, iters=3,
                       device="cuda", log=lambda _: None)
    for name, s in res["stages"].items():
        assert s["graph_equals_eager"], name
        want = 1 if name in ("cands", "cands_nofilter", "full",
                             "full_nofilter") else 0
        assert s["own_kernel_nodes"]["block_best_kernel"] == want, name
        assert s["own_kernel_nodes"]["prep_kernel"] == want, name
    assert res["matches"][8] > 0
    from matchmaking_tpu_torch.engine.kernels import (
        packed_now,
        pool_from_reference,
        unpack_batch as unpack,
    )
    ks = step.kernel_set(131_072, 8192)
    for rows in (2048, 4096):
        inp = step.make_inputs(131_072, rows, 100_000, 100.0)
        packed = torch.from_numpy(inp["packed"]).to(cuda)
        batch = unpack(packed)
        rep = step.check_candidates(ks, pool_from_reference(inp["arrays"],
                                                            cuda),
                                    batch, batch["threshold"],
                                    packed_now(packed))
        assert rep["window"] == rows and rep["candidates"] > 0
