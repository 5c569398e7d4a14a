"""Request tracing in the port (``utils/trace.py`` and its wiring through
the service) against the JAX package's.

- ``TraceContext``, ``FlightRecorder`` and ``EventLog`` on the same seeded
  marks: the same exports, stage histograms, exemplars and rows.
- The broker stamps a trace on a request publish only (every Nth with
  sampling), and the service leaves a sampled-out delivery untraced.
- Config #1 (``tests/test_torch_ingress.py``'s seeded soak: matches,
  queued acks, every kind of reject) through both apps with tracing on:
  answer bytes equal once trace ids are normalised to order of first
  appearance, each trace's mark names equal, work + wait equal to the
  enqueue→publish span for every trace (within 1e-9 s), equal
  attribution trace counts per category and statuses, equal
  ``stage_seconds`` counts, equal deterministic counters.
- With tracing off the port's answers carry no trace id and nothing is
  recorded; sampled 1 in 4, a quarter of the requests are traced.
- The engine's window marks: the JAX engine's names in its order on the
  same windows (chunked, Glicko-2, bucketed, a rescan tick), capped at
  512, popped by a sync ``search``.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest
import torch

from matchmaking_tpu.config import ObservabilityConfig as JaxObservabilityConfig
from matchmaking_tpu.service import contract as jax_contract
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu.utils import metrics as jax_metrics
from matchmaking_tpu.utils import trace as jax_trace
from matchmaking_tpu_torch.config import ObservabilityConfig
from matchmaking_tpu_torch.service import contract
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.attribution import decompose_marks
from matchmaking_tpu_torch.service.broker import InProcBroker, Properties
from matchmaking_tpu_torch.utils import metrics, trace
from test_torch_ingress import (
    QUEUE,
    jax_cfg,
    port_cfg,
    serve_bursts,
    soak_bodies,
)

torch.set_num_threads(1)

STAGES = ("consume", "middleware", "batch", "flush", "dispatch", "h2d",
          "device_step", "readback_seal", "collect", "encode", "respond",
          "publish")


def test_window_stages_equal_jax():
    assert trace.WINDOW_STAGES == jax_trace.WINDOW_STAGES


def _marked(mod, rng, queue="q", n_marks=8, t0=100.0):
    tr = mod.TraceContext(queue, "corr", redelivered=bool(rng.integers(2)),
                          t=t0)
    t = t0
    for name in STAGES[:n_marks]:
        t += float(rng.exponential(0.01))
        tr.mark(name, t)
    return tr


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_trace_context_equals_jax(seed):
    a = _marked(trace, np.random.default_rng(seed))
    b = _marked(jax_trace, np.random.default_rng(seed))
    a.player_id = b.player_id = "p1"
    a.status = b.status = "matched"
    a.quality, a.waited_s = b.quality, b.waited_s = (0.75, 0.125)
    assert a.trace_id.startswith("q#") and int(a.trace_id[2:]) > 0
    da, db = a.to_dict(), b.to_dict()
    da.pop("trace_id"), db.pop("trace_id")
    assert da == db
    assert a.total_s == b.total_s
    a.extend([("x", 1.0)])
    assert a.marks[-1] == ("x", 1.0)


def test_trace_ids_count_up_per_process():
    ids = [int(trace.TraceContext("q").trace_id.split("#")[1])
           for _ in range(3)]
    assert ids == sorted(ids) and len(set(ids)) == 3


@pytest.mark.parametrize("seed", (0, 1))
def test_flight_recorder_equals_jax(seed):
    """The same settled traces give the same stage histograms, ring
    contents, slow exemplars and p99 exemplar in both recorders."""
    m, jm = metrics.Metrics(), jax_metrics.Metrics()
    rec = trace.FlightRecorder(m, ring=16, slow_ring=4,
                               slow_threshold_s=0.06)
    jrec = jax_trace.FlightRecorder(jm, ring=16, slow_ring=4,
                                    slow_threshold_s=0.06)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    ours, theirs = [], []
    for i in range(40):
        q = f"q{i % 2}"
        n = 4 + i % 9
        a, b = _marked(trace, rng, q, n), _marked(jax_trace, jrng, q, n)
        rec.complete(a)
        jrec.complete(b)
        ours.append(a)
        theirs.append(b)
    assert m.report()["stage_seconds"] == jm.report()["stage_seconds"]

    def strip(snap):
        for per_q in snap["queues"].values():
            for rows in per_q.values():
                for row in rows:
                    row.pop("trace_id")
        return snap
    assert strip(rec.snapshot(limit=64)) == strip(jrec.snapshot(limit=64))
    assert strip(rec.snapshot("q1", 3)) == strip(jrec.snapshot("q1", 3))
    for q in ("q0", "q1"):
        a, b = rec.percentile_exemplar(q), jrec.percentile_exemplar(q)
        assert ours.index(a) == theirs.index(b)
    assert rec.percentile_exemplar("absent") is None
    assert rec.get(ours[-1].trace_id) is ours[-1]
    assert rec.get("nope#0") is None


def test_event_log_rows_equal_jax_shape():
    log, jlog = trace.EventLog(maxlen=3), jax_trace.EventLog(maxlen=3)
    for lg in (log, jlog):
        lg.append("breaker_trip", "q", "3 crashes", refs={"crashes": 3})
        lg.append("journal_compacted", "q", "anchor")
        lg.append("drain_begin", "", "checkpoint=off")
        lg.append("dead_letter", "q", "tag 4")
    assert len(log) == len(jlog) == 3

    def clockless(rows):
        return [{k: v for k, v in r.items() if k not in ("t", "mono_ns")}
                for r in rows]
    assert clockless(log.snapshot()) == clockless(jlog.snapshot())
    assert clockless(log.snapshot("q", limit=1)) == clockless(
        jlog.snapshot("q", limit=1))


async def _publish_some(broker, n_requests, n_responses):
    broker.declare_queue("rq")
    broker.declare_queue("replies")
    for i in range(n_requests):
        broker.publish("rq", b"{}", Properties(reply_to="replies",
                                               correlation_id=f"c{i}"))
    for i in range(n_responses):
        broker.publish("replies", b"{}", Properties(correlation_id=f"r{i}"))
    got = []
    for q in ("rq", "replies"):
        while (d := await broker.get(q, timeout=0.01)) is not None:
            got.append(d)
    return got


@pytest.mark.parametrize("sample_n", [1, 3])
async def test_broker_stamps_requests_only_and_samples(sample_n):
    broker = InProcBroker()
    broker.trace_sample_n = sample_n
    got = await _publish_some(broker, 9, 4)
    requests = [d for d in got if d.queue == "rq"]
    assert all(d.trace is None for d in got if d.queue == "replies")
    stamped = [d.properties.correlation_id for d in requests
               if d.trace is not None]
    assert stamped == [f"c{i}" for i in range(0, 9, sample_n)]
    for d in requests:
        if d.trace is not None:
            assert d.trace.marks[0][0] == "enqueue"
            assert d.trace.trace_id.startswith("rq#")
    broker.trace_enabled = False
    assert all(d.trace is None for d in await _publish_some(broker, 3, 0))


def _obs_cfgs(trace_on=True, sample_n=1):
    port, jax = port_cfg(), jax_cfg()
    port = dataclasses.replace(port, observability=ObservabilityConfig(
        trace=trace_on, trace_sample_n=sample_n, trace_ring=4096))
    jax = dataclasses.replace(jax, observability=JaxObservabilityConfig(
        trace=trace_on, trace_sample_n=sample_n, trace_ring=4096))
    return port, jax


class _Ids:
    """Trace ids normalised to order of first appearance, per queue."""

    def __init__(self):
        self.seen: dict[str, int] = {}

    def __call__(self, tid: str) -> str:
        if not tid:
            return ""
        queue = tid.rsplit("#", 1)[0]
        return f"{queue}#{self.seen.setdefault(tid, len(self.seen))}"


def _traces(app):
    return [tr for ring in app.recorder._recent.values() for tr in ring]


@pytest.fixture(scope="module")
def soaks():
    port_c, jax_c = _obs_cfgs()
    app = MatchmakingApp(port_c, device="cpu")
    mine = asyncio.run(serve_bursts(app, Properties, soak_bodies()))
    assert app.faults() == {}
    japp = JaxApp(jax_c)
    theirs = asyncio.run(serve_bursts(japp, JaxProperties, soak_bodies()))
    return app, mine, japp, theirs


def test_config1_bodies_equal_jax_after_trace_id_normalisation(soaks):
    app, mine, japp, theirs = soaks
    ids, jids = _Ids(), _Ids()
    assert {c: len(v) for c, v in mine.items()} == {
        c: len(v) for c, v in theirs.items()}
    traced = 0
    for corr in sorted(mine, key=lambda c: int(c[1:])):
        for body, jbody in zip(mine[corr], theirs[corr]):
            got = contract.decode_response(body)
            want = jax_contract.decode_response(jbody)
            assert ids(got.trace_id) == jids(want.trace_id), corr
            traced += bool(got.trace_id)
            match = want.match
            if match is not None:
                match = dataclasses.replace(match,
                                            match_id=got.match.match_id)
            want = dataclasses.replace(
                want, match=match, latency_ms=got.latency_ms,
                waited_ms=got.waited_ms, trace_id=got.trace_id)
            assert body == jax_contract.encode_response(want), corr
    # Every request's own answer quotes its trace; only a pool member's
    # later match does not.
    assert traced >= len(mine)


def test_config1_mark_sequences_and_spans_equal_jax(soaks):
    app, _, japp, _ = soaks
    mine = {tr.correlation_id: tr for tr in _traces(app)}
    theirs = {tr.correlation_id: tr for tr in _traces(japp)}
    assert len(mine) == len(theirs) == len(soak_bodies())
    assert set(mine) == set(theirs)
    for corr, tr in mine.items():
        names = [name for name, _ in tr.marks]
        assert names == [name for name, _ in theirs[corr].marks], corr
        assert tr.status == theirs[corr].status, corr
        times = [t for _, t in tr.marks]
        assert times == sorted(times), corr
        _, work, wait = decompose_marks(tr.marks)
        assert abs(work + wait - tr.total_s) <= 1e-9, corr
    statuses = {tr.status for tr in mine.values()}
    assert {"matched", "queued", "rejected"} <= statuses
    full = [name for name, _ in next(
        tr for tr in mine.values() if tr.status == "matched").marks]
    assert full[:10] == ["enqueue", "consume", "middleware", "batch",
                         "flush", "dispatch", "h2d", "device_step",
                         "readback_seal", "collect"]
    assert full[-2:] == ["respond", "publish"]


def test_config1_attribution_and_stage_counts_equal_jax(soaks):
    app, _, japp, _ = soaks
    snap = app.attribution.snapshot()["queues"][QUEUE]
    jsnap = japp.attribution.snapshot()["queues"][QUEUE]
    assert snap["spans"] == jsnap["spans"] == len(soak_bodies())
    assert snap["statuses"] == jsnap["statuses"]
    assert {k: (c["kind"], c["traces"]) for k, c in snap["categories"].items()
            if k not in ("consume", "decode")} == {
        k: (c["kind"], c["traces"]) for k, c in jsnap["categories"].items()
        if k not in ("consume", "decode")}
    # The ingest categories count rows per burst, in both.
    for k in ("consume", "decode"):
        assert snap["categories"][k]["traces"] == (
            jsnap["categories"][k]["traces"]), k
    stages = app.metrics.report()["stage_seconds"][QUEUE]
    jstages = japp.metrics.report()["stage_seconds"][QUEUE]
    assert {s: h["count"] for s, h in stages.items()} == {
        s: h["count"] for s, h in jstages.items()}
    assert stages["total"]["count"] == len(soak_bodies())
    assert set(app.metrics.latency) == set(japp.metrics.latency)
    assert len(app.metrics.latency["match_wait"]) == len(
        japp.metrics.latency["match_wait"])


def test_config1_counters_equal_jax(soaks):
    app, _, japp, _ = soaks
    got, want = app.metrics.counters, japp.metrics.counters
    for name in ("windows", "requests_batched", "players_matched",
                 "rejected_by_middleware", "rejected_by_engine",
                 "deduped_replays"):
        assert got.get(name) == want.get(name), name
    assert got.get("windows") > 0 and got.get("players_matched") > 0
    assert app.metrics.gauges["batch_fill[%s]" % QUEUE] == pytest.approx(
        japp.metrics.gauges["batch_fill[%s]" % QUEUE])
    assert set(app.metrics.report()["counters"]) <= set(
        japp.metrics.report()["counters"]) | {"xla_compiles",
                                              "xla_compile_seconds"}


def test_tracing_off_and_sampled():
    """Off: no answer quotes a trace id and nothing is recorded. Sampled
    (N = 4): about a quarter of the requests are traced, the rest quote
    no id, and no unstamped delivery is traced downstream."""
    port_c, _ = _obs_cfgs(trace_on=False)
    app = MatchmakingApp(port_c, device="cpu")
    bodies = soak_bodies()
    answers = asyncio.run(serve_bursts(app, Properties, bodies))
    assert all(not json.loads(b).get("trace_id")
               for v in answers.values() for b in v)
    assert not _traces(app) and not app.metrics.stages.get(QUEUE, {}).get(
        "total")
    port_c, _ = _obs_cfgs(sample_n=4)
    app = MatchmakingApp(port_c, device="cpu")
    answers = asyncio.run(serve_bursts(app, Properties, bodies))
    traced = _traces(app)
    assert len(traced) == len(bodies) // 4
    quoted = {json.loads(v[0]).get("trace_id") for v in answers.values()}
    assert quoted - {None} == {tr.trace_id for tr in traced}
    for tr in traced:
        _, work, wait = decompose_marks(tr.marks)
        assert abs(work + wait - tr.total_s) <= 1e-9


# ---- the engine's window marks --------------------------------------------

@pytest.mark.parametrize("name,engine_kw", [
    ("elo_1v1", {"batch_buckets": (16, 32)}),
    ("glicko2", {}),
    ("elo_1v1", {"bucketed": True, "band_spec": "gaussian:1500:300",
                 "prune_window_blocks": 2, "prune_chunk": 16}),
], ids=["elo_chunks", "glicko2", "elo_bucketed"])
def test_engine_window_marks_equal_tpu_engine(name, engine_kw):
    """Every window of the port's engine records the JAX engine's mark
    names in its order: dispatch, (h2d, device_step or
    formation_bucketed) per chunk, readback_seal, collect; a rescan tick
    readback_seal, collect. Host wall-clock stamps, non-decreasing; the
    service pops them (a sync ``search`` pops its own)."""
    from test_torch_columnar import columns_pair, engine_pair, stream

    jeng, teng = engine_pair(name, **engine_kw)
    rng = np.random.default_rng(3)
    toks = []
    for rows, t in stream(rng, 4, name):
        jc, tc = columns_pair(jeng, teng, rows)
        toks.append((jeng.search_columns_async(jc, t),
                     teng.search_columns_async(tc, t)))
    toks.append((jeng.rescan_async(64, t + 5.0),
                 teng.rescan_async(64, t + 5.0)))
    jeng.flush()
    teng.flush()
    for jtok, ttok in toks:
        got = teng.window_marks.pop(ttok)
        want = jeng.window_marks.pop(jtok)
        assert [n for n, _ in got] == [n for n, _ in want], ttok
        assert [t for _, t in got] == sorted(t for _, t in got)
    names = [n for n, _ in got]
    assert names == ["readback_seal", "collect"]
    assert not teng.window_marks


def test_engine_window_marks_are_capped_and_popped_by_search():
    from test_torch_columnar import engine_pair

    _, eng = engine_pair("elo_1v1")
    req = contract.SearchRequest(id="x", rating=1500.0)
    eng.search([req], 1.0)
    assert not eng.window_marks  # a sync caller merges none
    for i in range(520):
        eng.search_columns_async(eng_cols(eng, f"y{i}", 1500.0 + 1000 * i),
                                 2.0 + i)
        eng.flush()
    assert len(eng.window_marks) == 512
    assert min(eng.window_marks) == 520 + 1 - 512


def eng_cols(eng, pid, rating):
    from matchmaking_tpu_torch.service.contract import RequestColumns

    region, mode = eng.intern_columns(["*"], ["*"])
    return RequestColumns(
        ids=np.array([pid], object), rating=np.array([rating], np.float32),
        rd=np.array([350.0], np.float32), region=region, mode=mode,
        threshold=np.array([np.nan], np.float32),
        enqueued_at=np.array([0.0]), reply_to=np.array(["r"], object),
        correlation_id=np.array([pid], object))
