"""The port's metrics module (``matchmaking_tpu_torch/utils/metrics.py``)
against the JAX package's (``matchmaking_tpu/utils/metrics.py``) on the
same seeded inputs: ``Histogram`` and ``LatencyRecorder`` percentiles and
exports equal, ``Metrics.report()`` with the same key set, and the graph
capture count behind the ``xla_compiles`` keys."""

import math

import numpy as np
import pytest

from matchmaking_tpu.utils import metrics as jax_metrics
from matchmaking_tpu_torch.utils import metrics

SEEDS = (0, 1, 2, 3)


def _samples(seed, n=2_000):
    """Seeded latencies in seconds over the stage buckets' whole span:
    sub-bucket, inside, exactly on edges, and past the last bucket."""
    rng = np.random.default_rng(seed)
    xs = np.exp(rng.uniform(np.log(1e-6), np.log(4e3), n))
    edges = np.asarray(metrics.DEFAULT_STAGE_BUCKETS)
    xs[: n // 10] = rng.choice(edges, n // 10)
    rng.shuffle(xs)
    return xs.tolist()


def test_default_stage_buckets_equal_jax():
    assert metrics.DEFAULT_STAGE_BUCKETS == jax_metrics.DEFAULT_STAGE_BUCKETS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("buckets", [None, (0.5, 0.001, 0.1, 2.0, 0.01)])
def test_histogram_equals_jax(seed, buckets):
    kw = {} if buckets is None else {"buckets": buckets}
    h, jh = metrics.Histogram(**kw), jax_metrics.Histogram(**kw)
    assert h.percentile(99) != h.percentile(99)  # NaN when empty
    for x in _samples(seed):
        h.observe(x)
        jh.observe(x)
    assert (h.buckets, h.counts, h.overflow, h.count) == (
        jh.buckets, jh.counts, jh.overflow, jh.count)
    assert h.sum == jh.sum
    for p in (0.1, 1, 25, 50, 90, 99, 99.9, 100):
        assert h.percentile(p) == jh.percentile(p), p
    assert h.to_dict() == jh.to_dict()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("window", [64, 65_536])
def test_latency_recorder_equals_jax(seed, window):
    r = metrics.LatencyRecorder(window)
    jr = jax_metrics.LatencyRecorder(window)
    assert r.summary_ms() == jr.summary_ms() == {"count": 0}
    assert math.isnan(r.percentile(50))
    for x in _samples(seed, 500):
        r.record(x)
        jr.record(x)
    assert len(r) == len(jr) == 500
    for p in (1, 50, 90, 99, 100):
        assert r.percentile(p) == jr.percentile(p), p
    assert r.summary_ms() == jr.summary_ms()


def _fill(m, seed):
    rng = np.random.default_rng(seed)
    for i in range(200):
        m.counters.inc(f"c{i % 7}", float(rng.integers(1, 4)))
        m.record_latency("match_wait", float(rng.uniform(0, 2)))
        m.observe_stage(f"q{i % 2}", ("flush", "dispatch", "total")[i % 3],
                        float(rng.uniform(0, 0.5)))
    m.set_gauge("batch_fill[q0]", 0.5)
    m.set_gauge("breaker_state[q0]", 2)


@pytest.mark.parametrize("seed", SEEDS)
def test_metrics_report_equals_jax(seed):
    """The same calls give the same report, key for key; the compile keys
    are present in both (what they count differs by package)."""
    m, jm = metrics.Metrics(), jax_metrics.Metrics()
    _fill(m, seed)
    _fill(jm, seed)
    got, want = m.report(), jm.report()
    assert set(got) == set(want) == {"counters", "gauges", "latency",
                                     "stage_seconds"}
    assert set(got["counters"]) == set(want["counters"])
    for key in ("xla_compiles", "xla_compile_seconds"):
        assert key in got["counters"]
        got["counters"].pop(key)
        want["counters"].pop(key)
    assert got == want
    assert m.report_json().startswith("{")


def test_custom_stage_buckets_reach_every_histogram():
    m = metrics.Metrics(stage_buckets=(0.2, 0.1))
    m.observe_stage("q", "s", 0.15)
    h = m.stages["q"]["s"]
    assert h.buckets == (0.1, 0.2) and h.counts == [0, 1]


def test_span_measures_elapsed():
    s = metrics.Span("x")
    assert s.stop() >= 0.0 and s.elapsed == s.elapsed


def test_compile_counter_counts_graph_captures():
    """The port's ``xla_compiles`` is the graph capture count: each
    ``record`` (one per ``StepGraphs.capture``) adds one and its seconds,
    and ``report()`` shows them."""
    n0, s0 = metrics.CompileCounter.count(), metrics.CompileCounter.seconds()
    metrics.CompileCounter.record(0.25)
    metrics.CompileCounter.record(0.5)
    assert metrics.CompileCounter.count() == n0 + 2
    assert metrics.CompileCounter.seconds() == pytest.approx(s0 + 0.75)
    rep = metrics.Metrics().report()["counters"]
    assert rep["xla_compiles"] == float(n0 + 2)
