"""The port's critical-path attribution (``service/attribution.py``)
against the JAX package's on the same inputs: ``classify`` over every pair
of the mark vocabulary (and unknown marks), ``decompose_marks`` /
``decompose`` of the same seeded mark lists exactly equal, and
``Attribution`` snapshots equal after the same settled traces, ingest
spans and rescan windows, with tiers and an SLO target."""

import numpy as np
import pytest

from matchmaking_tpu.service import attribution as jax_attribution
from matchmaking_tpu.utils import trace as jax_trace
from matchmaking_tpu_torch.service import attribution
from matchmaking_tpu_torch.utils import trace

#: Every mark the services stamp, plus names no classifier knows.
VOCAB = sorted(set(attribution._BY_TARGET) | {
    "enqueue", "consume", "dispatch", "flush", "collect", "publish",
    "respond", "encode", "spec_snapshot", "spec_commit", "h2d",
    "readback_seal", "oracle_step", "formation_bucketed", "chaos_drop",
    "never_seen", ""})


def test_taxonomy_tables_equal_jax():
    assert attribution._BY_TARGET == jax_attribution._BY_TARGET
    assert attribution._KNOWN_WORK_MARKS == jax_attribution._KNOWN_WORK_MARKS
    assert attribution._SERVED_STATUSES == jax_attribution._SERVED_STATUSES


@pytest.mark.parametrize("prev", VOCAB)
def test_classify_equals_jax(prev):
    for cur in VOCAB:
        got = attribution.classify(prev, cur)
        assert got == jax_attribution.classify(prev, cur), (prev, cur)
        assert got[1] in (attribution.WORK, attribution.WAIT)


_LIFECYCLES = (
    ("consume", "middleware", "batch", "flush", "dispatch", "h2d",
     "device_step", "readback_seal", "collect", "encode", "respond",
     "publish"),
    ("consume", "middleware", "batch", "flush", "dispatch", "h2d",
     "formation_bucketed", "h2d", "formation_bucketed", "readback_seal",
     "collect", "encode", "encode", "respond", "respond", "publish"),
    ("consume", "middleware", "batch", "flush", "respond", "dedup_replay",
     "publish"),
    ("consume", "shed", "respond", "publish"),
    ("consume", "middleware", "batch", "flush", "expired", "respond",
     "publish"),
    ("consume", "reject", "publish"),
    ("consume", "middleware", "batch", "flush", "dispatch", "collect",
     "respond", "publish"),
    ("consume", "middleware", "batch", "flush", "dispatch", "oracle_step",
     "collect", "respond", "publish"),
    ("chaos_drop", "consume", "never_seen", "publish"),
)
_STATUSES = ("matched", "queued", "deduped", "shed", "expired", "rejected",
             "timeout", "")


def _traces(seed, n=120):
    """Seeded (marks, status, tier) triples over every lifecycle shape,
    with a redelivery (a second consume) now and then."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        names = list(_LIFECYCLES[i % len(_LIFECYCLES)])
        if i % 11 == 5:
            names = names[:3] + ["consume"] + names[3:]
        t = 1_000.0 + float(rng.uniform(0, 5))
        marks = [("enqueue", t)]
        for name in names:
            # Some gaps are zero or go backwards (clamped at 0).
            t += float(rng.choice([0.0, -1e-4, rng.exponential(0.004)]))
            marks.append((name, t))
        out.append((marks, _STATUSES[i % len(_STATUSES)], int(i % 3)))
    return out


def _trace(mod, queue, marks, status, tier):
    tr = mod.TraceContext(queue, t=marks[0][1])
    tr.marks = list(marks)
    tr.status = status
    tr.tier = tier
    return tr


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_decompose_equals_jax(seed):
    for marks, status, tier in _traces(seed):
        gaps, work, wait = attribution.decompose_marks(marks)
        jgaps, jwork, jwait = jax_attribution.decompose_marks(marks)
        assert (gaps, work, wait) == (jgaps, jwork, jwait)
        # The telescoping identity: work + wait is the clamped span.
        assert work + wait == pytest.approx(
            sum(max(0.0, b[1] - a[1]) for a, b in zip(marks, marks[1:])),
            abs=1e-12)
        got = attribution.decompose(_trace(trace, "q", marks, status, tier))
        want = jax_attribution.decompose(
            _trace(jax_trace, "q", marks, status, tier))
        got.pop("trace_id"), want.pop("trace_id")
        assert got == want


@pytest.mark.parametrize("tiers,slo", [(1, 0.0), (3, 0.02)])
@pytest.mark.parametrize("seed", (0, 1))
def test_attribution_snapshot_equals_jax(seed, tiers, slo):
    a = attribution.Attribution(slo_target_s=slo, tiers=tiers)
    ja = jax_attribution.Attribution(slo_target_s=slo, tiers=tiers)
    for i, (marks, status, tier) in enumerate(_traces(seed)):
        q = f"q{i % 2}"
        a.observe(_trace(trace, q, marks, status, tier))
        ja.observe(_trace(jax_trace, q, marks, status, tier))
    rng = np.random.default_rng(seed)
    for i in range(20):
        q, cat = f"q{i % 2}", ("consume", "decode")[i % 2]
        secs, rows = float(rng.uniform(-1e-3, 0.01)), int(rng.integers(1, 64))
        a.observe_ingest(q, cat, secs, rows)
        ja.observe_ingest(q, cat, secs, rows)
    for marks, _, _ in _traces(seed + 7, 6):
        window = [("dispatch", marks[0][1])] + marks[5:9]
        a.observe_rescan("q0", window)
        ja.observe_rescan("q0", window)
    a.observe_rescan("q1", [("collect", 1.0)])  # too short: ignored
    ja.observe_rescan("q1", [("collect", 1.0)])
    assert a.snapshot() == ja.snapshot()
    assert a.snapshot("q1") == ja.snapshot("q1")
    for q in ("q0", "q1", "absent"):
        assert a.slo_counts(q) == ja.slo_counts(q)
        assert a.queue_totals(q) == ja.queue_totals(q)
        for t in range(tiers):
            assert a.slo_counts_tier(q, t) == ja.slo_counts_tier(q, t)
