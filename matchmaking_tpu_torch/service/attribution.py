"""Critical-path attribution: settled traces decomposed into work and wait.

The port's copy of ``matchmaking_tpu/service/attribution.py``. Stage
histograms say which stage is slow, not whether a request's latency was
spent doing work (decode, pack, the device step) or waiting (broker
dwell, the batcher's window clock, a pipeline slot, the publish loop).

This module classifies every adjacent mark pair of a settled trace
(utils/trace.TraceContext) into a named category with a WORK/WAIT kind:

==================  =====  =====================================================
gap (prev → cur)    kind   meaning
==================  =====  =====================================================
enqueue→consume     wait   broker_dwell — queued in the broker before a
                           consumer picked it up
*→consume (redel.)  wait   redelivery_wait — nack/drop to redelivery pickup
consume→middleware  work   middleware — auth + validity checks
*→batch             work   ingress — decode/submit into the batcher
batch→flush         wait   batcher_hold — the window clock (max_wait_ms) or
                           windows queued ahead under saturation
flush→dispatch      wait   pipeline_slot_wait — engine-lock + pipeline-depth
                           backpressure + pre-dispatch sweeps
dispatch→h2d        work   pack_h2d — host pack + host→device transfer
h2d→device_step     work   device_step — the jitted kernel dispatch
dispatch→collect    work   engine_step — synchronous host-oracle engines
                           (no h2d/readback marks)
dispatch→oracle_…   work   oracle_step — delegated team/role oracle window
device_step→seal    wait   readback_group_wait — results waiting for their
                           readback group to fill/go stale
seal→collect        wait   readback_transfer — D2H in flight + collect poll
*→encode            work   encode — batch response-body building (native
                           batch encoder / Python fallback) for the
                           window this trace settles in
*→respond           wait   publish_lag — outcome handling queued on the loop
                           BEFORE the actual broker publish started
respond→publish     work   respond — the broker publish + settle itself
collect→publish     wait   publish_lag — traces without a respond mark keep
                           the pre-split lumped semantics
*→dedup_replay      work   dedup_replay — terminal-response replay
*→shed / *→expired  work   admission — shed/expire decision + response
*→reject            work   reject — middleware/contract rejection
*→chaos_drop        wait   broker_dwell — the drop happened at the consume
                           point; the dwell before it is broker time
==================  =====  =====================================================

Per queue it maintains, for each category: gap count, cumulative seconds, a
log-bucketed histogram (utils/metrics.Histogram), and the number of distinct
traces touching the category (the replay-stable count: chunked windows emit
a variable number of h2d/device_step gaps per trace, but whether a trace
touched a category at all is a pure function of its lifecycle under seeded
chaos). Work + wait sums telescope to the enqueue→publish span exactly, by
construction.

When an SLO target is configured (ObservabilityConfig.slo_target_ms) it also
counts per-queue attainment: a settled trace is GOOD when it reached a
served outcome (not shed/expired/rejected/timeout) within the target.
Shed/expired requests burn the SLO on purpose — an objective met by
rejecting everyone is not met.

Loop-confined like the batcher and AdmissionController: ``observe`` runs on
the event loop (every trace-settle path does), never from worker threads —
there is deliberately no lock here.
"""

from __future__ import annotations

from typing import Any

from matchmaking_tpu_torch.utils.metrics import DEFAULT_STAGE_BUCKETS, Histogram

WORK = "work"
WAIT = "wait"

#: Statuses that count as a served outcome for SLO attainment.
_SERVED_STATUSES = frozenset({"matched", "queued", "deduped"})

#: Classification keyed by the LATER mark of the pair (the mark a duration
#: is attributed to); pairs not covered here go through ``classify``'s
#: special cases, and genuinely unknown marks land in other_work/other_wait
#: so the work+wait identity still holds for novel mark vocabularies.
_BY_TARGET: dict[str, tuple[str, str]] = {
    "middleware": ("middleware", WORK),
    "batch": ("ingress", WORK),
    "flush": ("batcher_hold", WAIT),
    "dispatch": ("pipeline_slot_wait", WAIT),
    "h2d": ("pack_h2d", WORK),
    "device_step": ("device_step", WORK),
    # Bucketed formation: the engine names the
    # device-step mark after the step family actually dispatched, so the
    # sub-O(P) formation work is attributable separately from flat
    # device_step windows.
    "formation_bucketed": ("formation_bucketed", WORK),
    "oracle_step": ("oracle_step", WORK),
    "readback_seal": ("readback_group_wait", WAIT),
    "collect": ("readback_transfer", WAIT),
    "encode": ("encode", WORK),
    "respond": ("publish_lag", WAIT),
    "publish": ("publish_lag", WAIT),
    "dedup_replay": ("dedup_replay", WORK),
    "reject": ("reject", WORK),
    "shed": ("admission", WORK),
    "expired": ("admission", WORK),
    "chaos_drop": ("broker_dwell", WAIT),
}

#: Marks whose presence means real work happened even when unknown pairs
#: surround them (conservative fallback kind for unknown TARGETS).
_KNOWN_WORK_MARKS = frozenset(
    name for name, (_, kind) in _BY_TARGET.items() if kind == WORK)


def classify(prev: str, cur: str) -> tuple[str, str]:
    """(category, kind) for the duration between marks ``prev`` and
    ``cur``. Total classification: every pair maps somewhere, so a trace's
    category durations always sum to its span."""
    if cur == "consume":
        return (("broker_dwell", WAIT) if prev == "enqueue"
                else ("redelivery_wait", WAIT))
    if cur == "collect" and prev in ("dispatch", "flush"):
        # Synchronous engines (host oracle, non-pipelined flush) bracket the
        # whole engine step with dispatch→collect and ship no device marks.
        return ("engine_step", WORK)
    if cur == "publish" and prev == "respond":
        # The respond mark (stamped at the broker-publish call) splits the
        # old publish_lag in two: queueing before the publish (…→respond,
        # wait) vs the publish + settle itself (respond→publish, work).
        return ("respond", WORK)
    got = _BY_TARGET.get(cur)
    if got is not None:
        return got
    return (("other_work", WORK) if cur in _KNOWN_WORK_MARKS
            else ("other_wait", WAIT))


def decompose_marks(
        marks) -> tuple[list[dict[str, Any]], float, float]:
    """THE gap walk: classify every adjacent pair of a mark sequence
    (``[(name, t), ...]`` — tuples or JSON lists) into the taxonomy.
    Returns (gaps, work_s, wait_s); work + wait telescopes to the span.
    ``decompose`` and any offline reader of trace dumps share it, so
    the two cannot disagree."""
    gaps: list[dict[str, Any]] = []
    work_s = 0.0
    wait_s = 0.0
    prev_name, prev_t = marks[0]
    for name, t in marks[1:]:
        dur = max(0.0, t - prev_t)
        category, kind = classify(prev_name, name)
        if kind == WORK:
            work_s += dur
        else:
            wait_s += dur
        gaps.append({"from": prev_name, "to": name, "category": category,
                     "kind": kind, "ms": round(dur * 1e3, 3)})
        prev_name, prev_t = name, t
    return gaps, work_s, wait_s


def decompose(trace) -> dict[str, Any]:
    """One trace's full wait-vs-work decomposition (JSON-ready): the
    per-gap waterfall plus work/wait sums that — by telescoping — equal the
    enqueue→publish span exactly."""
    gaps, work_s, wait_s = decompose_marks(trace.marks)
    return {
        "trace_id": trace.trace_id,
        "status": trace.status,
        "total_ms": round(trace.total_s * 1e3, 3),
        "work_ms": round(work_s * 1e3, 3),
        "wait_ms": round(wait_s * 1e3, 3),
        "gaps": gaps,
    }


class _Category:
    __slots__ = ("kind", "gaps", "traces", "total_s", "hist")

    def __init__(self, kind: str, buckets: tuple[float, ...]):
        self.kind = kind
        self.gaps = 0
        self.traces = 0
        self.total_s = 0.0
        self.hist = Histogram(buckets)


class _TierStats:
    """Per-QoS-tier split of a queue's settled spans (tiered serving:
    the aggregate averages tier-0 holding its SLO with tier-2 burning on
    purpose into a number that describes neither). Totals only — the
    category HISTOGRAMS stay aggregate; tiers × categories × buckets is
    where the memory goes to die, and the per-tier question is "who is
    burning / who absorbs the shedding", answered by these."""

    __slots__ = ("spans", "work_s", "wait_s", "statuses", "slo_good",
                 "slo_total", "total_hist")

    def __init__(self, buckets: tuple[float, ...]):
        self.spans = 0
        self.work_s = 0.0
        self.wait_s = 0.0
        self.statuses: dict[str, int] = {}
        self.slo_good = 0
        self.slo_total = 0
        self.total_hist = Histogram(buckets)


class _RescanStats:
    """Per-queue attribution bucket for rescan windows:
    their device time lands in busy/idle but their window marks merge into
    no trace — this is where that time becomes a number. Kept OUTSIDE the
    queue's work/wait sums: those telescope to settled-trace spans exactly
    (the telescoping identity), and a rescan is not a trace."""

    __slots__ = ("windows", "total_s", "device_step_s", "hist")

    def __init__(self, buckets: tuple[float, ...]):
        self.windows = 0
        self.total_s = 0.0
        self.device_step_s = 0.0
        self.hist = Histogram(buckets)


class _QueueAttribution:
    __slots__ = ("categories", "work_s", "wait_s", "spans", "total_hist",
                 "statuses", "slo_good", "slo_total", "tiers", "rescan",
                 "ingest")

    def __init__(self, buckets: tuple[float, ...]):
        self.categories: dict[str, _Category] = {}
        self.work_s = 0.0
        self.wait_s = 0.0
        self.spans = 0
        self.total_hist = Histogram(buckets)
        self.statuses: dict[str, int] = {}
        self.slo_good = 0
        self.slo_total = 0
        self.tiers: dict[int, _TierStats] = {}
        self.rescan: _RescanStats | None = None
        #: Ingest-side WORK categories: ``consume`` (broker
        #: consume machinery + admission pre-checks + batcher hand-off)
        #: and ``decode`` (wire-body → columns, native or contract path),
        #: measured DIRECTLY at the burst/window site — one observation
        #: per burst, not one per trace — so the per-delivery cost is a
        #: true wall-clock sum on both the batched and the per-delivery
        #: ingress, comparable across the consume_batch on/off configs.
        #: Kept OUT of work_s/wait_s: those telescope to settled-trace
        #: spans exactly (the telescoping identity), and these spans overlap
        #: trace gaps that are already classified.
        self.ingest: dict[str, _Category] = {}


class Attribution:
    """Per-queue wait-vs-work accounting over settled traces, fed by
    FlightRecorder.complete. All counters are monotone, so deltas between
    any two scrapes are well-defined (the telemetry ring samples them)."""

    def __init__(self, buckets: tuple[float, ...] | None = None,
                 slo_target_s: float = 0.0, tiers: int = 1):
        self.buckets = tuple(buckets or DEFAULT_STAGE_BUCKETS)
        self.slo_target_s = slo_target_s
        #: QoS tier count (OverloadConfig.tiers): > 1 arms the per-tier
        #: span/status/SLO splits; 1 keeps the pre-tier shape (and cost).
        self.tiers = max(1, tiers)
        self._queues: dict[str, _QueueAttribution] = {}

    def _queue(self, q: str) -> _QueueAttribution:
        qa = self._queues.get(q)
        if qa is None:
            qa = self._queues[q] = _QueueAttribution(self.buckets)
        return qa

    def observe(self, trace) -> None:
        qa = self._queue(trace.queue)
        marks = trace.marks
        touched: set[str] = set()
        span_work = 0.0
        span_wait = 0.0
        prev_name, prev_t = marks[0]
        for name, t in marks[1:]:
            dur = max(0.0, t - prev_t)
            category, kind = classify(prev_name, name)
            cat = qa.categories.get(category)
            if cat is None:
                cat = qa.categories[category] = _Category(kind, self.buckets)
            cat.gaps += 1
            cat.total_s += dur
            cat.hist.observe(dur)
            if category not in touched:
                touched.add(category)
                cat.traces += 1
            if kind == WORK:
                span_work += dur
            else:
                span_wait += dur
            prev_name, prev_t = name, t
        qa.work_s += span_work
        qa.wait_s += span_wait
        qa.spans += 1
        total = trace.total_s
        qa.total_hist.observe(total)
        status = trace.status or "unknown"
        qa.statuses[status] = qa.statuses.get(status, 0) + 1
        good = (self.slo_target_s > 0 and status in _SERVED_STATUSES
                and total <= self.slo_target_s)
        if self.slo_target_s > 0:
            qa.slo_total += 1
            if good:
                qa.slo_good += 1
        if self.tiers > 1:
            tier = min(max(getattr(trace, "tier", 0), 0), self.tiers - 1)
            ts = qa.tiers.get(tier)
            if ts is None:
                ts = qa.tiers[tier] = _TierStats(self.buckets)
            ts.spans += 1
            ts.work_s += span_work
            ts.wait_s += span_wait
            ts.statuses[status] = ts.statuses.get(status, 0) + 1
            ts.total_hist.observe(total)
            if self.slo_target_s > 0:
                ts.slo_total += 1
                if good:
                    ts.slo_good += 1

    def observe_ingest(self, queue: str, category: str, seconds: float,
                       rows: int) -> None:
        """Record one ingest-side work span: ``category`` is
        ``"consume"`` or ``"decode"``, ``seconds`` the measured wall time
        of one burst/window's worth of that work, ``rows`` the deliveries
        it covered. Monotone counters, one call per burst."""
        if seconds < 0.0:
            return
        qa = self._queue(queue)
        cat = qa.ingest.get(category)
        if cat is None:
            cat = qa.ingest[category] = _Category(WORK, self.buckets)
        cat.gaps += 1
        cat.traces += max(0, rows)
        cat.total_s += seconds
        cat.hist.observe(seconds)

    def observe_rescan(self, queue: str, marks) -> None:
        """Record one finalized rescan window's engine marks (dispatch →
        h2d/device_step… → collect) into the queue's rescan bucket. Not a
        trace: kept out of work_s/wait_s so the telescoping identity over
        settled traces is untouched."""
        if not marks or len(marks) < 2:
            return
        qa = self._queue(queue)
        if qa.rescan is None:
            qa.rescan = _RescanStats(self.buckets)
        rs = qa.rescan
        span = max(0.0, marks[-1][1] - marks[0][1])
        rs.windows += 1
        rs.total_s += span
        rs.hist.observe(span)
        prev_t = marks[0][1]
        for name, t in marks[1:]:
            if name == "device_step":
                rs.device_step_s += max(0.0, t - prev_t)
            prev_t = t

    # ---- reads -------------------------------------------------------------

    def slo_counts(self, queue: str) -> tuple[int, int]:
        """(good, total) settled-trace SLO counters for one queue — the
        cumulative series the burn-rate monitor differences."""
        qa = self._queues.get(queue)
        return (qa.slo_good, qa.slo_total) if qa is not None else (0, 0)

    def slo_counts_tier(self, queue: str, tier: int) -> tuple[int, int]:
        """Per-tier (good, total) SLO counters — the series behind the
        ``queue@tN`` burn monitors."""
        qa = self._queues.get(queue)
        if qa is None:
            return (0, 0)
        ts = qa.tiers.get(tier)
        return (ts.slo_good, ts.slo_total) if ts is not None else (0, 0)

    def queue_totals(self, queue: str) -> dict[str, float]:
        """Monotone per-queue sums for the telemetry ring."""
        qa = self._queues.get(queue)
        if qa is None:
            return {"work_s": 0.0, "wait_s": 0.0, "spans": 0.0}
        return {"work_s": qa.work_s, "wait_s": qa.wait_s,
                "spans": float(qa.spans)}

    def snapshot(self, queue: str | None = None) -> dict[str, Any]:
        queues = [queue] if queue is not None else sorted(self._queues)
        out: dict[str, Any] = {}
        for q in queues:
            qa = self._queues.get(q)
            if qa is None:
                continue
            span_s = qa.work_s + qa.wait_s
            cats = {
                name: {
                    "kind": cat.kind,
                    "gaps": cat.gaps,
                    "traces": cat.traces,
                    "total_s": round(cat.total_s, 6),
                    "share": round(cat.total_s / span_s, 4) if span_s else 0.0,
                    "p99_ms": round(cat.hist.percentile(99) * 1e3, 3)
                    if cat.hist.count else None,
                }
                for name, cat in sorted(qa.categories.items())
            }
            # Ingest categories: measured at the burst/window
            # site, reported alongside the trace-derived ones with the
            # same share denominator (the queue's settled span) so
            # "consume/decode share" is directly comparable round over
            # round and across the consume_batch on/off configs.
            for name, cat in sorted(qa.ingest.items()):
                cats[name] = {
                    "kind": cat.kind,
                    "gaps": cat.gaps,
                    "traces": cat.traces,
                    "total_s": round(cat.total_s, 6),
                    "share": (round(cat.total_s / span_s, 4)
                              if span_s else 0.0),
                    "p99_ms": (round(cat.hist.percentile(99) * 1e3, 3)
                               if cat.hist.count else None),
                }
            entry: dict[str, Any] = {
                "spans": qa.spans,
                "work_s": round(qa.work_s, 6),
                "wait_s": round(qa.wait_s, 6),
                "wait_fraction": round(qa.wait_s / span_s, 4) if span_s else 0.0,
                "statuses": dict(sorted(qa.statuses.items())),
                "p99_total_ms": round(qa.total_hist.percentile(99) * 1e3, 3)
                if qa.total_hist.count else None,
                "categories": cats,
            }
            if self.slo_target_s > 0:
                entry["slo_good"] = qa.slo_good
                entry["slo_total"] = qa.slo_total
                entry["slo_attainment"] = (
                    round(qa.slo_good / qa.slo_total, 4)
                    if qa.slo_total else None)
            if qa.tiers:
                entry["tiers"] = {
                    str(t): {
                        "spans": ts.spans,
                        "work_s": round(ts.work_s, 6),
                        "wait_s": round(ts.wait_s, 6),
                        "wait_fraction": (
                            round(ts.wait_s / (ts.work_s + ts.wait_s), 4)
                            if ts.work_s + ts.wait_s else 0.0),
                        "statuses": dict(sorted(ts.statuses.items())),
                        "p99_total_ms": (
                            round(ts.total_hist.percentile(99) * 1e3, 3)
                            if ts.total_hist.count else None),
                        **({"slo_good": ts.slo_good,
                            "slo_total": ts.slo_total,
                            "slo_attainment": (
                                round(ts.slo_good / ts.slo_total, 4)
                                if ts.slo_total else None)}
                           if self.slo_target_s > 0 else {}),
                    }
                    for t, ts in sorted(qa.tiers.items())
                }
            if qa.rescan is not None and qa.rescan.windows:
                entry["rescan"] = {
                    "windows": qa.rescan.windows,
                    "total_s": round(qa.rescan.total_s, 6),
                    "device_step_s": round(qa.rescan.device_step_s, 6),
                    "p99_ms": (
                        round(qa.rescan.hist.percentile(99) * 1e3, 3)
                        if qa.rescan.hist.count else None),
                }
            out[q] = entry
        return {"slo_target_ms": round(self.slo_target_s * 1e3, 3),
                "queues": out}
