"""Request-lifecycle tracing: trace contexts, the flight recorder, the
event log.

The port's copy of ``matchmaking_tpu/utils/trace.py``, stdlib only:

- ``TraceContext``: one delivery's trace, an id ``f"{queue}#{n}"`` (``n``
  from a process-wide counter) and an append-only list of ``(stage,
  wall-clock)`` marks. The broker stamps it at publish (the "enqueue"
  mark) on the ``Delivery``, which carries it through middleware, the
  batcher, the engine window and the answer. A nacked delivery keeps its
  trace: the redelivery appends to the same marks.
- ``FlightRecorder``: per queue, a ring of settled traces and a ring of
  slow exemplars (span over the threshold). Each settled trace feeds the
  per-stage histograms (``utils/metrics.py``) with every adjacent mark
  pair, and the attribution (``service/attribution.py``).
- ``EventLog``: a bounded ring of lifecycle events, each stamped onto the
  app's ``EventSpine`` (``utils/forensics.py``); ``snapshot()`` orders by
  the spine's seq.

Stages (a stage's duration is its mark minus the previous mark): enqueue
→ consume → middleware → batch → flush → dispatch → h2d → device_step
(or formation_bucketed) → readback_seal → collect → encode → respond →
publish, with off-nominal marks where they happen (dedup_replay, reject,
shed, expired, oracle_step). The window marks (dispatch..collect) are
recorded once per engine window and merged into every member trace when
the window is collected.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import deque
from typing import Any, Iterable

#: Marks recorded once per engine window and merged into member traces.
WINDOW_STAGES = ("dispatch", "h2d", "device_step", "readback_seal",
                 "collect", "oracle_step")

_trace_seq = itertools.count(1)


class TraceContext:
    """One delivery's lifecycle marks. Allocated on every traced publish,
    so kept small (``__slots__``, one list)."""

    __slots__ = ("trace_id", "queue", "correlation_id", "player_id",
                 "redelivered", "status", "tier", "marks", "quality",
                 "waited_s")

    def __init__(self, queue: str, correlation_id: str = "",
                 redelivered: bool = False, t: float | None = None):
        self.trace_id = f"{queue}#{next(_trace_seq)}"
        self.queue = queue
        self.correlation_id = correlation_id
        self.player_id = ""
        self.redelivered = redelivered
        self.status = ""  # set at settle: matched, queued, rejected, ...
        #: QoS tier (service/overload.py), stamped at admission.
        self.tier = 0
        #: A matched trace's match quality and wait at match (seconds),
        #: stamped at encode; -1.0: not matched.
        self.quality = -1.0
        self.waited_s = -1.0
        self.marks: list[tuple[str, float]] = [
            ("enqueue", time.time() if t is None else t)]

    def mark(self, stage: str, t: float | None = None) -> None:
        self.marks.append((stage, time.time() if t is None else t))

    def extend(self, marks: Iterable[tuple[str, float]]) -> None:
        self.marks.extend(marks)

    @property
    def total_s(self) -> float:
        return self.marks[-1][1] - self.marks[0][1]

    def to_dict(self) -> dict[str, Any]:
        t0 = self.marks[0][1]
        return {
            "trace_id": self.trace_id,
            "queue": self.queue,
            "player_id": self.player_id,
            "correlation_id": self.correlation_id,
            "redelivered": self.redelivered,
            "status": self.status,
            "tier": self.tier,
            **({"quality": round(self.quality, 6),
                "waited_ms": round(self.waited_s * 1e3, 3)}
               if self.quality >= 0.0 else {}),
            "enqueue_t": t0,
            "total_ms": round(self.total_s * 1e3, 3),
            #: absolute wall-clock marks (monotone non-decreasing)
            "marks": [(name, t) for name, t in self.marks],
            #: per-stage durations, attributed to the later mark
            "stages_ms": {
                f"{i}:{name}": round((t - self.marks[i - 1][1]) * 1e3, 3)
                for i, (name, t) in enumerate(self.marks) if i
            },
        }


class EventLog:
    """Bounded ring of lifecycle events: breaker trips, probes, revives,
    delegations, journal compactions and recoveries, the drain, chaos
    faults, dead letters. Appended from the event loop and from worker
    threads; every row is stamped onto the spine, and ``snapshot()``
    orders by its seq (a worker that drew its seq but lost the race to
    the ring does not render late)."""

    def __init__(self, maxlen: int = 512, spine=None):
        self._events: deque[dict[str, Any]] = deque(maxlen=max(1, maxlen))
        if spine is None:
            # A standalone log owns a private spine: rows look the same.
            from matchmaking_tpu_torch.utils.forensics import EventSpine

            spine = EventSpine(ring=max(1, maxlen))
        self.spine = spine

    def append(self, kind: str, queue: str = "", detail: str = "",
               component: str = "",
               refs: dict[str, Any] | None = None) -> dict[str, Any]:
        ev = self.spine.stamp(kind, queue, detail, component=component,
                              refs=refs)
        self._events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self._events)

    def snapshot(self, queue: str | None = None,
                 limit: int = 0) -> list[dict[str, Any]]:
        # tuple() first: worker threads append while the ring is read.
        rows = [
            {"seq": ev["seq"], "t": ev["wall"], "mono_ns": ev["mono_ns"],
             "component": ev["component"], "kind": ev["kind"],
             "queue": ev["queue"], "detail": ev["detail"],
             "refs": ev["refs"]}
            for ev in tuple(self._events)
            if queue is None or ev["queue"] == queue
        ]
        rows.sort(key=lambda r: r["seq"])
        return rows[-limit:] if limit else rows


class FlightRecorder:
    """Per-queue rings of settled traces and slow exemplars; feeds the
    per-stage histograms and the attribution on every settle."""

    def __init__(self, metrics, ring: int = 256, slow_ring: int = 64,
                 slow_threshold_s: float = 0.25):
        self._metrics = metrics
        self._ring = max(1, ring)
        self._slow_ring = max(1, slow_ring)
        self.slow_threshold_s = slow_threshold_s
        self._recent: dict[str, deque[TraceContext]] = {}
        self._slow: dict[str, deque[TraceContext]] = {}
        #: The attribution sink (service/attribution.Attribution), attached
        #: by the app; None: attribution off.
        self.attribution = None

    def complete(self, trace: TraceContext) -> None:
        """Settle one trace: each adjacent mark pair into the stage
        histograms (and the whole span into "total"), the attribution, the
        recent ring, and the slow ring when its span reaches the
        threshold."""
        q = trace.queue
        marks = trace.marks
        if self._metrics is not None:
            observe = self._metrics.observe_stage
            prev_t = marks[0][1]
            for name, t in marks[1:]:
                observe(q, name, max(0.0, t - prev_t))
                prev_t = t
            observe(q, "total", max(0.0, marks[-1][1] - marks[0][1]))
        if self.attribution is not None:
            self.attribution.observe(trace)
        ring = self._recent.get(q)
        if ring is None:
            ring = self._recent[q] = deque(maxlen=self._ring)
        ring.append(trace)
        if trace.total_s >= self.slow_threshold_s:
            slow = self._slow.get(q)
            if slow is None:
                slow = self._slow[q] = deque(maxlen=self._slow_ring)
            slow.append(trace)

    def percentile_exemplar(self, queue: str,
                            p: float = 99.0) -> TraceContext | None:
        """The recent trace at the p-th percentile of span (nearest rank):
        its gaps sum to its span exactly, unlike a histogram p99."""
        ring = self._recent.get(queue)
        if not ring:
            return None
        by_total = sorted(ring, key=lambda t: t.total_s)
        k = min(len(by_total) - 1,
                max(0, math.ceil(p / 100.0 * len(by_total)) - 1))
        return by_total[k]

    def get(self, trace_id: str) -> TraceContext | None:
        for rings in (self._slow, self._recent):
            for ring in rings.values():
                for tr in ring:
                    if tr.trace_id == trace_id:
                        return tr
        return None

    def snapshot(self, queue: str | None = None,
                 limit: int = 32) -> dict[str, Any]:
        queues = ([queue] if queue is not None
                  else sorted(set(self._recent) | set(self._slow)))
        out: dict[str, Any] = {}
        for q in queues:
            recent = list(self._recent.get(q, ()))[-limit:]
            slow = list(self._slow.get(q, ()))[-limit:]
            out[q] = {
                "recent": [t.to_dict() for t in recent],
                "slow": [t.to_dict() for t in slow],
            }
        return {"slow_threshold_ms": self.slow_threshold_s * 1e3,
                "queues": out}
