"""Metrics: counters, latency percentiles, stage histograms, gauges.

The port's copy of ``matchmaking_tpu/utils/metrics.py``, stdlib only:
``Counter``, the sliding-window ``LatencyRecorder``, the fixed-bucket
``Histogram`` (``DEFAULT_STAGE_BUCKETS``), ``Span`` and ``Metrics`` with
``report()`` under the JAX package's key names.

``CompileCounter`` is the counterpart of the JAX package's XLA compile
counter: what the port compiles on first use is a CUDA graph capture
(``engine/graphs.py``), so it counts captures and their host seconds, fed
by ``StepGraphs.capture``. ``report()`` keeps the JAX keys
``xla_compiles`` and ``xla_compile_seconds`` for them, so both packages
report the same key set.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field


class Counter:
    def __init__(self) -> None:
        self._values: dict[str, float] = defaultdict(float)

    def inc(self, name: str, value: float = 1.0) -> None:
        self._values[name] += value

    def get(self, name: str) -> float:
        return self._values[name]

    def snapshot(self) -> dict[str, float]:
        return dict(self._values)


class LatencyRecorder:
    """The most recent ``window`` samples (bounded memory), plus the
    lifetime count and max; percentiles are over the window."""

    def __init__(self, window: int = 65_536) -> None:
        self._samples: deque[float] = deque(maxlen=window)
        self._count = 0
        self._max = 0.0

    def record(self, seconds: float) -> None:
        self._samples.append(seconds)
        self._count += 1
        if seconds > self._max:
            self._max = seconds

    def __len__(self) -> int:
        return self._count

    @staticmethod
    def _pct(sorted_samples: list[float], p: float) -> float:
        """Nearest-rank percentile of an already sorted list (the one
        definition ``percentile`` and ``summary_ms`` share)."""
        n = len(sorted_samples)
        k = min(n - 1, max(0, math.ceil(p / 100.0 * n) - 1))
        return sorted_samples[k]

    def percentile(self, p: float) -> float:
        if not self._samples:
            return math.nan
        return self._pct(sorted(self._samples), p)

    def summary_ms(self) -> dict[str, float]:
        if not self._samples:
            return {"count": 0}
        s = sorted(self._samples)
        return {
            "count": self._count,
            "p50_ms": round(self._pct(s, 50) * 1e3, 3),
            "p90_ms": round(self._pct(s, 90) * 1e3, 3),
            "p99_ms": round(self._pct(s, 99) * 1e3, 3),
            "max_ms": round(self._max * 1e3, 3),
            "mean_ms": round(sum(s) / len(s) * 1e3, 3),
        }


#: Stage histogram upper bounds: 100 µs · 2^k, 24 buckets (to ~14 min),
#: plus the overflow bucket. One octave bounds a bucket p99's error.
DEFAULT_STAGE_BUCKETS: tuple[float, ...] = tuple(
    1e-4 * 2.0 ** k for k in range(24))


class Histogram:
    """Fixed-bucket latency histogram: per-bucket counts, exported with
    Prometheus' cumulative ``le`` semantics."""

    __slots__ = ("buckets", "counts", "overflow", "count", "sum")

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_STAGE_BUCKETS):
        # bisect needs them sorted (configured buckets may not be).
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)
        self.overflow = 0  # observations above the last bucket (+Inf)
        self.count = 0
        self.sum = 0.0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.sum += seconds
        i = bisect.bisect_left(self.buckets, seconds)
        if i < len(self.buckets):
            self.counts[i] += 1
        else:
            self.overflow += 1

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile (NaN when
        empty; the last edge when it falls in +Inf)."""
        if self.count == 0:
            return math.nan
        rank = max(1, math.ceil(p / 100.0 * self.count))
        cum = 0
        for edge, c in zip(self.buckets, self.counts):
            cum += c
            if cum >= rank:
                return edge
        return self.buckets[-1] if self.buckets else math.nan

    def to_dict(self) -> dict:
        """Cumulative counts by upper bound (``le``), count and sum."""
        cum = 0
        le: dict[str, int] = {}
        for edge, c in zip(self.buckets, self.counts):
            cum += c
            le[format(edge, ".6g")] = cum
        le["+Inf"] = cum + self.overflow
        return {"le": le, "count": self.count, "sum_s": round(self.sum, 6)}


@dataclass
class Span:
    """A wall-clock span for per-stage accounting."""

    name: str
    start: float = field(default_factory=time.perf_counter)
    elapsed: float = 0.0

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self.start
        return self.elapsed


class CompileCounter:
    """Process-wide count of CUDA graph captures and their host seconds
    (the eager warm run and the capture), recorded by
    ``StepGraphs.capture``. A capture on a serving path is the port's
    latency cliff, as an XLA compile is the JAX package's."""

    _count = 0
    _seconds = 0.0
    # Captures may run on worker threads; count and seconds move together.
    _lock = threading.Lock()

    @classmethod
    def record(cls, seconds: float) -> None:
        with cls._lock:
            cls._count += 1
            cls._seconds += seconds

    @classmethod
    def count(cls) -> int:
        return cls._count

    @classmethod
    def seconds(cls) -> float:
        return cls._seconds


class Metrics:
    def __init__(self, stage_buckets: tuple[float, ...] | None = None) -> None:
        self.counters = Counter()
        self.latency: dict[str, LatencyRecorder] = defaultdict(LatencyRecorder)
        #: Point-in-time values (set, not accumulated): breaker state per
        #: queue, batch fill, the admission credit fraction, ...
        self.gauges: dict[str, float] = {}
        #: Per-stage histograms fed by the flight recorder on every settled
        #: trace: queue → stage → Histogram.
        self.stage_buckets = tuple(stage_buckets or DEFAULT_STAGE_BUCKETS)
        self.stages: dict[str, dict[str, Histogram]] = {}

    def record_latency(self, name: str, seconds: float) -> None:
        self.latency[name].record(seconds)

    def observe_stage(self, queue: str, stage: str, seconds: float) -> None:
        per_q = self.stages.get(queue)
        if per_q is None:
            per_q = self.stages[queue] = {}
        hist = per_q.get(stage)
        if hist is None:
            hist = per_q[stage] = Histogram(self.stage_buckets)
        hist.observe(seconds)

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def report(self) -> dict:
        counters = self.counters.snapshot()
        # The JAX package's names; here, CUDA graph captures and seconds.
        counters["xla_compiles"] = float(CompileCounter.count())
        counters["xla_compile_seconds"] = round(CompileCounter.seconds(), 6)
        return {
            "counters": counters,
            "gauges": dict(self.gauges),
            "latency": {k: v.summary_ms() for k, v in self.latency.items()},
            "stage_seconds": {
                q: {s: h.to_dict() for s, h in per_q.items()}
                for q, per_q in self.stages.items()
            },
        }

    def report_json(self) -> str:
        return json.dumps(self.report(), sort_keys=True)
