"""Continuous telemetry: a bounded ring of snapshots and SLO burn monitors.

The port's copy of ``matchmaking_tpu/utils/timeseries.py``, stdlib only.
``TelemetryRing`` keeps the app's periodic snapshots (``MatchmakingApp``
samples one every ``ObservabilityConfig.snapshot_interval_s``) and answers
delta and rate queries over any monotone counter in them; a counter that
restarts inside the window (a revive or a breaker swap installs a fresh
engine) is clamped to its reset-corrected increase and flagged.

``SloMonitor`` is the multi-window burn-rate monitor over a pair of
cumulative good/total counters in the ring (by default the attribution's
``slo_good[q]`` / ``slo_total[q]``; the quality monitors point it at
``quality_good[q]`` / ``quality_total[q]``):

    burn = (1 - attainment) / (1 - objective)

over a fast and a slow window. A queue burns when both reach
``slo_burn_threshold``; each transition appends ``slo_burn`` or
``slo_burn_clear`` to the event log, and every evaluation sets the
``slo_burning``, ``slo_burn_fast``, ``slo_burn_slow`` and
``slo_attainment`` gauges.

Timestamps are data: the sampler passes ``time.time()`` in, and windows are
``now - span`` over the stored stamps.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Mapping, NamedTuple


class Delta(NamedTuple):
    """A counter delta over a ring window. Indexes [0]/[1] keep the
    ``(value, span_s)`` tuple contract; ``reset`` flags that the counter
    RESTARTED inside the window — an engine revive
    or breaker swap installs a fresh engine whose monotone counters begin
    again at 0, and a naive newest-minus-oldest difference would go
    negative (a negative "rate" fed a burn monitor or the autotuner is a
    corrupt signal, not a datum). When set, ``value`` is the
    reset-corrected increase: positive increments summed across the
    window, with each post-reset sample counted from 0 (the Prometheus
    ``increase()`` convention)."""

    value: float
    span_s: float
    reset: bool = False


class TelemetryRing:
    """Bounded ring of ``(seq, t, values)`` snapshots with delta/rate
    queries. Values are flat ``name -> float`` dicts; per-queue series use
    the same ``name[queue]`` convention as the metrics gauges so the prom
    flattener's label splitting applies unchanged."""

    def __init__(self, capacity: int = 512):
        self._snaps: deque[tuple[int, float, dict[str, float]]] = deque(
            maxlen=max(2, capacity))
        self._seq = 0

    def __len__(self) -> int:
        return len(self._snaps)

    def append(self, t: float, values: Mapping[str, float]) -> int:
        self._seq += 1
        self._snaps.append((self._seq, t, dict(values)))
        return self._seq

    def latest(self) -> dict[str, Any] | None:
        if not self._snaps:
            return None
        seq, t, values = self._snaps[-1]
        return {"seq": seq, "t": t, "values": values}

    def _window(self, span_s: float,
                now: float | None) -> tuple[tuple, tuple] | None:
        """(oldest-in-window, newest) snapshot pair, or None when fewer
        than two snapshots exist. A window longer than the ring falls back
        to the oldest retained snapshot — deltas stay well-defined, just
        over a shorter-than-requested span."""
        if len(self._snaps) < 2:
            return None
        newest = self._snaps[-1]
        t_end = newest[1] if now is None else now
        first = None
        for snap in self._snaps:
            if snap[1] >= t_end - span_s:
                first = snap
                break
        if first is None or first[0] == newest[0]:
            first = self._snaps[-2]
        return first, newest

    def delta(self, name: str, span_s: float,
              now: float | None = None) -> Delta | None:
        """:class:`Delta` of counter ``name`` over the last ``span_s``
        seconds of snapshots; None when the series is absent or fewer than
        two snapshots cover it. Counter restarts inside the window (engine
        revive / breaker swap — counters begin again at 0) are detected by
        walking the window's consecutive pairs: the delta is clamped to
        the reset-corrected increase and flagged ``reset=True`` instead of
        ever going negative."""
        pair = self._window(span_s, now)
        if pair is None:
            return None
        (seq0, t0, v0), (seq1, t1, v1) = pair
        if name not in v0 or name not in v1:
            return None
        span = max(0.0, t1 - t0)
        naive = v1[name] - v0[name]
        # Reset scan over the window's consecutive pairs — an endpoint
        # check alone is not enough (a reset can hide inside a window
        # whose endpoints still increased). The ring is seq-ascending,
        # so the walk skips to the window and stops at its end.
        inc = 0.0
        reset = False
        prev = None
        for seq, _t, vals in self._snaps:
            if seq > seq1:
                break
            if seq < seq0 or name not in vals:
                continue
            v = vals[name]
            if prev is not None:
                if v >= prev:
                    inc += v - prev
                else:
                    # Counter restarted: this sample counts from 0.
                    reset = True
                    inc += v
            prev = v
        if not reset:
            return Delta(naive, span, False)
        return Delta(inc, span, True)

    def rate(self, name: str, span_s: float,
             now: float | None = None) -> float | None:
        d = self.delta(name, span_s, now)
        if d is None or d[1] <= 0:
            return None
        return d[0] / d[1]

    def series(self, name: str, limit: int = 0) -> list[tuple[float, float]]:
        rows = [(t, values[name]) for _, t, values in self._snaps
                if name in values]
        return rows[-limit:] if limit else rows

    def snapshot(self, limit: int = 0,
                 prefixes: tuple[str, ...] = ()) -> list[dict[str, Any]]:
        """JSON-ready tail of the ring; ``prefixes`` PREFIX-filters the
        value keys (``idle_frac`` matches ``idle_frac[q]`` for every queue,
        ``slo`` matches every slo_* series) so a bench artifact can embed a
        trajectory without the full key set."""
        rows = []
        for seq, t, values in self._snaps:
            if prefixes:
                values = {k: v for k, v in values.items()
                          if any(k.startswith(p) for p in prefixes)}
            rows.append({"seq": seq, "t": round(t, 3), "values": values})
        return rows[-limit:] if limit else rows


class SloMonitor:
    """Per-queue multi-window burn-rate monitor over a pair of cumulative
    good/total counters in the telemetry ring. Default series are the
    latency-SLO ``slo_good[q]``/``slo_total[q]``; ``good_key``/``total_key``
    point a monitor at any other counter pair — the quality-SLO monitors
    difference ``quality_good[q]``/``quality_total[q]`` with
    ``kind="quality"`` and are otherwise identical (same burn math, same
    events, same /healthz surfacing)."""

    def __init__(self, queue: str, target_ms: float, objective: float,
                 fast_window_s: float, slow_window_s: float,
                 burn_threshold: float = 1.0, events=None, metrics=None,
                 good_key: str | None = None, total_key: str | None = None,
                 kind: str = "latency"):
        self.queue = queue
        self.target_ms = target_ms
        self.kind = kind
        self._good_key = good_key or f"slo_good[{queue}]"
        self._total_key = total_key or f"slo_total[{queue}]"
        # Clamp away objective=1.0: a zero error budget makes burn infinite
        # on the first miss, which is an alerting footgun, not a policy.
        self.objective = min(0.9999, max(0.0, objective))
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.burn_threshold = burn_threshold
        self._events = events
        self._metrics = metrics
        self.burning = False
        self.burn_fast: float | None = None
        self.burn_slow: float | None = None
        self.attainment_fast: float | None = None
        self.attainment_slow: float | None = None

    def _attainment(self, ring: TelemetryRing, span_s: float,
                    now: float) -> float | None:
        good = ring.delta(self._good_key, span_s, now)
        total = ring.delta(self._total_key, span_s, now)
        if good is None or total is None or total[0] <= 0:
            return None  # no traffic settled in the window
        return max(0.0, min(1.0, good[0] / total[0]))

    def evaluate(self, ring: TelemetryRing, now: float) -> dict[str, Any]:
        """One evaluation tick (the app calls this right after each
        telemetry snapshot lands). Windows with no settled traffic read as
        not-burning: an idle queue is not missing its SLO."""
        budget = 1.0 - self.objective
        self.attainment_fast = self._attainment(ring, self.fast_window_s, now)
        self.attainment_slow = self._attainment(ring, self.slow_window_s, now)
        self.burn_fast = (None if self.attainment_fast is None
                          else (1.0 - self.attainment_fast) / budget)
        self.burn_slow = (None if self.attainment_slow is None
                          else (1.0 - self.attainment_slow) / budget)
        burning = (self.burn_fast is not None and self.burn_slow is not None
                   and self.burn_fast >= self.burn_threshold
                   and self.burn_slow >= self.burn_threshold)
        if burning != self.burning:
            self.burning = burning
            if self._events is not None:
                if burning:
                    target = (f"{self.target_ms:.0f} ms"
                              if self.kind == "latency"
                              else f"quality {self.target_ms:g}")
                    self._events.append(
                        "slo_burn", self.queue,
                        f"burn fast={self.burn_fast:.2f} "
                        f"slow={self.burn_slow:.2f} "
                        f"(threshold {self.burn_threshold:.2f}, target "
                        f"{target}, objective "
                        f"{self.objective:.4f})",
                        component="slo",
                        refs={"slo_kind": self.kind,
                              "burn_fast": round(self.burn_fast, 4),
                              "burn_slow": round(self.burn_slow, 4)})
                else:
                    self._events.append("slo_burn_clear", self.queue,
                                        "error budget burn back under "
                                        "threshold on both windows",
                                        component="slo",
                                        refs={"slo_kind": self.kind})
        if self._metrics is not None:
            q = self.queue
            self._metrics.set_gauge(f"slo_burning[{q}]",
                                    1.0 if self.burning else 0.0)
            if self.burn_fast is not None:
                self._metrics.set_gauge(f"slo_burn_fast[{q}]",
                                        round(self.burn_fast, 4))
            if self.burn_slow is not None:
                self._metrics.set_gauge(f"slo_burn_slow[{q}]",
                                        round(self.burn_slow, 4))
            if self.attainment_slow is not None:
                self._metrics.set_gauge(f"slo_attainment[{q}]",
                                        round(self.attainment_slow, 4))
        return self.snapshot()

    def snapshot(self) -> dict[str, Any]:
        rnd = lambda v: None if v is None else round(v, 4)  # noqa: E731
        return {
            "kind": self.kind,
            "target_ms": self.target_ms,
            "objective": self.objective,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.burn_threshold,
            "attainment_fast": rnd(self.attainment_fast),
            "attainment_slow": rnd(self.attainment_slow),
            "burn_fast": rnd(self.burn_fast),
            "burn_slow": rnd(self.burn_slow),
            "burning": self.burning,
        }
