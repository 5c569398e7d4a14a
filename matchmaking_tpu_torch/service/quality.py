"""The service's match-quality ledger: per-queue, per-tier accounting of
matched players, fed when their answers are published.

The port's copy of ``matchmaking_tpu/service/quality.py``. The engine's
accumulators answer the fairness question per rating bucket (the rating
lives in the pool); this ledger answers the QoS question per priority
tier, which only the publish path knows: it holds each matched player's
quality, wait and tier (``ColumnarOutcome`` ``m_quality`` / ``m_wait_*`` /
``m_tier_*``, or the object path's match and requests), so one vectorized
``observe`` per window costs the engine nothing.

With ``ObservabilityConfig.quality_slo_target`` set, the ledger also counts
per queue the matched players whose quality met the target (``good``) out
of all (``total``): ``slo_counts``.

``observe`` runs on the service's event loop only; there is no lock.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from matchmaking_tpu_torch.engine.quality import QualitySpec, _hist_percentile


class _TierQuality:
    __slots__ = ("q_hist", "w_hist", "count", "q_sum", "w_sum")

    def __init__(self, spec: QualitySpec):
        self.q_hist = np.zeros(spec.n_quality, np.int64)
        self.w_hist = np.zeros(spec.n_wait, np.int64)
        self.count = 0
        self.q_sum = 0.0
        self.w_sum = 0.0


class _QueueQuality:
    __slots__ = ("tiers", "good", "total")

    def __init__(self) -> None:
        self.tiers: dict[int, _TierQuality] = {}
        self.good = 0   # matched players with quality >= target
        self.total = 0  # matched players


class QualityLedger:
    """Per-queue/per-tier quality + wait-at-match histograms over matched
    players, plus the quality-SLO good/total counters. All counters are
    monotone — the telemetry ring and prom scrapes delta cleanly."""

    def __init__(self, spec: QualitySpec, quality_target: float = 0.0):
        self.spec = spec
        self.quality_target = quality_target
        self._queues: dict[str, _QueueQuality] = {}

    def _queue(self, q: str) -> _QueueQuality:
        qq = self._queues.get(q)
        if qq is None:
            qq = self._queues[q] = _QueueQuality()
        return qq

    def observe(self, queue: str, quality, wait_s, tiers=None) -> None:
        """Record matched-player samples (vectorized: one call per window).
        ``tiers`` None → all tier 0."""
        quality = np.atleast_1d(np.asarray(quality, np.float32))
        n = quality.shape[0]
        if n == 0:
            return
        wait_s = np.maximum(np.broadcast_to(
            np.atleast_1d(np.asarray(wait_s, np.float64)), (n,)), 0.0)
        tier_arr = (np.zeros(n, np.int64) if tiers is None
                    else np.broadcast_to(
                        np.atleast_1d(np.asarray(tiers, np.int64)), (n,)))
        spec = self.spec
        qb = spec.quality_bucket(quality)
        wb = spec.wait_bucket(wait_s)
        qq = self._queue(queue)
        qq.total += n
        if self.quality_target > 0:
            qq.good += int((quality >= self.quality_target).sum())
        for t in np.unique(tier_arr).tolist():
            sel = tier_arr == t
            tq = qq.tiers.get(t)
            if tq is None:
                tq = qq.tiers[t] = _TierQuality(spec)
            np.add.at(tq.q_hist, qb[sel], 1)
            np.add.at(tq.w_hist, wb[sel], 1)
            tq.count += int(sel.sum())
            tq.q_sum += float(quality[sel].sum())
            tq.w_sum += float(wait_s[sel].sum())

    # ---- reads -------------------------------------------------------------

    def slo_counts(self, queue: str) -> tuple[int, int]:
        """(good, total) cumulative matched-player counters."""
        qq = self._queues.get(queue)
        return (qq.good, qq.total) if qq is not None else (0, 0)

    def queues(self) -> list[str]:
        return sorted(self._queues)

    def _tier_dict(self, tq: _TierQuality) -> dict[str, Any]:
        spec = self.spec
        q_edges = tuple((k + 1) / spec.n_quality
                        for k in range(spec.n_quality))
        return {
            "count": tq.count,
            # Exact monotone sums (not mean × count, whose rounding jitter
            # would read as a counter reset).
            "quality_sum": round(tq.q_sum, 9),
            "wait_sum_s": round(tq.w_sum, 9),
            "quality_mean": (round(tq.q_sum / tq.count, 6)
                             if tq.count else None),
            "wait_mean_s": (round(tq.w_sum / tq.count, 6)
                            if tq.count else None),
            "quality_p10": _hist_percentile(tq.q_hist, q_edges, 10.0),
            "quality_p50": _hist_percentile(tq.q_hist, q_edges, 50.0),
            "wait_p99_s": _hist_percentile(tq.w_hist, spec.wait_edges, 99.0),
            "quality_hist": tq.q_hist.tolist(),
            "wait_hist": tq.w_hist.tolist(),
        }

    def snapshot(self, queue: str | None = None) -> dict[str, Any]:
        """JSON-ready per-queue/per-tier view."""
        names = [queue] if queue is not None else self.queues()
        out: dict[str, Any] = {}
        for q in names:
            qq = self._queues.get(q)
            if qq is None:
                continue
            entry: dict[str, Any] = {
                "matched_players": qq.total,
                "tiers": {str(t): self._tier_dict(tq)
                          for t, tq in sorted(qq.tiers.items())},
            }
            if self.quality_target > 0:
                entry["quality_slo"] = {
                    "target": self.quality_target,
                    "good": qq.good,
                    "total": qq.total,
                    "attainment": (round(qq.good / qq.total, 4)
                                   if qq.total else None),
                }
            out[q] = entry
        return {
            "quality_buckets": self.spec.n_quality,
            "wait_edges_s": list(self.spec.wait_edges),
            "queues": out,
        }
