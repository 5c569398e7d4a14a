"""Match-quality and fairness accounting: the bucket schemes and the host
accumulator.

The port's copy of ``matchmaking_tpu/engine/quality.py``. Every match
carries a quality in [0, 1] (``scoring.quality``) and each matched player a
wait-at-match (the window's dispatch time minus the player's enqueue
time); this module folds them into histograms and sums per rating bucket.

Three consumers share these definitions:

- ``GpuEngine`` accumulates on the device for 1v1 queues
  (``kernels.QualityAccumKernel``: the hand-written ``quality_accum``
  kernel on the card) and with :class:`HostQualityAccum` at the team and
  role finalize;
- ``CpuEngine``, the host oracle, accumulates with
  :class:`HostQualityAccum`;
- the service ledger (service/quality.py) buckets quality and wait with
  the same edges, per QoS tier.

Everything is conditioned on the RATING BUCKET of the matched player (the
fairness axis: do low-rated players get worse or slower matches?); the
per-tier split lives in the service ledger.

Bucket rules (the device kernel gives the same buckets on equal f32
inputs):

- rating bucket  = ``searchsorted(rating_edges, rating, side="right")``;
- quality bucket = ``clip(floor(quality * n_quality), 0, n_quality - 1)``;
- wait bucket    = ``searchsorted(wait_edges, wait_s, side="right")``, with
  one extra overflow bucket (Prometheus ``+Inf``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

#: Default rating-bucket edges (8 buckets over an N(1500, 300)-ish rating
#: distribution; roughly equal mass in the middle, open tails).
DEFAULT_RATING_EDGES: tuple[float, ...] = (
    1150.0, 1300.0, 1425.0, 1550.0, 1675.0, 1800.0, 1950.0)

#: Linear quality buckets over [0, 1] (upper edge k/N).
DEFAULT_QUALITY_BUCKETS = 20

#: Log-spaced wait-at-match bucket upper bounds (seconds): 1 ms · 2^k,
#: topping out ~35 min — wide enough for widening-driven long waits without
#: saturating; factor 2 bounds the percentile error at one octave.
DEFAULT_WAIT_BUCKETS: tuple[float, ...] = tuple(
    1e-3 * 2.0 ** k for k in range(22))


@dataclass(frozen=True)
class QualitySpec:
    """The bucket scheme one deployment uses everywhere (the engine's
    device state, the host accumulators, the service ledger)."""

    rating_edges: tuple[float, ...] = DEFAULT_RATING_EDGES
    n_quality: int = DEFAULT_QUALITY_BUCKETS
    wait_edges: tuple[float, ...] = DEFAULT_WAIT_BUCKETS

    @property
    def n_rating(self) -> int:
        return len(self.rating_edges) + 1

    @property
    def n_wait(self) -> int:
        return len(self.wait_edges) + 1  # + overflow

    def rating_bucket(self, rating: np.ndarray) -> np.ndarray:
        return np.searchsorted(
            np.asarray(self.rating_edges, np.float32),
            np.asarray(rating, np.float32), side="right").astype(np.int64)

    def quality_bucket(self, quality: np.ndarray) -> np.ndarray:
        q = np.asarray(quality, np.float32)
        return np.clip((q * self.n_quality).astype(np.int64), 0,
                       self.n_quality - 1)

    def wait_bucket(self, wait_s: np.ndarray) -> np.ndarray:
        return np.searchsorted(
            np.asarray(self.wait_edges, np.float64),
            np.asarray(wait_s, np.float64), side="right").astype(np.int64)

    def bucket_label(self, i: int) -> str:
        """Human/prom label for rating bucket ``i``: "lo-hi" with open
        tails ("-1150", "1950+")."""
        edges = self.rating_edges
        if i <= 0:
            return f"-{edges[0]:g}"
        if i >= len(edges):
            return f"{edges[-1]:g}+"
        return f"{edges[i - 1]:g}-{edges[i]:g}"

    @staticmethod
    def from_config(obs) -> "QualitySpec":
        """Build from an ObservabilityConfig (empty tuples → defaults)."""
        return QualitySpec(
            rating_edges=tuple(obs.quality_rating_edges)
            or DEFAULT_RATING_EDGES,
            n_quality=max(2, obs.quality_buckets),
            wait_edges=tuple(obs.quality_wait_buckets)
            or DEFAULT_WAIT_BUCKETS,
        )


def empty_arrays(spec: QualitySpec) -> dict[str, np.ndarray]:
    """Zeroed accumulator arrays — the one state layout the device kernel,
    the host accumulator, and the merge/report paths all share:

    - ``q_hist``  i64[R, NQ]      per-rating-bucket quality histogram
    - ``w_hist``  i64[R, NW + 1]  per-rating-bucket wait histogram (+Inf)
    - ``count``   i64[R]          matched-player samples per rating bucket
    - ``q_sum``   f64[R]          sum of quality per bucket
    - ``w_sum``   f64[R]          sum of wait seconds per bucket
    - ``d_sum``   f64[R]          sum of rating spread (1v1: pair distance)
    """
    r = spec.n_rating
    return {
        "q_hist": np.zeros((r, spec.n_quality), np.int64),
        "w_hist": np.zeros((r, spec.n_wait), np.int64),
        "count": np.zeros(r, np.int64),
        "q_sum": np.zeros(r, np.float64),
        "w_sum": np.zeros(r, np.float64),
        "d_sum": np.zeros(r, np.float64),
    }


def add_arrays(into: dict[str, np.ndarray],
               other: Mapping[str, Any] | None) -> dict[str, np.ndarray]:
    """``into += other`` (elementwise, dtype-preserving); tolerates None
    and missing keys so device snapshots / delegate accums merge freely."""
    if other is None:
        return into
    for k, v in into.items():
        o = other.get(k) if hasattr(other, "get") else None
        if o is not None:
            v += np.asarray(o).astype(v.dtype)
    return into


class HostQualityAccum:
    """The host-side equivalent of the device accumulation kernel:
    vectorized numpy scatter-adds into the shared array layout. One writer
    (the engine's caller); readers see monotone counters."""

    __slots__ = ("spec", "arrays")

    def __init__(self, spec: QualitySpec):
        self.spec = spec
        self.arrays = empty_arrays(spec)

    def observe(self, rating, quality, wait_s, spread) -> None:
        """Record matched-player samples (one per matched PLAYER — a 1v1
        match contributes two, with the pair's shared quality/spread and
        each side's own wait). All args broadcastable 1-d arrays."""
        rating = np.atleast_1d(np.asarray(rating, np.float32))
        n = rating.shape[0]
        if n == 0:
            return
        quality = np.broadcast_to(
            np.atleast_1d(np.asarray(quality, np.float32)), (n,))
        wait_s = np.broadcast_to(
            np.atleast_1d(np.asarray(wait_s, np.float64)), (n,))
        wait_s = np.maximum(wait_s, 0.0)
        spread = np.broadcast_to(
            np.atleast_1d(np.asarray(spread, np.float64)), (n,))
        spec = self.spec
        rb = spec.rating_bucket(rating)
        a = self.arrays
        np.add.at(a["q_hist"], (rb, spec.quality_bucket(quality)), 1)
        np.add.at(a["w_hist"], (rb, spec.wait_bucket(wait_s)), 1)
        np.add.at(a["count"], rb, 1)
        np.add.at(a["q_sum"], rb, quality.astype(np.float64))
        np.add.at(a["w_sum"], rb, wait_s)
        np.add.at(a["d_sum"], rb, spread)


def _hist_percentile(counts: np.ndarray, edges: tuple[float, ...],
                     p: float) -> float | None:
    """Upper-edge percentile over a bucket-count row whose last column is
    the overflow (+Inf) bucket — same nearest-rank rule as
    the JAX package's metrics histograms."""
    total = int(counts.sum())
    if total == 0:
        return None
    rank = max(1, math.ceil(p / 100.0 * total))
    cum = 0
    for i, c in enumerate(counts.tolist()):
        cum += int(c)
        if cum >= rank:
            return float(edges[i]) if i < len(edges) else float(edges[-1])
    return float(edges[-1])


def quality_percentile(arrays: Mapping[str, np.ndarray], spec: QualitySpec,
                       p: float) -> float | None:
    """Upper-edge percentile of the AGGREGATE quality histogram (linear
    buckets: edge of bucket k is (k+1)/NQ)."""
    counts = np.asarray(arrays["q_hist"]).sum(axis=0)
    edges = tuple((k + 1) / spec.n_quality for k in range(spec.n_quality))
    return _hist_percentile(counts, edges, p)


def wait_percentile(arrays: Mapping[str, np.ndarray], spec: QualitySpec,
                    p: float, bucket: int | None = None) -> float | None:
    """Upper-edge wait percentile (seconds) — aggregate, or one rating
    bucket's row."""
    w = np.asarray(arrays["w_hist"])
    counts = w[bucket] if bucket is not None else w.sum(axis=0)
    return _hist_percentile(counts, spec.wait_edges, p)


def disparity(arrays: Mapping[str, np.ndarray], spec: QualitySpec,
              min_count: int = 8) -> dict[str, Any]:
    """Explicit fairness gaps across rating buckets.

    - ``quality_gap``: max |bucket mean quality − global mean quality| over
      buckets with ≥ ``min_count`` samples (0.0 when nothing qualifies);
    - ``wait_p90_gap_s``: max |bucket p90 wait − global p90 wait| (bucket
      upper edges, so the gap resolves at histogram granularity).

    Both quote WHICH bucket is worst — a disparity number without the
    cohort it indicts is not actionable.
    """
    count = np.asarray(arrays["count"], np.float64)
    total = float(count.sum())
    out: dict[str, Any] = {
        "min_count": min_count,
        "quality_gap": 0.0, "quality_gap_bucket": None,
        "wait_p90_gap_s": 0.0, "wait_gap_bucket": None,
    }
    if total <= 0:
        return out
    q_sum = np.asarray(arrays["q_sum"], np.float64)
    global_q = float(q_sum.sum() / total)
    global_w90 = wait_percentile(arrays, spec, 90.0)
    for b in range(spec.n_rating):
        if count[b] < min_count:
            continue
        gap = abs(float(q_sum[b] / count[b]) - global_q)
        if gap > out["quality_gap"]:
            out["quality_gap"] = round(gap, 6)
            out["quality_gap_bucket"] = spec.bucket_label(b)
        w90 = wait_percentile(arrays, spec, 90.0, bucket=b)
        if w90 is not None and global_w90 is not None:
            wgap = abs(w90 - global_w90)
            if wgap > out["wait_p90_gap_s"]:
                out["wait_p90_gap_s"] = round(wgap, 6)
                out["wait_gap_bucket"] = spec.bucket_label(b)
    return out


def build_report(arrays: Mapping[str, np.ndarray], spec: QualitySpec,
                 min_count: int = 8) -> dict[str, Any]:
    """JSON-ready per-queue quality report from one merged array set:
    aggregate means/percentiles, per-rating-bucket conditional means, and
    the disparity block. Pure function of monotone counters — two reports
    delta cleanly."""
    count = np.asarray(arrays["count"], np.float64)
    total = float(count.sum())
    rep: dict[str, Any] = {
        "samples": int(total),
        "rating_edges": list(spec.rating_edges),
        "quality_mean": (round(float(np.asarray(arrays["q_sum"]).sum())
                               / total, 6) if total else None),
        "wait_mean_s": (round(float(np.asarray(arrays["w_sum"]).sum())
                              / total, 6) if total else None),
        "spread_mean": (round(float(np.asarray(arrays["d_sum"]).sum())
                              / total, 6) if total else None),
        "quality_p10": quality_percentile(arrays, spec, 10.0),
        "quality_p50": quality_percentile(arrays, spec, 50.0),
        "wait_p50_s": wait_percentile(arrays, spec, 50.0),
        "wait_p90_s": wait_percentile(arrays, spec, 90.0),
        "wait_p99_s": wait_percentile(arrays, spec, 99.0),
    }
    buckets = []
    w_hist = np.asarray(arrays["w_hist"])
    for b in range(spec.n_rating):
        c = float(count[b])
        # Cumulative prom-style ``le`` counts for the bucket's wait row —
        # what the matchmaking_wait_at_match_seconds{queue,bucket}
        # histogram family exports verbatim.
        cum = 0
        wait_le: dict[str, int] = {}
        for i, edge in enumerate(spec.wait_edges):
            cum += int(w_hist[b, i])
            wait_le[format(edge, ".6g")] = cum
        wait_le["+Inf"] = cum + int(w_hist[b, -1])
        buckets.append({
            "bucket": spec.bucket_label(b),
            "count": int(c),
            "quality_mean": (round(float(arrays["q_sum"][b]) / c, 6)
                             if c else None),
            "wait_mean_s": (round(float(arrays["w_sum"][b]) / c, 6)
                            if c else None),
            "wait_sum_s": round(float(arrays["w_sum"][b]), 6),
            "wait_p90_s": wait_percentile(arrays, spec, 90.0, bucket=b),
            "wait_le": wait_le,
        })
    rep["buckets"] = buckets
    rep["disparity"] = disparity(arrays, spec, min_count=min_count)
    return rep
