"""Population-model load scenarios: the load spec the load generator
(``service/loadgen.py``) and the tests share. The port's copy of the JAX
package's ``scenario.py``, drawing the same numpy streams in the same
order, so a build is bit-equal to the JAX package's.

- **Segments**: a piecewise arrival-rate curve (steady, ramp, diurnal,
  flash), concatenated in time. Arrival times are seeded unit-rate
  exponential increments mapped through the inverse cumulative rate
  (tabulated on a fixed grid), so the curve's shape is exact and the draw
  a pure function of ``(seed, scenario)``.
- **Cohorts**: a rating mixture. Each arrival draws a cohort, which
  decides its rating distribution (optionally *paired*: consecutive
  near-equal ratings), its QoS tier, its deadline budget and whether it
  retries once after a shed.
- **Incidents**: scripted faults in the ``ChaosConfig`` vocabulary
  (publish seqs for broker faults, device step indices for engine
  faults), so they replay exactly.

``build_arrivals(seed)`` is a pure function of ``(seed, scenario,
rate_scale, time_scale)``; a trivial scenario (one steady segment, one
paired cohort, no QoS, no incidents) draws in the legacy ``offered_load``
order, so ``steady`` reduces to the flat Poisson load byte for byte.
Named scenarios are the repository's ``configs/scenarios/*.json``;
``load_scenario`` resolves a name or a path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

from matchmaking_tpu_torch.config import ChaosConfig

#: Fixed Λ-tabulation resolution (points per scenario): part of the
#: determinism contract — changing it changes every non-trivial transcript.
_GRID_POINTS = 4096


@dataclass(frozen=True)
class Cohort:
    """One population slice: weight in the mixture, rating distribution,
    QoS class, deadline budget, and client retry behavior."""

    name: str = "default"
    #: Mixture weight (normalized across the scenario's cohorts).
    weight: float = 1.0
    rating_mean: float = 1500.0
    rating_sigma: float = 300.0
    #: Consecutive same-cohort arrivals share a rating in pairs — the
    #: legacy loadgen's default shape (arrivals pair off almost instantly,
    #: so the measured cost is ingress, not pool search).
    paired: bool = False
    #: QoS tier stamped as ``x-tier`` (0 = most latency-critical). Only
    #: stamped when any cohort in the scenario uses a nonzero tier.
    tier: int = 0
    #: Per-request deadline budget (ms) stamped as ``x-deadline`` at
    #: publish; 0 = none (the loadgen's global ``--deadline-ms`` still
    #: applies as a fallback).
    deadline_ms: float = 0.0
    #: Probability this cohort's member retries ONCE after a shed response
    #: (the retry-storm ingredient). The retry decision is drawn per
    #: arrival up front — pure function of the seed.
    retry_on_shed: float = 0.0
    #: Client-side backoff before the retry publish.
    retry_delay_s: float = 0.25


@dataclass(frozen=True)
class Segment:
    """One piece of the arrival-rate curve. ``rate_at(t)`` is evaluated at
    ``t`` seconds into the segment (before time scaling)."""

    kind: str = "steady"          # steady | ramp | diurnal | flash
    duration_s: float = 4.0
    #: Offered req/s at segment start (steady: the whole segment).
    rate: float = 200.0
    #: ramp: linear rate → rate_end over the segment.
    rate_end: float = 0.0
    #: diurnal: rate · (1 + amplitude · sin(2π·(t/period_s + phase))).
    amplitude: float = 0.0
    period_s: float = 0.0
    phase: float = 0.0
    #: flash: rate × peak_x inside [peak_start_s, peak_start_s+peak_len_s).
    peak_x: float = 1.0
    peak_start_s: float = 0.0
    peak_len_s: float = 0.0

    def rate_at(self, t: float) -> float:
        if self.kind == "ramp":
            frac = min(1.0, max(0.0, t / self.duration_s))
            return self.rate + (self.rate_end - self.rate) * frac
        if self.kind == "diurnal":
            period = self.period_s or self.duration_s
            return max(0.0, self.rate * (
                1.0 + self.amplitude
                * math.sin(2.0 * math.pi * (t / period + self.phase))))
        if self.kind == "flash":
            if self.peak_start_s <= t < self.peak_start_s + self.peak_len_s:
                return self.rate * self.peak_x
            return self.rate
        return self.rate  # steady


@dataclass(frozen=True)
class Incident:
    """A scripted fault window, expressed in the ChaosConfig vocabulary
    (publish seqs for broker faults, device step indices for engine
    faults) so injection replays bit-identically."""

    kind: str                     # drop | dup_storm | partition | engine_fault | probe_fail
    #: First publish seq / device step affected.
    at: int = 0
    #: Seqs/steps affected from ``at`` (drop, dup_storm, engine_fault) or
    #: failed probes (probe_fail).
    count: int = 1
    #: dup_storm: extra delivery copies per affected seq.
    copies: int = 1
    #: partition: consumers pause at seq ``at`` and resume at seq ``until``.
    until: int = 0


@dataclass(frozen=True)
class Scenario:
    """The full load model: curve + population + incidents."""

    name: str = "steady"
    segments: tuple[Segment, ...] = (Segment(),)
    cohorts: tuple[Cohort, ...] = (Cohort(paired=True),)
    incidents: tuple[Incident, ...] = ()
    description: str = ""

    def __post_init__(self):
        """Spec validation at construction time — a malformed spec must
        fail HERE with a speakable error, not deep inside build_arrivals
        as a numpy ValueError the matrix then misfiles as a cell crash."""
        if not self.segments:
            raise ValueError(f"scenario {self.name!r}: needs >= 1 segment")
        if not self.cohorts:
            raise ValueError(f"scenario {self.name!r}: needs >= 1 cohort")
        for seg in self.segments:
            if seg.duration_s <= 0:
                raise ValueError(f"scenario {self.name!r}: segment "
                                 f"duration_s must be > 0")
            if seg.kind not in ("steady", "ramp", "diurnal", "flash"):
                raise ValueError(f"scenario {self.name!r}: unknown segment "
                                 f"kind {seg.kind!r}")
        if sum(c.weight for c in self.cohorts) <= 0:
            raise ValueError(f"scenario {self.name!r}: cohort weights "
                             f"have no mass")

    # ---- curve -------------------------------------------------------------

    @property
    def duration_s(self) -> float:
        return sum(s.duration_s for s in self.segments)

    def rate_at(self, t: float) -> float:
        """Offered rate at ``t`` seconds into the scenario (unscaled)."""
        for seg in self.segments:
            if t < seg.duration_s:
                return seg.rate_at(t)
            t -= seg.duration_s
        return self.segments[-1].rate_at(self.segments[-1].duration_s)

    @property
    def tiered(self) -> bool:
        return any(c.tier > 0 for c in self.cohorts)

    @property
    def max_tier(self) -> int:
        return max(c.tier for c in self.cohorts)

    def is_trivial(self) -> bool:
        """One steady segment, one paired no-QoS no-retry cohort, no
        incidents — the legacy ``offered_load()`` model exactly. The
        trivial build path consumes the RNG in the legacy order, which is
        what makes ``scenario="steady"`` reduce byte for byte."""
        if len(self.segments) != 1 or self.segments[0].kind != "steady":
            return False
        if len(self.cohorts) != 1 or self.incidents:
            return False
        c = self.cohorts[0]
        return (c.paired and c.tier == 0 and c.deadline_ms == 0.0
                and c.retry_on_shed == 0.0)

    # ---- arrivals ----------------------------------------------------------

    def build_arrivals(self, seed: int, *, rate_scale: float = 1.0,
                       time_scale: float = 1.0) -> "Arrivals":
        """The seeded arrival transcript: pure function of
        ``(seed, self, rate_scale, time_scale)``. ``time_scale`` compresses
        the curve (a 60 s diurnal replayed in 15 s keeps its shape);
        ``rate_scale`` scales every segment's rate."""
        if self.is_trivial():
            return self._build_trivial(seed, rate_scale, time_scale)
        rng = np.random.default_rng(seed)
        duration = self.duration_s * time_scale
        # Λ tabulated on a fixed grid over UNSCALED scenario time, then the
        # axis is stretched — the curve shape is scale-invariant.
        tg = np.linspace(0.0, self.duration_s, _GRID_POINTS)
        lam = np.fromiter((self.rate_at(t) for t in tg), np.float64,
                          _GRID_POINTS) * rate_scale / max(1e-12, time_scale)
        # Cumulative trapezoid in SCALED time.
        dt = np.diff(tg) * time_scale
        big_l = np.concatenate(
            ([0.0], np.cumsum(0.5 * (lam[1:] + lam[:-1]) * dt)))
        total = float(big_l[-1])
        n_max = int(total * 2) + 16
        # RNG order (the determinism contract): 1. unit exponentials,
        # 2. cohort draw, 3. standard-normal rating draws, 4. retry draw.
        exp = np.cumsum(rng.exponential(1.0, size=n_max))
        t_arr = np.interp(exp, big_l, tg * time_scale,
                          right=np.inf)
        keep = t_arr < duration
        weights = np.fromiter((c.weight for c in self.cohorts), np.float64,
                              len(self.cohorts))
        weights = weights / weights.sum()
        cohort = rng.choice(len(self.cohorts), size=n_max, p=weights)
        z = rng.normal(0.0, 1.0, size=n_max)
        u_retry = rng.random(n_max)
        t_arr, cohort, z, u_retry = (t_arr[keep], cohort[keep], z[keep],
                                     u_retry[keep])
        n = t_arr.size
        rating = np.empty(n, np.float64)
        tier = np.zeros(n, np.int64)
        deadline_s = np.zeros(n, np.float64)
        retry = np.zeros(n, bool)
        retry_delay = np.zeros(n, np.float64)
        for j, c in enumerate(self.cohorts):
            idx = np.flatnonzero(cohort == j)
            zj = z[idx]
            if c.paired and zj.size > 1:
                # Consecutive same-cohort arrivals pair off: the 2nd of
                # each pair repeats the 1st's draw.
                zj = zj.copy()
                zj[1::2] = zj[0:zj.size - (zj.size % 2):2]
            rating[idx] = c.rating_mean + c.rating_sigma * zj
            tier[idx] = c.tier
            deadline_s[idx] = c.deadline_ms / 1e3
            retry[idx] = u_retry[idx] < c.retry_on_shed
            retry_delay[idx] = c.retry_delay_s
        return Arrivals(scenario=self, seed=seed, duration_s=duration,
                        rate_scale=rate_scale, time_scale=time_scale,
                        t=t_arr, rating=rating, cohort=cohort, tier=tier,
                        deadline_s=deadline_s, retry=retry,
                        retry_delay_s=retry_delay)

    def _build_trivial(self, seed: int, rate_scale: float,
                       time_scale: float) -> "Arrivals":
        """Legacy-order build: ratings (paired repeat) first, then gaps —
        exactly ``offered_load()``'s draws, so the steady scenario's
        transcript is the legacy transcript bit for bit."""
        c = self.cohorts[0]
        rate = self.segments[0].rate * rate_scale
        duration = self.segments[0].duration_s * time_scale
        rng = np.random.default_rng(seed)
        n_max = int(rate * duration * 2) + 16
        rating = np.repeat(
            rng.normal(c.rating_mean, c.rating_sigma, size=n_max // 2 + 1),
            2)[:n_max]
        t_arr = np.cumsum(rng.exponential(1.0 / rate, size=n_max))
        keep = t_arr <= duration
        n = int(keep.sum())
        return Arrivals(scenario=self, seed=seed, duration_s=duration,
                        rate_scale=rate_scale, time_scale=time_scale,
                        t=t_arr[:n], rating=rating[:n],
                        cohort=np.zeros(n, np.int64),
                        tier=np.zeros(n, np.int64),
                        deadline_s=np.zeros(n, np.float64),
                        retry=np.zeros(n, bool),
                        retry_delay_s=np.zeros(n, np.float64))

    # ---- incidents → chaos -------------------------------------------------

    def chaos_config(self, queue: str, seed: int = 0) -> ChaosConfig | None:
        """The scenario's incident script as a ChaosConfig for ``queue``
        (None when the scenario has no incidents). Scripted seq/step
        windows only — the replay-exact chaos machinery carries it from
        there."""
        if not self.incidents:
            return None
        drop: list[int] = []
        dup: list[tuple[int, int]] = []
        parts: list[tuple[int, int]] = []
        steps: list[tuple[int, int]] = []
        probes = 0
        for inc in self.incidents:
            if inc.kind == "drop":
                drop.extend(range(inc.at, inc.at + inc.count))
            elif inc.kind == "dup_storm":
                dup.extend((s, inc.copies)
                           for s in range(inc.at, inc.at + inc.count))
            elif inc.kind == "partition":
                parts.append((inc.at, inc.until or (inc.at + inc.count)))
            elif inc.kind == "engine_fault":
                steps.append((inc.at, inc.at + inc.count))
            elif inc.kind == "probe_fail":
                probes = max(probes, inc.count)
            else:
                raise ValueError(f"unknown incident kind {inc.kind!r}")
        return ChaosConfig(seed=seed, queues=(queue,),
                           drop_seqs=tuple(drop), dup_seqs=tuple(dup),
                           partitions=tuple(parts),
                           fail_step_ranges=tuple(steps),
                           fail_probes=probes)

    # ---- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Scenario":
        def build(cls, row):
            known = {f.name for f in dataclasses.fields(cls)}
            extra = [k for k in row if k not in known]
            if extra:
                raise ValueError(
                    f"unknown {cls.__name__} key(s) {extra} in scenario "
                    f"{d.get('name', '?')!r}")
            return cls(**row)

        kw: dict[str, Any] = {}
        for scalar in ("name", "description"):
            if scalar in d:
                kw[scalar] = d[scalar]
        if "segments" in d:
            kw["segments"] = tuple(build(Segment, s) for s in d["segments"])
        if "cohorts" in d:
            kw["cohorts"] = tuple(build(Cohort, c) for c in d["cohorts"])
        if "incidents" in d:
            kw["incidents"] = tuple(build(Incident, i)
                                    for i in d["incidents"])
        return Scenario(**kw)


@dataclass
class Arrivals:
    """The materialized arrival transcript: parallel arrays, one row per
    arrival, plus the build inputs (for provenance in artifacts)."""

    scenario: Scenario
    seed: int
    duration_s: float
    rate_scale: float
    time_scale: float
    t: np.ndarray            # arrival offset (s, ascending)
    rating: np.ndarray       # float64
    cohort: np.ndarray       # cohort index per arrival
    tier: np.ndarray         # int
    deadline_s: np.ndarray   # per-arrival deadline budget (0 = none)
    retry: np.ndarray        # bool: retries once on shed
    retry_delay_s: np.ndarray

    def __len__(self) -> int:
        return int(self.t.size)

    @property
    def stamp_tiers(self) -> bool:
        return bool(self.tier.size and self.tier.max() > 0)

    def transcript(self) -> dict[str, Any]:
        """JSON-able replay transcript: every deterministic per-arrival
        fact plus the incident script. Two builds with the same inputs
        produce equal transcripts — the determinism pin."""
        chaos = self.scenario.chaos_config("q", seed=self.seed)
        return {
            "scenario": self.scenario.name,
            "seed": self.seed,
            "rate_scale": self.rate_scale,
            "time_scale": self.time_scale,
            "n": len(self),
            "arrivals": [
                [round(float(self.t[i]), 9), round(float(self.rating[i]), 6),
                 int(self.cohort[i]), int(self.tier[i]),
                 round(float(self.deadline_s[i]), 6), bool(self.retry[i])]
                for i in range(len(self))
            ],
            "incidents": (dataclasses.asdict(chaos) if chaos else None),
        }

    def digest(self) -> str:
        return hashlib.sha256(
            json.dumps(self.transcript(), sort_keys=True).encode()
        ).hexdigest()


# ---- the committed library --------------------------------------------------

def scenarios_dir() -> str:
    """``configs/scenarios/`` at the repo root (next to the package)."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "scenarios")


def scenario_names() -> list[str]:
    """Names of every committed scenario, sorted."""
    d = scenarios_dir()
    if not os.path.isdir(d):
        return []
    return sorted(os.path.splitext(f)[0] for f in os.listdir(d)
                  if f.endswith(".json"))


def load_scenario(name_or_path: str) -> Scenario:
    """A committed scenario by name (``"flash-crowd"``) or any spec by
    path (``/tmp/my.json``)."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(scenarios_dir(), name_or_path + ".json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no scenario {name_or_path!r} (looked for a file and for "
                f"{path}; committed: {scenario_names()})")
    with open(path) as f:
        return Scenario.from_dict(json.load(f))
