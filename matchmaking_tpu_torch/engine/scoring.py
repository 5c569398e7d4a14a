"""Scoring semantics: the port's copy of the rating-distance definitions.

Plain scalar math for the host (match quality at finalize, invariant
checks); the device versions of the same expressions live in
``engine/cuda_kernels.py`` (the plain PyTorch twin and the CUDA kernel).

The Glicko-2 factor is written ``1 / sqrt(1 + G·rd²)`` with ``G`` computed
in Python double and rounded to f32 once — the constant the device code
uses — and each step rounded as an IEEE f32 op. (The JAX package writes
``1 / x ** 0.5``; its CPU compiler fuses the mul-adds and lowers the power,
so the two packages can differ by a few ulp in a Glicko-2 distance, never
in an ELO one.)
"""

from __future__ import annotations

import math

import numpy as np

# Glicko-2 g-function constant (q = ln 10 / 400).
_Q = math.log(10.0) / 400.0
_G_COEFF = 3.0 * _Q * _Q / (math.pi * math.pi)
#: The constant as the device sees it: rounded to f32 once.
G_COEFF_F32 = float(np.float32(_G_COEFF))


def glicko_g(rd_a, rd_b):
    """g(sqrt(rd_a² + rd_b²)) in (0, 1]; 1.0 when both deviations are 0."""
    rd2 = rd_a * rd_a + rd_b * rd_b
    return 1.0 / math.sqrt(1.0 + _G_COEFF * rd2)


def distance(rating_a, rating_b, rd_a=0.0, rd_b=0.0, *, glicko2: bool = False):
    """Effective rating distance: |Δ|, or g·|Δ| under Glicko-2."""
    delta = abs(rating_a - rating_b)
    if glicko2:
        return glicko_g(rd_a, rd_b) * delta
    return delta


def mutual_threshold(thr_a, thr_b):
    """A pair is valid only if the distance fits BOTH players' thresholds."""
    return min(thr_a, thr_b)


def quality(dist, thr_a, thr_b):
    """Match quality in [0, 1]: 1 at zero distance, 0 at the mutual limit."""
    limit = mutual_threshold(thr_a, thr_b)
    if limit <= 0.0:
        return 0.0
    return max(0.0, 1.0 - dist / limit)


def snake_signs(need: int) -> list[float]:
    """Sign of each ascending-sorted window position in the team-sum
    difference (team A minus team B) under the snake split of team queues
    (config #3).

    The split deals players in descending rating order: position j goes to
    team A iff j % 4 ∈ {0, 3} (A B B A A B B A ...); ascending position i
    is descending position need-1-i. Over the descending window the signed
    sum telescopes into an alternating series of disjoint consecutive gaps,
    (r0−r1) − (r2−r3) + …, each ≥ 0 and together ≤ the spread, so
    |sum_A − sum_B| ≤ spread ≤ every member's threshold whenever the window
    is valid: engines check only the spread."""
    return [1.0 if (need - 1 - i) % 4 in (0, 3) else -1.0 for i in range(need)]


def snake_split(members):
    """Split a full team window into (team_a, team_b) by the snake pattern:
    the one implementation of the split (the host oracle and the device
    finalize both call it). Sorts by descending rating (stable: ties keep
    the caller's order); descending position j goes to team A iff
    j % 4 ∈ {0, 3}, the pattern ``snake_signs`` bounds."""
    ordered = sorted(members, key=lambda r: -r.rating)
    team_a, team_b = [], []
    for j, p in enumerate(ordered):
        (team_a if j % 4 in (0, 3) else team_b).append(p)
    return tuple(team_a), tuple(team_b)


def region_mode_compatible(region_a: str, mode_a: str, region_b: str,
                           mode_b: str, *, any_token: str = "*") -> bool:
    """Hard filters: wildcard-or-equal on both axes."""
    region_ok = (region_a == any_token or region_b == any_token
                 or region_a == region_b)
    mode_ok = mode_a == any_token or mode_b == any_token or mode_a == mode_b
    return region_ok and mode_ok
