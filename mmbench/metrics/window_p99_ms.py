"""The 99th percentile, over every request answered in the timed window,
of the hand-off-to-answer time (ms; nearest rank, each request of a
window counted)."""

import math


def read(rec):
    lat = sorted((s, k) for k, s in rec.latency_s)
    total = sum(k for _, k in lat)
    if not total:
        return None
    rank = math.ceil(0.99 * total)
    seen = 0
    for s, k in lat:
        seen += k
        if seen >= rank:
            return s * 1e3
    return lat[-1][0] * 1e3
