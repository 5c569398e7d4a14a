"""The traffic generator: one general reader of the mixes in ``traffic/``.

A mix is a JSON file of parameters. ``Traffic`` turns it and a seed into
the rows a run hands to the engine, all made before the timed window:

- the fill: ``pool_waiting`` players restored at set-up;
- the arrival windows: ``window`` players each, window k always the same
  rows for one seed;
- the refill stream: fresh waiting players, taken in order, as many after
  each answered window as the window took out of the pool.

Each row is a player: an id, a rating, a rating deviation and how long
the player had waited before the hand-off (``wait_s``), whose enqueue
time is stamped at the hand-off (``now - wait``), as a client stamps it.
Region and mode are the wildcard.

Window ``k`` and refill row ``r`` are each one fixed function of the seed
and of ``k`` or ``r``, however fast the program runs. The ids come from
the position alone (``arrival`` row ``k * window + j``, ``refill`` row
``r``), made at the hand-off, so no id is ever handed over twice. The
ratings, deviations and waits come from a bank drawn before the window:
``bank_windows_per_s`` windows a second of the run, twice the fastest rate
measured on the card; a run that gets further takes the bank's values
again from its start, under new ids (``bank_cycles`` in the notes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

#: First id of each stream: the ids are decimal strings of ten digits,
#: disjoint between the fill, the arrivals and the refills.
_ID_BASE = {"fill": 1_000_000_000, "arrival": 2_000_000_000,
            "refill": 3_000_000_000}


@dataclass
class Rows:
    """Players as columns (host numpy): object ids, f32 ratings and
    deviations, f64 seconds waited before the hand-off."""

    ids: np.ndarray | None
    rating: np.ndarray
    rd: np.ndarray
    wait: np.ndarray

    def __len__(self) -> int:
        return len(self.rating)


def seed_rng(seed: int) -> np.random.Generator:
    """The run's generator: any whole number is a seed (taken mod 2**64)."""
    return np.random.default_rng(np.random.SeedSequence(int(seed) % (1 << 64)))


def _draw(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    if spec["dist"] == "normal":
        return rng.normal(spec["mean"], spec["std"], n)
    if spec["dist"] == "uniform":
        return rng.uniform(spec["lo"], spec["hi"], n)
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def _ids(stream: str, lo: int, hi: int) -> np.ndarray:
    """The ids of rows ``lo`` to ``hi`` of ``stream``."""
    base = _ID_BASE[stream]
    out = np.empty(hi - lo, object)
    out[:] = list(map(str, range(base + lo, base + hi)))
    return out


def _rows(rng: np.random.Generator, params: dict, stream: str, n: int) -> Rows:
    """``n`` rows of ``stream``; the ids of the fill only (the other
    streams name their rows at the hand-off)."""
    return Rows(ids=_ids(stream, 0, n) if stream == "fill" else None,
                rating=_draw(rng, params["rating"], n).astype(np.float32),
                rd=_draw(rng, params["rating_deviation"], n).astype(np.float32),
                wait=_draw(rng, params["wait_s"], n))


def bank_windows(params: dict, seconds: float, trace: bool) -> int:
    """Arrival windows the bank holds for a run of ``seconds``."""
    return (params["warm_windows"]
            + math.ceil(params["bank_windows_per_s"] * seconds)
            + (params["trace_windows"] if trace else 0))


class Traffic:
    """The rows of one run, drawn from ``seed`` before the window."""

    def __init__(self, params: dict, seed: int, seconds: float, trace: bool,
                 rescan_ticks: int = 0, rescan_rows: int = 0):
        if params.get("kind") != "closed_loop_columnar":
            raise ValueError(f"traffic kind {params.get('kind')!r} is not "
                             f"one this generator drives")
        if params.get("refill") != "net_consumed":
            raise ValueError(f"refill rule {params.get('refill')!r} unknown")
        self.window_size = int(params["window"])
        rng = seed_rng(seed)
        self.fill = _rows(rng, params, "fill", int(params["pool_waiting"]))
        self.n_windows = bank_windows(params, seconds, trace)
        self.arrivals = _rows(rng, params, "arrival",
                              self.n_windows * self.window_size)
        # A window takes out of the pool at most as many players as it
        # brought (every match has an arrival on one side), a rescan tick
        # at most twice the players it rescans.
        self.refills = _rows(rng, params, "refill",
                             self.n_windows * self.window_size
                             + rescan_ticks * 2 * rescan_rows)
        self._refill_at = 0
        self._window_hi = 0

    @property
    def bank_cycles(self) -> int:
        """How many times a stream has started its bank again."""
        w = self.window_size
        return max(0, (self._window_hi - 1) // (self.n_windows * w),
                   (self._refill_at - 1) // len(self.refills))

    def window(self, k: int) -> Rows:
        """Arrival window ``k``."""
        w = self.window_size
        lo = (k % self.n_windows) * w
        self._window_hi = max(self._window_hi, (k + 1) * w)
        r = self.arrivals
        return Rows(_ids("arrival", k * w, (k + 1) * w), r.rating[lo:lo + w],
                    r.rd[lo:lo + w], r.wait[lo:lo + w])

    def refill(self, n: int) -> Rows:
        """The next ``n`` rows of the refill stream."""
        at, total = self._refill_at, len(self.refills)
        self._refill_at += n
        lo = at % total
        idx = (slice(lo, lo + n) if lo + n <= total
               else np.arange(lo, lo + n) % total)
        r = self.refills
        return Rows(_ids("refill", at, at + n), r.rating[idx], r.rd[idx],
                    r.wait[idx])
