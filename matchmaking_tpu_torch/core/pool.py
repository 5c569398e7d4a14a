"""The player pool: host-side slot allocator and authoritative mirror.

The device side of the pool is a dict of 1-D tensors, one per
``POOL_FIELDS`` entry, owned by the engine (engine/gpu.py) and updated in
place by the window step (engine/kernels.py). This module owns which slot
means which player:

- **Fixed capacity P.** Slots are recycled through a LIFO free list: a
  numpy stack with a head cursor, so initial pops yield slot 0, 1, 2, ...
  The JAX package's allocator behaves the same, which is what lets the
  parity tests expect the same player in the same slot on both engines.
- **Rating bands** (``band_edges``, from ``band_edges_from_spec``): the
  slots split into contiguous bands, one free stack each, and a player's
  slot comes from the band of its rating, spilling to the nearest band
  with room. Each pool block then holds a narrow rating interval, which
  is what lets the pruned window step skip blocks. The slot sequence is
  the JAX allocator's, spills included.
- **Segment counts** (``segments``): waiting players per pool block,
  kept by allocate and release, the host twin of the bucketed step's
  device index counts.
- **Columnar mirror.** Waiting requests are kept as slot-indexed numpy
  columns; ``SearchRequest`` objects are built lazily for matched slots.
  Device state is a pure function of the mirror, so the mirror is the
  checkpoint (``waiting()`` / ``Engine.restore``).
- **String interning.** Region/game-mode strings become int32 codes
  (0 = wildcard) so the filter masks are integer compares on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from matchmaking_tpu_torch.service.contract import (
    ANY,
    RequestColumns,
    SearchRequest,
)

#: Device pool columns and their dtypes (one 1-D tensor each).
POOL_FIELDS: tuple[tuple[str, np.dtype], ...] = (
    ("rating", np.float32),
    ("rd", np.float32),          # Glicko-2 rating deviation
    ("region", np.int32),        # interned; 0 = ANY
    ("mode", np.int32),          # interned; 0 = ANY
    ("threshold", np.float32),   # base rating_threshold for this player
    ("enqueue_t", np.float32),   # seconds since the engine's time base
    ("active", np.bool_),
)

#: Row order of the packed window: one f32[9, B] array per window (a single
#: host→device copy). All rows are exact in f32: slot ids and interner
#: codes ≪ 2^24, valid is 0/1. Row 8 carries the rebased ``now``.
PACKED_ROWS = ("slot", "rating", "rd", "region", "mode", "threshold",
               "enqueue_t", "valid")


class Interner:
    """str → dense int32 codes; code 0 is reserved for the ANY wildcard."""

    def __init__(self) -> None:
        self._codes: dict[str, int] = {ANY: 0}
        self._names: list[str] = [ANY]

    def code(self, name: str) -> int:
        c = self._codes.get(name)
        if c is None:
            c = len(self._names)
            self._codes[name] = c
            self._names.append(name)
        return c

    def name(self, code: int) -> str:
        return self._names[code]

    def names(self) -> np.ndarray:
        """Every interned name as object[codes], indexable by code."""
        return np.array(self._names, dtype=object)


class PoolFullError(RuntimeError):
    pass


@dataclass
class BatchArrays:
    """A padded request window (host numpy). ``valid`` masks padding lanes;
    padding lanes carry slot = capacity, the never-matching sentinel."""

    slot: np.ndarray      # i32[B]
    rating: np.ndarray    # f32[B]
    rd: np.ndarray        # f32[B]
    region: np.ndarray    # i32[B]
    mode: np.ndarray      # i32[B]
    threshold: np.ndarray # f32[B]
    enqueue_t: np.ndarray # f32[B]
    valid: np.ndarray     # bool[B]


def pack_batch(batch: BatchArrays, now: float = 0.0,
               out: np.ndarray | None = None) -> np.ndarray:
    """BatchArrays (+ rebased now) → one f32[9, B] array (written into
    ``out`` when given, e.g. a pinned staging buffer's numpy view)."""
    if out is None:
        out = np.empty((len(PACKED_ROWS) + 1, batch.slot.shape[0]), np.float32)
    for i, name in enumerate(PACKED_ROWS):
        out[i] = getattr(batch, name)
    out[8] = now
    return out


class PlayerPool:
    """Host-side owner of the pool: slot allocator + columnar mirror."""

    def __init__(self, capacity: int, default_threshold: float,
                 band_edges: Sequence[float] | None = None,
                 segments: int = 0):
        self.capacity = int(capacity)
        self.default_threshold = float(default_threshold)
        # Occupancy per segment of ``capacity // segments`` slots (the
        # bucketed engine passes its device block count): the host twin of
        # the device bucket index's counts, kept by allocate and release.
        # 0 = not tracked.
        self._segments = max(0, int(segments))
        self._seg_size = self.capacity // self._segments if self._segments else 0
        self._seg_n = (np.zeros(self._segments, np.int64)
                       if self._segments else None)
        # Free list popped from the END: initial pops yield 0, 1, 2, ...
        self._free = np.arange(self.capacity - 1, -1, -1, dtype=np.int32)
        self._head = self.capacity  # number of free slots
        # Rating bands: ``band_edges`` are the R - 1 ascending boundaries;
        # band b owns slots [b·P/R, (b+1)·P/R) and a free stack of its own
        # (stored descending, so pops yield ascending slots).
        self._band_edges: np.ndarray | None = None
        if band_edges is not None and len(band_edges) > 0:
            edges = np.asarray(band_edges, np.float64)
            if not np.all(np.diff(edges) > 0):
                raise ValueError("band_edges must be strictly ascending")
            r = edges.size + 1
            self._band_edges = edges
            self._band_start = np.array(
                [b * self.capacity // r for b in range(r + 1)], np.int64)
            self._band_free = [
                np.arange(self._band_start[b + 1] - 1,
                          self._band_start[b] - 1, -1, dtype=np.int32)
                for b in range(r)]
            self._band_head = np.array([f.size for f in self._band_free],
                                       np.int64)
        self._slot_of: dict[str, int] = {}
        self.m_id = np.full(self.capacity, None, dtype=object)
        self.m_rating = np.zeros(self.capacity, np.float32)
        self.m_rd = np.zeros(self.capacity, np.float32)
        self.m_region = np.zeros(self.capacity, np.int32)
        self.m_mode = np.zeros(self.capacity, np.int32)
        self.m_threshold = np.zeros(self.capacity, np.float32)
        self.m_thr_override = np.zeros(self.capacity, np.bool_)
        self.m_enqueued = np.zeros(self.capacity, np.float64)
        self.m_reply = np.full(self.capacity, "", dtype=object)
        self.m_corr = np.full(self.capacity, "", dtype=object)
        self.m_tier = np.zeros(self.capacity, np.int32)
        self.m_deadline = np.zeros(self.capacity, np.float64)
        #: Waiting players per QoS tier, and waiting players with a nonzero
        #: deadline: kept up to date by allocate/release, so reading them
        #: never scans the pool.
        self._tier_n: dict[int, int] = {}
        self._deadline_n = 0
        self.m_roles = np.full(self.capacity, None, dtype=object)
        self.regions = Interner()
        self.modes = Interner()

    # ---- introspection ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._slot_of)

    def free_count(self) -> int:
        return self._head

    def __contains__(self, player_id: str) -> bool:
        return player_id in self._slot_of

    def slot_of(self, player_id: str) -> int | None:
        return self._slot_of.get(player_id)

    def request_at(self, slot: int) -> SearchRequest:
        """Materialize the SearchRequest held by one occupied slot."""
        return SearchRequest(
            id=self.m_id[slot],
            rating=float(self.m_rating[slot]),
            rating_deviation=float(self.m_rd[slot]),
            game_mode=self.modes.name(int(self.m_mode[slot])),
            region=self.regions.name(int(self.m_region[slot])),
            rating_threshold=(float(self.m_threshold[slot])
                              if self.m_thr_override[slot] else None),
            roles=tuple(self.m_roles[slot] or ()),
            reply_to=self.m_reply[slot],
            correlation_id=self.m_corr[slot],
            enqueued_at=float(self.m_enqueued[slot]),
            tier=int(self.m_tier[slot]),
            deadline_at=float(self.m_deadline[slot]),
        )

    def waiting(self) -> list[SearchRequest]:
        """Checkpoint payload: every waiting request."""
        return [self.request_at(s) for s in self._slot_of.values()]

    def waiting_slots(self) -> np.ndarray:
        return np.fromiter(self._slot_of.values(), np.int32, len(self._slot_of))

    def waiting_columns(self) -> tuple[RequestColumns, np.ndarray, np.ndarray]:
        """Checkpoint payload as columns, in ``waiting()`` order: every
        waiting row (NaN threshold where the queue default applies), plus
        its region and mode names (the codes belong to this pool's
        interners; a new pool interns the names again)."""
        slots = self.waiting_slots()
        cols = RequestColumns(
            ids=self.m_id[slots], rating=self.m_rating[slots],
            rd=self.m_rd[slots], region=self.m_region[slots],
            mode=self.m_mode[slots],
            threshold=np.where(self.m_thr_override[slots],
                               self.m_threshold[slots],
                               np.float32(np.nan)).astype(np.float32),
            enqueued_at=self.m_enqueued[slots], reply_to=self.m_reply[slots],
            correlation_id=self.m_corr[slots], tier=self.m_tier[slots],
            deadline=self.m_deadline[slots])
        return (cols, self.regions.names()[cols.region],
                self.modes.names()[cols.mode])

    def deadline_count(self) -> int:
        """Waiting players with a stamped deadline (O(1))."""
        return self._deadline_n

    def segment_counts(self) -> np.ndarray | None:
        """Waiting players per segment (= device pool block, the rating
        bucket under ``band_spec``), kept by allocate and release: an
        O(segments) read. None when segments are not tracked."""
        return self._seg_n

    def segment_max(self) -> int:
        """The most waiting players in one segment (0 when not tracked or
        empty)."""
        if self._seg_n is None:
            return 0
        return int(self._seg_n.max(initial=0))

    def _seg_add(self, slots: np.ndarray, sign: int) -> None:
        if self._seg_n is None or slots.size == 0:
            return
        seg = np.minimum(slots // self._seg_size, self._segments - 1)
        np.add.at(self._seg_n, seg, sign)

    def band_report(self) -> dict | None:
        """The rating bands' free stacks: per band its free-slot count
        (head) and size, and the edges. None without bands."""
        if self._band_edges is None:
            return None
        return {
            "bands": len(self._band_free),
            "free_heads": [int(h) for h in self._band_head],
            "band_sizes": [int(self._band_start[b + 1] - self._band_start[b])
                           for b in range(len(self._band_free))],
            "edges": [float(e) for e in self._band_edges],
        }

    def tier_counts(self, n_tiers: int) -> list[int]:
        """Waiting players per QoS tier (``n_tiers`` buckets; out-of-range
        tiers are clamped into the last). O(n_tiers)."""
        out = [0] * max(1, n_tiers)
        for t, n in self._tier_n.items():
            out[min(max(t, 0), len(out) - 1)] += n
        return out

    # ---- mutation (single writer) -----------------------------------------

    def allocate_columns(self, cols: RequestColumns) -> np.ndarray:
        """Assign slots to a columnar window and record it in the mirror.
        Stores are vectorized; the id checks and the id→slot dict update are
        the only per-row work. Ids must be unique within the window and
        absent from the pool (engines dedupe first); violations raise before
        any mutation."""
        n = len(cols)
        if n > self._head:
            raise PoolFullError(
                f"pool exhausted: {n} requested, {self._head} free "
                f"(capacity {self.capacity})")
        ids = cols.ids.tolist()
        if len(set(ids)) != n:
            raise ValueError("duplicate player id in window")
        if any(pid in self._slot_of for pid in ids):
            raise ValueError("player already in pool")
        if self._band_edges is not None:
            slots = self._take_banded(np.asarray(cols.rating, np.float64), n)
        else:
            slots = self._free[self._head - n:self._head][::-1].copy()
        self._head -= n
        self.m_id[slots] = cols.ids
        self.m_rating[slots] = cols.rating
        self.m_rd[slots] = cols.rd
        self.m_region[slots] = cols.region
        self.m_mode[slots] = cols.mode
        override = ~np.isnan(cols.threshold)
        self.m_thr_override[slots] = override
        self.m_threshold[slots] = np.where(override, cols.threshold,
                                           self.default_threshold)
        self.m_enqueued[slots] = cols.enqueued_at
        # Missing columns clear the slots: a recycled slot must not leak
        # its previous occupant's reply queue, tier or deadline.
        self.m_reply[slots] = "" if cols.reply_to is None else cols.reply_to
        self.m_corr[slots] = ("" if cols.correlation_id is None
                              else cols.correlation_id)
        if cols.tier is None:
            self.m_tier[slots] = 0
            self._tier_n[0] = self._tier_n.get(0, 0) + n
        else:
            self.m_tier[slots] = cols.tier
            for t, c in zip(*np.unique(np.asarray(cols.tier, np.int64),
                                       return_counts=True)):
                self._tier_n[int(t)] = self._tier_n.get(int(t), 0) + int(c)
        if cols.deadline is None:
            self.m_deadline[slots] = 0.0
        else:
            dl = np.nan_to_num(np.asarray(cols.deadline, np.float64), nan=0.0)
            self.m_deadline[slots] = dl
            self._deadline_n += int((dl != 0.0).sum())
        self._slot_of.update(zip(ids, slots.tolist()))
        self._seg_add(slots, 1)
        return slots

    def allocate(self, requests: Sequence[SearchRequest]) -> list[int]:
        """Object-path wrapper around ``allocate_columns`` (also records
        each request's roles)."""
        for req in requests:
            if req.id in self._slot_of:
                raise ValueError(f"player {req.id!r} already in pool")
        cols = RequestColumns.from_requests(
            requests, self.regions.code, self.modes.code)
        slots = self.allocate_columns(cols).tolist()
        for s, req in zip(slots, requests):
            if req.roles:
                self.m_roles[s] = req.roles
        return slots

    def release(self, slots: Sequence[int] | np.ndarray,
                in_order: bool = False) -> None:
        """Free slots (matched / cancelled / timed out). Idempotent. The
        freed slots go onto the free stacks in slot order; with
        ``in_order`` in the order given (first occurrence), which leaves
        the stacks as a ``release`` of each slot in turn would."""
        arr = np.asarray(slots, dtype=np.int32)
        if in_order:
            arr = np.fromiter(dict.fromkeys(arr.tolist()), np.int32)
        else:
            arr = np.unique(arr)
        if arr.size == 0:
            return
        ids = self.m_id[arr]
        occupied = ids != None  # noqa: E711 (elementwise over object ids)
        arr = arr[occupied]
        if arr.size == 0:
            return
        for pid in ids[occupied].tolist():
            del self._slot_of[pid]
        self._seg_add(arr, -1)
        # Tier/deadline occupancy before the slots are cleared.
        for t, c in zip(*np.unique(self.m_tier[arr], return_counts=True)):
            self._tier_n[int(t)] = self._tier_n.get(int(t), 0) - int(c)
        self._deadline_n -= int((self.m_deadline[arr] != 0.0).sum())
        self.m_deadline[arr] = 0.0
        self.m_id[arr] = None
        self.m_roles[arr] = None
        if self._band_edges is not None:
            # Back to the HOME band (slot ranges are static), so band
            # occupancy heals as spilled players match out.
            bands = np.searchsorted(self._band_start, arr, side="right") - 1
            for b in np.unique(bands):
                sel = arr[bands == b]
                if not in_order:
                    sel = sel[::-1]
                h = self._band_head[b]
                self._band_free[b][h:h + sel.size] = sel
                self._band_head[b] += sel.size
        else:
            self._free[self._head:self._head + arr.size] = arr
        self._head += arr.size

    def _take_banded(self, ratings: np.ndarray, n: int) -> np.ndarray:
        """Pop ``n`` slots by rating band, spilling to the nearest band with
        room when a band is full: vectorized per band present in the
        window; only spilled rows take the per-row loop."""
        band = np.digitize(ratings, self._band_edges)
        slots = np.empty(n, np.int32)
        for b in np.unique(band):
            idx = np.nonzero(band == b)[0]
            h = int(self._band_head[b])
            take = min(idx.size, h)
            if take:
                slots[idx[:take]] = self._band_free[b][h - take:h][::-1]
                self._band_head[b] = h - take
            for j in idx[take:]:
                bb = self._nearest_free_band(int(b))
                hh = int(self._band_head[bb])
                slots[j] = self._band_free[bb][hh - 1]
                self._band_head[bb] = hh - 1
        return slots

    def _nearest_free_band(self, b: int) -> int:
        """The band nearest to ``b`` with a free slot (lower side first on
        equal distance). The caller checked that the pool has room."""
        r = len(self._band_free)
        for off in range(1, r):
            for cand in (b - off, b + off):
                if 0 <= cand < r and self._band_head[cand] > 0:
                    return cand
        raise PoolFullError("no free slot in any band")

    # ---- array building ---------------------------------------------------

    def batch_arrays_cols(self, cols: RequestColumns, slots: np.ndarray,
                          bucket: int, t_offset: float = 0.0) -> BatchArrays:
        """Pack a columnar window into padded arrays of size ``bucket``;
        padding lanes get slot = capacity, the never-matching sentinel.

        ``t_offset`` rebases wall-clock timestamps: device times are f32,
        whose spacing at epoch magnitude is 128 s, so the engine subtracts
        its start time (in f64, before the f32 store)."""
        b = len(cols)
        assert b <= bucket
        arr = BatchArrays(
            slot=np.full(bucket, self.capacity, np.int32),
            rating=np.zeros(bucket, np.float32),
            rd=np.zeros(bucket, np.float32),
            region=np.zeros(bucket, np.int32),
            mode=np.zeros(bucket, np.int32),
            threshold=np.zeros(bucket, np.float32),
            enqueue_t=np.zeros(bucket, np.float32),
            valid=np.zeros(bucket, np.bool_),
        )
        if b:
            arr.slot[:b] = slots
            arr.rating[:b] = cols.rating
            arr.rd[:b] = cols.rd
            arr.region[:b] = cols.region
            arr.mode[:b] = cols.mode
            arr.threshold[:b] = np.where(np.isnan(cols.threshold),
                                         self.default_threshold,
                                         cols.threshold)
            arr.enqueue_t[:b] = cols.enqueued_at - t_offset
            arr.valid[:b] = True
        return arr

    def batch_arrays(self, requests: Sequence[SearchRequest],
                     slots: Sequence[int], bucket: int,
                     t_offset: float = 0.0) -> BatchArrays:
        """Object-path wrapper around ``batch_arrays_cols``."""
        cols = RequestColumns.from_requests(
            requests, self.regions.code, self.modes.code)
        return self.batch_arrays_cols(cols, np.asarray(slots, np.int32),
                                      bucket, t_offset)

    @staticmethod
    def empty_device_arrays(capacity: int) -> dict[str, np.ndarray]:
        """Initial pool state (all slots inactive), as host numpy."""
        return {name: np.zeros(capacity, dtype) for name, dtype in POOL_FIELDS}


def band_edges_from_spec(spec: str, n_bands: int) -> list[float] | None:
    """An ``EngineConfig.band_spec`` → ``n_bands - 1`` rating edges (None:
    no banding, for "" or fewer than two bands).

    - ``"uniform:LO:HI"``: equal-width bands over [LO, HI];
    - ``"gaussian:MEAN:STD"``: equal-mass bands under N(MEAN, STD)
      (``statistics.NormalDist`` quantiles), which a normal rating
      distribution fills evenly."""
    if not spec or n_bands < 2:
        return None
    kind, *params = spec.split(":")
    if kind == "uniform":
        lo, hi = float(params[0]), float(params[1])
        if not hi > lo:
            raise ValueError(f"uniform band_spec needs hi > lo: {spec!r}")
        step = (hi - lo) / n_bands
        return [lo + i * step for i in range(1, n_bands)]
    if kind == "gaussian":
        from statistics import NormalDist

        nd = NormalDist(float(params[0]), float(params[1]))
        return [nd.inv_cdf(i / n_bands) for i in range(1, n_bands)]
    raise ValueError(f"unknown band_spec kind: {spec!r}")
