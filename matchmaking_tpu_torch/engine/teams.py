"""The 5v5 team window step (config #3) in PyTorch.

Port of ``matchmaking_tpu/engine/teams.py``'s single-card ``TeamKernelSet``.
The oracle's rule (engine/cpu.py ``_try_team_window``): among mutually
region/mode-compatible waiting players, the contiguous rating-sorted
window of ``need = 2 * team_size`` players with the smallest spread forms a
match iff the spread fits every member's effective threshold. The snake
split then keeps |sum_A − sum_B| ≤ spread (``scoring.snake_signs``).

One step admits a window and forms every available match in the pool:

    admit (indexed write) → stable two-pass argsort by (group, rating)
    → per-window spread and minimum threshold
    → fixed rounds of parallel greedy selection of disjoint windows
    → top-k extraction of the winners → evict the matched slots

Every reduction is exact (a sort, subtractions, minima, ORs), so slots,
spread and limit equal the JAX step's bit for bit on the CPU, and the
card's equal the CPU's. The JAX code writes each windowed reduction as
``need`` (or 2·need − 1) static shifts; here each is one ``unfold`` view
and one reduction kernel, and the selection rounds write into padded
buffers allocated once per step, so a selection round is 10 kernels
instead of ~36 per reduction. No step reads a value back to the host:
``max_matches`` is static and the rounds all run.

Grouping is by exact (region, mode) code; a wildcard (code 0) would only
match other wildcards, where the oracle expands it into every concrete
group. ``GpuEngine`` therefore hands the queue to the host oracle the
moment a wildcard arrives (``_maybe_delegate_team``), so this step only
ever sees pools where the two rules agree.

The sharded half (``ShardedTeamKernelSet``, over an engine/sharded.py
mesh): window formation needs the global (group, rating) order, so the
replicated fallback gathers the formation columns of every shard and
forms windows once on the whole pool; with ``frontier_k`` each shard
sends only its first ``frontier_k`` (group, rating)-sorted rows
(``pack_frontier``) around the ring, and formation runs on the merged
frontier (``merge_frontiers``: all D·K rows, or a tournament-tree top K).
While no shard holds more than ``frontier_k`` waiting players the two
paths are bit-equal; the engine checks the mirror per window.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from matchmaking_tpu_torch.core.pool import PACKED_ROWS, POOL_FIELDS
from matchmaking_tpu_torch.engine.cuda_kernels import effective_threshold
from matchmaking_tpu_torch.engine.kernels import (
    ADMIT_FIELDS,
    admit,
    evict,
    packed_now,
    unpack_batch,
)
from matchmaking_tpu_torch.engine.sharded import (
    _ShardedBase,
    resolve_mesh,
    tournament_merge_topk,
)

BIG_I32 = 1 << 30
INF = float("inf")


def sorted_group_order(pool: dict[str, torch.Tensor]):
    """Stable lexicographic order by (group, rating), inactive slots last:
    two stable passes (rating, then group), so ties keep the lower slot
    first, as the oracle's per-group stable rating sort does. Returns
    (order i64[P], group i32[P])."""
    group = pool["region"] * (1 << 15) + pool["mode"]
    group = torch.where(pool["active"], group, BIG_I32)
    p1 = torch.argsort(pool["rating"], stable=True)
    p2 = torch.argsort(group[p1], stable=True)
    return p1[p2], group


def extract_windows(won: torch.Tensor, need: int, max_matches: int,
                    order: torch.Tensor, capacity: int):
    """Winning window starts → member slots: (slots i32[M, need], is_match
    bool[M], w i64[M]), winners in ascending start order (``topk`` of the
    negated start, as ``lax.top_k``), padding rows at slot ``capacity``."""
    n = won.shape[0]
    dev = won.device
    starts = torch.arange(n, dtype=torch.int32, device=dev)
    score = torch.where(won, -starts, -BIG_I32)
    topv, topi = torch.topk(score, max_matches)
    is_match = topv > -BIG_I32
    w = torch.where(is_match, topi, 0)
    member_pos = w[:, None] + torch.arange(need, device=dev)[None, :]
    slots = torch.where(is_match[:, None], order[member_pos], capacity)
    return slots.to(torch.int32), is_match, w


class TeamKernelSet:
    """The team window step for one (pool geometry × queue config).

    ``search_step`` returns (slots i32[M, need], spread f32[M], limit
    f32[M]); rows with ``slots[m, 0] == capacity`` are padding (spread
    +inf, limit 0). The pool is a ``kernels.DevicePool`` updated in
    place."""

    is_role = False
    #: Device pool columns beyond ``POOL_FIELDS``.
    extra_pool_fields: dict[str, Any] = {}
    #: Rows of the packed window: ``PACKED_ROWS`` + now.
    pack_rows = len(PACKED_ROWS) + 1
    admit_fields = ADMIT_FIELDS

    def __init__(self, *, capacity: int, team_size: int,
                 widen_per_sec: float, max_threshold: float,
                 max_matches: int = 1024, rounds: int = 16):
        if team_size <= 1:
            raise ValueError("the team step needs team_size > 1")
        self.capacity = capacity
        self.team_size = team_size
        self.need = 2 * team_size
        self.widen_per_sec = widen_per_sec
        self.max_threshold = max_threshold
        self.max_matches = min(max_matches, max(1, capacity // self.need))
        self.rounds = rounds

    # ---- pool I/O -----------------------------------------------------------

    def unpack(self, packed: torch.Tensor) -> dict[str, torch.Tensor]:
        return unpack_batch(packed)

    def admit_packed(self, pool, packed: torch.Tensor) -> None:
        admit(pool, self.unpack(packed), self.admit_fields)

    def evict(self, pool, slots: torch.Tensor) -> None:
        evict(pool, slots)

    # ---- the step -----------------------------------------------------------

    def _windows(self, pool, order, group, now: torch.Tensor):
        """Validity, spread and minimum effective threshold of every window
        start w ∈ [0, P − need]. A window is valid iff its first and last
        members share a group below ``BIG_I32`` (the order is sorted by
        group, and inactive slots carry ``BIG_I32``: so all its members
        are active and of that group, the JAX step's ``all_active &
        same_group`` term) and its spread fits the minimum threshold."""
        need = self.need
        n_win = self.capacity - need + 1
        r_s = pool["rating"][order]
        g_s = group[order]
        thr_s = effective_threshold(pool["threshold"][order],
                                    pool["enqueue_t"][order], now,
                                    self.widen_per_sec, self.max_threshold)
        win_thr = thr_s.unfold(0, need, 1).amin(1)
        spread = r_s[need - 1:] - r_s[:n_win]
        first = g_s[:n_win]
        valid = ((first == g_s[need - 1:]) & (first < BIG_I32)
                 & (spread <= win_thr))
        return valid, spread, win_thr

    def _select_windows(self, valid: torch.Tensor,
                        spread: torch.Tensor | None = None):
        """Disjoint windows by fixed-round parallel greedy over window
        starts, tightest first (the role step passes no ``spread``:
        leftmost first, as its oracle returns the first valid window). A
        window wins a round iff it is the (spread, start) minimum (start
        only, without ``spread``) of the windows overlapping it
        (|Δstart| < need), and the winners knock out every window they
        overlap. Each neighbourhood reduction is one reduction over an
        ``unfold`` view of a buffer padded with the reduction's identity.

        A non-candidate carries key ``BIG_I32 + 1 + start`` instead of its
        start: above every candidate's key, and above the padding's
        ``BIG_I32`` and its left neighbour's key, so it never equals its
        neighbourhood's minimum and "candidate and minimum" is one compare.
        ``valid`` is updated in place (the caller's tensor)."""
        n = valid.shape[0]
        dev = valid.device
        h = self.need - 1
        width = 2 * h + 1
        starts = torch.arange(n, dtype=torch.int32, device=dev)
        not_cand = starts + (BIG_I32 + 1)
        ci_buf = torch.full((n + 2 * h,), BIG_I32, dtype=torch.int32, device=dev)
        win_buf = torch.zeros(n + 2 * h, dtype=torch.bool, device=dev)
        ci, win = ci_buf[h:h + n], win_buf[h:h + n]
        if spread is not None:
            # A device scalar for the ``out=`` form of ``where`` (made by a
            # fill: nothing is copied from the host).
            inf = torch.full((), INF, dtype=spread.dtype, device=dev)
            sp_buf = torch.full((n + 2 * h,), INF, dtype=spread.dtype,
                                device=dev)
            sp = sp_buf[h:h + n]
        won = torch.zeros(n, dtype=torch.bool, device=dev)
        for _ in range(self.rounds):
            if spread is not None:
                torch.where(valid, spread, inf, out=sp)
                cand = valid & (sp <= sp_buf.unfold(0, width, 1).amin(1))
            else:
                cand = valid
            torch.where(cand, starts, not_cand, out=ci)
            torch.eq(ci, ci_buf.unfold(0, width, 1).amin(1), out=win)
            # valid & ~hit, as one compare of bools (False < True).
            torch.lt(win_buf.unfold(0, width, 1).any(1), valid, out=valid)
            won |= win
        return won

    def form(self, cols: dict[str, torch.Tensor], now: torch.Tensor,
             capacity: int):
        """Window formation over ``cols`` (the pool's columns, or a
        sharded set's gathered columns or merged frontier): (member slots
        i32[M, need], the rows of ``cols``, ``capacity`` in padding rows;
        the result rows after them: spread f32[M], limit f32[M])."""
        order, group = sorted_group_order(cols)
        valid, spread, win_thr = self._windows(cols, order, group, now)
        won = self._select_windows(valid, spread)
        slots, is_match, w = extract_windows(won, self.need, self.max_matches,
                                             order, capacity)
        return slots, [torch.where(is_match, spread[w], INF),
                       torch.where(is_match, win_thr[w], 0.0)]

    def search_step(self, pool, batch: dict[str, torch.Tensor],
                    now: torch.Tensor):
        """One team window: admit → form → evict, the pool updated in
        place, at the window's time ``now`` (a one-element f32 tensor on
        the pool's device). Returns (slots i32[M, need], spread f32[M],
        limit f32[M]) (and, for the role step, split i32[M])."""
        admit(pool, batch, self.admit_fields)
        slots, rows = self.form(pool, now, self.capacity)
        evict(pool, slots.reshape(-1))
        return (slots, *rows)

    def search_step_packed(self, pool, packed: torch.Tensor):
        """Packed step: f32[pack_rows, B] in (``now`` read on the device from
        its last row: ``packed_now``), f32[need + 2, M] out: member slots
        (f32-exact), spread, limit (and the role step's split)."""
        slots, *rows = self.search_step(pool, self.unpack(packed),
                                        packed_now(packed))
        return torch.cat([slots.T.to(torch.float32)]
                         + [r.to(torch.float32)[None, :] for r in rows])


@functools.lru_cache(maxsize=None)
def team_kernel_set(capacity: int, team_size: int, widen_per_sec: float,
                    max_threshold: float, max_matches: int = 1024,
                    rounds: int = 16) -> TeamKernelSet:
    return TeamKernelSet(capacity=capacity, team_size=team_size,
                         widen_per_sec=widen_per_sec,
                         max_threshold=max_threshold,
                         max_matches=max_matches, rounds=rounds)


# ---- the sharded half -------------------------------------------------------


def pack_frontier(pool, fields: tuple[str, ...], k: int, offset: int,
                  capacity: int) -> torch.Tensor:
    """One shard's first ``k`` rows in (group, rating) order, as one
    f32[len(fields) + 1, k] buffer: ``fields`` rows, then the row's GLOBAL
    slot (``capacity`` for inactive padding). Active rows sort first, so a
    shard holding at most ``k`` active rows sends all of them, in the order
    the global sort gives them. Every value is f32-exact (codes < 2^15,
    role masks < 2^5, slot ids < 2^24: checked at the kernel set's
    build)."""
    order, _ = sorted_group_order(pool)
    top = order[:k]
    act = pool["active"][top]
    rows = [pool[f][top].to(torch.float32) for f in fields]
    gslot = torch.where(act, top + offset, capacity).to(torch.float32)
    return torch.stack(rows + [gslot])


def unpack_frontier(buf: torch.Tensor, fields: tuple[str, ...]):
    """Gathered frontiers f32[n, len(fields) + 1, k] → formation columns
    of n·k rows in canonical shard order, and the global slot column."""
    n, c, k = buf.shape
    flat = buf.transpose(0, 1).reshape(c, n * k)
    cols: dict[str, torch.Tensor] = {}
    for i, f in enumerate(fields):
        if f == "active":
            cols[f] = flat[i] > 0.5
        elif f in ("region", "mode", "role_mask"):
            cols[f] = flat[i].to(torch.int32)
        else:
            cols[f] = flat[i]
    return cols, flat[len(fields)].to(torch.int32)


def merge_frontiers(buf: torch.Tensor, fields: tuple[str, ...],
                    n_shards: int, merge: str):
    """Gathered frontiers → formation columns, by either merge:
    ``"linear"`` keeps all D·K rows in canonical shard order
    (``unpack_frontier``); ``"tournament"`` merges the D sorted K-row
    frontiers up a pairwise tree keeping the top K
    (``sharded.tournament_merge_topk``), bit-equal to the linear merge
    whenever the whole pool's active rows fit in K. Returns (columns,
    global slot i32) of D·K or K rows."""
    if merge != "tournament" or n_shards <= 1:
        return unpack_frontier(buf, fields)
    ridx, midx = fields.index("region"), fields.index("mode")
    aidx, slot_row = fields.index("active"), len(fields)

    def key_fn(fb):
        group = torch.where(fb[aidx] > 0.5,
                            fb[ridx].to(torch.int32) * (1 << 15)
                            + fb[midx].to(torch.int32), BIG_I32)
        return group, fb[0], fb[slot_row].to(torch.int32)

    merged = tournament_merge_topk([buf[i] for i in range(n_shards)], key_fn)
    return unpack_frontier(merged[None], fields)


def pad_match_columns(out: torch.Tensor, pad: int, need: int, capacity: int,
                      extra_zero_rows: int = 0) -> torch.Tensor:
    """A packed (need + 2 + extra, M) match result widened to M + pad
    columns of the non-match sentinels (slots ``capacity``, spread +inf,
    limit and any extra rows 0): the ring step's result then has the
    fallback's shape and padding, byte for byte."""
    if pad <= 0:
        return out
    col = torch.cat([
        torch.full((need, pad), float(capacity), dtype=torch.float32,
                   device=out.device),
        torch.full((1, pad), INF, dtype=torch.float32, device=out.device),
        torch.zeros((1 + extra_zero_rows, pad), dtype=torch.float32,
                    device=out.device)])
    return torch.cat([out, col], dim=1)


def shard_comms_accounting(ks) -> dict:
    """Per-device bytes received and formation rows of one step of a
    sharded team or role set, from the buffers its steps move: the
    fallback gathers the ``_GATHER`` columns at their pool dtypes (active
    one byte, the rest four) from every other shard, O(P) whatever D; the
    ring ships one (len(_GATHER) + 1, K) f32 frontier per hop for D − 1
    hops, O(K·D), and forms windows over P/D local and D·K merged rows."""
    cols = len(ks._GATHER)
    dtypes = dict(POOL_FIELDS)
    dtypes.update(getattr(ks, "extra_pool_fields", {}))
    row_bytes = sum(np.dtype(dtypes[f]).itemsize for f in ks._GATHER)
    acct = {
        "n_shards": ks.n_shards,
        "capacity": ks.capacity,
        "gather_cols": cols,
        "allgather": {
            "ici_recv_bytes": (ks.capacity - ks.local_capacity) * row_bytes,
            "formation_rows": ks.capacity,
        },
    }
    if ks.frontier_k:
        k = ks.frontier_k
        acct["ring"] = {
            "frontier_k": k,
            "ici_recv_bytes": (ks.n_shards - 1) * (cols + 1) * k * 4,
            "formation_rows": ks.local_capacity + ks.n_shards * k,
        }
    return acct


class _ShardedTeamFamily(_ShardedBase):
    """The sharded team-family step (team and role sets): per-shard
    admission, formation on gathered columns (``search_step_packed``) or
    on merged frontiers (``search_step_packed_ring``, with
    ``frontier_k``), and each shard evicting its part of the matches."""

    #: Formation columns (gathered whole by the fallback, frontier rows in
    #: the ring; the frontier adds the global-slot row).
    _GATHER: tuple[str, ...] = ("rating", "region", "mode", "threshold",
                                "enqueue_t", "active")
    #: Rows of the packed result past the member slots, spread and limit.
    _extra_rows = 0

    def _family(self, *, capacity: int, team_size: int, mesh,
                frontier_k: int, frontier_merge: str, make) -> None:
        capacity = self._geometry(capacity, mesh)
        if capacity >= (1 << 24):
            raise ValueError(
                f"capacity {capacity} >= 2**24: slot ids must stay f32-exact")
        self.team_size = team_size
        self.need = 2 * team_size
        self._global = make(capacity, None)
        self.max_matches = self._global.max_matches
        self.frontier_k = (min(max(frontier_k, self.need),
                               self.local_capacity)
                           if frontier_k > 0 else 0)
        if frontier_merge not in ("linear", "tournament"):
            raise ValueError(f"unknown frontier_merge {frontier_merge!r} "
                             f"(expected 'linear' or 'tournament')")
        self.frontier_merge = frontier_merge
        self._ring_form = None
        if self.frontier_k:
            rows = (self.frontier_k if frontier_merge == "tournament"
                    else self.n_shards * self.frontier_k)
            self._ring_form = make(rows, self.max_matches)

    def _finish(self, pool, slots: torch.Tensor, rows) -> torch.Tensor:
        self.evict(pool, slots)
        return torch.cat([slots.T.to(torch.float32)]
                         + [r.to(torch.float32)[None, :] for r in rows])

    def search_step_packed(self, pool, packed: torch.Tensor) -> torch.Tensor:
        """The replicated fallback: every shard admits its slice, the
        formation columns of all shards are gathered (O(P)), windows are
        formed once on the whole pool, and each shard evicts its part."""
        self.admit_packed(pool, packed)
        parts = [tuple(lp[f] for f in self._GATHER) for lp in pool.shards]
        gathered = self.mesh.all_gather(parts)
        cols = {f: t.reshape(-1) for f, t in zip(self._GATHER, gathered)}
        slots, rows = self._global.form(cols, packed_now(packed),
                                        self.capacity)
        return self._finish(pool, slots, rows)

    def search_step_packed_ring(self, pool, packed: torch.Tensor
                                ) -> torch.Tensor:
        """The ring step: each shard's (group, rating)-sorted frontier of
        ``frontier_k`` rows, the ring (D − 1 hops of one frontier each),
        formation on the merged frontier, the rows mapped back to global
        slots. Bit-equal to the fallback while no shard holds more than
        ``frontier_k`` active rows (the engine's gate)."""
        self.admit_packed(pool, packed)
        parts = [(pack_frontier(lp, self._GATHER, self.frontier_k, off,
                                self.capacity),)
                 for lp, off, _ in self._locals(pool)]
        (buf,) = self.mesh.ring_all_gather(parts)
        cols, gslot = merge_frontiers(buf, self._GATHER, self.n_shards,
                                      self.frontier_merge)
        g = self._ring_form
        slots_b, rows = g.form(cols, packed_now(packed), g.capacity)
        gs = torch.cat([gslot, gslot.new_full((1,), self.capacity)])
        slots = gs[slots_b.long()]
        out = self._finish(pool, slots, rows)
        return pad_match_columns(out, self.max_matches - g.max_matches,
                                 self.need, self.capacity, self._extra_rows)

    def comms_accounting(self) -> dict:
        return shard_comms_accounting(self)


class ShardedTeamKernelSet(_ShardedTeamFamily):
    """The team step over a sharded pool (config #3 with
    ``mesh_pool_axis`` > 1): ``TeamKernelSet``'s packed surface
    (``search_step_packed``, ``admit_packed``, ``evict``) over a
    ``sharded.ShardedPool``, plus ``search_step_packed_ring`` when
    ``frontier_k`` > 0 (the engine picks it per window while the waiting
    players fit the frontier)."""

    def __init__(self, *, capacity: int, team_size: int,
                 widen_per_sec: float, max_threshold: float, mesh,
                 max_matches: int = 1024, rounds: int = 16,
                 frontier_k: int = 0, frontier_merge: str = "linear"):
        def make(rows, matches):
            return TeamKernelSet(
                capacity=rows, team_size=team_size,
                widen_per_sec=widen_per_sec, max_threshold=max_threshold,
                max_matches=max_matches if matches is None else matches,
                rounds=rounds)

        self._family(capacity=capacity, team_size=team_size, mesh=mesh,
                     frontier_k=frontier_k, frontier_merge=frontier_merge,
                     make=make)


def sharded_team_kernel_set(capacity: int, team_size: int,
                            widen_per_sec: float, max_threshold: float,
                            n_shards: int, max_matches: int = 1024,
                            rounds: int = 16, frontier_k: int = 0,
                            frontier_merge: str = "linear",
                            device_ids: tuple | None = None,
                            device="cuda") -> ShardedTeamKernelSet:
    return ShardedTeamKernelSet(
        capacity=capacity, team_size=team_size, widen_per_sec=widen_per_sec,
        max_threshold=max_threshold,
        mesh=resolve_mesh(n_shards, device_ids, device),
        max_matches=max_matches, rounds=rounds, frontier_k=frontier_k,
        frontier_merge=frontier_merge)
