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
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from matchmaking_tpu_torch.core.pool import PACKED_ROWS
from matchmaking_tpu_torch.engine.cuda_kernels import effective_threshold
from matchmaking_tpu_torch.engine.kernels import (
    ADMIT_FIELDS,
    admit,
    evict,
    packed_now,
    unpack_batch,
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

    def search_step(self, pool, batch: dict[str, torch.Tensor],
                    now: torch.Tensor):
        """One team window: admit → form → evict, the pool updated in
        place, at the window's time ``now`` (a one-element f32 tensor on
        the pool's device). Returns (slots i32[M, need], spread f32[M],
        limit f32[M])."""
        admit(pool, batch, self.admit_fields)
        order, group = sorted_group_order(pool)
        valid, spread, win_thr = self._windows(pool, order, group, now)
        won = self._select_windows(valid, spread)
        slots, is_match, w = extract_windows(won, self.need, self.max_matches,
                                             order, self.capacity)
        evict(pool, slots.reshape(-1))
        return (slots, torch.where(is_match, spread[w], INF),
                torch.where(is_match, win_thr[w], 0.0))

    def search_step_packed(self, pool, packed: torch.Tensor):
        """Packed step: f32[pack_rows, B] in (``now`` read on the device from
        its last row: ``packed_now``), f32[need + 2, M] out: member slots
        (f32-exact), spread, limit."""
        slots, spread, limit = self.search_step(pool, self.unpack(packed),
                                                packed_now(packed))
        return torch.cat([slots.T.to(torch.float32), spread[None, :],
                          limit[None, :]])


@functools.lru_cache(maxsize=None)
def team_kernel_set(capacity: int, team_size: int, widen_per_sec: float,
                    max_threshold: float, max_matches: int = 1024,
                    rounds: int = 16) -> TeamKernelSet:
    return TeamKernelSet(capacity=capacity, team_size=team_size,
                         widen_per_sec=widen_per_sec,
                         max_threshold=max_threshold,
                         max_matches=max_matches, rounds=rounds)
