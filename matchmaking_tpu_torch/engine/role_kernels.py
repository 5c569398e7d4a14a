"""The role-queue window step for solo players (config #5) in PyTorch.

Port of ``matchmaking_tpu/engine/role_kernels.py``'s single-card
``RoleKernelSet``. Parties (and region/mode wildcards) go to the host
oracle (engine/roles.py): ``GpuEngine._maybe_delegate_team`` hands the
queue over while they wait. For solo players the oracle's window slide
reduces to this (derived in the JAX module's docstring):

- every unit has size 1, so the first-fit-decreasing pack of a
  rating-sorted window puts the k lowest-rated members on team A and the
  next k on team B, and a window larger than ``need = 2k`` packs the same
  members with a larger spread: only windows of exactly ``need`` members
  can win, tried by start, leftmost first;
- a window is valid iff its spread fits every member's effective threshold
  and the base split, or the first swap-repair exchange in the oracle's
  (i, j) order, gives both teams a perfect member→role-slot assignment;
- a perfect assignment of k members to k slots is Hall's condition over
  the distinct roles: for every nonempty subset S of them, the members
  eligible for some role in S number ≥ the slots of S.

The pool gains one column, ``role_mask`` (i32: bit r ⇔ the member can
play distinct role r; a member without declared roles carries every bit),
and the packed window one row for it, before ``now``.

The Hall check is one pass over all 1 + k² splits of every window: each
member's eligibility per role subset is a lookup in a constant
(2^d, 2^d − 1) table, a constant (1 + k², 2k) index tensor gathers each
split's teams, and a sum compares with the demand vector; the first split
that passes (by the oracle's priority) is an ``argmin``. At P = 16,384,
k = 5 and three distinct roles the gathered tensor is ~30 MB of int8.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from matchmaking_tpu_torch.core.pool import PACKED_ROWS
from matchmaking_tpu_torch.engine.kernels import (
    ADMIT_FIELDS,
    admit,
    evict,
    packed_now,
    unpack_batch,
)
from matchmaking_tpu_torch.engine.teams import (
    BIG_I32,
    INF,
    TeamKernelSet,
    extract_windows,
    sorted_group_order,
)


class RoleKernelSet(TeamKernelSet):
    """The solo role-queue step. ``search_step`` returns (slots i32[M,
    need], spread f32[M], limit f32[M], split i32[M]); split bit i set ⇔
    the i-th window member (rating order) is on team A. The packed step
    takes f32[10, B] (``PACKED_ROWS``, ``role_mask``, now) and returns
    f32[need + 3, M] (slots, spread, limit, split)."""

    is_role = True
    extra_pool_fields = {"role_mask": np.int32}
    pack_rows = len(PACKED_ROWS) + 2
    admit_fields = (*ADMIT_FIELDS, "role_mask")

    def __init__(self, *, capacity: int, team_size: int,
                 role_slots: tuple[str, ...], widen_per_sec: float,
                 max_threshold: float, max_matches: int = 1024,
                 rounds: int = 16):
        if not role_slots or len(role_slots) != team_size:
            raise ValueError("role_slots must name one role per team member")
        super().__init__(capacity=capacity, team_size=team_size,
                         widen_per_sec=widen_per_sec,
                         max_threshold=max_threshold,
                         max_matches=max_matches, rounds=rounds)
        # Distinct roles in sorted order → bit index (deterministic).
        self.distinct = tuple(sorted(set(role_slots)))
        self._bit = {r: i for i, r in enumerate(self.distinct)}
        d = len(self.distinct)
        self.full_mask = (1 << d) - 1
        subsets = range(1, 1 << d)
        # Slot demand of one team per role subset.
        self._demand = np.array(
            [sum(1 for r in role_slots if (1 << self._bit[r]) & s)
             for s in subsets], np.int32)
        # elig[m, s]: a member with mask m can play some role of subset s.
        self._elig = np.array([[(m & s) != 0 for s in subsets]
                               for m in range(1 << d)], np.int8)
        # The oracle's split order: the base split (the k lowest → A), then
        # each swap of member i of A with member j of B, (i, j) ascending.
        k = team_size
        base_a, base_b = list(range(k)), list(range(k, 2 * k))
        members, bits = [base_a + base_b], [(1 << k) - 1]
        for i in range(k):
            for j in range(k):
                a, b = list(base_a), list(base_b)
                a[i], b[j] = k + j, i
                members.append(a + b)
                bits.append(((1 << k) - 1) ^ (1 << i) | (1 << (k + j)))
        self._split_members = np.array(members, np.int64)   # (1 + k², 2k)
        self._split_bits = np.array(bits, np.int32)
        self._consts: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    # ---- host helpers -------------------------------------------------------

    def mask_of(self, roles: tuple[str, ...]) -> int:
        """Member roles → eligibility bitmask (the oracle's rule: no
        declared roles ⇒ every slot; roles the queue does not use add no
        bit)."""
        if not roles:
            return self.full_mask
        m = 0
        for r in roles:
            b = self._bit.get(r)
            if b is not None:
                m |= 1 << b
        return m

    # ---- pool I/O -----------------------------------------------------------

    def unpack(self, packed: torch.Tensor) -> dict[str, torch.Tensor]:
        batch = unpack_batch(packed)
        batch["role_mask"] = packed[len(PACKED_ROWS)].to(torch.int32)
        return batch

    # ---- the step -----------------------------------------------------------

    def _device_consts(self, dev: torch.device):
        """The constant tables on ``dev``, copied there once (the first
        step on a device pays one host→device copy of a few hundred
        bytes)."""
        c = self._consts.get(dev)
        if c is None:
            c = tuple(torch.from_numpy(a).to(dev) for a in (
                self._elig, self._split_members, self._demand,
                self._split_bits,
                np.arange(len(self._split_bits), dtype=np.int32)))
            self._consts[dev] = c
        return c

    def _cover_split(self, member_masks: torch.Tensor):
        """The oracle's pack order over each window's ``need`` rating-sorted
        members: the base split, then the swap repairs; the first split whose
        both teams pass Hall's condition wins. ``member_masks`` i32[n_win,
        need] → (ok bool[n_win], split i32[n_win]: bit i ⇔ member i on
        team A; 0 where no split passes)."""
        elig, split_members, demand, split_bits, prio = self._device_consts(
            member_masks.device)
        n_win = member_masks.shape[0]
        k = self.team_size
        # Per member and role subset: eligible (0/1), then gathered per
        # split: (n_win, 1 + k², 2k, subsets).
        per_member = elig[(member_masks & self.full_mask).long()]
        per_split = per_member[:, split_members]
        counts = per_split.view(n_win, len(prio), 2, k, -1).sum(
            3, dtype=torch.int32)
        ok_m = (counts >= demand).all(3).all(2)            # (n_win, 1 + k²)
        first = torch.where(ok_m, prio, BIG_I32).argmin(1)
        ok = ok_m.any(1)
        return ok, torch.where(ok, split_bits[first], 0)

    def _windows_roles(self, pool, order, group, now: torch.Tensor):
        """Team-window validity and the role cover/split term."""
        valid, spread, win_thr = self._windows(pool, order, group, now)
        member_masks = pool["role_mask"][order].unfold(0, self.need, 1)
        cover_ok, split = self._cover_split(member_masks)
        return valid & cover_ok, spread, win_thr, split

    def search_step(self, pool, batch: dict[str, torch.Tensor],
                    now: torch.Tensor):
        admit(pool, batch, self.admit_fields)
        order, group = sorted_group_order(pool)
        valid, spread, win_thr, split = self._windows_roles(
            pool, order, group, now)
        won = self._select_windows(valid)  # leftmost first
        slots, is_match, w = extract_windows(won, self.need, self.max_matches,
                                             order, self.capacity)
        evict(pool, slots.reshape(-1))
        return (slots, torch.where(is_match, spread[w], INF),
                torch.where(is_match, win_thr[w], 0.0),
                torch.where(is_match, split[w], 0))

    def search_step_packed(self, pool, packed: torch.Tensor):
        slots, spread, limit, split = self.search_step(
            pool, self.unpack(packed), packed_now(packed))
        return torch.cat([slots.T.to(torch.float32), spread[None, :],
                          limit[None, :], split.to(torch.float32)[None, :]])


@functools.lru_cache(maxsize=None)
def role_kernel_set(capacity: int, team_size: int,
                    role_slots: tuple[str, ...], widen_per_sec: float,
                    max_threshold: float, max_matches: int = 1024,
                    rounds: int = 16) -> RoleKernelSet:
    return RoleKernelSet(capacity=capacity, team_size=team_size,
                         role_slots=role_slots, widen_per_sec=widen_per_sec,
                         max_threshold=max_threshold,
                         max_matches=max_matches, rounds=rounds)
