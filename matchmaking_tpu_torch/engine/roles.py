"""Role-queue party matchmaking (config #5): the host oracle.

The port's copy of ``matchmaking_tpu/engine/roles.py``. Parties of 1-3
players queue as a unit and must land on the same team; each team must
fill the queue's role slots (e.g. tank/healer/dps/dps/dps) from its
members' declared roles. Greedy and deterministic:

1. Sort the waiting units by rating (a unit's rating is its members' mean).
2. Slide a window over the sorted units; within each window (spread ≤
   every unit's effective threshold) pack units into two teams of exactly
   ``team_size`` members (first-fit decreasing by party size — parties are
   atomic).
3. A packing is valid iff each team has a perfect member→role-slot
   assignment (backtracking over ≤ team_size! tiny cases).
4. The first valid window wins; quality = 1 − spread/threshold.

The device role step (engine/role_kernels.py) forms the same matches for
solo players; ``CpuEngine`` (engine/cpu.py) runs this oracle.
"""

from __future__ import annotations

from typing import Sequence

from matchmaking_tpu_torch.config import QueueConfig
from matchmaking_tpu_torch.service.contract import PartyMember, SearchRequest


def unit_rating(req: SearchRequest) -> float:
    total = req.rating + sum(m.rating for m in req.party)
    return total / req.party_size


def _members(req: SearchRequest) -> list[PartyMember]:
    lead = PartyMember(req.id, req.rating, req.rating_deviation, req.roles)
    return [lead, *req.party]


def _roles_cover(team: Sequence[SearchRequest], slots: tuple[str, ...]) -> bool:
    """Perfect assignment members → role slots, by backtracking."""
    members = [m for req in team for m in _members(req)]
    if len(members) != len(slots):
        return False
    # Most-constrained first: fewest eligible members per slot.
    elig = [
        [i for i, m in enumerate(members) if (not m.roles) or slot in m.roles]
        for slot in slots
    ]
    order = sorted(range(len(slots)), key=lambda s: len(elig[s]))
    used = [False] * len(members)

    def assign(k: int) -> bool:
        if k == len(order):
            return True
        for i in elig[order[k]]:
            if not used[i]:
                used[i] = True
                if assign(k + 1):
                    return True
                used[i] = False
        return False

    return assign(0)


def _window_feasible(window: Sequence[SearchRequest],
                     slots: tuple[str, ...]) -> bool:
    """Cheap necessary condition before the pack: for every role, the
    window holds at least 2 × (its slot count) eligible members (members
    without declared roles are eligible for everything). Filters the
    common dps-heavy windows that lack the 2 tanks / 2 healers without a
    failed pack and its swap repair."""
    if not slots:
        return True
    members = [m for u in window for m in _members(u)]
    for role in set(slots):
        needed = 2 * slots.count(role)
        elig = 0
        for m in members:
            if (not m.roles) or role in m.roles:
                elig += 1
                if elig >= needed:
                    break
        if elig < needed:
            return False
    return True


def _pack_two_teams(units: Sequence[SearchRequest], team_size: int,
                    slots: tuple[str, ...]):
    """First-fit-decreasing pack of atomic party units into two exact teams
    with role coverage. Returns (team_a, team_b) or None."""
    order = sorted(units, key=lambda u: (-u.party_size, unit_rating(u)))
    team_a: list[SearchRequest] = []
    team_b: list[SearchRequest] = []
    size_a = size_b = 0
    for u in order:
        if size_a + u.party_size <= team_size:
            team_a.append(u)
            size_a += u.party_size
        elif size_b + u.party_size <= team_size:
            team_b.append(u)
            size_b += u.party_size
    if size_a != team_size or size_b != team_size:
        return None
    if slots and not (_roles_cover(team_a, slots) and _roles_cover(team_b, slots)):
        # One swap-repair pass: exchange equal-size units across the teams.
        for i, ua in enumerate(team_a):
            for j, ub in enumerate(team_b):
                if ua.party_size != ub.party_size:
                    continue
                team_a[i], team_b[j] = ub, ua
                if _roles_cover(team_a, slots) and _roles_cover(team_b, slots):
                    return tuple(team_a), tuple(team_b)
                team_a[i], team_b[j] = ua, ub
        return None
    return tuple(team_a), tuple(team_b)


#: Windows tried per start beyond the minimal member count: an unpackable
#: minimal window almost never packs with many more units, and each
#: extension costs a pack with role backtracking (unbounded, the scan is
#: O(n²) packs per request).
WINDOW_SLACK = 6


def try_party_match(units: Sequence[SearchRequest], queue: QueueConfig,
                    now: float, engine,
                    focus: SearchRequest | None = None,
                    ) -> tuple[tuple[tuple[SearchRequest, ...], ...], float] | None:
    """Try to form one match from waiting party units. Returns (teams,
    quality) or None. ``engine`` provides ``effective_threshold``.

    ``focus``: the arrival-triggered fast path — only windows containing
    this unit are tried. Exact under the greedy invariant (every earlier
    arrival tried its windows, and removals never create matches: the
    caller forces a full scan after one), so callers pass ``focus=None``
    after a restore (a checkpoint can hold latent matches) or with
    threshold widening (old windows can become valid by waiting)."""
    need = 2 * queue.team_size
    total = sum(u.party_size for u in units)
    if total < need:
        return None
    su = sorted(units, key=unit_rating)
    n = len(su)
    if focus is not None:
        fidx = next((i for i, u in enumerate(su) if u.id == focus.id), None)
        if fidx is None:
            return None
        # Windows must include fidx: lo ≤ fidx, and a window holds at most
        # need + WINDOW_SLACK units (every unit carries ≥ 1 member).
        lo_iter = range(max(0, fidx - (need + WINDOW_SLACK) + 1), fidx + 1)
    else:
        fidx = -1
        lo_iter = range(n)
    for lo in lo_iter:
        members = 0
        extra = 0
        for hi in range(lo, n):
            members += su[hi].party_size
            if members < need:
                continue
            # Every completed window counts toward the slack, those ending
            # before the focus included, so the focused scan tries exactly
            # the full scan's windows that contain the focus unit.
            extra += 1
            if extra > WINDOW_SLACK:
                break
            if hi < fidx:
                continue  # tried by an earlier arrival (greedy invariant)
            window = su[lo:hi + 1]
            spread = unit_rating(window[-1]) - unit_rating(window[0])
            # The window must fit every unit's effective threshold.
            thr = min(engine.effective_threshold(u, now) for u in window)
            if spread > thr:
                break
            if not _window_feasible(window, queue.role_slots):
                continue
            packed = _pack_two_teams(window, queue.team_size, queue.role_slots)
            if packed is not None:
                qual = max(0.0, 1.0 - spread / thr) if thr > 0 else 0.0
                return packed, qual
    return None
