"""The host oracle: the reference's sequential matching semantics.

The port's copy of ``matchmaking_tpu/engine/cpu.py``'s ``CpuEngine``. Each
request is processed in turn against the waiting pool: a 1v1 request
takes the nearest-rating compatible candidate within the mutual
threshold; a team or role request joins the pool and then forms at most
one match among the compatible waiting players. It is no backend of its
own here: ``GpuEngine`` hands a team or role queue to it while wildcard
requests (or, on a role queue, parties) wait, since the device steps group
by exact region/mode code and pack solo players only, and the service runs
a queue on it while its circuit breaker is open (``backend="cpu"`` builds
it directly).

Every formed match lands in ``quality_accum`` (engine/quality.py's host
accumulator), one sample per member request, so the matches a delegated
queue formed stay in its engine's ``quality_report`` after re-promotion.
"""

from __future__ import annotations

import heapq
from typing import Sequence

import numpy as np

from matchmaking_tpu_torch.config import Config, QueueConfig
from matchmaking_tpu_torch.engine import scoring
from matchmaking_tpu_torch.engine.interface import Engine, Match, SearchOutcome
from matchmaking_tpu_torch.engine.quality import (
    HostQualityAccum,
    QualitySpec,
    add_arrays,
    build_report,
)
from matchmaking_tpu_torch.engine.roles import try_party_match
from matchmaking_tpu_torch.service.contract import (
    ANY,
    SearchRequest,
    is_wildcard,
    new_match_id,
)


class CpuEngine(Engine):
    def __init__(self, cfg: Config, queue: QueueConfig):
        super().__init__(cfg, queue)
        # Waiting pool: insertion-ordered parallel lists.
        self._entries: list[SearchRequest] = []
        self._by_id: dict[str, int] = {}  # player id -> index in _entries
        #: Waiting players per QoS tier and with a deadline, kept by every
        #: insert and eviction (the O(1) reads admission and the sweep use).
        self._tier_n: dict[int, int] = {}
        self._deadline_n = 0
        #: Match-quality accounting of every match formed here.
        self.quality_accum = HostQualityAccum(
            QualitySpec.from_config(cfg.observability))
        # Role/party fast path (try_party_match's focus): sound only under
        # the greedy invariant; a restore or a removal breaks it, so scans
        # run unfocused until a scan finds nothing.
        self._team_full_scan = False

    # ---- Engine API -------------------------------------------------------

    def search(self, requests: Sequence[SearchRequest], now: float) -> SearchOutcome:
        out = SearchOutcome()
        # Dedupe within the window too: this engine matches on arrival, so
        # a second copy later in the window would re-admit a player the
        # first copy just matched.
        seen: set[str] = set()
        for req in requests:
            if req.id in self._by_id or req.id in seen:
                continue  # idempotent redelivery
            seen.add(req.id)
            if req.party_size > 1 and not self.queue.role_slots:
                # Only role queues (config #5) serve parties; anywhere else
                # they would wait forever.
                out.rejected.append((req, "party_not_supported"))
                continue
            if self.queue.team_size == 1:
                self._search_1v1(req, now, out)
            else:
                self._search_team(req, now, out)
        return out

    def remove(self, player_id: str) -> SearchRequest | None:
        idx = self._by_id.get(player_id)
        if idx is None:
            return None
        return self._evict(idx)

    def pool_size(self) -> int:
        return len(self._entries)

    def deadline_count(self) -> int:
        return self._deadline_n

    def pool_tier_counts(self, n_tiers: int) -> list[int]:
        out = [0] * max(1, n_tiers)
        for t, n in self._tier_n.items():
            out[min(max(t, 0), len(out) - 1)] += n
        return out

    def waiting(self) -> list[SearchRequest]:
        return list(self._entries)

    def has_wildcards(self) -> bool:
        """True if any waiting player has an ANY region or mode: the gate
        of re-promotion to the device step's exact-group semantics."""
        return any(is_wildcard(r) for r in self._entries)

    def has_parties(self) -> bool:
        """True if any waiting unit is a party: the other re-promotion gate
        of role queues (the device role step packs solo units only)."""
        return any(r.party_size > 1 for r in self._entries)

    def restore(self, requests: Sequence[SearchRequest], now: float) -> None:
        for req in requests:
            if req.id not in self._by_id:
                self._insert(req)
        if requests and self.queue.team_size > 1:
            self._team_full_scan = True

    def rescan(self, max_window: int, now: float) -> SearchOutcome:
        """Re-run the sequential search for the longest-waiting players, so
        threshold widening can resolve between pool members. 1v1 only (team
        queues re-form on arrival). The outcome's ``queued`` players were
        already waiting."""
        out = SearchOutcome()
        if self.queue.team_size != 1:
            return out
        oldest = heapq.nsmallest(max_window, self._entries,
                                 key=lambda r: r.enqueued_at)
        for req in oldest:
            idx = self._by_id.get(req.id)
            if idx is None:
                continue  # matched earlier in this rescan
            self._evict(idx)
            self._search_1v1(req, now, out)  # re-inserts on no match
        return out

    # ---- internals --------------------------------------------------------

    def quality_report(self) -> dict:
        """Per-rating-bucket quality/wait report over every match this
        engine formed (engine/quality.build_report)."""
        return build_report(self.quality_accum.arrays,
                            self.quality_accum.spec)

    def quality_checkpoint(self) -> dict:
        """A copy of the accumulator arrays, for a successor engine."""
        return {k: v.copy() for k, v in self.quality_accum.arrays.items()}

    def quality_restore(self, arrays: dict | None) -> None:
        if arrays is not None:
            add_arrays(self.quality_accum.arrays, arrays)

    def _observe_match(self, members, quality: float, spread: float,
                       now: float) -> None:
        """Fold one formed match into the quality accumulator: one sample
        per member request unit (its leader's rating; a party counts
        once), with its wait at ``now``."""
        self.quality_accum.observe(
            rating=[m.rating for m in members],
            quality=quality,
            wait_s=[(max(0.0, now - m.enqueued_at) if m.enqueued_at else 0.0)
                    for m in members],
            spread=spread)

    def _insert(self, req: SearchRequest) -> None:
        self._by_id[req.id] = len(self._entries)
        self._entries.append(req)
        self._tier_n[req.tier] = self._tier_n.get(req.tier, 0) + 1
        if req.deadline_at:
            self._deadline_n += 1

    def _evict(self, idx: int) -> SearchRequest:
        """Remove entry idx; swap-with-last keeps removal O(1) (scan order
        is then not FIFO: ties go to the nearest distance, then the lowest
        index)."""
        req = self._entries[idx]
        last = self._entries.pop()
        del self._by_id[req.id]
        self._tier_n[req.tier] = self._tier_n.get(req.tier, 0) - 1
        if req.deadline_at:
            self._deadline_n -= 1
        if idx < len(self._entries):
            self._entries[idx] = last
            self._by_id[last.id] = idx
        # Role queues: any removal can make a match among the remaining
        # units (it joins a rating-sorted span, or frees role slots), and
        # the focused scan only tries windows holding the newest arrival:
        # force one full scan.
        if self.queue.role_slots and self.queue.team_size > 1:
            self._team_full_scan = True
        return req

    def _compatible(self, a: SearchRequest, b: SearchRequest) -> bool:
        return scoring.region_mode_compatible(a.region, a.game_mode,
                                              b.region, b.game_mode)

    def _compat_groups(self, entries: list[SearchRequest]):
        """Partition candidates into pairwise region/mode-compatible groups.

        Compatibility with wildcards is not transitive (eu—*—na), so each
        group is keyed by a concrete (region, mode) present in the pool, and
        a member must equal the key or be a wildcard on each axis: every
        pair inside a group is compatible. Wildcard players appear in
        several groups; the first group (keys sorted) that matches wins."""
        keys = sorted({(e.region, e.game_mode) for e in entries})
        for key_r, key_m in keys:
            members = [
                e for e in entries
                if e.region in (key_r, ANY) and e.game_mode in (key_m, ANY)
            ]
            yield (key_r, key_m), members

    def _search_1v1(self, req: SearchRequest, now: float, out: SearchOutcome) -> None:
        thr_req = self.effective_threshold(req, now)
        best_idx, best_dist = -1, np.inf
        for idx, cand in enumerate(self._entries):
            if not self._compatible(req, cand):
                continue
            d = scoring.distance(
                req.rating, cand.rating, req.rating_deviation,
                cand.rating_deviation, glicko2=self.queue.glicko2)
            limit = scoring.mutual_threshold(
                thr_req, self.effective_threshold(cand, now))
            if d <= limit and d < best_dist:
                best_idx, best_dist = idx, d
        if best_idx >= 0:
            cand = self._evict(best_idx)
            q = scoring.quality(best_dist, self.effective_threshold(req, now),
                                self.effective_threshold(cand, now))
            out.matches.append(
                Match(match_id=new_match_id(), teams=((req,), (cand,)), quality=q))
            self._observe_match((req, cand), q, float(best_dist), now)
        else:
            self._insert(req)
            out.queued.append(req)

    def _search_team(self, req: SearchRequest, now: float, out: SearchOutcome) -> None:
        """Team queues (configs #3/#5): insert, then form at most one full
        match among compatible waiting players. Plain team queues take the
        tightest valid rating window (``_try_team_window``); role queues
        the role/party oracle (engine/roles.py), one compatible group at a
        time."""
        self._insert(req)
        if self.queue.role_slots:
            # Focused (windows holding the arrival) while the greedy
            # invariant holds; full scans after restore() or a removal, and
            # with widening (old windows can become valid by waiting).
            use_focus = (self.queue.widen_per_sec <= 0.0
                         and not self._team_full_scan)
            matched_here = False
            for _, members in self._compat_groups(list(self._entries)):
                if use_focus and all(m.id != req.id for m in members):
                    continue  # no new unit: no new match
                formed = try_party_match(members, self.queue, now, self,
                                         focus=req if use_focus else None)
                if formed is not None:
                    teams, qual = formed
                    for r in (r for team in teams for r in team):
                        self._evict(self._by_id[r.id])
                    out.matches.append(Match(new_match_id(), teams, qual))
                    self._observe_match(
                        tuple(r for team in teams for r in team), qual, 0.0,
                        now)
                    matched_here = True
                    break
            if self._team_full_scan and not matched_here:
                # Quiescent: the pool holds no latent match; the greedy
                # invariant holds again.
                self._team_full_scan = False
        else:
            solos = [e for e in self._entries if e.party_size == 1]
            for _, members in self._compat_groups(solos):
                formed = self._try_team_window(members, now)
                if formed is not None:
                    teams, spread, thr = formed
                    for p in (p for t in teams for p in t):
                        self._evict(self._by_id[p.id])
                    qual = max(0.0, 1.0 - spread / thr) if thr > 0 else 0.0
                    out.matches.append(Match(new_match_id(), teams, qual))
                    self._observe_match(tuple(p for t in teams for p in t),
                                        qual, spread, now)
                    break
        if req.id in self._by_id:  # not in the formed match: it waits
            out.queued.append(req)

    def _try_team_window(self, members: list[SearchRequest], now: float):
        """The tightest valid 2×team_size rating window among ``members``
        → (teams, spread, thr), or None.

        A window is valid iff its spread fits every member's effective
        threshold. The team-sum constraint of config #3 (|sum_A − sum_B| ≤
        threshold) then holds by construction under the snake split
        (``scoring.snake_signs``). Glicko-2 weighting applies to 1v1
        distances only: a team spread is a plain rating range."""
        need = 2 * self.queue.team_size
        if len(members) < need:
            return None
        ratings = np.array([e.rating for e in members])
        thrs = np.array([self.effective_threshold(e, now) for e in members])
        order = np.argsort(ratings, kind="stable")
        sorted_ratings = ratings[order]
        sorted_thrs = thrs[order]
        n_win = len(sorted_ratings) - need + 1
        spreads = sorted_ratings[need - 1:] - sorted_ratings[:n_win]
        win_thr = np.array([sorted_thrs[w:w + need].min() for w in range(n_win)])
        valid = spreads <= win_thr
        if not valid.any():
            return None
        # The tightest valid window wins (ties: the lowest start).
        w = int(np.argmin(np.where(valid, spreads, np.inf)))
        spread = float(spreads[w])
        thr = float(win_thr[w])
        players = [members[int(order[w + j])] for j in range(need)]
        team_a, team_b = scoring.snake_split(players)
        return (team_a, team_b), spread, thr
