"""The ``Engine`` seam of the port.

One engine serves one matchmaking queue. Semantics contract:

- ``search(requests, now)`` processes a window of new requests against the
  waiting pool and reports which players matched (including players
  already waiting) and which new requests were queued;
- a matched player leaves the pool before the next window; no player is
  ever in two matches;
- unmatched requests join the pool and may match in any later window.

``make_engine`` is the backend selection point: ``"gpu"`` (engine/gpu.py)
for 1v1, team and role queues, which runs on the card unless the caller
asks for the CPU with ``device="cpu"``, and ``"cpu"``, the host oracle
(engine/cpu.py). The oracle also serves a team or role queue while
wildcards or parties wait, and any queue whose circuit breaker is open
(service/breaker.py).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from matchmaking_tpu_torch.config import Config, QueueConfig
from matchmaking_tpu_torch.service.contract import MatchResult, SearchRequest


@dataclass(frozen=True)
class Match:
    """One formed match: teams of original requests."""

    match_id: str
    teams: tuple[tuple[SearchRequest, ...], ...]
    quality: float = 1.0

    def result(self) -> MatchResult:
        return MatchResult(
            match_id=self.match_id,
            players=tuple(pid for team in self.teams for req in team
                          for pid in req.all_ids()),
            teams=tuple(tuple(pid for req in team for pid in req.all_ids())
                        for team in self.teams),
            quality=self.quality,
        )

    def requests(self) -> tuple[SearchRequest, ...]:
        return tuple(req for team in self.teams for req in team)


@dataclass
class SearchOutcome:
    matches: list[Match] = field(default_factory=list)
    #: New requests inserted into the waiting pool this window.
    queued: list[SearchRequest] = field(default_factory=list)
    #: Requests the engine cannot serve (reason code, e.g. "pool_full").
    rejected: list[tuple[SearchRequest, str]] = field(default_factory=list)


@dataclass
class ColumnarOutcome:
    """A 1v1 window's outcome as parallel numpy arrays (the columnar path's
    twin of ``SearchOutcome``). Matched pairs are row-aligned across the
    ``m_*`` arrays; every string column is dtype=object."""

    m_id_a: "np.ndarray"      # object[M] player ids, side A
    m_id_b: "np.ndarray"      # object[M] player ids, side B
    m_match_id: "np.ndarray"  # object[M]
    m_dist: "np.ndarray"      # f32[M] rating distance
    m_quality: "np.ndarray"   # f32[M]
    m_reply_a: "np.ndarray"   # object[M] reply queues (may be "")
    m_reply_b: "np.ndarray"
    m_corr_a: "np.ndarray"    # object[M] correlation ids
    m_corr_b: "np.ndarray"
    m_enq_a: "np.ndarray"     # f64[M] enqueue wall-clock
    m_enq_b: "np.ndarray"
    q_ids: "np.ndarray"       # object[Q] newly queued player ids
    #: (player_id, reason_code) pairs the engine refused.
    rejected: list[tuple[str, str]] = field(default_factory=list)
    #: Wait-at-match per side (seconds): the window's dispatch time minus
    #: the enqueue time (0 where unstamped) — the ``waited_ms`` field.
    m_wait_a: "np.ndarray" = field(
        default_factory=lambda: np.empty(0, np.float64))
    m_wait_b: "np.ndarray" = field(
        default_factory=lambda: np.empty(0, np.float64))
    #: QoS tier per matched side (pool mirror column; zeros untiered).
    m_tier_a: "np.ndarray" = field(
        default_factory=lambda: np.empty(0, np.int32))
    m_tier_b: "np.ndarray" = field(
        default_factory=lambda: np.empty(0, np.int32))

    @property
    def n_matches(self) -> int:
        return len(self.m_id_a)


def empty_columnar_outcome() -> ColumnarOutcome:
    e = np.empty(0, object)
    z = np.empty(0, np.float32)
    t = np.empty(0, np.float64)
    i = np.empty(0, np.int32)
    return ColumnarOutcome(m_id_a=e, m_id_b=e, m_match_id=e, m_dist=z,
                           m_quality=z, m_reply_a=e, m_reply_b=e, m_corr_a=e,
                           m_corr_b=e, m_enq_a=t, m_enq_b=t, q_ids=e,
                           m_wait_a=t.copy(), m_wait_b=t.copy(),
                           m_tier_a=i.copy(), m_tier_b=i.copy())


class Engine(abc.ABC):
    """Pluggable matching engine for a single queue."""

    def __init__(self, cfg: Config, queue: QueueConfig):
        self.cfg = cfg
        self.queue = queue

    @abc.abstractmethod
    def search(self, requests: Sequence[SearchRequest], now: float) -> SearchOutcome:
        """Match a window of new requests against the waiting pool."""

    @abc.abstractmethod
    def remove(self, player_id: str) -> SearchRequest | None:
        """Cancel: evict a waiting player (returns their request, or None)."""

    def remove_many(self, player_ids: Sequence[str]) -> list[SearchRequest]:
        """Evict the named waiting players (absent ids are skipped) and
        return their requests in the order named. Default: ``remove`` of
        each in turn."""
        out = [self.remove(pid) for pid in player_ids]
        return [r for r in out if r is not None]

    @abc.abstractmethod
    def pool_size(self) -> int:
        """Number of requests currently waiting."""

    @abc.abstractmethod
    def waiting(self) -> list[SearchRequest]:
        """Snapshot of the waiting pool (checkpoint payload)."""

    @abc.abstractmethod
    def restore(self, requests: Sequence[SearchRequest], now: float) -> None:
        """Rebuild pool state from a checkpoint: re-admit WITHOUT matching."""

    def warmup(self) -> None:
        """Prepare every device path the serving path can reach (nothing
        for a host engine)."""

    def heartbeat(self, now: float) -> bool:
        """The health timer's tick; True when it changed the engine's
        state. Default: nothing to do."""
        return False

    def close(self) -> None:
        """Release what the engine holds (a device engine: its pools,
        graphs and staging buffers) when it is replaced; it is not used
        again. Default: nothing to release."""

    def probe(self) -> None:
        """One end-to-end no-op step that proves the engine healthy (the
        circuit breaker's half-open probe); raises if it is not. Default:
        a host engine has no device path to check."""

    def pool_tier_counts(self, n_tiers: int) -> list[int] | None:
        """Waiting players per QoS tier (``n_tiers`` entries, out-of-range
        tiers in the last), or None when the engine does not track them
        (admission then counts every waiting player against every tier).
        O(n_tiers): both engines keep the counts as players come and go."""
        return None

    def waiting_qos(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, tiers, enqueue times) of the waiting players in
        ``waiting()`` order: what the service's ``shed_policy="oldest"``
        debt pick sorts. Default: read from ``waiting()``."""
        waiting = self.waiting()
        n = len(waiting)
        return (np.fromiter((r.id for r in waiting), object, n),
                np.fromiter((r.tier for r in waiting), np.int32, n),
                np.fromiter((r.enqueued_at for r in waiting), np.float64, n))

    def expire(self, now: float, timeout: float) -> list[SearchRequest]:
        """Evict every waiting request older than ``timeout`` (enqueue time
        0.0 means unstamped and never expires) and return them. Default:
        a scan of ``waiting()``, fine for the host oracle's small pools;
        ``GpuEngine`` sweeps its mirror's columns instead."""
        return self._remove_all([r for r in self.waiting()
                                 if r.enqueued_at
                                 and now - r.enqueued_at > timeout])

    def expire_deadlines(self, now: float) -> list[SearchRequest]:
        """Evict every waiting request whose ``deadline_at`` (0.0 = none)
        has passed and return them. Default: a scan of ``waiting()``."""
        return self._remove_all([r for r in self.waiting()
                                 if r.deadline_at and now >= r.deadline_at])

    def _remove_all(self, expired: list[SearchRequest]) -> list[SearchRequest]:
        out: list[SearchRequest] = []
        for req in expired:
            removed = self.remove(req.id)
            if removed is not None:
                out.append(removed)
        return out

    def quality_report(self) -> dict | None:
        """Match-quality and fairness accounting (engine/quality.
        build_report): per-rating-bucket quality/wait histograms, means and
        disparity gaps over every match this engine formed; None when the
        engine tracks none. A read of host counters, with no device sync."""
        return None

    def quality_checkpoint(self) -> dict | None:
        """The quality accumulator's arrays, to hand to a successor engine
        (a revive), so the counters stay monotone; None when none is
        tracked."""
        return None

    def quality_restore(self, arrays: dict | None) -> None:
        """Fold a predecessor engine's ``quality_checkpoint`` into this
        engine's accounting. Default: nothing tracked."""

    # ---- speculative formation ---------------------------------------------
    # The seam of speculation (engine/gpu.py): a formation window computed
    # in the gap between cuts, validated at the cut against the pool's
    # mutation clock, then committed or discarded. Engines without a
    # speculation path (the host oracle) keep these no-ops, so both sides
    # of a comparison can call the same methods.

    def speculate(self, now: float) -> bool:
        """Compute a speculative formation window over the current pool
        without changing it; True when one is held. Default: none."""
        return False

    def spec_validate(self, now: float, max_age_s: float = 0.0) -> int | None:
        """The held speculation's token if the pool is unchanged since it
        was taken (and it is at most ``max_age_s`` old, when > 0), else
        discard it and return None. Default: nothing held."""
        return None

    def spec_commit(self, token: int | None, now: float) -> int | None:
        """Commit the speculation ``spec_validate`` just validated, as a
        window collected as any other; returns its token, or None when
        nothing was held. Default: nothing to commit."""
        return None

    def spec_invalidate(self, reason: str = "external") -> None:
        """Discard any held speculation. Default: nothing held."""

    def spec_report(self) -> dict | None:
        """Speculation counts, or None without a speculation path."""
        return None

    def frontier_snapshot(self) -> dict | None:
        """The bucket frontier's width in use and move count, or None
        without a frontier ladder."""
        return None

    def effective_threshold(self, req: SearchRequest, now: float) -> float:
        """The request's ``rating_threshold`` (or the queue default) plus
        config-gated widening by wait time."""
        base = (req.rating_threshold if req.rating_threshold is not None
                else self.queue.rating_threshold)
        if self.queue.widen_per_sec <= 0.0:
            return base
        waited = max(0.0, now - req.enqueued_at)
        return min(self.queue.max_threshold,
                   base + self.queue.widen_per_sec * waited)


def make_engine(cfg: Config, queue: QueueConfig, device=None,
                devices=None) -> Engine:
    """Engine factory. ``backend="gpu"`` builds a ``GpuEngine`` on
    ``device`` (default ``"cuda"``; raises when CUDA is absent — pass
    ``device="cpu"`` explicitly to run the plain versions on the CPU),
    its pool on ``devices`` where given (one entry per shard, or one
    device for an unsharded pool); ``backend="cpu"`` builds the host
    oracle ``CpuEngine`` (``device`` and ``devices`` are not read)."""
    if cfg.engine.backend == "cpu":
        from matchmaking_tpu_torch.engine.cpu import CpuEngine

        return CpuEngine(cfg, queue)
    if cfg.engine.backend == "gpu":
        from matchmaking_tpu_torch.engine.gpu import GpuEngine

        return GpuEngine(cfg, queue, device=device, devices=devices)
    raise ValueError(
        f"unknown engine backend {cfg.engine.backend!r} (this package serves "
        f"'gpu' and 'cpu'; load the repository's configs with "
        f"Config.from_json(path, backend='gpu'))")
