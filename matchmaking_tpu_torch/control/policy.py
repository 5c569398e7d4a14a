"""Placement policies: the seam + the greedy burn-to-idle implementation.

The policy is a PURE function of ``(bindings, signal view, now)`` — no RNG,
no clock reads, no device access — so the seeded simulation replays
decision traces bit-identically and the unit tests assert exact decisions.
``GreedyPolicy`` ships first (move the hottest-burning queue to the idlest
device; promote a hot, busy, solo 1v1 queue to D+1 chips; demote a cold
sharded queue to D-1).  MIPS's search over placements (Monte-Carlo tree
search on a simulated objective) is the intended drop-in successor: it
implements the same :class:`PlacementPolicy.plan` contract against the
same :class:`SignalView`.

Signals come from what the service already exports (utils/timeseries ring
+ SLO monitors):

- ``burning`` — any of the queue's burn monitors (aggregate, per-tier
  ``queue@tN``, ``queue#quality``) is in the burning state;
- ``idle_frac`` — the queue's device idle fraction over the last telemetry
  window (``idle_frac[q]``);
- ``occupancy`` — effective device occupancy (valid/padded lanes);
- ``p99_ms`` — the queue's end-to-end stage p99;
- ``pool`` — waiting-pool size.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from matchmaking_tpu_torch.config import PlacementConfig
from matchmaking_tpu_torch.control.state import (
    DEMOTE,
    MIGRATE,
    PROMOTE,
    PlacementState,
    STABLE,
)


@dataclasses.dataclass(frozen=True)
class QueueSignals:
    """One queue's policy inputs at a tick (missing series read as the
    neutral value: not burning, fully idle, empty)."""

    burning: bool = False
    idle_frac: float = 1.0
    occupancy: float = 0.0
    p99_ms: float = 0.0
    pool: int = 0
    #: The queue's engine is degraded (breaker open / host oracle) — the
    #: policy must not touch it: its device binding is not what serves.
    degraded: bool = False
    #: Elastic sharding is available for this queue (device 1v1 path —
    #: team/role queues migrate whole-device only).
    shardable: bool = False

    def to_dict(self) -> dict[str, Any]:
        return {
            "burning": self.burning,
            "idle_frac": round(self.idle_frac, 4),
            "occupancy": round(self.occupancy, 4),
            "p99_ms": round(self.p99_ms, 3),
            "pool": self.pool,
            "degraded": self.degraded,
            "shardable": self.shardable,
        }


@dataclasses.dataclass(frozen=True)
class SignalView:
    """The full per-queue signal map one tick plans against."""

    queues: dict[str, QueueSignals]

    def of(self, queue: str) -> QueueSignals:
        return self.queues.get(queue, QueueSignals())


@dataclasses.dataclass(frozen=True)
class Action:
    """One planned placement action (state.begin consumes it)."""

    kind: str                   # migrate | promote | demote
    queue: str
    devices: tuple[int, ...]
    #: Signal rows quoted in the audit record.
    signals: dict[str, Any]
    reason: str


class PlacementPolicy:
    """The policy seam: rank actions for one tick.  Implementations must
    be pure (same inputs → same plan) and side-effect-free — the
    controller owns execution, cooldowns are data in the bindings."""

    def plan(self, state: PlacementState, view: SignalView,
             now: float) -> list[Action]:
        raise NotImplementedError


class GreedyPolicy(PlacementPolicy):
    """Burn-to-idle: one action per tick, hottest queue first.

    Ordering inside a tick (first match wins — the controller executes at
    most one action per tick so migrations never race each other):

    1. DEMOTE a cold sharded queue (cheapest capacity to give back);
    2. MIGRATE the hottest hot queue to the idlest cold device;
    3. PROMOTE a hot, busy, solo 1v1 queue to one more chip.

    Determinism: candidates are sorted by (score, name) with explicit
    tie-breaks; device choices take the lowest-numbered qualifying id.
    """

    def __init__(self, cfg: PlacementConfig):
        self.cfg = cfg

    # ---- helpers -----------------------------------------------------------

    def _device_idle(self, state: PlacementState, view: SignalView,
                     device: int) -> float:
        """A device's idle estimate: the min idle fraction of the queues
        bound to it (1.0 when unbound) — conservative: a device is only as
        idle as its busiest tenant."""
        queues = state.queues_on(device)
        if not queues:
            return 1.0
        return min(view.of(q).idle_frac for q in queues)

    def _hot(self, sig: QueueSignals) -> bool:
        return (not sig.degraded
                and (sig.burning or sig.idle_frac < self.cfg.hot_idle_below))

    def _eligible(self, state: PlacementState, queue: str,
                  now: float) -> bool:
        p = state.placement(queue)
        if p.status != STABLE:
            return False
        return now - p.last_action_t >= self.cfg.cooldown_s

    # ---- the plan ----------------------------------------------------------

    def plan(self, state: PlacementState, view: SignalView,
             now: float) -> list[Action]:
        actions: list[Action] = []
        placements = state.placements()

        # 1. Demote cold sharded queues (release chips before shuffling).
        for queue in sorted(placements):
            p = placements[queue]
            sig = view.of(queue)
            if (p.shard > 1 and not sig.degraded and not sig.burning
                    and sig.idle_frac > self.cfg.demote_idle_above
                    and self._eligible(state, queue, now)):
                actions.append(Action(
                    kind=DEMOTE, queue=queue, devices=p.devices[:-1],
                    signals={queue: sig.to_dict()},
                    reason=f"idle_frac {sig.idle_frac:.2f} > "
                           f"{self.cfg.demote_idle_above:.2f} at D={p.shard}"))
        if actions:
            return actions

        # Hot queues, hottest first: burning beats merely-busy, then by
        # ascending idle fraction, then name (the deterministic tiebreak).
        hot = sorted(
            (q for q in placements if self._hot(view.of(q))
             and self._eligible(state, q, now)),
            key=lambda q: (not view.of(q).burning, view.of(q).idle_frac, q))

        # 2. Migrate the hottest queue to the idlest cold device.
        for queue in hot:
            p = placements[queue]
            if p.shard != 1:
                continue  # sharded queues scale by demote, not by moving
            src_dev = p.devices[0]
            if len(state.queues_on(src_dev)) <= 1:
                # Alone on its device: moving to another empty chip gains
                # nothing — only promotion (below) adds capacity.
                continue
            src_idle = self._device_idle(state, view, src_dev)
            best: tuple[float, int] | None = None
            for d in range(state.n_devices):
                if d == src_dev:
                    continue
                if any(self._hot(view.of(q)) for q in state.queues_on(d)):
                    continue  # never co-locate two hot queues
                idle = self._device_idle(state, view, d)
                if idle < self.cfg.cold_idle_above:
                    continue
                if idle - src_idle < self.cfg.min_idle_gain:
                    continue
                # Prefer idler targets; among equals the lowest id wins.
                if best is None or (-idle, d) < best:
                    best = (-idle, d)
            if best is not None:
                target = best[1]
                sig = view.of(queue)
                actions.append(Action(
                    kind=MIGRATE, queue=queue, devices=(target,),
                    signals={
                        queue: sig.to_dict(),
                        "src_device": src_dev,
                        "src_device_idle": round(src_idle, 4),
                        "dst_device": target,
                        "dst_device_idle": round(-best[0], 4),
                    },
                    reason=("slo burning" if sig.burning else
                            f"idle_frac {sig.idle_frac:.2f} < "
                            f"{self.cfg.hot_idle_below:.2f}")
                           + f" → device {target}"))
                return actions

        # 3. Promote a hot, busy queue that is ALONE on its device and
        #    still under the shard cap, onto the idlest free device(s).
        if self.cfg.max_shard > 1:
            free = state.free_devices()
            for queue in hot:
                p = placements[queue]
                sig = view.of(queue)
                if not sig.shardable:
                    continue
                if p.shard >= self.cfg.max_shard or not free:
                    continue
                if sig.occupancy < self.cfg.promote_occupancy:
                    continue
                if any(state.queues_on(d) != [queue] for d in p.devices):
                    continue  # co-located: migrate first, don't fan out
                target = p.devices + (free[0],)
                actions.append(Action(
                    kind=PROMOTE, queue=queue, devices=target,
                    signals={queue: sig.to_dict(),
                             "free_devices": list(free)},
                    reason=f"occupancy {sig.occupancy:.2f} >= "
                           f"{self.cfg.promote_occupancy:.2f} → D={len(target)}"))
                return actions
        return actions
