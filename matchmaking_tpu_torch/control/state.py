"""Placement state model: bindings, the migration typestate, the audit log.

The state object is the control plane's single source of truth for *where
every queue runs* (device ids + shard degree D) and *what the controller
did about it* (a bounded ring of :class:`PlacementDecision` records, each
carrying the signal snapshot that drove it and the measured blackout).

Exactly-once migration typestate: a queue is either ``STABLE`` or
``MIGRATING``; ``begin()`` refuses a second concurrent action on the same
queue (the executor's drain already serializes on the engine lock, but the
typestate makes the controller's own reentrancy bug a loud error instead
of a double drain).  ``complete()``/``fail()`` are the only exits — the
acquire/settle discipline of the delivery lifecycle, applied to placement
actions.

Event-loop-confined like the batcher and the admission controller: all
mutation happens on the controller's tick (or the executor it awaits), so
there is deliberately no lock here.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Iterable

#: Queue placement statuses (the migration typestate).
STABLE = "stable"
MIGRATING = "migrating"

#: Decision kinds.
MIGRATE = "migrate"
PROMOTE = "promote"
DEMOTE = "demote"


class PlacementError(RuntimeError):
    """A placement-typestate violation (concurrent action on one queue,
    unknown queue/device, malformed target)."""


@dataclasses.dataclass
class QueuePlacement:
    """Where one queue runs: the bound logical device ids (shard degree D
    is their count) plus the migration typestate."""

    queue: str
    devices: tuple[int, ...]
    status: str = STABLE
    #: Monotone per-queue binding generation — bumped on every completed
    #: action, so an audit reader can order rebinding races out.
    generation: int = 0
    #: ``now`` of the last completed action (cooldown anchor; 0 = never).
    last_action_t: float = 0.0

    @property
    def shard(self) -> int:
        return len(self.devices)

    def to_dict(self) -> dict[str, Any]:
        return {
            "devices": list(self.devices),
            "shard": self.shard,
            "status": self.status,
            "generation": self.generation,
            "last_action_t": round(self.last_action_t, 3),
        }


@dataclasses.dataclass
class PlacementDecision:
    """One audit record: what the controller decided, on which signals,
    and what it cost."""

    seq: int
    t: float
    kind: str                       # migrate | promote | demote
    queue: str
    src: tuple[int, ...]
    dst: tuple[int, ...]
    #: The signal snapshot that drove the decision (policy view rows).
    signals: dict[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "pending"         # pending | applied | failed
    #: Measured migration blackout (seconds the queue's engine lock was
    #: held across drain→restore; 0 until applied).
    blackout_s: float = 0.0
    #: Waiting players carried across the move.
    transferred: int = 0
    detail: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "seq": self.seq,
            "t": round(self.t, 3),
            "kind": self.kind,
            "queue": self.queue,
            "from": list(self.src),
            "to": list(self.dst),
            "signals": self.signals,
            "status": self.status,
            "blackout_ms": round(self.blackout_s * 1e3, 3),
            "transferred": self.transferred,
            "detail": self.detail,
        }


class PlacementState:
    """Bindings for every placed queue + the decision audit ring."""

    def __init__(self, n_devices: int, decision_ring: int = 256):
        if n_devices < 1:
            raise PlacementError(f"device inventory must be >= 1, "
                                 f"got {n_devices}")
        self.n_devices = n_devices
        self._placements: dict[str, QueuePlacement] = {}
        self.decisions: deque[PlacementDecision] = deque(
            maxlen=max(1, decision_ring))
        self._seq = 0
        #: Blackout stats per queue (max/last, seconds) — the bounded-
        #: blackout acceptance reads these without replaying the ring.
        self.blackout_last: dict[str, float] = {}
        self.blackout_max: dict[str, float] = {}

    # ---- bindings ----------------------------------------------------------

    def bind(self, queue: str, devices: Iterable[int]) -> QueuePlacement:
        """Initial binding (boot). Re-binding an existing queue resets it
        (the app rebuilds runtimes only at boot)."""
        devs = self._validate(devices)
        p = QueuePlacement(queue=queue, devices=devs)
        self._placements[queue] = p
        return p

    def placement(self, queue: str) -> QueuePlacement:
        try:
            return self._placements[queue]
        except KeyError:
            raise PlacementError(f"unplaced queue {queue!r}") from None

    def placements(self) -> dict[str, QueuePlacement]:
        return dict(self._placements)

    def queues_on(self, device: int) -> list[str]:
        """Queues bound to (sharing) one device, sorted for determinism."""
        return sorted(q for q, p in self._placements.items()
                      if device in p.devices)

    def free_devices(self) -> list[int]:
        """Devices with no queue bound, ascending."""
        used = {d for p in self._placements.values() for d in p.devices}
        return [d for d in range(self.n_devices) if d not in used]

    def shared_devices(self) -> set[int]:
        """Devices hosting >= 2 queues (the arbiter's engagement set)."""
        counts: dict[int, int] = {}
        for p in self._placements.values():
            for d in p.devices:
                counts[d] = counts.get(d, 0) + 1
        return {d for d, n in counts.items() if n >= 2}

    def _validate(self, devices: Iterable[int]) -> tuple[int, ...]:
        devs = tuple(int(d) for d in devices)
        if not devs:
            raise PlacementError("a placement needs >= 1 device")
        if len(set(devs)) != len(devs):
            raise PlacementError(f"duplicate device in target {devs}")
        bad = [d for d in devs if not 0 <= d < self.n_devices]
        if bad:
            raise PlacementError(
                f"device(s) {bad} outside inventory [0, {self.n_devices})")
        return devs

    # ---- the migration typestate ------------------------------------------

    def begin(self, kind: str, queue: str, devices: Iterable[int],
              now: float, signals: dict[str, Any] | None = None,
              ) -> PlacementDecision:
        """Arm one placement action. Raises on a concurrent action on the
        same queue (exactly-once: the decision must be completed or failed
        before the next one arms)."""
        p = self.placement(queue)
        devs = self._validate(devices)
        if p.status != STABLE:
            raise PlacementError(
                f"queue {queue!r} already has a placement action in "
                f"flight (status {p.status})")
        if devs == p.devices:
            raise PlacementError(
                f"queue {queue!r} is already placed on {devs}")
        p.status = MIGRATING
        self._seq += 1
        d = PlacementDecision(seq=self._seq, t=now, kind=kind, queue=queue,
                              src=p.devices, dst=devs,
                              signals=dict(signals or {}))
        self.decisions.append(d)
        return d

    def complete(self, decision: PlacementDecision, now: float,
                 blackout_s: float, transferred: int,
                 detail: str = "") -> None:
        """The action landed: rebind, clear the typestate, record cost."""
        p = self.placement(decision.queue)
        p.devices = decision.dst
        p.status = STABLE
        p.generation += 1
        p.last_action_t = now
        decision.status = "applied"
        decision.blackout_s = blackout_s
        decision.transferred = transferred
        decision.detail = detail
        self.blackout_last[decision.queue] = blackout_s
        self.blackout_max[decision.queue] = max(
            self.blackout_max.get(decision.queue, 0.0), blackout_s)

    def refuse(self, kind: str, queue: str, devices: Iterable[int],
               now: float, detail: str) -> PlacementDecision:
        """Audit an action the typestate/validator REFUSED (concurrent
        action, unknown queue, bad target) without touching any binding —
        every decision lands in the ring, including the ones that never
        armed (the /debug/placement contract).  Raw target preserved
        unvalidated: the refusal may be ABOUT the target being invalid."""
        src: tuple[int, ...] = ()
        p = self._placements.get(queue)
        if p is not None:
            src = p.devices
        self._seq += 1
        d = PlacementDecision(seq=self._seq, t=now, kind=kind, queue=queue,
                              src=src, dst=tuple(int(x) for x in devices),
                              status="refused", detail=detail)
        self.decisions.append(d)
        return d

    def fail(self, decision: PlacementDecision, now: float,
             detail: str) -> None:
        """The action failed: binding unchanged, typestate cleared, the
        failure audited.  The cooldown anchor still advances — a failing
        target must not be retried every tick."""
        p = self.placement(decision.queue)
        p.status = STABLE
        p.last_action_t = now
        decision.status = "failed"
        decision.detail = detail

    # ---- observability -----------------------------------------------------

    def snapshot(self, history: int = 0) -> dict[str, Any]:
        """JSON-ready state for /debug/placement."""
        rows = [d.to_dict() for d in self.decisions]
        if history:
            rows = rows[-history:]
        return {
            "n_devices": self.n_devices,
            "bindings": {q: p.to_dict()
                         for q, p in sorted(self._placements.items())},
            "devices": {str(d): self.queues_on(d)
                        for d in range(self.n_devices)},
            "shared_devices": sorted(self.shared_devices()),
            "decisions": rows,
            "blackout_ms": {
                q: {"last": round(self.blackout_last.get(q, 0.0) * 1e3, 3),
                    "max": round(self.blackout_max.get(q, 0.0) * 1e3, 3)}
                for q in sorted(self.blackout_last)
            },
        }
