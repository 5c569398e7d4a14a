"""Cross-queue (tier, deadline) dispatch arbitration for co-located queues.

EDF window cutting orders dispatch WITHIN one queue's batcher; when the
placement controller co-locates two queues on one device their windows
interleave in whatever order the event loop runs the flushes — a
near-deadline tier-0 window on queue A can enqueue its device step behind
queue B's tier-2 window.  This arbiter closes that gap: each queue's
dispatch section registers its window's EDF key (the minimum
``(tier, absolute deadline)`` over the window's deliveries — a pure
function of cached admission fields, no clock reads) and, while >= 2
queues share the device, the arbiter grants the dispatch slot to the
lowest key among the windows CURRENTLY waiting.

Engagement is dynamic and cheap: the controller feeds the shared-device
set after every placement change; a device hosting one queue bypasses the
arbiter entirely (one dict lookup per dispatch), so the common unshared
layout pays nothing.

Deadlock discipline: the slot is held only across the host-side dispatch
section (admit + async launch — sub-ms), released before any backpressure
wait, and the holder never awaits another arbiter slot while holding one.

In this package a window's dispatch runs on the event loop without
yielding (service/app.py), so a slot is only ever contended by a dispatch
section that awaits; the gate keeps the order among windows that do wait.
"""

from __future__ import annotations

import asyncio
import heapq
from typing import Any

#: A window with no deadline sorts last within its tier.
NO_DEADLINE = float("inf")


def window_key(deliveries) -> tuple[int, float]:
    """The window's EDF key: min ``(tier, deadline-or-inf)`` over its
    deliveries (the same key the batcher cuts by — cached fields only)."""
    best: tuple[int, float] = (1 << 30, NO_DEADLINE)
    for d in deliveries:
        dl = d.deadline if d.deadline and d.deadline > 0.0 else NO_DEADLINE
        k = (d.tier, dl)
        if k < best:
            best = k
    return best


class _Slot:
    """Context manager returned by :meth:`DispatchArbiter.slot`."""

    __slots__ = ("arbiter", "device", "key", "granted")

    def __init__(self, arbiter: "DispatchArbiter", device: int | None,
                 key: tuple[int, float]):
        self.arbiter = arbiter
        self.device = device
        self.key = key
        self.granted = False

    async def __aenter__(self) -> "_Slot":
        if self.device is not None:
            await self.arbiter._arbiter_turn(self.device, self.key)
            self.granted = True
        return self

    async def __aexit__(self, *exc) -> None:
        if self.granted:
            self.arbiter._release(self.device)
            self.granted = False


#: Reusable no-op slot for services without a live controller (its
#: __aenter__/__aexit__ touch nothing when device is None, so concurrent
#: use of the one instance is safe).
NOOP_SLOT = _Slot(None, None, (0, 0.0))


class DispatchArbiter:
    """Per-device EDF gate over co-located queues' dispatch sections."""

    def __init__(self, metrics=None):
        #: The app's metrics (utils/metrics.py), kept for the controller's
        #: wiring; the grant and hold counts are this object's own.
        self._metrics = metrics
        #: Devices with >= 2 queues bound (controller-fed); dispatches on
        #: any other device bypass the gate.
        self._shared: set[int] = set()
        #: device -> heap of (key, seq, event) waiting dispatchers.
        self._waiting: dict[int, list[tuple[tuple[int, float], int, asyncio.Event]]] = {}
        #: device -> True while a dispatch slot is held.
        self._busy: set[int] = set()
        self._seq = 0
        self.grants = 0
        self.holds = 0

    # ---- controller feed ---------------------------------------------------

    def set_shared(self, devices: "set[int]") -> None:
        """Update the engagement set (called after every placement change).
        Dropping a device from the set lets its current waiters drain
        through the normal grant path — the gate only stops ARMING there."""
        self._shared = set(devices)

    def engaged(self, device: int | None) -> bool:
        return device is not None and device in self._shared

    # ---- the gate ----------------------------------------------------------

    def slot(self, device: int | None, key: tuple[int, float]) -> _Slot:
        """The dispatch-section guard.  ``device`` None (or not shared)
        returns a no-op slot — zero overhead off the co-located layout."""
        return _Slot(self, device if self.engaged(device) else None, key)

    async def _arbiter_turn(self, device: int, key: tuple[int, float]) -> None:
        """Wait for this window's EDF turn.  Intentionally awaited with
        the caller's pool lock held: the lock guards the caller's OWN
        engine state (which nothing can touch while it is held), while
        this wait orders against OTHER queues' dispatch sections — the
        slot is the strictly innermost resource (no holder ever acquires
        a lock while holding it), so no cycle exists."""
        if device not in self._busy and not self._waiting.get(device):
            # Uncontended: grant immediately.
            self._busy.add(device)
            self.grants += 1
            return
        self.holds += 1
        self._seq += 1
        ev = asyncio.Event()
        entry = (key, self._seq, ev)
        heapq.heappush(self._waiting.setdefault(device, []), entry)
        try:
            await ev.wait()
        except BaseException:
            # Cancelled while queued (drain/stop tears flush tasks down
            # mid-wait).  Two cases, both of which would otherwise wedge
            # the device forever: still in the heap → withdraw the entry
            # (a granted-to-dead-task event later would strand _busy);
            # already granted (popped + set between the set() and our
            # resume) → we own the busy slot and will never dispatch, so
            # pass it on to the next waiter.
            if ev.is_set():
                self._release(device)
            else:
                heap = self._waiting.get(device)
                if heap is not None and entry in heap:
                    heap.remove(entry)
                    heapq.heapify(heap)
                    if not heap:
                        del self._waiting[device]
            raise

    def _release(self, device: int) -> None:
        heap = self._waiting.get(device)
        if heap:
            # Grant the EDF-best waiting window (stable: seq breaks ties
            # in arrival order).
            _key, _seq, ev = heapq.heappop(heap)
            if not heap:
                del self._waiting[device]
            self.grants += 1
            ev.set()   # the waiter inherits the busy slot
        else:
            self._busy.discard(device)

    # ---- observability -----------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        return {
            "shared_devices": sorted(self._shared),
            "grants": self.grants,
            "holds": self.holds,
            "waiting": {str(d): len(h) for d, h in self._waiting.items()
                        if h},
        }
