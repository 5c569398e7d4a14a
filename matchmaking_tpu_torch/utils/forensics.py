"""The causal event spine: one ordered timeline of lifecycle events.

The spine half of ``matchmaking_tpu/utils/forensics.py``. Every lifecycle
emission (an ``EventLog`` append: breaker trips, probes, revives, journal
compactions and recoveries, the drain, speculation invalidations, chaos
faults, dead letters) is stamped here with ``(seq, mono_ns, wall,
component, queue, kind, detail, refs)``: ``seq`` is one monotone sequence
per app, drawn under a lock together with the ring append (events come
from the event loop and from worker threads, and ring order must be seq
order); ``mono_ns`` is ``time.monotonic_ns()``, so two events in the same
wall millisecond still order causally; ``refs`` links causal neighbours
(player counts, epochs, record counts). ``component`` says which layer
spoke, resolved from the kind when the caller does not say.

``transcript()`` is the deterministic projection: the scripted-recovery
kinds with their counter-valued refs and no clock, which two seeded runs
must reproduce exactly; ``digest()`` is its sha256.

The black-box capture (``IncidentRecorder``) and the bundle validator of
the JAX module are not carried.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

#: Kind prefix → component, first match wins; anything else is "service".
_COMPONENT_PREFIXES = (
    ("autotune", "control"),
    ("placement", "control"),
    ("migrate", "control"),
    ("replication", "replication"),
    ("failover", "replication"),
    ("lease", "replication"),
    ("epoch", "replication"),
    ("replay", "replication"),
    ("journal", "durability"),
    ("crash", "durability"),
    ("checkpoint", "durability"),
    ("backlog", "durability"),
    ("slo_", "slo"),
    ("chaos", "chaos"),
    ("spec_", "engine"),
    ("team_", "engine"),
    ("engine", "engine"),
    ("window_failed", "engine"),
    ("rescan", "engine"),
    ("breaker", "service"),
    ("probe", "service"),
    ("drain", "service"),
    ("shed", "service"),
    ("expired", "service"),
    ("partition", "broker"),
    ("dead_letter", "broker"),
)


def component_of(kind: str) -> str:
    for prefix, component in _COMPONENT_PREFIXES:
        if kind.startswith(prefix):
            return component
    return "service"


#: Kinds whose emission is a pure function of the scripted load (recovery
#: chains, counter-valued refs): the transcript's default selection.
#: Breaker, chaos and shedding kinds are clock-shaped and stay out.
DETERMINISTIC_KINDS = (
    "lease_expired", "epoch_bump", "replay_window", "failover_takeover",
    "crash_recovered", "replication_attached",
)

#: Refs keys that are counts or identities; timing refs (``rto_ms``, ...)
#: stay out of the transcript.
_TRANSCRIPT_REF_KEYS = ("epoch", "prev_epoch", "players", "records",
                        "snapshot_players", "decision", "knob")


class EventSpine:
    """Causal ordering for one app's lifecycle events (one per app, not
    module-global: two seeded runs must each start at seq 1)."""

    def __init__(self, ring: int = 4096):
        # guarded-by: _lock
        self._ring: deque[dict[str, Any]] = deque(maxlen=max(16, ring))
        self._seq = itertools.count(1)
        #: The seq draw and the ring append are one step under this lock,
        #: so ring order is seq order under concurrent emitters.
        self._lock = threading.Lock()
        self._observers: list[Callable[[dict[str, Any]], None]] = []

    def subscribe(self, fn: Callable[[dict[str, Any]], None]) -> None:
        self._observers.append(fn)

    def stamp(self, kind: str, queue: str = "", detail: str = "",
              component: str = "", refs: dict[str, Any] | None = None,
              wall: float | None = None) -> dict[str, Any]:
        """Stamp one event and return its row. Observers run outside the
        lock, and one that raises is ignored: it must not take the
        emitting subsystem down or block other emitters."""
        ev = {
            "seq": 0,  # drawn under the lock below
            "mono_ns": time.monotonic_ns(),
            "wall": time.time() if wall is None else wall,
            "component": component or component_of(kind),
            "queue": queue,
            "kind": kind,
            "detail": detail,
            "refs": dict(refs) if refs else {},
        }
        with self._lock:
            ev["seq"] = next(self._seq)
            self._ring.append(ev)
        for fn in tuple(self._observers):
            try:
                fn(ev)
            except Exception:
                pass
        return ev

    def __len__(self) -> int:
        return len(self._ring)

    def window(self, limit: int = 0, queue: str | None = None,
               kinds: Iterable[str] | None = None) -> list[dict[str, Any]]:
        """The newest ``limit`` rows (0: all), in seq order. The ring is
        copied first: worker threads append while it is read."""
        want = set(kinds) if kinds is not None else None
        rows = [dict(ev) for ev in tuple(self._ring)
                if (queue is None or ev["queue"] == queue)
                and (want is None or ev["kind"] in want)]
        rows.sort(key=lambda ev: ev["seq"])
        return rows[-limit:] if limit else rows

    def transcript(self, kinds: Iterable[str] | None = None,
                   ) -> list[dict[str, Any]]:
        """The deterministic projection: in seq order, (component, queue,
        kind, the counter refs) of ``kinds`` (default
        ``DETERMINISTIC_KINDS``), every clock dropped."""
        rows = []
        for ev in self.window(kinds=kinds or DETERMINISTIC_KINDS):
            refs = {k: ev["refs"][k] for k in _TRANSCRIPT_REF_KEYS
                    if k in ev["refs"]}
            rows.append({"component": ev["component"], "queue": ev["queue"],
                         "kind": ev["kind"], "refs": refs})
        return rows

    def digest(self, kinds: Iterable[str] | None = None) -> str:
        """sha256 of the transcript's canonical JSON."""
        blob = json.dumps(self.transcript(kinds), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()
