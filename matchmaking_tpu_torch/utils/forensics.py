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

The incident half: ``IncidentRecorder`` subscribes to the spine and, when a
trigger kind is stamped (``TRIGGER_KINDS``: SLO burn and its clearing,
breaker trip, crash recovery, failover takeover, a placement blackout over
budget, an autotune oscillation), freezes the app's rings into one
bounded, schema-versioned JSON bundle (``INCIDENT_SCHEMA``): the spine's
window, the telemetry tail, the slow-trace exemplars, the attribution, the
SLO monitors, the counters and each journal's watermark. Bundles stay in
a ring (``/debug/incidents``) and, with ``incident_dir``, are written there
under a retention cap. Captures are rate-limited per trigger class and a
capture that triggers another is dropped; both drops are counted. The
capture runs on the emitting thread, outside the spine's lock.
``validate_bundle`` checks a bundle's schema.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

#: Bundle schema version: bumped on any breaking field change (the JAX
#: package's bundles carry the same one).
INCIDENT_SCHEMA = "mm.incident/1"

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


# ---- black-box auto-capture -------------------------------------------------

#: Trigger rules: spine kind → trigger class. One bundle per firing
#: (subject to the per-class rate limit). ``slo_burn_clear`` is a
#: checkpoint trigger on purpose: a recovery's chain ends at the burn
#: clearing, so the bundle after the recovery must exist too.
TRIGGER_KINDS = {
    "slo_burn": "slo_burn",
    "slo_burn_clear": "slo_burn_clear",
    "breaker_trip": "breaker_trip",
    "failover_takeover": "failover",
    "crash_recovered": "crash_recovery",
    "placement_blackout_over_budget": "blackout_over_budget",
    "autotune_oscillation": "autotune_oscillation",
}

#: Required top-level bundle fields (what ``validate_bundle`` checks).
_BUNDLE_REQUIRED = ("schema", "id", "trigger", "captured_wall",
                    "capture_ms", "spine", "spine_digest", "telemetry",
                    "replication", "journal", "counters")
_TRIGGER_REQUIRED = ("class", "seq", "kind", "queue", "detail", "refs")


class IncidentRecorder:
    """Subscribes to the app's EventSpine; freezes bounded ring snapshots
    into schema-versioned incident bundles when a trigger rule fires."""

    def __init__(self, app, cfg):
        self.app = app
        self.cfg = cfg
        # guarded-by: _lock
        self._ring: deque[dict[str, Any]] = deque(
            maxlen=max(1, cfg.incident_ring))
        self._lock = threading.Lock()
        self._id = itertools.count(1)
        #: Per-trigger-class monotonic stamp of the last capture (the
        #: rate limiter's memory) and the last few autotune moves per
        #: (queue, knob) for the oscillation detector.
        self._last_capture: dict[str, float] = {}  # guarded-by: _lock
        # guarded-by: _lock
        self._moves: dict[tuple[str, str], deque[tuple[Any, Any]]] = {}
        self._capturing = False  # guarded-by: _lock
        self.captured = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock
        self.by_class: dict[str, int] = {}  # guarded-by: _lock
        if cfg.enabled():
            app.spine.subscribe(self.observe)

    # -- trigger matching ---------------------------------------------------

    def observe(self, ev: dict[str, Any]) -> None:
        """Spine observer (runs outside the spine lock, possibly on an
        engine worker thread). Cheap non-match path: one dict lookup."""
        kind = ev["kind"]
        if kind.startswith("autotune_") and kind not in TRIGGER_KINDS:
            self._observe_knob_move(ev)
            return
        cls = TRIGGER_KINDS.get(kind)
        if cls is None:
            return
        if cls == "blackout_over_budget" and self.cfg.blackout_budget_ms <= 0:
            return
        self._fire(cls, ev)

    def _observe_knob_move(self, ev: dict[str, Any]) -> None:
        """Autotuner oscillation: the same knob on the same queue flips
        src→dst then dst→src within the configured move window — the
        tuner is chasing its own tail and an operator needs the signal
        slice that confused it."""
        refs = ev.get("refs") or {}
        src, dst = refs.get("src"), refs.get("dst")
        if src is None or dst is None:
            return
        key = (ev["queue"], ev["kind"])
        # Observers run on whatever thread emitted the spine event, so
        # the move rings mutate under the lock — but the oscillation
        # emission below stays OUTSIDE it: events.append re-enters
        # observe → _fire, which takes this same (non-reentrant) lock.
        with self._lock:
            ring = self._moves.get(key)
            if ring is None:
                ring = self._moves[key] = deque(
                    maxlen=max(2, self.cfg.oscillation_window))
            flip = any(p_src == dst and p_dst == src
                       for p_src, p_dst in ring)
            ring.append((src, dst))
        if flip:
            osc = self.app.events.append(
                "autotune_oscillation", ev["queue"],
                f"{ev['kind']} flip {dst} -> {src} -> {dst} within "
                f"{ring.maxlen} moves", component="control",
                refs={"knob": refs.get("knob", ev["kind"]),
                      "decision": refs.get("decision")})
            # append() already re-entered observe() with the oscillation
            # event, which fired the trigger — nothing more to do here.
            del osc

    def _fire(self, cls: str, ev: dict[str, Any]) -> None:
        now = time.monotonic()
        with self._lock:
            if self._capturing:
                # A capture in flight triggered a spine event that itself
                # matches a rule — self-amplification, by definition.
                self.dropped += 1
                self.app.metrics.counters.inc("incidents_dropped")
                return
            last = self._last_capture.get(cls)
            if (last is not None
                    and now - last < self.cfg.min_interval_s):
                self.dropped += 1
                self.app.metrics.counters.inc("incidents_dropped")
                return
            self._last_capture[cls] = now
            self._capturing = True
        try:
            self.capture(cls, ev)
        finally:
            with self._lock:
                self._capturing = False

    # -- bundle assembly ----------------------------------------------------

    def capture(self, cls: str, ev: dict[str, Any]) -> dict[str, Any]:
        """Freeze the rings into one bundle. Read-only against the same
        snapshot surfaces /metrics scrapes (no device read); measured into
        the ``incident_capture`` latency series."""
        t0 = time.perf_counter()
        app = self.app
        cfg = self.cfg
        bundle: dict[str, Any] = {
            "schema": INCIDENT_SCHEMA,
            "id": f"inc-{next(self._id):06d}",
            "trigger": {"class": cls, "seq": ev["seq"], "kind": ev["kind"],
                        "queue": ev["queue"], "detail": ev["detail"],
                        "refs": dict(ev["refs"]),
                        "mono_ns": ev["mono_ns"], "wall": ev["wall"]},
            "captured_wall": time.time(),
            "capture_ms": 0.0,  # patched below, after the freeze
            "spine": app.spine.window(limit=cfg.spine_window),
            "spine_digest": app.spine.digest(),
            "telemetry": app.telemetry.snapshot(limit=cfg.telemetry_tail),
            "counters": {},
            "replication": {},
            "journal": {},
        }
        counters = app.metrics.report()["counters"]
        bundle["counters"] = {k: v for k, v in sorted(counters.items())
                              if v}
        recorder = getattr(app, "recorder", None)
        if recorder is not None and getattr(app, "trace_enabled", True):
            snap = recorder.snapshot(limit=cfg.trace_slice)
            # Slow exemplars only: the recent ring is volume, the slow
            # ring is the incident's latency evidence.
            bundle["slow_traces"] = {
                q: entry["slow"] for q, entry in snap["queues"].items()
                if entry["slow"]}
        attribution = getattr(app, "attribution", None)
        if attribution is not None:
            bundle["attribution"] = attribution.snapshot()
        slo = {name: mon.snapshot()
               for name, mon in getattr(app, "_slo_monitors", {}).items()}
        if slo:
            bundle["slo"] = slo
        placement = getattr(app, "placement", None)
        if placement is not None:
            bundle["placement"] = placement.snapshot(
                history=cfg.audit_slice)
        tuner = getattr(app, "autotune", None)
        if tuner is not None:
            bundle["autotune"] = tuner.snapshot(history=cfg.audit_slice)
        for name, rt in app._runtimes.items():
            repl = getattr(rt, "replication", None)
            if repl is not None:
                bundle["replication"][name] = repl.snapshot()
            j = getattr(rt, "journal", None)
            if j is not None:
                watermark = {"seq": j.seq, "synced_seq": j.synced_seq,
                             "segment_records": j.segment_records,
                             "segment_bytes": j.segment_bytes,
                             "path": getattr(j, "path", "")}
                # The tail digest names exactly which journal window the
                # bundle saw.
                blob = json.dumps(
                    {k: watermark[k] for k in
                     ("seq", "synced_seq", "segment_records")},
                    sort_keys=True).encode("utf-8")
                watermark["lsn_range"] = [
                    max(0, j.seq - j.segment_records), j.seq]
                watermark["tail_digest"] = hashlib.sha256(blob).hexdigest()
                bundle["journal"][name] = watermark
        capture_ms = (time.perf_counter() - t0) * 1e3
        bundle["capture_ms"] = round(capture_ms, 3)
        app.metrics.record_latency("incident_capture", capture_ms / 1e3)
        app.metrics.counters.inc("incidents_captured")
        with self._lock:
            self.captured += 1
            self.by_class[cls] = self.by_class.get(cls, 0) + 1
            self._ring.append(bundle)
        if cfg.incident_dir:
            self._persist(bundle)
        return bundle

    def _persist(self, bundle: dict[str, Any]) -> None:
        """Write one bundle file; prune oldest past the retention cap.
        Best-effort: a full disk must not take the service down."""
        import os

        try:
            os.makedirs(self.cfg.incident_dir, exist_ok=True)
            path = os.path.join(
                self.cfg.incident_dir,
                f"incident_{bundle['id']}_{bundle['trigger']['class']}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, sort_keys=True)
            os.replace(tmp, path)
            kept = sorted(
                f for f in os.listdir(self.cfg.incident_dir)
                if f.startswith("incident_") and f.endswith(".json"))
            for stale in kept[:-max(1, self.cfg.retention_files)]:
                try:
                    os.unlink(os.path.join(self.cfg.incident_dir, stale))
                except OSError:
                    pass
        except OSError:
            self.app.metrics.counters.inc("incidents_persist_errors")

    # -- debug surfaces -----------------------------------------------------

    def get(self, incident_id: str) -> "dict[str, Any] | None":
        with self._lock:
            for bundle in self._ring:
                if bundle["id"] == incident_id:
                    return bundle
        return None

    def snapshot(self, include_bundles: bool = False) -> dict[str, Any]:
        """Counters + bundle summaries for /debug/incidents, /metrics and
        /healthz. Summaries stay small; the full bundle is per-id fetch."""
        lat = self.app.metrics.latency.get("incident_capture")
        with self._lock:
            bundles = list(self._ring)
            body: dict[str, Any] = {
                "captured": self.captured,
                "dropped": self.dropped,
                "by_class": dict(sorted(self.by_class.items())),
                "incident_dir": self.cfg.incident_dir,
                "capture_ms_p99": (
                    round(lat.percentile(99) * 1e3, 3)
                    if lat is not None and len(lat) else None),
            }
        body["incidents"] = [
            {"id": b["id"], "class": b["trigger"]["class"],
             "kind": b["trigger"]["kind"], "queue": b["trigger"]["queue"],
             "seq": b["trigger"]["seq"], "wall": b["trigger"]["wall"],
             "capture_ms": b["capture_ms"],
             "spine_events": len(b["spine"])}
            for b in bundles]
        if include_bundles:
            body["bundles"] = bundles
        return body


def validate_bundle(bundle: Any) -> list[str]:
    """Schema check of one bundle. Returns human-readable problems, []
    when the bundle is valid."""
    problems: list[str] = []
    if not isinstance(bundle, dict):
        return [f"bundle must be a JSON object, got {type(bundle).__name__}"]
    if bundle.get("schema") != INCIDENT_SCHEMA:
        problems.append(
            f"schema {bundle.get('schema')!r} != {INCIDENT_SCHEMA!r}")
    for field in _BUNDLE_REQUIRED:
        if field not in bundle:
            problems.append(f"missing required field {field!r}")
    trigger = bundle.get("trigger")
    if isinstance(trigger, dict):
        for field in _TRIGGER_REQUIRED:
            if field not in trigger:
                problems.append(f"trigger missing field {field!r}")
        if trigger.get("class") not in set(TRIGGER_KINDS.values()):
            problems.append(
                f"unknown trigger class {trigger.get('class')!r}")
    elif "trigger" in bundle:
        problems.append("trigger must be an object")
    spine = bundle.get("spine")
    if isinstance(spine, list):
        prev = 0
        for i, ev in enumerate(spine):
            if not isinstance(ev, dict):
                problems.append(f"spine[{i}] is not an object")
                break
            missing = [k for k in ("seq", "mono_ns", "wall", "component",
                                   "queue", "kind", "refs")
                       if k not in ev]
            if missing:
                problems.append(f"spine[{i}] missing {missing}")
                break
            if ev["seq"] <= prev:
                problems.append(
                    f"spine[{i}] seq {ev['seq']} not strictly increasing "
                    f"(prev {prev}) — causal order broken")
                break
            prev = ev["seq"]
    elif "spine" in bundle:
        problems.append("spine must be a list")
    if "capture_ms" in bundle and not isinstance(
            bundle["capture_ms"], (int, float)):
        problems.append("capture_ms must be a number")
    return problems
