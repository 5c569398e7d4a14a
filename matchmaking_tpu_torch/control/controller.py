"""The live placement controller: signals → policy → executed migration.

One supervised asyncio loop per app (PlacementConfig.interval_s), the same
shape as the telemetry sampler: each tick builds a
:class:`~matchmaking_tpu_torch.control.policy.SignalView` from what the service
already exports (telemetry ring ``idle_frac[q]``/``effective_occupancy[q]``/
``stage_total_p99_ms[q]``, the SLO burn monitors, live pool sizes), asks
the policy for a plan, and executes AT MOST ONE action — migrations are
serialized by construction, so two queues can never drain into each other
mid-move.  Every decision (applied, failed, or policy-refused) lands in
the audit ring ``/debug/placement`` serves, with the signal rows that
drove it and the measured blackout.

The controller also owns the :class:`~matchmaking_tpu_torch.control.arbiter.
DispatchArbiter` engagement set: after every placement change it re-derives
which devices host >= 2 queues and feeds the arbiter, so cross-queue EDF
arbitration switches on exactly while co-location exists.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from matchmaking_tpu_torch.config import PlacementConfig
from matchmaking_tpu_torch.control.arbiter import DispatchArbiter
from matchmaking_tpu_torch.control.policy import (
    Action,
    GreedyPolicy,
    PlacementPolicy,
    QueueSignals,
    SignalView,
)
from matchmaking_tpu_torch.control.state import PlacementError, PlacementState

log = logging.getLogger(__name__)


class PlacementController:
    """Owns placement state, the policy, the arbiter, and the tick loop."""

    def __init__(self, app, cfg: PlacementConfig,
                 policy: PlacementPolicy | None = None):
        self.app = app
        self.cfg = cfg
        n = cfg.devices if cfg.devices > 0 else self._discover_devices()
        self.state = PlacementState(n, decision_ring=cfg.decision_ring)
        self.policy = policy or GreedyPolicy(cfg)
        self.arbiter = DispatchArbiter(getattr(app, "metrics", None))
        self._task: asyncio.Task | None = None
        #: Monotone counters for /debug/placement.
        self.ticks = 0
        self.migrations = 0
        self.failures = 0
        self.refusals = 0

    def _discover_devices(self) -> int:
        """The app's logical device inventory's length (called once at
        boot, when ``PlacementConfig.devices`` gives no explicit count):
        the visible cards by default, or the inventory the app was given
        (``MatchmakingApp(devices=...)``)."""
        inventory = getattr(self.app, "inventory", None)
        return max(1, len(inventory)) if inventory is not None else 1

    # ---- boot wiring -------------------------------------------------------

    def bind_boot_placements(self) -> None:
        """Bind every queue runtime's boot placement: runtimes that
        declared one keep it; the rest are packed round-robin over the
        inventory (the static pre-controller layout, now explicit)."""
        runtimes = self.app._runtimes
        next_dev = 0
        for name in runtimes:
            rt = runtimes[name]
            devices = rt.placement
            if devices is None:
                devices = (next_dev % self.state.n_devices,)
                next_dev += 1
                rt.placement = devices
            self.state.bind(name, devices)
        self._feed_arbiter()

    def _feed_arbiter(self) -> None:
        self.arbiter.set_shared(self.state.shared_devices())

    # ---- signals -----------------------------------------------------------

    def signal_view(self, now: float) -> SignalView:
        """The policy's input, assembled from the telemetry ring (latest
        snapshot), the burn monitors, and live runtime state.  Read-only
        against the same unguarded surface /metrics scrapes."""
        ring = self.app.telemetry
        latest = ring.latest()
        vals: dict[str, float] = latest["values"] if latest else {}
        monitors = getattr(self.app, "_slo_monitors", {})
        out: dict[str, QueueSignals] = {}
        for name, rt in self.app._runtimes.items():
            burning = any(
                mon.burning for key, mon in monitors.items()
                if key == name or key.startswith(name + "@t")
                or key == name + "#quality")
            breaker = getattr(rt, "breaker", None)
            degraded = breaker is not None and breaker.state != "closed"
            out[name] = QueueSignals(
                burning=burning,
                idle_frac=float(vals.get(f"idle_frac[{name}]", 1.0)),
                occupancy=float(
                    vals.get(f"effective_occupancy[{name}]", 0.0)),
                p99_ms=float(vals.get(f"stage_total_p99_ms[{name}]", 0.0)),
                pool=rt.engine.pool_size(),
                degraded=degraded,
                shardable=rt.elastic_shardable(),
            )
        return SignalView(queues=out)

    # ---- one control tick --------------------------------------------------

    async def step(self, now: float | None = None,
                   view: SignalView | None = None) -> "dict[str, Any] | None":
        """One tick: plan, execute at most one action, audit.  Public so
        tests (and chip_smoke.py) can drive the controller without the
        wall-clock loop; ``view`` injection is the simulation seam.
        Returns the applied/failed decision dict, or None."""
        now = time.time() if now is None else now
        self.ticks += 1
        view = view if view is not None else self.signal_view(now)
        actions = self.policy.plan(self.state, view, now)
        if not actions:
            return None
        return await self._execute(actions[0], now)

    async def _execute(self, action: Action, now: float,
                       ) -> "dict[str, Any] | None":
        rt = self.app._runtimes.get(action.queue)
        if rt is None:
            refused = self.state.refuse(action.kind, action.queue,
                                        action.devices, now,
                                        "unknown queue")
            self.refusals += 1
            return refused.to_dict()
        try:
            decision = self.state.begin(action.kind, action.queue,
                                        action.devices, now,
                                        signals=action.signals)
        except PlacementError as e:
            # Every decision lands in the audit ring, REFUSED ones
            # included — a force() that never armed must be debuggable
            # from /debug/placement, not the process log.
            refused = self.state.refuse(action.kind, action.queue,
                                        action.devices, now, str(e))
            self.refusals += 1
            log.warning("placement action refused: %s", e)
            return refused.to_dict()
        self.app.events.append(
            "placement_" + action.kind, action.queue,
            f"{list(decision.src)} -> {list(decision.dst)}: {action.reason}",
            component="control", refs={"decision": decision.seq})
        try:
            stats = await rt.migrate(decision.dst)
        except BaseException as e:
            # BaseException: a cancelled tick (drain/stop mid-migration)
            # must clear the MIGRATING typestate too, or the queue is
            # stuck refusing actions forever; the cancellation itself
            # still propagates.
            self.failures += 1
            # The tick's own ``now`` domain (injected in sim/tests): the
            # cooldown anchor must compare against the clock the POLICY
            # reads, never a second wall-clock sample.
            self.state.fail(decision, now, f"{e!r}")
            self.app.events.append("placement_failed", action.queue,
                                   repr(e), component="control",
                                   refs={"decision": decision.seq})
            if not isinstance(e, Exception):
                raise
            log.exception("placement %s of %r failed; binding unchanged",
                          action.kind, action.queue)
            return decision.to_dict()
        self.migrations += 1
        self.state.complete(decision, now,
                            stats["blackout_s"], stats["transferred"],
                            detail=action.reason)
        budget_ms = self.app.cfg.forensics.blackout_budget_ms
        if budget_ms > 0 and stats["blackout_s"] * 1e3 > budget_ms:
            # Incident trigger: a migration that froze the
            # queue longer than the operator's budget is a capture-worthy
            # fact even when the migration itself succeeded.
            self.app.events.append(
                "placement_blackout_over_budget", action.queue,
                f"blackout {stats['blackout_s'] * 1e3:.1f} ms > budget "
                f"{budget_ms:.1f} ms ({action.kind})",
                component="control",
                refs={"decision": decision.seq,
                      "blackout_ms": round(stats["blackout_s"] * 1e3, 3)})
        self._feed_arbiter()
        self.app.metrics.counters.inc("placement_migrations")
        self.app.metrics.set_gauge(
            f"placement_blackout_ms[{action.queue}]",
            round(stats["blackout_s"] * 1e3, 3))
        log.info(
            "placement %s: queue %r %s -> %s (%d players, blackout "
            "%.1f ms) — %s", action.kind, action.queue,
            list(decision.src), list(decision.dst), stats["transferred"],
            stats["blackout_s"] * 1e3, action.reason)
        return decision.to_dict()

    async def force(self, kind: str, queue: str,
                    devices: "tuple[int, ...]", reason: str = "forced",
                    now: float | None = None) -> "dict[str, Any] | None":
        """Execute one operator- or script-chosen action through the SAME
        audited path as a policy decision (typestate, blackout
        measurement, arbiter re-feed, decision ring).  chip_smoke.py's
        placement cycle scripts its migrations with this so the mechanism
        and audit trail under measurement are exactly production's."""
        now = time.time() if now is None else now
        return await self._execute(
            Action(kind=kind, queue=queue, devices=tuple(devices),
                   signals={}, reason=reason), now)

    # ---- the loop ----------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        """Cancel AND await the tick loop: the caller (app.stop/drain)
        must not proceed to drain/checkpoint engines while a migration
        tick could still be mid-flight — awaiting the cancelled task
        guarantees the tick's unwind (including the migrate guard that
        disposes a half-built candidate and clears the typestate) has
        completed before this returns."""
        if self._task is not None:
            task, self._task = self._task, None
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:
                log.exception("placement loop raised during stop")

    async def _loop(self) -> None:
        """Supervised: one bad tick must not end the control plane."""
        interval = self.cfg.interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                await self.step()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("placement tick failed; retrying")
                self.app.metrics.counters.inc("placement_tick_errors")

    # ---- observability -----------------------------------------------------

    def snapshot(self, history: int = 0) -> dict[str, Any]:
        body = self.state.snapshot(history=history)
        body["ticks"] = self.ticks
        body["migrations"] = self.migrations
        body["failures"] = self.failures
        body["refusals"] = self.refusals
        body["interval_s"] = self.cfg.interval_s
        body["arbiter"] = self.arbiter.snapshot()
        # The RUNTIME's live binding + serving engine class per queue:
        # normally identical to `bindings`, but a direct runtime.migrate()
        # (tests, an operator shell) bypasses the controller's state — the
        # debug surface must show where the engine actually runs.
        body["live"] = {
            name: {
                "devices": list(rt.placement) if rt.placement else None,
                "engine": type(rt.engine).__name__,
            }
            for name, rt in sorted(self.app._runtimes.items())
        }
        return body
