"""Scripted engine faults (``config.ChaosConfig`` is the script).

The engine half of ``matchmaking_tpu/utils/chaos.py``: every fault is a
pure function of an index, so a chaos run replays identically under any
interleaving.

- ``EngineChaosHook``, one per queue: a device search-step counter and a
  breaker-probe counter, each raising ``ChaosInjectedError`` at the
  scripted indices. The queue runtime owns it and hands it to every engine
  it builds, so the indices keep advancing across revives: a schedule
  that fails steps 0-2 trips the breaker instead of failing step 0 of
  every fresh engine forever.
- ``ChaosState``, one per app: which queues the script covers, and their
  hooks.

Every injected fault is appended to ``events`` (the app's event log) as
``chaos_step_fault`` or ``chaos_probe_fault``, beside the breaker trips
it causes.

Only search steps and probes are faulted: admission, eviction and restore
are the crash-recovery path itself. The JAX package's broker, replication
and network faults are not carried.
"""

from __future__ import annotations

from matchmaking_tpu_torch.config import ChaosConfig


class ChaosInjectedError(RuntimeError):
    """Raised at a scripted fault point (a device step or a probe)."""


class EngineChaosHook:
    """One queue's fault streams. ``on_step`` and ``on_probe`` each take
    the next index of their own stream and raise at a scripted one."""

    __slots__ = ("cfg", "queue", "events", "steps", "probes", "_fail",
                 "_ranges")

    def __init__(self, cfg: ChaosConfig, queue: str = "", events=None):
        self.cfg = cfg
        self.queue = queue
        #: The event log (utils/trace.EventLog) or None.
        self.events = events
        self.steps = 0
        self.probes = 0
        self._fail = frozenset(cfg.fail_steps)
        self._ranges = tuple(cfg.fail_step_ranges)

    def on_step(self) -> None:
        """A device search step is about to be dispatched: the engine calls
        this before it changes any state for the chunk."""
        idx = self.steps
        self.steps += 1
        if idx in self._fail or any(a <= idx < b for a, b in self._ranges):
            if self.events is not None:
                self.events.append("chaos_step_fault", self.queue,
                                   f"step {idx}")
            raise ChaosInjectedError(
                f"chaos: scripted device-step failure at step index {idx}")

    def on_probe(self) -> None:
        """A half-open breaker probe is about to run (a stream of its own,
        so probe outcomes do not depend on how many steps a storm took)."""
        idx = self.probes
        self.probes += 1
        if idx < self.cfg.fail_probes:
            if self.events is not None:
                self.events.append("chaos_probe_fault", self.queue,
                                   f"probe {idx}")
            raise ChaosInjectedError(
                f"chaos: scripted probe failure (probe index {idx})")


class ChaosState:
    """The app's chaos bookkeeping: the queues the script applies to and
    one engine hook per queue."""

    def __init__(self, cfg: ChaosConfig, events=None):
        self.cfg = cfg
        self._queues = frozenset(cfg.queues)
        self._hooks: dict[str, EngineChaosHook] = {}
        #: The event log each hook reports to (set before any hook exists).
        self.events = events

    def applies(self, queue: str) -> bool:
        return not self._queues or queue in self._queues

    def engine_hook(self, queue: str) -> EngineChaosHook:
        hook = self._hooks.get(queue)
        if hook is None:
            hook = EngineChaosHook(self.cfg, queue, events=self.events)
            self._hooks[queue] = hook
        return hook
