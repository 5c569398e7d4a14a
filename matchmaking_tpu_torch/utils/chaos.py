"""The fault script's runtime (``config.ChaosConfig`` is the script).

Every fault decision is a pure function of a message's identity (its
queue's publish sequence number and its redelivery attempt), of a device
step index or of a stream record seq, so a chaos run replays identically
under any interleaving of the event loop:

- ``hash01(seed, *keys)``: a uniform float in [0, 1) from splitmix64 over
  the keys (strings hashed by crc32, never the builtin ``hash``), equal to
  the JAX package's for the same keys.
- ``EngineChaosHook``, one per queue: a device search-step counter and a
  breaker-probe counter, each raising ``ChaosInjectedError`` at the
  scripted indices (``ChaosDeviceLostError`` at a device-loss step).
  The queue runtime owns it and hands it to every engine it builds, so
  the indices keep advancing across revives: a schedule that fails steps
  0-2 trips the breaker instead of failing step 0 of every fresh engine
  forever.
- ``ChaosState``, one per app: which queues the script covers, the
  broker's drop, duplicate and partition decisions, and the engine hooks.

Every injected engine fault is appended to ``events`` (the app's event
log) as ``chaos_step_fault`` or ``chaos_probe_fault``, beside the breaker
trips it causes; the broker logs its own (``chaos_drop``, ``chaos_dup``,
``partition_pause``, ``partition_resume``).

Only search steps and probes are faulted on the engine: admission,
eviction and restore are the crash-recovery path itself. The JAX
package's network faults are not carried.
"""

from __future__ import annotations

import zlib

from matchmaking_tpu_torch.config import ChaosConfig

_MASK = (1 << 64) - 1


class ChaosInjectedError(RuntimeError):
    """Raised at a scripted fault point (a device step or a probe)."""


class ChaosDeviceLostError(ChaosInjectedError):
    """A scripted device loss: a mesh participant dies mid-serve. A plain
    revive from the mirror cannot fix it (the rebuilt engine would bind
    the same dead card), so the queue runtime counts it as an engine
    crash and demotes a sharded queue to its surviving devices.

    ``device`` is the logical index within the queue's binding that died
    (-1: the last device, the schedule's default)."""

    def __init__(self, message: str, device: int = -1):
        super().__init__(message)
        self.device = device


def _mix(h: int) -> int:
    """The splitmix64 finalizer (full 64-bit avalanche)."""
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _MASK
    h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK
    return h ^ (h >> 31)


def hash01(seed: int, *keys: int | str) -> float:
    """A uniform float in [0, 1) from (seed, *keys); a string key is hashed
    by crc32, so ``PYTHONHASHSEED`` cannot change a schedule."""
    h = _mix(seed & _MASK ^ 0x9E3779B97F4A7C15)
    for k in keys:
        if isinstance(k, str):
            k = zlib.crc32(k.encode())
        h = _mix(h ^ (k & _MASK))
    return h / float(1 << 64)


class EngineChaosHook:
    """One queue's fault streams. ``on_step`` and ``on_probe`` each take
    the next index of their own stream and raise at a scripted one."""

    __slots__ = ("cfg", "queue", "events", "steps", "probes", "_fail",
                 "_ranges", "_lost")

    def __init__(self, cfg: ChaosConfig, queue: str = "", events=None):
        self.cfg = cfg
        self.queue = queue
        #: The event log (utils/trace.EventLog) or None.
        self.events = events
        self.steps = 0
        self.probes = 0
        self._fail = frozenset(cfg.fail_steps)
        self._ranges = tuple(cfg.fail_step_ranges)
        self._lost = frozenset(cfg.device_lost_steps)

    def on_step(self) -> None:
        """A device search step is about to be dispatched: the engine calls
        this before it changes any state for the chunk."""
        idx = self.steps
        self.steps += 1
        if idx in self._lost:
            # Before the plain step faults: a schedule naming one index in
            # both means the stronger fault, the one failover absorbs.
            if self.events is not None:
                self.events.append("chaos_device_lost", self.queue,
                                   f"step {idx}")
            raise ChaosDeviceLostError(
                f"chaos: scripted device loss at step index {idx}",
                device=self.cfg.device_lost_device)
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
    """The app's chaos bookkeeping: the queues the script applies to, the
    broker's fault decisions and one engine hook per queue."""

    def __init__(self, cfg: ChaosConfig, events=None):
        self.cfg = cfg
        self._queues = frozenset(cfg.queues)
        self._drop_seqs = frozenset(cfg.drop_seqs)
        self._dup_seqs = {int(s): int(n) for s, n in cfg.dup_seqs}
        self._hooks: dict[str, EngineChaosHook] = {}
        #: The event log each hook reports to (set before any hook exists).
        self.events = events

    def applies(self, queue: str) -> bool:
        return not self._queues or queue in self._queues

    # ---- broker faults ----------------------------------------------------

    def consume_faults(self) -> bool:
        return self.cfg.consume_faults()

    def publish_faults(self) -> bool:
        return self.cfg.publish_faults()

    def should_drop(self, queue: str, seq: int, attempt: int) -> bool:
        """Drop delivery ``seq`` on its ``attempt``-th try (0 = the first)?
        A scripted drop hits the first attempt only, so the redelivery
        makes progress."""
        if seq < 0 or not self.applies(queue):
            return False
        if attempt == 0 and seq in self._drop_seqs:
            return True
        p = self.cfg.drop_prob
        return p > 0 and hash01(self.cfg.seed, "drop", queue, seq, attempt) < p

    def dup_copies(self, queue: str, seq: int) -> int:
        """Extra copies of publish ``seq`` to enqueue."""
        if not self.applies(queue):
            return 0
        extra = self._dup_seqs.get(seq, 0)
        p = self.cfg.dup_prob
        if p > 0 and hash01(self.cfg.seed, "dup", queue, seq) < p:
            extra += 1
        return extra

    def partition_action(self, queue: str, seq: int) -> str | None:
        """"pause", "resume" or None for publish ``seq`` (a queue's
        publishes are numbered one after another, so an exact match
        suffices)."""
        if not self.applies(queue):
            return None
        for pause_seq, resume_seq in self.cfg.partitions:
            if seq == resume_seq:
                return "resume"
            if seq == pause_seq:
                return "pause"
        return None

    # ---- engine hooks -----------------------------------------------------

    def engine_hook(self, queue: str) -> EngineChaosHook:
        hook = self._hooks.get(queue)
        if hook is None:
            hook = EngineChaosHook(self.cfg, queue, events=self.events)
            self._hooks[queue] = hook
        return hook
