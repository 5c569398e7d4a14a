"""Per-queue device-engine circuit breaker.

The port's copy of ``matchmaking_tpu/service/breaker.py``. Without it,
every engine crash revives the device engine from the host mirror, so a
device path that keeps failing is rebuilt at traffic rate and matches
nothing. The breaker counts crashes; at ``breaker_threshold`` of them in
``breaker_window_s`` it opens, and the queue runtime (service/app.py)
serves the queue from the host oracle (engine/cpu.py) while half-open
probes, spaced by an exponential backoff, try the card again:

    CLOSED ──(≥ threshold crashes in window_s)──▶ OPEN
    OPEN ──(probe due)──▶ HALF_OPEN
    HALF_OPEN ──probe ok──▶ CLOSED        (device engine restored)
    HALF_OPEN ──probe failed──▶ OPEN      (probe delay ×= backoff, capped)

This class only keeps the books; the runtime swaps the engines. Every
method takes ``now`` from its caller.
"""

from __future__ import annotations

import collections

from matchmaking_tpu_torch.config import EngineConfig

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: State → numeric code (> 0: the queue is off its device path).
STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(self, cfg: EngineConfig):
        self.threshold = cfg.breaker_threshold
        self.window_s = cfg.breaker_window_s
        self.probe_initial_s = cfg.breaker_probe_initial_s
        self.probe_backoff = cfg.breaker_probe_backoff
        self.probe_max_s = cfg.breaker_probe_max_s
        self.state = CLOSED
        self._crashes: collections.deque[float] = collections.deque()
        self.probe_delay_s = self.probe_initial_s
        self.next_probe_at = 0.0
        self.trips = 0
        self.probes = 0
        self.probe_failures = 0
        self.opened_at = 0.0
        self.time_degraded_s = 0.0

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def record_crash(self, now: float) -> bool:
        """Count one engine crash; True when this crash trips the breaker
        (the caller's next engine rebuild is the host oracle). Crashes
        while open or half-open do not count: the queue is on the host."""
        if not self.enabled or self.state != CLOSED:
            return False
        self._crashes.append(now)
        floor = now - self.window_s
        while self._crashes and self._crashes[0] < floor:
            self._crashes.popleft()
        if len(self._crashes) < self.threshold:
            return False
        self.state = OPEN
        self.trips += 1
        self.opened_at = now
        self.probe_delay_s = self.probe_initial_s
        self.next_probe_at = now + self.probe_delay_s
        self._crashes.clear()
        return True

    def probe_due(self, now: float) -> bool:
        return self.state == OPEN and now >= self.next_probe_at

    def begin_probe(self, now: float) -> None:
        assert self.state == OPEN, "probe without an open breaker"
        self.state = HALF_OPEN
        self.probes += 1

    def probe_failed(self, now: float) -> None:
        """The probe failed: stay open, back off."""
        assert self.state == HALF_OPEN
        self.state = OPEN
        self.probe_failures += 1
        self.probe_delay_s = min(self.probe_max_s,
                                 self.probe_delay_s * self.probe_backoff)
        self.next_probe_at = now + self.probe_delay_s

    def probe_succeeded(self, now: float) -> None:
        """The probe passed and the caller swapped the device engine in:
        close."""
        assert self.state == HALF_OPEN
        self.state = CLOSED
        self.time_degraded_s += max(0.0, now - self.opened_at)
        self.opened_at = 0.0
        self.probe_delay_s = self.probe_initial_s
        self.next_probe_at = 0.0
        self._crashes.clear()

    def snapshot(self, now: float | None = None) -> dict:
        """The state as a dict; ``time_degraded_s`` includes the current
        open stretch when ``now`` is given."""
        degraded = self.time_degraded_s
        if now is not None and self.state != CLOSED and self.opened_at:
            degraded += max(0.0, now - self.opened_at)
        return {
            "state": self.state,
            "enabled": self.enabled,
            "trips": self.trips,
            "probes": self.probes,
            "probe_failures": self.probe_failures,
            "probe_delay_s": round(self.probe_delay_s, 3),
            "time_degraded_s": round(degraded, 3),
        }
