"""The deterministic network nemesis.

It reads ``ChaosConfig``'s ``net_*`` keys as the in-process link reads
``repl_*``: every fault decision is a function of (seed, flow id, frame
seq). A scripted entry names its flow by substring (``repl:<queue>:fwd``,
``repl:<queue>:ack``, ``lease:<owner>``) and fires on a frame's first
transmission only, so retransmitting the unacked tail is how a faulted
stream converges, and two seeded runs inject the same faults.

Sender side (``FlowNemesis.transmit``): drop, duplicate, delay by N first
transmissions (reordering), partition windows, a mid-stream connection
reset and a bandwidth cap (frames wait, never tear). Receiver side
(``NetNemesis.rx_deaf``): asymmetric partitions, which the in-process link
cannot express, where a process still sends but its inbound frames (acks,
lease answers, heartbeats) vanish, scripted from the start
(``net_deaf_flows``) or armed at run time (``NetNemesis.deafen``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from matchmaking_tpu_torch.utils.chaos import hash01

__all__ = ["FlowNemesis", "NetNemesis"]


class FlowNemesis:
    """The sender-side fault pipeline of one flow. ``transmit(seq, frame)``
    returns the actions the transport takes, in order: ``("send", frame)``
    any number of times and at most one ``("reset",)``. Delayed and
    partitioned frames are held inside and released by later
    transmissions, as ``InProcReplicationLink.send`` does."""

    def __init__(self, flow: str, chaos: Any, seed: int,
                 count: Callable[[str], None]):
        self.flow = flow
        self._seed = int(seed)
        self._count = count

        def seqs(entries) -> set[int]:
            return {int(s) for f, s in (entries or ()) if f in flow}

        self._drop = frozenset(seqs(getattr(chaos, "net_drop_frames", ())))
        self._dup = frozenset(seqs(getattr(chaos, "net_dup_frames", ())))
        self._reset = seqs(getattr(chaos, "net_reset_frames", ()))
        self._delay = {int(s): int(h)
                       for f, s, h in (getattr(chaos, "net_delay_frames",
                                               ()) or ()) if f in flow}
        self._partitions = [(int(a), int(b))
                            for f, a, b in (getattr(chaos, "net_partitions",
                                                    ()) or ()) if f in flow]
        self._drop_prob = float(getattr(chaos, "net_drop_prob", 0.0) or 0.0)
        #: Pacing cap in bytes per second, or None (the link applies it).
        self.bandwidth_bps: int | None = None
        for f, bps in (getattr(chaos, "net_bandwidth_caps", ()) or ()):
            if f in flow:
                self.bandwidth_bps = int(bps)
                break
        self._seen: set[int] = set()
        self._delayed: list[list[Any]] = []
        self._partitioned = False
        self._resume_at = 0
        self._partition_buf: list[bytes] = []

    def transmit(self, seq: int, frame: bytes) -> list[tuple]:
        """Filter one transmission (faults fire on the first one only; the
        seq is the record seq on a replication flow, a per-flow frame
        counter elsewhere)."""
        out: list[tuple] = []
        first = seq not in self._seen
        if first:
            self._seen.add(seq)
        if self._partitioned and seq >= self._resume_at:
            self._partitioned = False
            for held in self._partition_buf:
                out.append(("send", held))
            self._partition_buf.clear()
        elif first and not self._partitioned:
            for pause, resume in self._partitions:
                if seq == pause:
                    self._partitioned = True
                    self._resume_at = resume
                    self._count("nemesis_partitions")
                    break
        if first and self._delayed:
            due = [d for d in self._delayed if d[0] <= 1]
            self._delayed = [[h - 1, f] for h, f in self._delayed if h > 1]
            for _h, held in due:
                if self._partitioned:
                    self._partition_buf.append(held)
                else:
                    out.append(("send", held))
        if self._partitioned:
            self._partition_buf.append(frame)
            return out
        if first:
            if seq in self._drop:
                self._count("nemesis_dropped")
                return out
            if self._drop_prob > 0 and hash01(
                    self._seed, "net", self.flow, seq) < self._drop_prob:
                self._count("nemesis_dropped")
                return out
            if seq in self._reset:
                # The reset consumes the frame: the retransmitted tail
                # carries it over the next connection.
                self._count("nemesis_resets")
                out.append(("reset",))
                return out
            hold = self._delay.get(seq)
            if hold is not None:
                self._count("nemesis_delayed")
                self._delayed.append([hold, frame])
                return out
            if seq in self._dup:
                self._count("nemesis_dup")
                out.append(("send", frame))
        out.append(("send", frame))
        return out

    def partition(self, start: int, resume: int | None = None) -> None:
        """A partition armed at run time: transmissions of seqs >= start
        are held until one reaches ``resume`` (default: never)."""
        self._partitions.append(
            (int(start), (1 << 62) if resume is None else int(resume)))


class NetNemesis:
    """A process's fault registry: a ``FlowNemesis`` per sender flow from
    the chaos script, and the receiver-side deafness verdict. Thread-safe:
    links live on the IO loop while callers arm deafness from other
    threads."""

    def __init__(self, chaos: Any = None, seed: int = 0):
        self.chaos = chaos
        self.seed = int(seed)
        self._deaf_patterns: list[str] = list(
            getattr(chaos, "net_deaf_flows", ()) or ())
        self._lock = threading.Lock()

    def flow(self, flow_id: str,
             count: Callable[[str], None]) -> FlowNemesis | None:
        """The sender pipeline of a flow, or None when no scripted or
        seeded fault touches it."""
        ch = self.chaos
        if ch is None or not ch.net_faults():
            return None
        fn = FlowNemesis(flow_id, ch, self.seed, count)
        if (fn._drop or fn._dup or fn._reset or fn._delay
                or fn._partitions or fn._drop_prob > 0
                or fn.bandwidth_bps is not None):
            return fn
        return None

    # ---- receiver side (asymmetric partitions) -------------------------------

    def rx_deaf(self, flow_id: str) -> Callable[[], bool]:
        """The verdict a connection asks at every inbound read: True while
        a deaf pattern matches this flow."""
        def deaf() -> bool:
            with self._lock:
                return any(p in flow_id for p in self._deaf_patterns)
        return deaf

    def deafen(self, pattern: str) -> None:
        """Drop the inbound frames of every flow matching ``pattern`` from
        now on."""
        with self._lock:
            self._deaf_patterns.append(pattern)

    def undeafen(self) -> None:
        with self._lock:
            self._deaf_patterns = list(
                getattr(self.chaos, "net_deaf_flows", ()) or ())
