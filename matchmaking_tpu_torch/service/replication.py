"""Hot-standby journal replication with fenced failover.

The write-ahead journal (utils/journal.py) lets a crashed process recover
its queue from its own disk; a lost host would still lose it. This module
streams each queue's journal to a standby, so the queue can move hosts:

- The **primary** (``QueueReplication``, on ``_QueueRuntime.replication``)
  ships every sealed journal record: the journal's ``tap`` hands it to
  ``on_record`` at append time. The sender keeps the unacked tail and
  sends it again when acks stall, so the link is at-least-once with one
  cumulative ack, and the stream heals from the scripted drops, delays
  and partitions of ``ChaosConfig``'s ``repl_*`` keys.
- The **standby** (``StandbyApplier``) applies the stream into a shadow
  ``RecoveredQueue`` (waiting rows, the terminal-replay cache, the
  admission checkpoint: what crash recovery applies) and acks the highest
  seq applied without a gap. Arrivals ahead of a gap wait in a buffer;
  duplicates are dropped. A baseline record (``RT_REPL_SNAPSHOT``, the
  primary's whole state at attach) replaces the shadow, so a standby can
  attach at any point of a queue's life.
- **Failover is fenced by a lease and an epoch** (``LeaseAuthority``, the
  in-process stand-in for a lease service). The standby takes a queue over
  only once the lease expired, which bumps the epoch; from then on the
  ex-primary's journal appends (``PoolJournal.fence``) and response
  publishes (the service's ``_publish`` and ``_publish_batch``) fail the
  authority's ``is_current`` check, however alive it is. A takeover
  applies only the tail the link already delivered, so its time is
  bounded by the replication lag, not the journal's size. A successor app
  adopts the shadow (``_QueueRuntime.recover_from_replica``).

Roles per queue: ``primary`` → ``fenced``. Lease deadlines are functions
of the ``now`` each caller passes (``time.monotonic()`` in the service)
and link faults are functions of record seqs, so a seeded failover
replays identically. ``InProcReplicationLink`` is the in-process link; a
network transport fills the same four methods (``send``, ``recv``,
``ack``, ``acked``).
"""

from __future__ import annotations

import base64
import collections
import json
import logging
import threading
import time
from typing import Any

from matchmaking_tpu_torch.utils.chaos import hash01
from matchmaking_tpu_torch.utils.journal import (
    RT_ADMISSION,
    RT_ADMIT,
    RT_CLEAN,
    RT_TERMINAL,
    RT_TERMINALS,
    FencedError,
    RecoveredQueue,
)

__all__ = [
    "RT_REPL_SNAPSHOT", "FencedError", "LeaseHeldError", "LeaseAuthority",
    "InProcReplicationLink", "StandbyApplier", "QueueReplication",
    "ReplicationHub", "baseline_payload",
]

log = logging.getLogger(__name__)

#: The stream-only record type of the primary's baseline at attach
#: (waiting rows, replay cache, admission checkpoint). Never written to a
#: journal segment: compaction folds the journal's history into snapshots
#: the stream never replays, so a standby starts from this instead.
RT_REPL_SNAPSHOT = 100


class LeaseHeldError(RuntimeError):
    """Acquire or takeover refused: another owner holds a live lease."""


#: Rows a baseline encodes per ``json`` call. The encoder holds the GIL
#: for a whole call: a 100k baseline in one call (~0.4 s on the H100's
#: host) kept the socket transport's IO thread, and so its heartbeats,
#: off the interpreter; between calls the GIL is handed over.
_BASELINE_CHUNK = 2048


def baseline_payload(rows: list[list[Any]],
                     recent: list[tuple[str, bytes, float]],
                     admission: dict[str, Any] | None) -> bytes:
    """The ``RT_REPL_SNAPSHOT`` payload: ADMIT-shaped waiting rows (region
    and mode by name, as the journal writes them), the live replay
    entries and the admission checkpoint; the bytes of one
    ``json.dumps`` of them, encoded ``_BASELINE_CHUNK`` rows at a time."""
    enc = json.JSONEncoder(separators=(",", ":")).encode
    chunks = [enc(rows[i:i + _BASELINE_CHUNK])[1:-1]
              for i in range(0, len(rows), _BASELINE_CHUNK)]
    tail = enc({"recent": [[pid, base64.b64encode(body).decode("ascii"), exp]
                           for pid, body, exp in recent],
                "admission": admission})
    return ('{"rows":[' + ",".join(chunks) + "]," + tail[1:]).encode("utf-8")


# protocol-monotone: epoch
class _Lease:
    __slots__ = ("owner", "epoch", "deadline")

    def __init__(self, owner: str, epoch: int, deadline: float):
        self.owner = owner
        self.epoch = epoch
        self.deadline = deadline


class LeaseAuthority:
    """Per queue: (owner, epoch, lease deadline), a function of the ``now``
    values callers pass. The epoch is the fencing token: it bumps on every
    change of owner (a takeover after expiry, or an acquire over an
    expired lease) and never goes back; ``is_current`` is the check the
    journal and publish seams run. Thread-safe: the journal's fence runs
    on whatever thread appends, the pump renews on the event loop."""

    def __init__(self, lease_s: float = 0.5,
                 fail_renewals: tuple[int, ...] = ()):
        self.lease_s = float(lease_s)
        #: Renewal call indices refused (``ChaosConfig.repl_fail_renewals``):
        #: a live primary's lease then lapses on the authority's clock.
        self._fail_renewals = frozenset(int(i) for i in fail_renewals)
        self._renewals = 0
        self._leases: dict[str, _Lease] = {}
        self._lock = threading.Lock()

    def acquire(self, queue: str, owner: str, now: float) -> int:
        """Take the queue's lease. The holder re-acquiring renews it (same
        epoch); another owner may take it only when absent or expired, and
        that bumps the epoch. Raises ``LeaseHeldError`` otherwise."""
        with self._lock:
            lease = self._leases.get(queue)
            if lease is None:
                self._leases[queue] = _Lease(owner, 1, now + self.lease_s)
                return 1
            if lease.owner == owner:
                lease.deadline = now + self.lease_s
                return lease.epoch
            if now < lease.deadline:
                raise LeaseHeldError(
                    f"queue {queue!r}: lease held by {lease.owner!r} "
                    f"(epoch {lease.epoch}) and not expired")
            lease.owner = owner
            lease.epoch += 1
            lease.deadline = now + self.lease_s
            return lease.epoch

    def renew(self, queue: str, owner: str, epoch: int, now: float) -> bool:
        """Extend the lease; False when (owner, epoch) is no longer current
        or a scripted renewal fault fires (the lease then lapses, though
        its holder is alive)."""
        with self._lock:
            idx = self._renewals
            self._renewals = idx + 1
            if idx in self._fail_renewals:
                return False
            lease = self._leases.get(queue)
            if lease is None or lease.owner != owner or lease.epoch != epoch:
                return False
            lease.deadline = now + self.lease_s
            return True

    def expired(self, queue: str, now: float) -> bool:
        with self._lock:
            lease = self._leases.get(queue)
            return lease is None or now >= lease.deadline

    def takeover(self, queue: str, owner: str, now: float,
                 force: bool = False) -> int:
        """A standby claims the queue once the lease expired (``force``:
        before, an operator's override), bumping the epoch: every check
        the old primary runs from now on fails."""
        with self._lock:
            lease = self._leases.get(queue)
            if lease is None:
                self._leases[queue] = _Lease(owner, 1, now + self.lease_s)
                return 1
            if not force and now < lease.deadline:
                raise LeaseHeldError(
                    f"queue {queue!r}: takeover refused — lease held by "
                    f"{lease.owner!r} (epoch {lease.epoch}) is not expired")
            lease.owner = owner
            lease.epoch += 1
            lease.deadline = now + self.lease_s
            return lease.epoch

    def release(self, queue: str, owner: str, epoch: int, now: float) -> None:
        """A clean shutdown expires its own lease now, so a standby may
        take over without waiting."""
        with self._lock:
            lease = self._leases.get(queue)
            if (lease is not None and lease.owner == owner
                    and lease.epoch == epoch):
                lease.deadline = now

    def is_current(self, queue: str, owner: str, epoch: int) -> bool:
        """The fencing check of the journal and publish seams."""
        with self._lock:
            lease = self._leases.get(queue)
            return (lease is not None and lease.owner == owner
                    and lease.epoch == epoch)

    def epoch_of(self, queue: str) -> int:
        with self._lock:
            lease = self._leases.get(queue)
            return 0 if lease is None else lease.epoch


# protocol-monotone: max_delivered, _acked
class InProcReplicationLink:
    """The in-process stream transport: at-least-once and not in order
    (a record can be dropped, duplicated, delayed or held by a partition),
    with one cumulative ack flowing back. Faults are scripted by stream
    record seq (``repl_drop_seqs``, ``repl_dup_seqs``, ``repl_delay_seqs``,
    ``repl_partitions``) or seeded by ``hash01(seed, "repl", queue, seq)``
    (``repl_drop_prob``), and fire on a seq's FIRST transmission only: the
    sender's retransmission of its unacked tail heals them."""

    def __init__(self, queue: str, chaos=None, seed: int = 0):
        self.queue = queue
        self._seed = seed
        self._drop = frozenset(getattr(chaos, "repl_drop_seqs", ()) or ())
        self._dup = frozenset(getattr(chaos, "repl_dup_seqs", ()) or ())
        self._delay = {int(s): int(h) for s, h
                       in (getattr(chaos, "repl_delay_seqs", ()) or ())}
        self._partitions = [(int(a), int(b)) for a, b
                            in (getattr(chaos, "repl_partitions", ()) or ())]
        self._drop_prob = float(getattr(chaos, "repl_drop_prob", 0.0) or 0.0)
        #: Records the standby's next ``recv`` takes.
        self._wire: collections.deque[tuple[int, int, bytes]] = (
            collections.deque())
        #: Delayed records: [first transmissions still to wait, record].
        self._delayed: list[list[Any]] = []
        self._partitioned = False
        self._resume_at = 0
        self._partition_buf: list[tuple[int, int, bytes]] = []
        #: Seqs transmitted at least once (a scripted fault fires once).
        self._seen: set[int] = set()
        #: The highest seq ``recv`` handed out: an ack never passes it.
        self.max_delivered = 0
        self._acked = 0
        self.counters = collections.Counter()

    def partition(self, start: int, resume: int | None = None) -> None:
        """Hold the transmissions of seqs >= ``start`` until one reaches
        ``resume`` (default: never)."""
        self._partitions.append((int(start),
                                 (1 << 62) if resume is None else int(resume)))

    # ---- primary side ------------------------------------------------------

    def send(self, seq: int, rtype: int, payload: bytes) -> None:
        rec = (seq, rtype, payload)
        first = seq not in self._seen
        if first:
            self._seen.add(seq)
        else:
            self.counters["retransmits"] += 1
        self.counters["sent"] += 1
        # A partition starts at the pause seq's first transmission and
        # ends when any transmission reaches the resume seq (a dropped
        # resume record must not wedge the link: the retransmitted tail
        # reaches it).
        if self._partitioned and seq >= self._resume_at:
            self._partitioned = False
            for held in self._partition_buf:
                self._wire.append(held)
            self._partition_buf.clear()
        elif first and not self._partitioned:
            for pause, resume in self._partitions:
                if seq == pause:
                    self._partitioned = True
                    self._resume_at = resume
                    self.counters["partitions"] += 1
                    break
        # Delays age by first transmissions; a released record arrives
        # late (the reordering the applier's gap buffer absorbs), and is
        # still held by a partition.
        if first and self._delayed:
            due = [d for d in self._delayed if d[0] <= 1]
            self._delayed = [[h - 1, r] for h, r in self._delayed if h > 1]
            for _h, held in due:
                if self._partitioned:
                    self._partition_buf.append(held)
                else:
                    self._wire.append(held)
        if self._partitioned:
            self._partition_buf.append(rec)
            return
        if first:
            if seq in self._drop:
                self.counters["dropped"] += 1
                return
            if (self._drop_prob > 0 and hash01(self._seed, "repl", self.queue,
                                               seq) < self._drop_prob):
                self.counters["dropped"] += 1
                return
            hold = self._delay.get(seq)
            if hold is not None:
                self.counters["delayed"] += 1
                self._delayed.append([hold, rec])
                return
            if seq in self._dup:
                self.counters["dup"] += 1
                self._wire.append(rec)
        self._wire.append(rec)

    # ---- standby side ------------------------------------------------------

    def recv(self) -> list[tuple[int, int, bytes]]:
        out = list(self._wire)
        self._wire.clear()
        for rec in out:
            if rec[0] > self.max_delivered:
                self.max_delivered = rec[0]
        self.counters["delivered"] += len(out)
        return out

    def ack(self, seq: int) -> None:
        """The standby's cumulative watermark: every seq <= ``seq`` is in
        the shadow."""
        self._acked = max(self._acked, int(seq))

    @property
    def acked(self) -> int:
        return self._acked


# protocol-monotone: applied_seq, last_seq
class StandbyApplier:
    """The standby of one queue: applies the stream into a shadow
    ``RecoveredQueue`` in seq order and acks the highest seq applied
    without a gap. An arrival ahead of a gap waits in ``_ahead`` until
    the retransmission fills the gap; an arrival at or below the watermark
    is a duplicate. A baseline replaces the shadow and re-bases the
    watermark. ``takeover`` applies what the link already delivered, bumps
    the epoch (fencing the ex-primary) and hands the shadow to the hub."""

    def __init__(self, queue: str, link: InProcReplicationLink,
                 authority: LeaseAuthority | None = None,
                 owner: str = "standby", hub: "ReplicationHub | None" = None):
        self.queue = queue
        self.link = link
        self.authority = authority
        self.owner = owner
        self.hub = hub
        self.shadow = RecoveredQueue(queue=queue, clean=False)
        #: The highest seq applied without a gap: the ack watermark.
        self.applied_seq = 0
        self._ahead: dict[int, tuple[int, int, bytes]] = {}
        self.counters = collections.Counter()

    # protocol-effect: standby_ack bounded-by applied_seq
    def pump(self) -> int:
        """Drain the link, apply in order, ack the watermark; returns the
        records applied."""
        before = self.counters["applied"]
        for seq, rtype, payload in self.link.recv():
            if rtype == RT_REPL_SNAPSHOT:
                # A baseline below the watermark is a retransmitted copy
                # of state already held.
                if seq >= self.applied_seq:
                    self._apply(seq, rtype, payload)
                    self._ahead = {s: r for s, r in self._ahead.items()
                                   if s > self.applied_seq}
                    self._drain_ahead()
                else:
                    self.counters["dups"] += 1
                continue
            if seq <= self.applied_seq:
                self.counters["dups"] += 1
                continue
            if seq == self.applied_seq + 1:
                self._apply(seq, rtype, payload)
                self._drain_ahead()
            else:
                self._ahead[seq] = (seq, rtype, payload)
                self.counters["buffered"] += 1
        applied = self.counters["applied"] - before
        self.link.ack(self.applied_seq)
        return applied

    def _drain_ahead(self) -> None:
        while True:
            rec = self._ahead.pop(self.applied_seq + 1, None)
            if rec is None:
                return
            self._apply(*rec)

    def _apply(self, seq: int, rtype: int, payload: bytes) -> None:
        """One record into the shadow, as the journal's replay reads it:
        ADMIT rows (re-)enter waiting, terminals move players to removed
        and the replay cache, an admission checkpoint replaces the last,
        CLEAN marks the stream clean and any later record reopens it."""
        sh = self.shadow
        if rtype == RT_REPL_SNAPSHOT:
            d = json.loads(payload.decode("utf-8"))
            sh = RecoveredQueue(queue=self.queue, clean=False)
            for row in d["rows"]:
                sh.waiting[str(row[0])] = row
            for pid, b64, exp in d["recent"]:
                sh.recent[str(pid)] = (base64.b64decode(b64), float(exp))
            sh.admission = d.get("admission")
            self.shadow = sh
            self.counters["snapshots"] += 1
        elif rtype == RT_CLEAN:
            sh.clean = True
        elif rtype == RT_ADMIT:
            sh.clean = False
            for row in json.loads(payload.decode("utf-8"))["rows"]:
                sh.waiting[str(row[0])] = row
                sh.removed.discard(str(row[0]))
        elif rtype in (RT_TERMINAL, RT_TERMINALS):
            sh.clean = False
            d = json.loads(payload.decode("utf-8"))
            entries = (d["t"] if rtype == RT_TERMINALS
                       else [[d["id"], d["body"], d["exp"]]])
            for pid, b64, exp in entries:
                pid = str(pid)
                sh.recent[pid] = (base64.b64decode(b64), float(exp))
                sh.waiting.pop(pid, None)
                sh.removed.add(pid)
        elif rtype == RT_ADMISSION:
            sh.clean = False
            sh.admission = json.loads(payload.decode("utf-8"))
        sh.last_seq = max(sh.last_seq, seq)
        # protocol-rebase: callers admit only the contiguous next seq or a re-basing snapshot
        self.applied_seq = seq
        self.counters["applied"] += 1

    def takeover(self, now: float, force: bool = False) -> int:
        """Promote this standby: apply the delivered tail, bump the epoch,
        register the shadow with the hub for a successor app. Returns the
        new epoch."""
        assert self.authority is not None, "takeover needs a LeaseAuthority"
        self.pump()
        new_epoch = self.authority.takeover(self.queue, self.owner, now,
                                            force=force)
        self.shadow.clean = False
        if self.hub is not None:
            self.hub.adopted[self.queue] = {
                "epoch": new_epoch, "owner": self.owner, "state": self.shadow,
                "applied_seq": self.applied_seq,
            }
        return new_epoch


# protocol-role: primary -> fenced
# protocol-monotone: sent_seq, acked_seq
class QueueReplication:
    """The primary's side of one queue (``_QueueRuntime.replication``):
    keeps the unacked tail for retransmission, the sent and acked
    watermarks, renews the lease, and holds the role (primary → fenced).

    The journal's ``tap`` calls ``on_record`` under the journal's lock
    (a dict insert and a send: cheap), its ``fence`` calls ``may_write``,
    the publish seams ``may_publish``; both checks ask the authority, so a
    superseded ex-primary can neither append nor publish, from any thread
    or path."""

    def __init__(self, queue: str, owner: str, epoch: int,
                 authority: LeaseAuthority, link: InProcReplicationLink,
                 metrics=None, events=None):
        self.queue = queue
        self.owner = owner
        self.epoch = epoch
        self.authority = authority
        self.link = link
        self.metrics = metrics
        self.events = events
        self.role = "primary"
        #: seq → (record type, payload).
        # guarded-by: _lock
        self._unacked: collections.OrderedDict[int, tuple[int, bytes]] = (
            collections.OrderedDict())
        #: seq → send time (the ack-lag histogram).
        self._send_t: dict[int, float] = {}  # guarded-by: _lock
        self.sent_seq = 0
        self.acked_seq = 0
        #: Sends that raised (logged; the record stays in the tail).
        self.send_errors = 0
        self._stalled_pumps = 0
        self._lock = threading.Lock()

    # ---- the stream (the journal's tap) ------------------------------------

    def on_record(self, seq: int, rtype: int, payload: bytes) -> None:
        """Ship one sealed record. Never raises into the append."""
        if self.role != "primary":
            return
        with self._lock:
            self._unacked[seq] = (rtype, payload)
            self._send_t[seq] = time.monotonic()
            if seq > self.sent_seq:
                self.sent_seq = seq
        try:
            self.link.send(seq, rtype, payload)
        except Exception:
            self.send_errors += 1
            log.exception("replication send failed for %r seq %d",
                          self.queue, seq)

    def send_baseline(self, seq: int, payload: bytes) -> None:
        """Ship the baseline at attach (carrying the journal seq it
        summarizes); kept and retransmitted like any record."""
        if seq > 0:
            with self._lock:
                self._unacked[seq] = (RT_REPL_SNAPSHOT, payload)
                self._send_t[seq] = time.monotonic()
                if seq > self.sent_seq:
                    self.sent_seq = seq
        try:
            self.link.send(seq, RT_REPL_SNAPSHOT, payload)
        except Exception:
            self.send_errors += 1
            log.exception("replication baseline send failed for %r",
                          self.queue)

    # ---- the fences --------------------------------------------------------

    def may_write(self) -> bool:
        """The journal's fence: False flips the role to fenced, and the
        journal raises ``FencedError``."""
        return self._check_current("journal append")

    def may_publish(self) -> bool:
        """The publish fence: False means the publish is dropped (and
        counted)."""
        return self._check_current("response publish")

    def superseded(self) -> bool:
        """The fence checks without their side effect."""
        return not self.authority.is_current(self.queue, self.owner,
                                             self.epoch)

    def _check_current(self, site: str) -> bool:
        if self.role == "fenced":
            return False
        if self.authority.is_current(self.queue, self.owner, self.epoch):
            return True
        self._fence(f"{site} refused: epoch {self.epoch} superseded by "
                    f"{self.authority.epoch_of(self.queue)}")
        return False

    def _fence(self, why: str) -> None:
        if self.role == "fenced":
            return
        self.role = "fenced"
        if self.metrics is not None:
            self.metrics.counters.inc("replication_fenced")
        if self.events is not None:
            self.events.append("replication_fenced", self.queue, why,
                               component="replication",
                               refs={"epoch": self.epoch})
        log.warning("queue %r: FENCED (%s)", self.queue, why)

    # ---- the pump ----------------------------------------------------------

    # protocol-effect: lease_renewal requires-check renew
    def pump(self, now: float) -> None:
        """One sender tick (``now``: ``time.monotonic()``): take the
        standby's ack, retransmit the unacked tail after two pumps without
        progress, renew the lease, set the lag gauges."""
        a = self.link.acked
        progress = a > self.acked_seq
        if progress:
            with self._lock:
                for seq in [s for s in self._unacked if s <= a]:
                    del self._unacked[seq]
                    t = self._send_t.pop(seq, None)
                    if t is not None and self.metrics is not None:
                        self.metrics.record_latency(
                            f"replication_ack_lag[{self.queue}]", now - t)
                self.acked_seq = a
            self._stalled_pumps = 0
        else:
            self._stalled_pumps += 1
        if (self.role == "primary" and not progress
                and self._stalled_pumps >= 2):
            with self._lock:
                tail = list(self._unacked.items())
            for seq, (rtype, payload) in tail:
                self.link.send(seq, rtype, payload)
        if self.role == "primary":
            if not self.authority.renew(self.queue, self.owner, self.epoch,
                                        now):
                # A refused renewal lets the lease lapse; the primary
                # serves on until the epoch is actually superseded.
                self._check_current("lease renewal")
        if self.metrics is not None:
            q = self.queue
            self.metrics.set_gauge(f"replication_lag[{q}]", self.lag())
            self.metrics.set_gauge(f"replication_epoch[{q}]", self.epoch)
            self.metrics.set_gauge(f"replication_acked_seq[{q}]",
                                   self.acked_seq)

    def shutdown(self, now: float) -> None:
        """A clean stop (after the CLEAN record streamed): a last pump,
        then the lease's release, so a standby may promote at once."""
        self.pump(now)
        if self.role == "primary":
            self.authority.release(self.queue, self.owner, self.epoch, now)

    # ---- observability -----------------------------------------------------

    def lag(self) -> int:
        """Records sent and not acked: what a host loss now could cost."""
        return max(0, self.sent_seq - self.acked_seq)

    @property
    def quiescent(self) -> bool:
        """The ack watermark caught up with the last record sent."""
        return self.acked_seq >= self.sent_seq

    def unacked_admit_players(self) -> int:
        """Players in unacked ADMIT and baseline records: the bound on the
        waiting players a kill now could lose across a failover."""
        with self._lock:
            tail = list(self._unacked.values())
        n = 0
        for rtype, payload in tail:
            if rtype == RT_ADMIT or rtype == RT_REPL_SNAPSHOT:
                n += len(json.loads(payload.decode("utf-8"))["rows"])
        return n

    def snapshot(self) -> dict[str, Any]:
        """The queue's replication block of ``/metrics`` and ``/healthz``."""
        return {
            "role": self.role,
            "owner": self.owner,
            "epoch": self.epoch,
            "sent_seq": self.sent_seq,
            "acked_seq": self.acked_seq,
            "lag": self.lag(),
            "link": dict(self.link.counters),
        }


class ReplicationHub:
    """The in-process fabric a primary app, its standbys and a failover
    successor share: the lease authority, one link per queue, and the
    takeover handoff (``adopted``: queue → the shadow a successor adopts at
    its start)."""

    def __init__(self, lease_s: float = 0.5, chaos=None, seed: int = 0):
        self.authority = LeaseAuthority(
            lease_s,
            fail_renewals=getattr(chaos, "repl_fail_renewals", ()) or ())
        self.chaos = chaos
        self.seed = seed
        self._links: dict[str, InProcReplicationLink] = {}
        #: queue → {"epoch", "owner", "state", "applied_seq"}, taken by the
        #: successor's ``start_replication``.
        self.adopted: dict[str, dict[str, Any]] = {}

    def link(self, queue: str) -> InProcReplicationLink:
        lk = self._links.get(queue)
        if lk is None:
            chaos = self.chaos
            if chaos is not None:
                qs = getattr(chaos, "queues", ()) or ()
                if qs and queue not in qs:
                    chaos = None
            lk = InProcReplicationLink(queue, chaos=chaos, seed=self.seed)
            self._links[queue] = lk
        return lk

    def standby(self, queue: str, owner: str = "standby") -> StandbyApplier:
        return StandbyApplier(queue, self.link(queue), self.authority,
                              owner=owner, hub=self)
