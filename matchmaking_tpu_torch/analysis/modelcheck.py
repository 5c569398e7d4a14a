"""Small-scope interleaving model checker for the failover protocol
(the dynamic half of the protocol conformance rule).

Where ``analysis/protocol.py`` proves per-path properties of the SOURCE
(every epoch-bearing effect fence-dominated, watermarks monotone), this
module checks the INTERACTION of the real objects: it drives the actual
:class:`~matchmaking_tpu_torch.service.replication.LeaseAuthority`,
:class:`~matchmaking_tpu_torch.service.replication.QueueReplication`,
:class:`~matchmaking_tpu_torch.service.replication.StandbyApplier`, and
:class:`~matchmaking_tpu_torch.utils.journal.PoolJournal` (fence + tap wired
exactly as ``_QueueRuntime.start_replication`` wires them — no mocks)
through a bounded exhaustive enumeration of action interleavings and
fault injections, via :class:`~matchmaking_tpu_torch.testing.scheduler.Explorer`.

Small-scope hypothesis: protocol bugs that exist at all show up at tiny
scope — two queues, a couple of admits, one settle, a handful of fault
actions. The checker enumerates EVERY interleaving at that scope
(state-digest dedup + partial-order reduction keep it tractable), so a
clean run is a proof over the bounded space, not a sampled soak.

Per-queue action vocabulary (``<action>@<queue>`` keys):

- core: ``admit`` (journal a window's admits — fence-checked append),
  ``settle`` (journal a terminal + write-ahead commit), ``publish``
  (release a settled response through the ``may_publish`` fence),
  ``pump_p`` (sender tick: acks/retransmit/lease renewal), ``pump_s``
  (standby tick: apply + ack watermark), ``takeover`` (standby
  promotion — refused while the lease is unexpired).
- faults (budget-bounded, config-selected): ``expire`` (advance the
  queue's virtual clock to the lease deadline), ``crash`` (primary dies:
  journal abandoned crash-faithfully), ``drop``/``dup``/``reorder``
  (in-flight stream records lost / duplicated / delivered out of
  order), ``partition`` (link partition healed by the retransmit tail).
  A *stale-epoch resume* needs no dedicated action: after
  ``expire -> takeover`` WITHOUT a crash, the un-dead ex-primary's
  core actions keep running and must all be refused by the fences.

Safety invariants, checked after EVERY action:

1. the authority's epoch per queue never decreases;
2. a successful journal append or response publish implies the writer's
   (owner, epoch) is still current — a fenced ex-primary that extends
   the WAL or answers a request is the split-brain bug;
3. the replication ack watermark never passes the receive horizon, nor
   the standby's applied watermark;
4. the standby applies contiguously: the watermark advances by exactly
   the records applied, and the gap buffer holds only future seqs;
5. at takeover, the promoted shadow equals an oracle rebuilt by
   replaying the on-disk journal records up to the applied watermark
   (recovered state == primary history at the cut);
6. at most one (owner, epoch) is current per queue.

Counterexamples minimize to the shortest failing schedule (greedy
delta-debugging), render as a spine-style causal timeline, and carry a
schedule digest that replays bit-identically
(``run_modelcheck(cfg, replay=[...])`` — the CI repro path).

The mutation gate (:func:`run_mutation_gate`) is the checker's own
test: it breaks each fenced seam one at a time (skip the append fence,
ack past the horizon, apply a gapped seq, publish from a stale epoch)
and asserts every mutant yields a minimized, digest-replayable
counterexample while the unmutated protocol stays clean.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import shutil
import tempfile
import time
from typing import Any

from matchmaking_tpu_torch.service.replication import (
    InProcReplicationLink, LeaseAuthority, LeaseHeldError, QueueReplication,
    StandbyApplier)
from matchmaking_tpu_torch.testing.scheduler import Explorer, schedule_digest
from matchmaking_tpu_torch.utils.journal import (
    FencedError, PoolJournal, RecoveredQueue, journal_path, read_segment)

__all__ = [
    "ACTIONS", "MUTANTS", "ModelCheckConfig", "ProtocolWorld",
    "mutation_gate_config", "run_modelcheck", "run_mutation_gate",
]

#: Canonical per-queue action order (the POR rule's ``index``): core
#: operations first, then the fault vocabulary.
ACTIONS = ("admit", "settle", "publish", "pump_p", "pump_s", "takeover",
           "expire", "crash", "drop", "dup", "reorder", "partition")

_FAULT_ACTIONS = frozenset(
    ("expire", "crash", "drop", "dup", "reorder", "partition"))

#: Seeded protocol breaks for the mutation gate — each one disables
#: exactly one fenced seam the invariants must then catch.
MUTANTS = ("skip-append-fence", "ack-past-horizon", "gapped-apply",
           "publish-stale-epoch")


@dataclasses.dataclass(frozen=True)
class ModelCheckConfig:
    """One bounded scope. The defaults are the committed CI smoke scope:
    exhaustive in seconds, yet past every seeded mutant's horizon."""

    #: Queues (worlds are per-queue independent except the lease
    #: authority object, whose state is per-queue keyed — which is what
    #: makes cross-queue actions commute for the POR rule).
    queues: int = 2
    #: Schedule length bound (actions per explored interleaving).
    depth: int = 6
    #: Admit windows per queue (each is one RT_ADMIT journal record).
    admits: int = 2
    #: Terminal settles per queue (journal + write-ahead commit).
    settles: int = 1
    #: Enabled fault actions (subset of the fault vocabulary).
    faults: "tuple[str, ...]" = ("expire", "crash", "drop", "dup")
    #: Total fault actions per schedule, across all queues.
    fault_budget: int = 2
    #: Unique-state cap — exceeded means ``exhaustive`` reports False.
    max_states: int = 250_000
    #: Wall-clock cap in seconds (None = none) — same exhaustive flag.
    deadline_s: "float | None" = None
    #: Virtual lease length (virtual clocks start at 0.0 per queue).
    lease_s: float = 5.0
    #: One of :data:`MUTANTS`, or None for the real protocol.
    mutation: "str | None" = None

    def scope(self) -> "dict[str, Any]":
        """The digest-salted scope knobs: a schedule only replays
        bit-identically under the scope that produced it."""
        return {
            "queues": self.queues, "depth": self.depth,
            "admits": self.admits, "settles": self.settles,
            "faults": list(self.faults), "fault_budget": self.fault_budget,
            "lease_s": self.lease_s, "mutation": self.mutation,
        }


def mutation_gate_config() -> ModelCheckConfig:
    """The committed mutation-gate scope: one queue and the two faults
    (``expire``, ``drop``) that set up every seeded seam break keep the
    per-mutant search small enough for the CI smoke budget."""
    return ModelCheckConfig(queues=1, depth=5, admits=2, settles=1,
                            faults=("expire", "drop"), fault_budget=2)


class _OracleLink:
    """Perfect one-shot link for the takeover oracle: delivers the
    on-disk records once, in order, and swallows acks."""

    def __init__(self, records: "list[tuple[int, int, bytes]]"):
        self._records = list(records)
        self.max_delivered = max((r[0] for r in self._records), default=0)

    def recv(self) -> "list[tuple[int, int, bytes]]":
        out, self._records = self._records, []
        return out

    def ack(self, seq: int) -> None:
        pass


class _QueueWorld:
    """One queue's real protocol objects plus the bookkeeping the
    invariants need (virtual clock, previous watermarks, publish
    ledger). All state is per-queue — the cross-queue POR contract."""

    def __init__(self, name: str, cfg: ModelCheckConfig, root: str,
                 authority: LeaseAuthority):
        self.name = name
        self.cfg = cfg
        self.root = root
        self.authority = authority
        self.clock = 0.0
        self.journal = PoolJournal(root, name, fsync="none")
        self.link = InProcReplicationLink(name)
        epoch = authority.acquire(name, "primary", now=self.clock)
        self.repl = QueueReplication(name, "primary", epoch, authority,
                                     self.link)
        # The exact _QueueRuntime.start_replication wiring: the journal
        # taps every sealed record into the sender and asks the sender's
        # epoch check before every append.
        self.journal.tap = self.repl.on_record
        self.journal.fence = (None if cfg.mutation == "skip-append-fence"
                              else self.repl.may_write)
        if cfg.mutation == "publish-stale-epoch":
            self.repl.may_publish = lambda: True  # type: ignore[method-assign]
        self.applier = StandbyApplier(name, self.link, authority,
                                      owner="standby")
        self.admits_done = 0
        self.settles_done = 0
        #: Settled-but-unpublished responses (pid, seq) — the window
        #: between the write-ahead commit and the publish fence.
        self.pending: "list[tuple[str, int]]" = []
        self.published: "list[str]" = []
        self.refused_publishes = 0
        self.primary_dead = False
        self.taken = False
        self.taken_epoch = 0
        self.partition_used = False
        self.last_epoch = epoch
        self._prev_applied_seq = 0
        self._prev_applied_cnt = 0

    # ---- action enabling ---------------------------------------------------

    def enabled(self, action: str, budget_left: bool) -> bool:
        if action in _FAULT_ACTIONS:
            if action not in self.cfg.faults or not budget_left:
                return False
        if action == "admit":
            return not self.primary_dead and self.admits_done < self.cfg.admits
        if action == "settle":
            return (not self.primary_dead
                    and self.settles_done < self.cfg.settles)
        if action == "publish":
            return not self.primary_dead and bool(self.pending)
        if action == "pump_p":
            return not self.primary_dead
        if action == "pump_s":
            return True
        if action == "takeover":
            return not self.taken
        if action == "expire":
            return not self.authority.expired(self.name, self.clock)
        if action == "crash":
            return not self.primary_dead
        if action == "drop" or action == "dup":
            return bool(self.link._wire)
        if action == "reorder":
            return len(self.link._wire) >= 2
        if action == "partition":
            return not self.link._partitioned and not self.partition_used
        raise ValueError(f"unknown action {action!r}")

    # ---- actions -----------------------------------------------------------

    def act(self, action: str, world: "ProtocolWorld") -> str:
        return getattr(self, f"_act_{action}")(world)

    def _require_current(self, world: "ProtocolWorld", what: str) -> None:
        """Invariant 2: the side effect just succeeded — the authority
        must still recognize the writer's (owner, epoch)."""
        if not self.authority.is_current(self.name, self.repl.owner,
                                         self.repl.epoch):
            world.violation = (
                f"[{self.name}] {what} succeeded under epoch "
                f"{self.repl.epoch} but the authority is at epoch "
                f"{self.authority.epoch_of(self.name)} — a fenced "
                f"ex-primary produced an externally visible effect")

    def _act_admit(self, world: "ProtocolWorld") -> str:
        pid = f"{self.name}-p{self.admits_done + 1}"
        row = [pid, 1500.0, 60.0, "eu", "duel", None, 0.0,
               "rt", "cid", 0, 99.0]
        try:
            seq = self.journal.append_admits([row])
        except FencedError:
            return "admit refused: journal append fenced (FencedError)"
        self.admits_done += 1
        self._require_current(world, f"journal append (admit seq {seq})")
        return f"admit {pid} journaled at seq {seq}"

    def _act_settle(self, world: "ProtocolWorld") -> str:
        pid = f"{self.name}-t{self.settles_done + 1}"
        try:
            seq = self.journal.append_terminal(
                pid, f"match:{pid}".encode("utf-8"), 99.0)
        except FencedError:
            return "settle refused: journal append fenced (FencedError)"
        self.journal.commit()
        self.settles_done += 1
        self.pending.append((pid, seq))
        self._require_current(world, f"journal append (terminal seq {seq})")
        return f"settle {pid} journaled at seq {seq}, write-ahead committed"

    def _act_publish(self, world: "ProtocolWorld") -> str:
        pid, _seq = self.pending[0]
        if not self.repl.may_publish():
            self.refused_publishes += 1
            return f"publish {pid} refused: epoch superseded (dropped)"
        self.pending.pop(0)
        self.published.append(pid)
        self._require_current(world, f"response publish ({pid})")
        return f"published response {pid} under epoch {self.repl.epoch}"

    def _act_pump_p(self, world: "ProtocolWorld") -> str:
        self.repl.pump(self.clock)
        return (f"primary pump: acked_seq={self.repl.acked_seq} "
                f"lag={self.repl.lag()} role={self.repl.role}")

    def _act_pump_s(self, world: "ProtocolWorld") -> str:
        mut = self.cfg.mutation
        if mut == "ack-past-horizon":
            # Seeded break: ack the receive horizon, not the applied
            # watermark — a gap makes the ack overrun the apply.
            self.applier.pump()
            self.link.ack(self.link.max_delivered)
        elif mut == "gapped-apply":
            # Seeded break: apply whatever arrived, contiguous or not.
            for seq, rtype, payload in self.link.recv():
                if seq > self.applier.applied_seq:
                    self.applier._apply(seq, rtype, payload)
            self.link.ack(self.applier.applied_seq)
        else:
            self.applier.pump()
        return (f"standby pump: applied_seq={self.applier.applied_seq} "
                f"acked={self.link.acked} ahead={len(self.applier._ahead)}")

    def _act_takeover(self, world: "ProtocolWorld") -> str:
        try:
            epoch = self.applier.takeover(now=self.clock, force=False)
        except LeaseHeldError:
            return "takeover refused: lease not expired (standby pumped once)"
        self.taken = True
        self.taken_epoch = epoch
        bad = self._oracle_check()
        if bad is not None:
            world.violation = bad
        return f"standby took over: epoch -> {epoch}, ex-primary fenced"

    def _act_expire(self, world: "ProtocolWorld") -> str:
        with self.authority._lock:
            lease = self.authority._leases.get(self.name)
            deadline = self.clock if lease is None else lease.deadline
        self.clock = max(self.clock, deadline)
        return f"virtual clock -> {self.clock:g}: lease expired"

    def _act_crash(self, world: "ProtocolWorld") -> str:
        self.journal.abandon()
        self.primary_dead = True
        return "primary crashed: journal abandoned (kill -9 fidelity)"

    def _act_drop(self, world: "ProtocolWorld") -> str:
        rec = self.link._wire.popleft()
        return f"wire drop: stream record seq {rec[0]} lost in flight"

    def _act_dup(self, world: "ProtocolWorld") -> str:
        rec = self.link._wire[0]
        self.link._wire.append(rec)
        return f"wire dup: stream record seq {rec[0]} duplicated"

    def _act_reorder(self, world: "ProtocolWorld") -> str:
        rec = self.link._wire.popleft()
        self.link._wire.append(rec)
        return f"wire reorder: stream record seq {rec[0]} delivered late"

    def _act_partition(self, world: "ProtocolWorld") -> str:
        start = self.repl.sent_seq + 1
        self.link.partition(start, start + 2)
        self.partition_used = True
        return (f"link partitioned from seq {start}, "
                f"healing at seq {start + 2}")

    # ---- invariants --------------------------------------------------------

    def sweep(self) -> "str | None":
        name = self.name
        epoch = self.authority.epoch_of(name)
        if epoch < self.last_epoch:
            return (f"[{name}] epoch rewound: {self.last_epoch} -> {epoch} "
                    f"(the fencing token must be monotone)")
        self.last_epoch = epoch
        link, applier = self.link, self.applier
        if link.acked > link.max_delivered:
            return (f"[{name}] ack watermark {link.acked} passed the "
                    f"receive horizon {link.max_delivered} (acked a record "
                    f"never delivered)")
        if link.acked > applier.applied_seq:
            return (f"[{name}] ack watermark {link.acked} passed the "
                    f"applied watermark {applier.applied_seq} — the primary "
                    f"may now trim history the standby never applied")
        if any(s <= applier.applied_seq for s in applier._ahead):
            return (f"[{name}] gap buffer holds seq(s) at or below the "
                    f"applied watermark {applier.applied_seq}")
        d_seq = applier.applied_seq - self._prev_applied_seq
        d_cnt = applier.counters["applied"] - self._prev_applied_cnt
        self._prev_applied_seq = applier.applied_seq
        self._prev_applied_cnt = applier.counters["applied"]
        if d_seq != d_cnt:
            return (f"[{name}] applied watermark advanced by {d_seq} with "
                    f"{d_cnt} record(s) applied — contiguous apply broken "
                    f"(a gap was skipped, losing records)")
        candidates = [(self.repl.owner, self.repl.epoch)]
        if self.taken:
            candidates.append((self.applier.owner, self.taken_epoch))
        current = [pair for pair in candidates
                   if self.authority.is_current(name, *pair)]
        if len(current) > 1:
            return (f"[{name}] split-brain: {current} are BOTH current")
        return None

    def _oracle_check(self) -> "str | None":
        """Invariant 5: the promoted shadow equals a from-disk replay of
        the journal up to the applied watermark — what the real recovery
        path (``recover_from_replica`` vs journal attach) would see."""
        header, records, torn, _off = read_segment(
            journal_path(self.root, self.name))
        cut = self.applier.applied_seq
        oracle = StandbyApplier(self.name,
                                _OracleLink([r for r in records
                                             if r[0] <= cut]))
        oracle.pump()
        got = self._shadow_key(self.applier.shadow)
        want = self._shadow_key(oracle.shadow)
        if got != want:
            return (f"[{self.name}] divergent failover: promoted shadow "
                    f"{got} != journal replay at cut seq {cut} {want}")
        return None

    @staticmethod
    def _shadow_key(sh: RecoveredQueue) -> "tuple[Any, ...]":
        return (sorted(sh.waiting), sorted(sh.removed), sorted(sh.recent),
                sh.admission, sh.last_seq)

    # ---- canonical state ---------------------------------------------------

    def digest(self) -> "tuple[Any, ...]":
        """Everything behavior depends on, nothing else: observability
        counters and wall-clock send times are deliberately excluded, so
        schedules differing only in those merge for dedup."""
        link, applier, repl, sh = (self.link, self.applier, self.repl,
                                   self.applier.shadow)
        return (
            self.journal.seq, self.journal.synced_seq,
            repl.role, repl.epoch, repl.sent_seq, repl.acked_seq,
            tuple(repl._unacked), repl._stalled_pumps,
            tuple((s, rt) for s, rt, _p in link._wire),
            tuple((s, rt) for s, rt, _p in link._partition_buf),
            link._partitioned, link._resume_at, tuple(sorted(link._seen)),
            link._acked, link.max_delivered,
            applier.applied_seq, tuple(sorted(applier._ahead)),
            tuple(sorted(sh.waiting)), tuple(sorted(sh.removed)),
            tuple(sorted(sh.recent)), sh.clean, sh.last_seq,
            self.clock, self.primary_dead, self.taken, self.taken_epoch,
            self.admits_done, self.settles_done,
            tuple(self.pending), tuple(self.published),
            self.partition_used,
        )

    def close(self) -> None:
        self.journal.abandon()


class ProtocolWorld:
    """One small-scope instance of the whole protocol: N queues sharing
    one :class:`LeaseAuthority` (per-queue keyed), each wired exactly as
    production wires them. Implements the
    :class:`~matchmaking_tpu_torch.testing.scheduler.Explorer` world protocol.
    """

    def __init__(self, cfg: ModelCheckConfig, root: str):
        self.cfg = cfg
        self.root = root
        self.violation: "str | None" = None
        self.authority = LeaseAuthority(lease_s=cfg.lease_s)
        self.queues: "dict[str, _QueueWorld]" = {}
        for i in range(cfg.queues):
            name = f"q{i}"
            self.queues[name] = _QueueWorld(name, cfg, root, self.authority)
        self._index = {f"{a}@{q}": qi * len(ACTIONS) + ai
                       for qi, q in enumerate(sorted(self.queues))
                       for ai, a in enumerate(ACTIONS)}
        self.faults_used = 0

    # ---- explorer protocol -------------------------------------------------

    def enabled(self) -> "list[str]":
        budget_left = self.faults_used < self.cfg.fault_budget
        out: "list[str]" = []
        for qname in sorted(self.queues):
            q = self.queues[qname]
            for action in ACTIONS:
                if q.enabled(action, budget_left):
                    out.append(f"{action}@{qname}")
        return out

    def step(self, key: str) -> str:
        action, _, qname = key.partition("@")
        effect = self.queues[qname].act(action, self)
        if action in _FAULT_ACTIONS:
            self.faults_used += 1
        return effect

    def check(self) -> "str | None":
        if self.violation is not None:
            return self.violation
        for qname in sorted(self.queues):
            bad = self.queues[qname].sweep()
            if bad is not None:
                self.violation = bad
                return bad
        return None

    def digest(self) -> "tuple[Any, ...]":
        return (self.faults_used,) + tuple(
            self.queues[q].digest() for q in sorted(self.queues))

    def slot(self, key: str) -> str:
        return key.partition("@")[2]

    def index(self, key: str) -> int:
        return self._index[key]

    def close(self) -> None:
        for q in self.queues.values():
            q.close()
        shutil.rmtree(self.root, ignore_errors=True)


# ---- entry points ----------------------------------------------------------


def _scratch_base() -> "str | None":
    """RAM-backed scratch when available: the explorer builds one fresh
    journal directory per replayed schedule, so metadata latency is the
    dominant cost on a disk-backed tmp (measured ~6x slower than
    tmpfs). Falls back to the platform default."""
    base = "/dev/shm"
    if os.path.isdir(base) and os.access(base, os.W_OK):
        return base
    return None


@contextlib.contextmanager
def _quiet_protocol_logs():
    """Exploration drives the objects through thousands of INTENDED
    fencings/refusals — the replication module's warnings about them are
    the checker's working noise, not operator signal."""
    logger = logging.getLogger("matchmaking_tpu_torch.service.replication")
    prev = logger.level
    logger.setLevel(logging.CRITICAL)
    try:
        yield
    finally:
        logger.setLevel(prev)


def _result_dict(cfg: ModelCheckConfig, *, states: int = 0, nodes: int = 0,
                 replays: int = 0, pruned_dedup: int = 0, pruned_por: int = 0,
                 exhaustive: bool = False, violation: "str | None" = None,
                 schedule: "list[str] | None" = None,
                 timeline: "list[str] | None" = None,
                 elapsed_s: float = 0.0, replay_mode: bool = False
                 ) -> "dict[str, Any]":
    schedule = schedule or []
    return {
        "modelcheck_queues": cfg.queues,
        "modelcheck_depth": cfg.depth,
        "modelcheck_faults": list(cfg.faults),
        "modelcheck_fault_budget": cfg.fault_budget,
        "modelcheck_mutation": cfg.mutation,
        "modelcheck_replay": replay_mode,
        "modelcheck_states_explored": states,
        "modelcheck_nodes": nodes,
        "modelcheck_replays": replays,
        "modelcheck_pruned_dedup": pruned_dedup,
        "modelcheck_pruned_por": pruned_por,
        "modelcheck_exhaustive": exhaustive,
        "modelcheck_violations": 0 if violation is None else 1,
        "modelcheck_violation": violation,
        "modelcheck_schedule": schedule,
        "modelcheck_schedule_digest": (
            schedule_digest(schedule, cfg.scope()) if schedule else ""),
        "modelcheck_timeline": timeline or [],
        "modelcheck_elapsed_s": round(elapsed_s, 3),
    }


def run_modelcheck(cfg: "ModelCheckConfig | None" = None, *,
                   replay: "list[str] | None" = None) -> "dict[str, Any]":
    """Explore one bounded scope (or, with ``replay``, re-execute one
    exact schedule — the CI repro path for a counterexample digest).
    Returns a JSON-able report; ``modelcheck_violations`` is 0 on a
    clean exhaustive run."""
    cfg = cfg or ModelCheckConfig()
    t0 = time.monotonic()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_quiet_protocol_logs())
        td = stack.enter_context(tempfile.TemporaryDirectory(
            prefix="mmtpu-modelcheck-", dir=_scratch_base()))
        ids = itertools.count()

        def factory() -> ProtocolWorld:
            d = os.path.join(td, f"w{next(ids)}")
            os.makedirs(d)
            return ProtocolWorld(cfg, d)

        explorer = Explorer(factory, max_depth=cfg.depth,
                            max_states=cfg.max_states,
                            deadline_s=cfg.deadline_s)
        if replay is not None:
            timeline, bad = explorer.trace(list(replay))
            return _result_dict(cfg, replays=explorer.replays,
                                violation=bad, schedule=list(replay),
                                timeline=timeline, replay_mode=True,
                                elapsed_s=time.monotonic() - t0)
        res = explorer.explore()
        return _result_dict(
            cfg, states=res.states, nodes=res.nodes, replays=res.replays,
            pruned_dedup=res.pruned_dedup, pruned_por=res.pruned_por,
            exhaustive=res.exhaustive, violation=res.violation,
            schedule=res.schedule, timeline=res.timeline,
            elapsed_s=res.elapsed_s)


def run_mutation_gate(cfg: "ModelCheckConfig | None" = None
                      ) -> "dict[str, Any]":
    """The checker's own falsifiability test: every seeded seam break
    must produce a minimized counterexample whose schedule REPLAYS to
    the same violation under the same digest, and the unmutated
    protocol at the same scope must stay clean."""
    base = cfg or mutation_gate_config()
    t0 = time.monotonic()
    mutants: "dict[str, dict[str, Any]]" = {}
    all_caught = True
    for name in MUTANTS:
        mcfg = dataclasses.replace(base, mutation=name)
        rep = run_modelcheck(mcfg)
        caught = rep["modelcheck_violations"] > 0
        replay_ok = False
        if caught:
            rerun = run_modelcheck(mcfg, replay=rep["modelcheck_schedule"])
            replay_ok = (
                rerun["modelcheck_violation"] == rep["modelcheck_violation"]
                and (rerun["modelcheck_schedule_digest"]
                     == rep["modelcheck_schedule_digest"]))
        all_caught = all_caught and caught and replay_ok
        mutants[name] = {
            "caught": caught,
            "replay_ok": replay_ok,
            "steps": len(rep["modelcheck_schedule"]),
            "schedule": rep["modelcheck_schedule"],
            "digest": rep["modelcheck_schedule_digest"],
            "violation": rep["modelcheck_violation"],
            "timeline": rep["modelcheck_timeline"],
            "states_explored": rep["modelcheck_states_explored"],
        }
    clean = run_modelcheck(dataclasses.replace(base, mutation=None))
    baseline_clean = (clean["modelcheck_violations"] == 0
                      and clean["modelcheck_exhaustive"])
    return {
        "mutation_gate_mutants": mutants,
        "mutation_gate_all_caught": all_caught,
        "mutation_gate_baseline_clean": baseline_clean,
        "mutation_gate_passed": all_caught and baseline_clean,
        "mutation_gate_elapsed_s": round(time.monotonic() - t0, 3),
    }
