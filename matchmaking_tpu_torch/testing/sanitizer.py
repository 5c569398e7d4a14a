"""Runtime async sanitizer: the dynamic half of the port's matchlint
gate.

Static rules (matchmaking_tpu_torch/analysis) catch the lock-discipline
bugs visible in the AST; this module catches the ones only an execution
order reveals, with zero changes to production code — a test installs it
and the service's own ``asyncio.Lock()`` calls come back instrumented:

- **lock-order inversion** — every task's held-lock set is tracked; an
  acquisition of B while holding A records the edge A→B with both call
  sites. The first task that acquires in the reverse order reports an
  inversion (the classic two-lock deadlock, caught even when the schedule
  happens to win the race this run).
- **await-under-lock** — when a lock is held across an actual event-loop
  suspension, a ``call_soon`` canary fires and walks the holder task's
  coroutine await chain. The sanctioned suspensions: ``asyncio.to_thread``
  (and ``_shielded_to_thread``, its cancellation-hardened form — the
  off-loop seam), ``_QueueRuntime._backpressure_wait`` (the pipeline's
  lock-held wait for a free window slot: the port dispatches on the loop
  under ``_pool_lock``, so a full pipeline holds the flush there by
  design) and the dispatch arbiter's ``_arbiter_turn`` (the cross-queue
  gate, the strictly innermost resource). Anything else reports the
  acquire site AND the awaiting file:line. Best effort by construction —
  a suspension shorter than one loop pass can escape — but a real stall
  (sleep, RPC, I/O) is caught deterministically because the canary is
  already queued.
- **event-loop stall** — a watchdog task sleeps a short interval and
  measures oversleep; a callback that blocked the loop longer than the
  threshold is recorded with the observed stall. Started lazily on the
  first instrumented acquire in each loop (soak tests run their own
  ``asyncio.run``).
- **held-lock duration histogram** — every release records the hold time
  against the acquire site (``hold_report()``: count / max / p50 / p99 per
  site, log-spaced buckets from utils/metrics.Histogram). A convoy — one
  slow window serializing a queue behind ``_pool_lock`` — shows up as a
  fat p99 at one site; ``assert_clean`` quotes the slowest sites so a
  failing soak names its convoy.
- **settlement twin** — the dynamic half of the static ``settlement``
  typestate (analysis/lifecycle.py): ``AdmissionController
  .admit/release`` and the in-proc broker's app-facing ``ack``/``nack``
  come back instrumented.  A second app-level settle of a delivery tag
  that is no longer in flight (and was not requeued in between) is a
  **double-settle**; an admission credit still held at ``assert_clean``
  for a tag the broker already settled is a **credit leak** — both
  reported with the acquire/settle sites quoted.  The broker's own crash
  handler and cancel paths go through ``_Consumer.nack``/``_requeue``
  directly, so at-least-once redelivery never trips the check — only the
  app's settle seam is audited, which is exactly the static rule's scope,
  measured instead of proved.
- **replication twin** — the hot-standby replication seams
  (service/replication.py, net/link.py) come back instrumented.  A
  **publish after fence** is a response that became VISIBLE at the broker
  from a runtime whose (owner, epoch) the lease authority no longer
  recognizes — the split-brain double match epoch fencing exists to kill;
  refused attempts (the publish closure returning early at its fence) are
  NOT findings, only real visibility is.  The port's publishes leave
  through ``_QueueRuntime._effect`` (inline, or after the settler's
  commit), so the twin audits every effect as it runs.  An **apply out of
  order** is a standby applying a stream record whose seq is not
  ``watermark + 1`` (a baseline snapshot legitimately re-bases).  An
  **ack beyond received** is a replication ack past the link's delivered
  horizon — the primary would drop unacked-tail records the standby never
  saw, turning a failover into silent loss.  All three report with both
  sites quoted.
- **journal twin** — the write-ahead pool journal (utils/journal.py) comes
  back instrumented.  A delivery **acked while its queue's journal holds
  uncommitted records** (fsync policy ≠ ``none``) violates the
  acked-after-append discipline; an **identical record appended twice**
  within one segment is a double-append (replay would apply the mutation
  twice); an **append after the clean-shutdown marker** voids the crash
  detector.  All three report with both sites quoted.
- **speculation twin** — ``GpuEngine.spec_validate``/``spec_commit``: a
  commit with no live validation (or a stale token) is reported even when
  the service's cut helper swallows the engine's raise.

Usage:

    san = AsyncSanitizer(stall_threshold_s=2.0)
    with san.installed():
        asyncio.run(main())
    san.assert_clean()

Overhead is one ``call_soon`` per loop pass per *held* instrumented lock
plus O(1) dict work per acquire, per settle and per journal append.
"""

from __future__ import annotations

import asyncio
import sys
import time
from typing import Any

__all__ = ["AsyncSanitizer", "InstrumentedLock", "SanitizerFinding"]

#: Await chains routed through these code names (or asyncio/threads.py)
#: are sanctioned suspensions under a lock: the off-loop seam
#: (``to_thread``, ``run_in_executor``, service/app's
#: ``_shielded_to_thread`` — asyncio.shield detaches the await chain from
#: the thread task, so the bare names no longer appear in the holder's
#: frames), the pipeline's lock-held backpressure wait
#: (``_backpressure_wait``, the one place a window flush suspends with
#: ``_pool_lock`` held) and control/arbiter's ``_arbiter_turn`` (the
#: cross-queue dispatch gate: the slot is the strictly innermost resource,
#: holders never acquire a lock under it, so the wait is bounded and
#: cycle-free). matchlint's await-under-lock rule sanctions the same names.
_SANCTIONED_CODE_NAMES = {
    "to_thread", "run_in_executor", "_shielded_to_thread",
    "_backpressure_wait", "_arbiter_turn",
}


class SanitizerFinding:
    __slots__ = ("kind", "message")

    def __init__(self, kind: str, message: str):
        self.kind = kind
        self.message = message

    def __repr__(self) -> str:
        return f"[{self.kind}] {self.message}"


def _caller_site(skip_module: str) -> str:
    """file:line (function) of the nearest frame outside this module and
    asyncio internals — the acquire/creation site shown in findings."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if skip_module not in fn and "asyncio" not in fn.replace("\\", "/"):
            return f"{fn}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<unknown>"


def _await_chain_frames(task: asyncio.Task) -> list[Any]:
    """The frames a suspended task is parked in, outermost → innermost."""
    frames: list[Any] = []
    c = task.get_coro()
    seen: set[int] = set()
    while c is not None and id(c) not in seen:
        seen.add(id(c))
        fr = getattr(c, "cr_frame", None)
        if fr is None:
            fr = getattr(c, "gi_frame", None)
        if fr is not None:
            frames.append(fr)
        nxt = getattr(c, "cr_await", None)
        if nxt is None:
            nxt = getattr(c, "gi_yieldfrom", None)
        c = nxt
    return frames


class InstrumentedLock(asyncio.Lock):
    """Drop-in ``asyncio.Lock`` that reports to an AsyncSanitizer."""

    def __init__(self, sanitizer: "AsyncSanitizer"):
        super().__init__()
        self._san = sanitizer
        sanitizer._locks.append(self)  # pin: id()s in _order stay unique
        self._where = _caller_site(__name__.replace(".", "/"))
        self._generation = 0
        self._holder: asyncio.Task | None = None
        self._acquire_site = ""
        self._acquired_at = 0.0
        self._reported_hold = False

    async def acquire(self) -> bool:
        ok = await super().acquire()
        self._san._on_acquired(self)
        return ok

    def release(self) -> None:
        self._san._on_release(self)
        super().release()


class _HoldStats:
    """Hold-time distribution for one lock acquire site. Uses the shared
    log-spaced Histogram (utils/metrics.py) — stdlib-only, bounded memory,
    p99 accurate to one factor-2 bucket — plus the exact max, because the
    single worst convoy is the number a failing soak needs."""

    __slots__ = ("hist", "max_s")

    def __init__(self) -> None:
        from matchmaking_tpu_torch.utils.metrics import Histogram

        self.hist = Histogram()
        self.max_s = 0.0

    def observe(self, seconds: float) -> None:
        self.hist.observe(seconds)
        if seconds > self.max_s:
            self.max_s = seconds

    def to_dict(self) -> dict[str, float]:
        return {
            "count": self.hist.count,
            "max_ms": round(self.max_s * 1e3, 3),
            "p50_ms": round(self.hist.percentile(50) * 1e3, 3),
            "p99_ms": round(self.hist.percentile(99) * 1e3, 3),
        }


class AsyncSanitizer:
    def __init__(self, stall_threshold_s: float = 0.5,
                 stall_interval_s: float = 0.05,
                 max_canaries_per_hold: int = 100_000):
        self.findings: list[SanitizerFinding] = []
        self.stall_threshold_s = stall_threshold_s
        self.stall_interval_s = stall_interval_s
        self.max_canaries_per_hold = max_canaries_per_hold
        #: (earlier_lock_id, later_lock_id) -> (site_earlier, site_later):
        #: observed acquisition orders, for inversion detection. Keyed by
        #: id() — sound only because ``_locks`` below pins every
        #: instrumented lock for the sanitizer's (test-scoped) lifetime,
        #: so CPython can never reuse an id for a different lock.
        self._order: dict[tuple[int, int], tuple[str, str]] = {}
        #: Strong refs to every lock this sanitizer instrumented.
        self._locks: list[InstrumentedLock] = []
        #: task -> [(lock, acquire_site)] currently held, LIFO.
        self._held: dict[asyncio.Task, list[tuple[InstrumentedLock,
                                                  str]]] = {}
        self._reported: set[tuple[str, ...]] = set()
        #: Loops with a stall watchdog installed. Holds the loop OBJECTS:
        #: consecutive asyncio.run calls can reuse a dead loop's id(), and
        #: an id-keyed set would then silently skip installing the
        #: watchdog on every later loop.
        self._watched_loops: set[Any] = set()
        #: Held-lock duration accounting: acquire site → _HoldStats (makes
        #: lock convoys visible).
        self._holds: dict[str, _HoldStats] = {}
        #: The longest loop stall the watchdog measured, over the
        #: threshold or not (seconds).
        self.longest_stall_s = 0.0
        #: Speculative commits the speculation twin saw go through.
        self.spec_commits = 0
        self._orig_lock: Any = None
        # ---- settlement twin state -----------------------------
        #: (id(controller), delivery_tag) → (controller, acquire site):
        #: admission credits currently held.  The controller ref is pinned
        #: for the sanitizer's test-scoped lifetime, so id() keys are
        #: stable (same argument as ``_locks``).
        self._credits: dict[tuple[int, int], tuple[Any, str]] = {}
        #: delivery_tag → (kind, site) of the last app-level settle since
        #: the delivery was (re)registered (tags are globally unique —
        #: the in-proc broker draws them from one counter).
        self._settles: dict[int, tuple[str, str]] = {}
        # ---- journal twin state --------------------------------
        #: Strong refs to every PoolJournal created while installed
        #: (id()-key stability — same argument as ``_locks``).
        self._journal_refs: list[Any] = []
        #: id(journal) → {(rtype, payload crc32): first append site} for
        #: the LIVE segment (reset at rotation: compaction legitimately
        #: carries terminals into the fresh segment).
        self._journal_seen: dict[int, dict[tuple[int, int], str]] = {}
        #: id(journal) → site of the clean-shutdown marker append.
        self._journal_clean: dict[int, str] = {}
        #: id(journal) → site of the newest still-uncommitted append.
        self._journal_dirty_site: dict[int, str] = {}
        # ---- replication twin state ----------------------------
        #: Strong refs to every LeaseAuthority whose takeover fired while
        #: installed (id()-key stability — same argument as ``_locks``).
        self._repl_refs: list[Any] = []
        #: (id(authority), queue) → site of the newest takeover — the
        #: fencing event a publish-after-fence finding quotes.
        self._repl_takeover: dict[tuple[int, str], str] = {}
        #: id(applier) → (expected next seq, site of the previous apply).
        self._repl_applied: dict[int, tuple[int, str]] = {}
        #: id(link) → site of the newest recv() (the receive horizon an
        #: ack may never pass).
        self._repl_recv_site: dict[int, str] = {}
        # ---- speculation twin state ----------------------------
        #: Strong refs to every GpuEngine whose speculation seam fired
        #: while installed (id()-key stability — same argument as
        #: ``_locks``).
        self._spec_refs: list[Any] = []
        #: id(engine) → (validated token, validate site): the freshness
        #: record a later spec_commit must present. Cleared by every pool
        #: mutation — a commit that finds no record (or a stale token)
        #: committed a speculation OLDER than the last pool mutation.
        self._spec_valid: dict[int, tuple[int, str]] = {}

    # ---- installation ------------------------------------------------------

    def installed(self):
        """Context manager patching ``asyncio.Lock`` (lock instrumentation)
        plus the port's seams: the admission controller's admit/release
        and the in-proc broker's app-facing ack/nack (the settlement
        twin), the pool journal's append/commit discipline (the journal
        twin), ``GpuEngine``'s speculation validate/commit ordering (the
        speculation twin), and the lease authority's takeover, the
        standby's apply, the links' recv/ack and the queue runtime's
        effects (the replication twin) — every lock, settle, journal
        write, speculative commit and publish the code under test performs
        reports here."""
        import contextlib
        import zlib as _zlib

        from matchmaking_tpu_torch.service import broker as _broker_mod
        from matchmaking_tpu_torch.service import overload as _overload_mod
        from matchmaking_tpu_torch.utils import journal as _journal_mod

        san = self
        _site = lambda: _caller_site(__name__.replace(".", "/"))  # noqa: E731

        class _Factory(asyncio.Lock):
            def __new__(cls, *a: Any, **k: Any):
                return InstrumentedLock(san)

        ac = _overload_mod.AdmissionController
        br = _broker_mod.InProcBroker
        orig_admit, orig_release = ac.admit, ac.release
        orig_ack, orig_nack = br.ack, br.nack
        orig_requeue = br._requeue

        def admit(ctrl, delivery_tag: int, tier: int = 0) -> None:
            if delivery_tag not in ctrl._credits:
                san._credits[(id(ctrl), delivery_tag)] = (
                    ctrl, _caller_site(__name__.replace(".", "/")))
            orig_admit(ctrl, delivery_tag, tier)

        def release(ctrl, delivery_tag: int) -> None:
            san._credits.pop((id(ctrl), delivery_tag), None)
            orig_release(ctrl, delivery_tag)

        def ack(broker, consumer_tag: str, delivery_tag: int) -> None:
            san._on_settle(broker, consumer_tag, delivery_tag, "ack")
            orig_ack(broker, consumer_tag, delivery_tag)

        def nack(broker, consumer_tag: str, delivery_tag: int,
                 requeue: bool = True) -> None:
            san._on_settle(broker, consumer_tag, delivery_tag, "nack")
            orig_nack(broker, consumer_tag, delivery_tag, requeue)

        def _requeue(broker, queue, delivery) -> None:
            # Redelivery legitimizes a future settle of the SAME tag (the
            # in-proc broker reuses the Delivery object): reset the twin's
            # record so at-least-once redelivery never reads as a double.
            # A dead-lettered delivery never re-enters, so its record must
            # SURVIVE — a later second settle of that tag is still the
            # double-settle class this twin exists to catch.
            if delivery.redelivery_count < broker.cfg.max_redelivery:
                san._settles.pop(delivery.delivery_tag, None)
            orig_requeue(broker, queue, delivery)

        # ---- journal twin -------------------------------------------------
        pj = _journal_mod.PoolJournal
        orig_jinit = pj.__init__
        orig_jappend = pj._append
        orig_jcommit = pj.commit
        orig_jclean = pj.mark_clean
        orig_jcompact = pj.compact_finish

        def jinit(j, *a: Any, **k: Any) -> None:
            orig_jinit(j, *a, **k)
            san._journal_refs.append(j)

        def jappend(j, rtype: int, payload: bytes, logical: int,
                    writeout: bool = False) -> int:
            site = _site()
            clean_site = san._journal_clean.get(id(j))
            if clean_site is not None:
                san._report(
                    "journal-append-after-clean",
                    ("jclean", j.queue, site),
                    f"journal for queue {j.queue!r} appended to at {site} "
                    f"AFTER its clean-shutdown marker was written at "
                    f"{clean_site} — the marker must be the final record "
                    f"(boot trusts its presence to skip crash recovery)")
            if rtype in (_journal_mod.RT_ADMIT, _journal_mod.RT_TERMINAL,
                         _journal_mod.RT_TERMINALS):
                key = (rtype, _zlib.crc32(payload))
                seen = san._journal_seen.setdefault(id(j), {})
                prev = seen.get(key)
                if prev is not None:
                    san._report(
                        "journal-double-append",
                        ("jdouble", j.queue, prev, site),
                        f"identical journal record (type {rtype}) appended "
                        f"twice in one segment for queue {j.queue!r}: "
                        f"first at {prev}, again at {site} — replay would "
                        f"apply the mutation twice")
                else:
                    seen[key] = site
            # writeout appends are never observably buffered (the frame is
            # os.write'n inside the same lock hold), so they leave no
            # dirty site — dropping the flag here would both false-flag
            # concurrent settles and change the on-disk crash shape the
            # instrumented tests exercise.
            if not writeout:
                san._journal_dirty_site[id(j)] = site
            return orig_jappend(j, rtype, payload, logical, writeout)

        def jcommit(j, force_sync: bool = False) -> None:
            san._journal_dirty_site.pop(id(j), None)
            orig_jcommit(j, force_sync)

        def jclean(j) -> None:
            orig_jclean(j)
            san._journal_clean[id(j)] = _site()
            san._journal_dirty_site.pop(id(j), None)

        def jcompact(j, *a: Any, **k: Any) -> None:
            orig_jcompact(j, *a, **k)
            # Fresh segment: the dedup key space resets with it (the
            # rotation wrote the carried terminals directly, not via
            # _append, so they never collide here).
            san._journal_seen.pop(id(j), None)
            san._journal_dirty_site.pop(id(j), None)

        # ---- speculation twin ---------------------------------------------
        # Dynamic mirror of the validation-token discipline the engine
        # enforces by raising and matchlint checks lexically: a committed
        # speculative window must carry a validation token NEWER than the
        # last pool mutation. The twin reports the ordering violation
        # even when a supervising caller (the service's cut helper
        # swallows commit failures by design) eats the engine's raise.
        from matchmaking_tpu_torch.engine import gpu as _gpu_mod

        te = _gpu_mod.GpuEngine
        orig_svalidate = te.spec_validate
        orig_scommit = te.spec_commit
        orig_sinval = te.spec_invalidate
        orig_smutated = te._pool_mutated

        def svalidate(eng, now: float, max_age_s: float = 0.0):
            tok = orig_svalidate(eng, now, max_age_s)
            if tok is not None:
                if not any(e is eng for e in san._spec_refs):
                    san._spec_refs.append(eng)
                san._spec_valid[id(eng)] = (tok, _site())
            else:
                san._spec_valid.pop(id(eng), None)
            return tok

        def smutated(eng) -> None:
            # Every pool mutation retires the freshness record — exactly
            # the clock semantics spec_commit must be newer than.
            san._spec_valid.pop(id(eng), None)
            orig_smutated(eng)

        def sinval(eng, reason: str = "external") -> None:
            san._spec_valid.pop(id(eng), None)
            orig_sinval(eng, reason)

        def scommit(eng, token, now: float):
            site = _site()
            if token is not None:
                rec = san._spec_valid.pop(id(eng), None)
                if rec is None:
                    san._report(
                        "spec-commit-unvalidated",
                        ("spec-unvalidated", site),
                        f"spec_commit at {site} carries token {token} with "
                        f"no live validation record — spec_validate never "
                        f"ran, or a pool mutation ran after it (validate-"
                        f"after-mutate): a committed speculative window "
                        f"must carry a validation token newer than the "
                        f"last pool mutation")
                elif rec[0] != token or token != eng.pool_mutations:
                    san._report(
                        "spec-commit-stale-token",
                        ("spec-stale", site),
                        f"spec_commit at {site} presents token {token} but "
                        f"the live validation is {rec[0]} from {rec[1]} "
                        f"(pool_mutations={eng.pool_mutations}) — the "
                        f"committed window would predate the last pool "
                        f"mutation")
            out = orig_scommit(eng, token, now)
            if out is not None:
                san.spec_commits += 1
            return out

        # ---- replication twin ---------------------------------------------
        # Dynamic mirror of the epoch-fencing and stream-ordering
        # disciplines: the production seams REFUSE violations (fenced
        # publishes return early, the applier's pump buffers gaps) — the
        # twin reports when a violation actually became OBSERVABLE, i.e.
        # a fenced runtime's response reached the broker, a record applied
        # out of seq order, or an ack passed the delivered horizon.
        from matchmaking_tpu_torch.service import app as _app_mod
        from matchmaking_tpu_torch.service import replication as _repl_mod

        la = _repl_mod.LeaseAuthority
        sap = _repl_mod.StandbyApplier
        rl = _repl_mod.InProcReplicationLink
        qrt = _app_mod._QueueRuntime
        orig_takeover = la.takeover
        orig_rapply = sap._apply
        orig_rrecv = rl.recv
        orig_rack = rl.ack
        # Socket twin: the standby half of the SOCKET link
        # exposes the identical recv/ack/max_delivered surface, so the
        # same closures mirror it — an ack past the delivered horizon is
        # the same silent-loss bug whichever transport carried it.
        # Guarded import: the sanitizer must stay usable if the net
        # package is unavailable.
        try:
            from matchmaking_tpu_torch.net.link import (
                SocketStandbyLink as _slink_cls,
            )
        except ImportError:  # pragma: no cover - net package missing
            _slink_cls = None
        orig_srecv = _slink_cls.recv if _slink_cls is not None else None
        orig_sack = _slink_cls.ack if _slink_cls is not None else None
        orig_effect = qrt._effect

        def _pin_repl(obj: Any) -> None:
            if not any(o is obj for o in san._repl_refs):
                san._repl_refs.append(obj)

        def rtakeover(auth, queue: str, owner: str, now: float,
                      force: bool = False) -> int:
            epoch = orig_takeover(auth, queue, owner, now, force=force)
            _pin_repl(auth)
            san._repl_takeover[(id(auth), queue)] = _site()
            return epoch

        def _published(rt) -> int:
            stats = getattr(rt.broker, "stats", None)
            return stats.get("published", 0) if stats is not None else 0

        def _audit_publish(rt, before: int, site: str) -> None:
            r = rt.replication
            if r is None or not r.superseded():
                return
            if _published(rt) > before:
                tsite = san._repl_takeover.get(
                    (id(r.authority), r.queue),
                    "<lease authority (no takeover recorded)>")
                san._report(
                    "replication-publish-after-fence",
                    ("repl-pub", r.queue, site),
                    f"queue {r.queue!r}: a response became visible at the "
                    f"broker via {site} from owner {r.owner!r} epoch "
                    f"{r.epoch} AFTER the epoch was superseded (takeover "
                    f"at {tsite}) — the split-brain double match epoch "
                    f"fencing exists to kill")

        def effect(rt, fn, *, hold: bool = False) -> None:
            # The site is the publish seam that queued the effect; the
            # audit runs when the effect does (inline, or in the settler
            # after its commit).
            site = _site()

            def audited() -> None:
                before = _published(rt)
                fn()
                _audit_publish(rt, before, site)
            orig_effect(rt, audited, hold=hold)

        def rapply(applier, seq: int, rtype: int, payload: bytes) -> None:
            site = _site()
            _pin_repl(applier)
            if rtype != _repl_mod.RT_REPL_SNAPSHOT:
                rec = san._repl_applied.get(id(applier))
                expect, prev_site = (
                    rec if rec is not None
                    else (applier.applied_seq + 1,
                          "<applier watermark at install>"))
                if applier.applied_seq and seq != expect:
                    san._report(
                        "replication-apply-out-of-order",
                        ("repl-order", applier.queue, seq, site),
                        f"standby for {applier.queue!r} applied stream seq "
                        f"{seq} at {site} but the watermark expects "
                        f"{expect} (previous apply at {prev_site}) — "
                        f"out-of-order apply corrupts the shadow the "
                        f"failover successor adopts")
            orig_rapply(applier, seq, rtype, payload)
            san._repl_applied[id(applier)] = (applier.applied_seq + 1, site)

        def rrecv(link):
            out = orig_rrecv(link)
            _pin_repl(link)
            san._repl_recv_site[id(link)] = _site()
            return out

        def rack(link, seq: int) -> None:
            site = _site()
            if seq > link.max_delivered:
                rsite = san._repl_recv_site.get(
                    (id(link)), "<no recv yet>")
                san._report(
                    "replication-ack-beyond-received",
                    ("repl-ack", link.queue, seq, site),
                    f"replication ack {seq} at {site} passes the delivered "
                    f"horizon {link.max_delivered} (last recv at {rsite}) "
                    f"for queue {link.queue!r} — the primary would drop "
                    f"unacked-tail records the standby never saw, turning "
                    f"failover into silent loss")
            orig_rack(link, seq)

        def srecv(link):
            out = orig_srecv(link)
            _pin_repl(link)
            san._repl_recv_site[id(link)] = _site()
            return out

        def sack(link, seq: int) -> None:
            site = _site()
            if seq > link.max_delivered:
                rsite = san._repl_recv_site.get(
                    (id(link)), "<no recv yet>")
                san._report(
                    "replication-ack-beyond-received",
                    ("repl-ack", link.queue, seq, site),
                    f"replication ack {seq} at {site} passes the delivered "
                    f"horizon {link.max_delivered} (last recv at {rsite}) "
                    f"for queue {link.queue!r} over the SOCKET link — the "
                    f"primary would drop unacked-tail records the standby "
                    f"never saw, turning failover into silent loss")
            orig_sack(link, seq)

        @contextlib.contextmanager
        def _cm():
            self._orig_lock = asyncio.Lock
            asyncio.Lock = _Factory  # type: ignore[misc]
            ac.admit, ac.release = admit, release
            br.ack, br.nack, br._requeue = ack, nack, _requeue
            pj.__init__, pj._append = jinit, jappend
            pj.commit, pj.mark_clean = jcommit, jclean
            pj.compact_finish = jcompact
            te.spec_validate, te.spec_commit = svalidate, scommit
            te.spec_invalidate, te._pool_mutated = sinval, smutated
            la.takeover, sap._apply = rtakeover, rapply
            rl.recv, rl.ack = rrecv, rack
            if _slink_cls is not None:
                _slink_cls.recv, _slink_cls.ack = srecv, sack
            qrt._effect = effect
            try:
                yield self
            finally:
                asyncio.Lock = self._orig_lock  # type: ignore[misc]
                ac.admit, ac.release = orig_admit, orig_release
                br.ack, br.nack = orig_ack, orig_nack
                br._requeue = orig_requeue
                pj.__init__, pj._append = orig_jinit, orig_jappend
                pj.commit, pj.mark_clean = orig_jcommit, orig_jclean
                pj.compact_finish = orig_jcompact
                te.spec_validate, te.spec_commit = (orig_svalidate,
                                                    orig_scommit)
                te.spec_invalidate = orig_sinval
                te._pool_mutated = orig_smutated
                la.takeover, sap._apply = orig_takeover, orig_rapply
                rl.recv, rl.ack = orig_rrecv, orig_rack
                if _slink_cls is not None:
                    _slink_cls.recv = orig_srecv
                    _slink_cls.ack = orig_sack
                qrt._effect = orig_effect

        return _cm()

    # ---- settlement twin ---------------------------------------------------

    def _on_settle(self, broker: Any, consumer_tag: str,
                   delivery_tag: int, kind: str) -> None:
        consumer = broker._consumers.get(consumer_tag)
        if consumer is None:
            return  # late settle after basic_cancel: documented no-op
        site = _caller_site(__name__.replace(".", "/"))
        # Journal twin: the write-ahead discipline — every
        # journaled mutation must be COMMITTED (acked-after-append) before
        # its delivery settles when the fsync policy promises durability.
        # Runs for every settle, including the first of a tag.
        qname = getattr(getattr(consumer, "queue", None), "name", None)
        if qname is not None:
            for j in self._journal_refs:
                if j.queue == qname and j.fsync != "none" and j.dirty:
                    append_site = self._journal_dirty_site.get(
                        id(j), "<unknown>")
                    self._report(
                        "journal-unflushed-settle",
                        ("jflush", qname, site),
                        f"delivery tag {delivery_tag} {kind}ed at {site} "
                        f"while queue {qname!r}'s journal holds "
                        f"uncommitted record(s) (newest appended at "
                        f"{append_site}) — the write-ahead discipline "
                        f"requires commit before settle when "
                        f"fsync={j.fsync!r}")
        if delivery_tag in consumer.unacked:
            self._settles[delivery_tag] = (kind, site)
            return
        prev = self._settles.get(delivery_tag)
        if prev is not None:
            self._report(
                "double-settle", ("settle", consumer_tag, delivery_tag,
                                  prev[1], site),
                f"delivery tag {delivery_tag} {kind}ed at {site} but it "
                f"was already {prev[0]}ed at {prev[1]} (no redelivery in "
                f"between) — the second settle acks a delivery the caller "
                f"no longer owns")

    def settlement_report(self) -> dict[str, Any]:
        """Open credits + settle counts, for tests that drain fully and
        want to assert the ledger is empty."""
        return {
            "open_credits": [
                {"tag": tag, "queue": ctrl.queue, "acquired_at": site}
                for (_cid, tag), (ctrl, site) in sorted(
                    self._credits.items())
            ],
            "settled": len(self._settles),
        }

    def _check_settlement_leaks(self) -> None:
        for (_cid, tag), (ctrl, site) in sorted(self._credits.items()):
            if tag in self._settles:
                self._report(
                    "credit-leak", ("leak", ctrl.queue, tag),
                    f"admission credit for delivery tag {tag} "
                    f"(queue {ctrl.queue!r}) is still held after the "
                    f"delivery settled at the broker — acquired at {site}; "
                    f"the limiter's inflight count never recovers")

    # ---- reporting ---------------------------------------------------------

    def _report(self, kind: str, dedup: tuple[str, ...],
                message: str) -> None:
        if dedup in self._reported:
            return
        self._reported.add(dedup)
        self.findings.append(SanitizerFinding(kind, message))

    def hold_report(self, top: int = 0) -> dict[str, dict[str, float]]:
        """Held-lock durations per acquire site (count / max / p50 / p99 in
        ms), slowest max first. ``top`` caps the row count (0 = all)."""
        rows = sorted(self._holds.items(),
                      key=lambda kv: kv[1].max_s, reverse=True)
        if top:
            rows = rows[:top]
        return {site: stats.to_dict() for site, stats in rows}

    def assert_clean(self) -> None:
        self._check_settlement_leaks()
        if self.findings:
            # Quote the slowest lock sites alongside the findings: an
            # overload-induced convoy (every queue serialized behind one
            # slow engine step) is usually WHY the stall/await finding
            # fired, and the hold histogram names the site.
            holds = "\n".join(
                f"    {site}: {stats}"
                for site, stats in self.hold_report(top=3).items())
            raise AssertionError(
                "async sanitizer findings:\n" + "\n".join(
                    f"  {f!r}" for f in self.findings)
                + (f"\n  slowest lock sites:\n{holds}" if holds else ""))

    # ---- lock events -------------------------------------------------------

    def _on_acquired(self, lock: InstrumentedLock) -> None:
        try:
            task = asyncio.current_task()
            loop = asyncio.get_running_loop()
        except RuntimeError:  # pragma: no cover - no loop: nothing to track
            return
        if task is None:  # pragma: no cover
            return
        site = _caller_site(__name__.replace(".", "/"))
        held = self._held.setdefault(task, [])
        for other, osite in held:
            if other is lock:
                continue
            self._order.setdefault((id(other), id(lock)), (osite, site))
            rev = self._order.get((id(lock), id(other)))
            if rev is not None:
                self._report(
                    "lock-order-inversion",
                    ("inv", other._where, lock._where),
                    f"lock created at {lock._where} acquired while holding "
                    f"lock created at {other._where} at {site}, but the "
                    f"REVERSE order was taken at {rev[1]} (after "
                    f"{rev[0]}) — a schedule exists that deadlocks both "
                    f"tasks")
        held.append((lock, site))
        lock._generation += 1
        lock._holder = task
        lock._acquire_site = site
        lock._acquired_at = time.monotonic()
        lock._reported_hold = False
        loop.call_soon(self._canary, lock, lock._generation, 0)
        self._ensure_stall_watch(loop)

    def _on_release(self, lock: InstrumentedLock) -> None:
        if lock._acquired_at:
            # Held-lock duration, attributed to the ACQUIRE site (the code
            # that decided to close the critical section, not whoever
            # releases it) — lock convoys read as a fat p99 at one site.
            held_s = time.monotonic() - lock._acquired_at
            lock._acquired_at = 0.0
            site = lock._acquire_site or lock._where
            stats = self._holds.get(site)
            if stats is None:
                stats = self._holds[site] = _HoldStats()
            stats.observe(held_s)
        lock._generation += 1  # invalidate in-flight canaries
        lock._holder = None
        for task, held in list(self._held.items()):
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is lock:
                    del held[i]
                    if not held:  # don't pin completed tasks forever
                        del self._held[task]
                    return

    def _canary(self, lock: InstrumentedLock, generation: int,
                count: int) -> None:
        """Runs whenever the loop regains control while ``lock`` may still
        be held: the holder suspended mid-critical-section."""
        if lock._generation != generation or not lock.locked():
            return  # released (or re-acquired) since scheduling
        task = lock._holder
        if task is None or task.done():
            return
        frames = _await_chain_frames(task)
        sanctioned = any(
            fr.f_code.co_name in _SANCTIONED_CODE_NAMES
            or fr.f_code.co_filename.replace("\\", "/").endswith(
                "asyncio/threads.py")
            for fr in frames)
        if not sanctioned and not lock._reported_hold:
            site = None
            for fr in reversed(frames):
                fn = fr.f_code.co_filename.replace("\\", "/")
                if "asyncio" not in fn and "/testing/sanitizer" not in fn:
                    site = f"{fn}:{fr.f_lineno} ({fr.f_code.co_name})"
                    break
            if site is None and frames:  # pragma: no cover - all internal
                fr = frames[-1]
                site = f"{fr.f_code.co_filename}:{fr.f_lineno}"
            if site is not None:
                lock._reported_hold = True
                self._report(
                    "await-under-lock",
                    ("await", lock._acquire_site, site),
                    f"lock acquired at {lock._acquire_site} held across a "
                    f"non-sanctioned suspension awaiting at {site} — other "
                    f"tasks interleave with the critical section "
                    f"(route blocking work through asyncio.to_thread)")
        if count < self.max_canaries_per_hold:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:  # pragma: no cover - loop closing
                return
            # First re-check rides the very next loop pass (catches short
            # non-sanctioned suspensions); after that poll at 5 ms — a
            # per-pass reschedule during a long sanctioned to_thread hold
            # (collector ticks run every 1 ms) is pure overhead, and a
            # violation lasting under the poll interval is best-effort
            # either way.
            if count == 0:
                loop.call_soon(self._canary, lock, generation, 1)
            else:
                loop.call_later(0.005, self._canary, lock, generation,
                                count + 1)

    # ---- event-loop stall watchdog ----------------------------------------

    def _ensure_stall_watch(self, loop: asyncio.AbstractEventLoop) -> None:
        if loop in self._watched_loops:
            return
        self._watched_loops.add(loop)
        loop.create_task(self._stall_watch(), name="sanitizer-stall-watch")

    async def _stall_watch(self) -> None:
        loop = asyncio.get_running_loop()
        interval = self.stall_interval_s
        while True:
            before = loop.time()
            await asyncio.sleep(interval)
            lag = loop.time() - before - interval
            if lag > self.longest_stall_s:
                self.longest_stall_s = lag
            if lag > self.stall_threshold_s:
                self._report(
                    "loop-stall", ("stall", f"{lag:.3f}"),
                    f"event loop blocked for {lag * 1e3:.0f} ms "
                    f"(threshold {self.stall_threshold_s * 1e3:.0f} ms): a "
                    f"callback ran blocking work on the loop")
