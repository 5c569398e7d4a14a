"""The matchmaking service: the pipelined window loop of every queue of a
config.

Each queue of ``cfg.queues`` gets its own ``_QueueRuntime``: an engine, a
consumer of the queue's broker queue, a batcher, its loops and its
terminal-replay cache. A 1v1 queue takes the columnar path:

    broker burst consume → ``_on_delivery_batch``: the first-receive
    stamp, one native decode of the burst (``service/ingress.py``: rows
    the codec flags NEEDS_PYTHON decode through the contract module;
    malformed rows are answered here) → batcher window → ``_flush``:
    terminal-replay probe → column gather from the decoded bursts →
    ``engine.search_columns_async`` …
    collected window: native batch encode → one ``publish_batch`` → acks

With ``BrokerConfig.consume_batch`` off (or a burst under
``_MIN_DECODE_BURST`` rows) each delivery runs the stamp middleware on its
own and the flush decodes the window natively instead.

A team or role queue (configs #3 and #5) takes the object path:

    broker consume → stamp + decode middleware (a ``SearchRequest`` with
    its party and roles) → batcher window → ``_flush``: terminal-replay
    probe → ``engine.search_async`` …
    collected window: one ``publish_batch`` of the ``SearchOutcome``'s
    answers (``contract.encode_response``) → acks

Up to ``EngineConfig.pipeline_depth`` windows are in flight: a window is
answered when it is collected — by a later flush or by the collector loop
— and the batcher waits while the pipeline is full. With depth 1 each
window is dispatched and collected in one step. Beside the batcher run the
rescan loop (``QueueConfig.rescan_interval_s``: re-matches the
longest-waiting players so widened thresholds resolve inside the pool),
the sweep loop (``request_timeout_s`` timeouts and the per-player
``x-deadline`` expiry of ``OverloadConfig.deadline_sweep_ms``), the
health timer (``EngineConfig.health_interval_s``: moves an idle team or
role queue that was handed to the host oracle back onto the card,
rebuilds a bucketed queue's index, and runs the circuit breaker's
half-open probes) and, for a 1v1 queue with
``EngineConfig.spec_formation``, the speculation loop: every
``spec_interval_ms`` while no window is in flight it commits the
speculation it left last time, if still valid, and lets the engine
speculate again. Every cut (a window's dispatch, a rescan tick) first
commits a valid speculation (``spec_validate`` then ``spec_commit``, with
nothing in between); its matches are published as a rescan tick's.

Every request gets a ``queued`` ack when it enters the pool
(``send_queued_ack``), each matched player a ``matched`` response with
``latency_ms`` and ``waited_ms``, engine rejections an ``error``, and
expired players ``timeout``. A redelivered request whose player reached a
terminal answer within ``dedup_ttl_s`` is answered with the cached body.
A window that fails on the device is nacked (the broker redelivers it) and
the engine is rebuilt from the old engine's mirror, its quality counters
carried across (``quality_checkpoint`` / ``quality_restore``), and the old
engine closed. Every published match also lands in ``app.quality``
(service/quality.py), the per-queue, per-tier ledger of matched players'
quality and wait.

Overload control (``OverloadConfig``, service/overload.py): with any of its
knobs set, each runtime has an ``AdmissionController``. Ingress stamps the
default deadline, caches each delivery's tier and deadline, and answers a
request already past its deadline (``timeout``) or arriving while draining
(``shed``). The credit and waiting-pool ladder runs once per cut window at
the top of the flush, in arrival order (``_admission_cut``; per delivery at
ingress with ``batch_admission`` off); a refused request gets ``shed``
with a retry-after hint. The batcher and the flush order a window by
(tier, deadline) with ``edf``; a deadline is checked again at the cut and
right before the dispatch; under ``shed_policy="oldest"`` the dispatch
pays the window's debt by evicting the lowest tier's longest-waiting
players (``shed`` answers) or shedding the window's own lowest-tier
entrants. A credit is returned on every settle (ack or nack).

The circuit breaker (``EngineConfig.breaker_threshold``,
service/breaker.py): every engine crash is counted; once the breaker
trips, the next engine rebuild is the host oracle (engine/cpu.py) with the
whole pool, served synchronously on the object path (a columnar delivery
already in the batcher is decoded at its flush). The health timer's
half-open probes (``_probe_device``) build a fresh device engine and run
its ``probe()``; on success the pool moves onto it (``waiting()`` objects)
and the breaker closes. ``_bind_engine`` recomputes the ingress shape, the
pipeline and the collector on every swap. Scripted engine faults
(``Config.chaos``, utils/chaos.py) reach every engine of a queue through
one hook, whose indices survive the swaps.

Durability (``DurabilityConfig``, utils/journal.py): each queue writes a
write-ahead journal. A dispatched window's players are one ADMIT record,
written out at the dispatch; every terminal answer (a window's matches in
one record, timeouts, evictions) is a TERMINAL record. Every answer and
every ack leaves after a commit that covers the records before it: inline,
or, under an fsync policy, through the settler (``_effect``), which
commits on a worker thread and then publishes and acks in order. The
compaction timer snapshots the pool (utils/checkpoint.py) and rotates the
segment under ``_pool_lock``, which every pool-mutating entry point takes
for its synchronous stretch. ``start`` recovers an unclean predecessor's
journal before the consumer exists; ``stop`` writes the clean marker;
``crash`` leaves the disk as ``kill -9`` would. ``drain`` stops admission,
stops every queue and saves the pools, the admission state and the
broker's backlog; ``restore_checkpoint`` takes them back.

Auth (``AuthConfig``, service/middleware.py): ``static`` and ``rpc`` run
in the middleware chain of each delivery (``rpc`` with a handler task per
delivery, so its round trips overlap); the columnar ingress without the
chain serves auth ``"none"`` only.

Everything runs on the event loop's thread: a dispatch or a collection
runs to its end without yielding, so only compaction and recovery, which
wait for a worker thread, need ``_pool_lock``; and no second thread
contends with the loop for the interpreter lock (every PyTorch call of the
window step releases and retakes it).

Tracing (``ObservabilityConfig.trace``, on by default; utils/trace.py):
the broker stamps a ``TraceContext`` on each request it publishes (every
``trace_sample_n``-th with sampling) and the runtime marks it at consume,
middleware, batch, flush and the answer's encode, respond and publish;
each window's engine marks (dispatch, h2d, device_step, readback_seal,
collect) are merged into its members' traces when it is collected, and
every answer carries its ``trace_id``. A settled trace goes to
``app.recorder`` (the flight recorder), the per-stage histograms of
``app.metrics`` and ``app.attribution`` (work against wait); adaptive
shedding reads the p99 of the "total" stage over the traces settled since
the last cut. ``app.metrics`` also holds the counters under the JAX
package's names (each runtime's ``counters`` dict stays) and the gauges
(breaker state, batch fill, admission, ``crash_rto_ms``); ``app.events``
is the event log of every lifecycle event, stamped onto ``app.spine``
(utils/forensics.py). The marks, events and histogram updates are host
code outside any graph capture; settling a trace rides the same effect
queue as its answer, so its marks keep the order they have in the JAX
app.

Telemetry (``ObservabilityConfig.snapshot_interval_s``, 1 s by default;
utils/timeseries.py): a task samples pool size, batch fill, breaker state,
shed and expired, the stage p99, work and wait, SLO good/total, the device's
busy and idle seconds and speculation into ``app.telemetry`` and then runs
the SLO burn monitors (``slo_target_ms``: one per queue, one per tier with
``overload.tiers`` > 1, and ``<queue>#quality`` with
``quality_slo_target``). ``app.incidents`` (utils/forensics.py) freezes an
incident bundle when a trigger event (an SLO burn, a breaker trip, a crash
recovery) is stamped. With ``Config.metrics_port`` the app serves
``/healthz``, ``/metrics`` and ``/debug/*`` (service/observability.py) on
its own loop. A tick, a capture and a scrape read host state only.

Chaos and invariants: ``Config.chaos`` scripts the broker's faults as well
(drops, duplicate storms, partitions: the app hands its ``ChaosState`` and
``Config.seed`` to the broker, service/broker.py); with
``Config.debug_invariants`` each runtime feeds every window's outcome,
columnar or object, and every rescan tick's to an ``InvariantChecker``
(utils/invariants.py), which raises at a double match.

Replication (``ReplicationConfig``, service/replication.py): with a role
and a hub (``MatchmakingApp(replication_hub=...)``: a ``ReplicationHub``
in this process, or a ``SocketReplicationHub``, net/link.py; with
``NetConfig.transport`` "socket" and no hub passed the app builds and owns
a socket hub from ``cfg.net``), each queue's journal streams to a standby,
in this process or another. ``start_replication`` runs after the
journal's recovery and before the consumer: it adopts a standby's shadow
the hub holds for this queue (``recover_from_replica``: a failover
successor), takes the lease, and, under ``_pool_lock`` with no window in
flight, installs the journal's tap and fence and sends the baseline, so
the stream is gapless from the baseline's seq. A pump task collects acks,
retransmits a stalled tail and renews the lease. A fenced ex-primary's
appends raise and its publishes are refused and counted
(``fenced_publish_refused``); ``stop`` streams the clean marker and
releases the lease.

This is the JAX package's ``MatchmakingApp`` and ``_QueueRuntime`` (their
columnar path, the object flush, the health timer, burst consume and
decode, the speculation loop and cut, overload control and the circuit
breaker, broker chaos and the invariant checker, durability, in-process
replication and failover over the in-process or the socket fabric, the
drain, auth, tracing, the metrics and the event log, telemetry and the SLO
burn monitors, incident capture and the HTTP surfaces), without
placement, the autotuner, the AMQP transport and the dispatch arbiter.

    python -m matchmaking_tpu_torch.service.app --demo [--device cpu]
                                                [--config PATH]

runs ten players through every queue of the service (the default
one-queue config, or the config file at PATH; on the card unless
``--device`` says otherwise) and prints their answers;

    python -m matchmaking_tpu_torch.service.app serve [--device cpu]

serves the ``MM_*`` config on the in-process broker until SIGTERM.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
import os
import time
from typing import Any, Iterable, Sequence

import numpy as np

from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.engine.cpu import CpuEngine
from matchmaking_tpu_torch.engine.interface import (
    ColumnarOutcome,
    SearchOutcome,
    make_engine,
)
from matchmaking_tpu_torch.engine.quality import QualitySpec
from matchmaking_tpu_torch.native import codec
from matchmaking_tpu_torch.service.attribution import Attribution
from matchmaking_tpu_torch.service.batcher import Batcher
from matchmaking_tpu_torch.service.breaker import (
    CLOSED,
    STATE_CODE,
    CircuitBreaker,
)
from matchmaking_tpu_torch.service.broker import Delivery, InProcBroker, Properties
from matchmaking_tpu_torch.service.client import MatchmakingClient
from matchmaking_tpu_torch.service.contract import (
    ContractError,
    MatchResult,
    RequestColumns,
    SearchRequest,
    SearchResponse,
    decode_request,
    encode_response,
)
from matchmaking_tpu_torch.service.ingress import (
    IngressShards,
    ShardedRecent,
    gather_rows,
)
from matchmaking_tpu_torch.service.middleware import (
    MessageContext,
    MiddlewareReject,
    columnar_pipeline,
    default_pipeline,
)
from matchmaking_tpu_torch.service.overload import (
    ADMIT,
    EXPIRED,
    AdmissionController,
    deadline_of,
)
from matchmaking_tpu_torch.service.quality import QualityLedger
from matchmaking_tpu_torch.service.replication import (
    QueueReplication,
    baseline_payload,
)
from matchmaking_tpu_torch.utils import checkpoint
from matchmaking_tpu_torch.utils.chaos import ChaosState
from matchmaking_tpu_torch.utils.forensics import EventSpine, IncidentRecorder
from matchmaking_tpu_torch.utils.invariants import InvariantChecker
from matchmaking_tpu_torch.utils.journal import PoolJournal, row_to_request
from matchmaking_tpu_torch.utils.metrics import Metrics
from matchmaking_tpu_torch.utils.timeseries import SloMonitor, TelemetryRing
from matchmaking_tpu_torch.utils.trace import (
    EventLog,
    FlightRecorder,
    TraceContext,
)

log = logging.getLogger(__name__)

#: A response row: (reply_to, correlation_id, body, trace or None); the
#: trace gets its "respond" mark when the row is published.
Row = tuple[str, str, bytes, Any]

#: Fewest deliveries of a consume burst that are decoded at consume; the
#: rows of a smaller burst are decoded with their window at the flush.
_MIN_DECODE_BURST = 16

#: Counters of failures the service catches and recovers from (a failed
#: window is nacked and the engine revived, a failed tick retried).
FAULT_COUNTERS = ("engine_failures", "revives", "outcome_errors",
                  "collector_errors", "rescan_skipped", "health_tick_errors",
                  "spec_errors", "flush_errors", "replication_pump_errors")


def _admit_rows(cols: RequestColumns, regions, modes) -> list[tuple]:
    """ADMIT rows of ``cols`` (the journal's portable row: region and mode
    by name, ``regions`` / ``modes``), value for value the JAX package's
    (the same dtypes, read in the same order; tuples, not lists: the same
    JSON with no list built per row)."""
    k = len(cols)
    tiers = cols.tier.tolist() if cols.tier is not None else [0] * k
    dls = cols.deadline.tolist() if cols.deadline is not None else [0.0] * k
    thr = cols.threshold.astype(object)  # Python floats
    thr[np.isnan(cols.threshold)] = None
    return list(zip(
        cols.ids.tolist(), cols.rating.tolist(), cols.rd.tolist(),
        list(regions), list(modes), thr.tolist(), cols.enqueued_at.tolist(),
        cols.reply_to.tolist(), cols.correlation_id.tolist(), tiers, dls))


def _admit_rows_of(requests: Iterable[SearchRequest]) -> list[list]:
    """ADMIT rows of request objects (the object path and the object
    baseline): the JAX package's row, field for field."""
    return [
        [r.id, float(r.rating), float(r.rating_deviation), r.region,
         r.game_mode,
         (None if r.rating_threshold is None else float(r.rating_threshold)),
         float(r.enqueued_at), r.reply_to, r.correlation_id,
         int(r.tier), float(r.deadline_at)]
        for r in requests]


class _QueueRuntime:
    """One queue of the app: its engine (``make_engine``, or the host
    oracle while its breaker is open), batcher and consumer, its
    collector, rescan, sweep and health loops, its revive state, its
    admission controller and breaker, its terminal-replay cache and its
    pipeline (the object or the columnar path). A queue's answers are
    published, acked, deduped and observed by its own runtime only; the
    quality ledger is the app's, keyed by queue name.

    Batcher items are ``(request or None, delivery)``: None where decoding
    waits for the flush (the columnar ingress)."""

    def __init__(self, app: "MatchmakingApp", queue_cfg: QueueConfig):
        self.app = app
        self.cfg = app.cfg
        self.queue_cfg = queue_cfg
        self.broker = app.broker
        self.device = app.device
        #: The app's metrics (counters under the JAX package's names,
        #: gauges, stage histograms) and event log.
        self.metrics: Metrics = app.metrics
        self.events: EventLog = app.events
        #: The app-wide ledger: per queue, per tier quality and wait of
        #: matched players, fed when their answers are published.
        self.quality = app.quality
        #: Team and role queues speak the engine's object API (decoded
        #: requests, ``SearchOutcome``s); 1v1 queues the columnar one,
        #: except while the host oracle serves them (``_bind_engine``).
        self._team = queue_cfg.team_size > 1
        self._objects = self._team
        self.pipeline = None
        self.pipeline_depth = max(1, self.cfg.engine.pipeline_depth)
        self.engine = None
        #: The engine has the pipelined window API (``collect_ready``,
        #: ``inflight``, ...): the device engine; the host oracle has not.
        self._async_api = False
        #: The columnar ingress runs (decode waits for the flush, and a
        #: consume burst is decoded at once), else each delivery runs the
        #: middleware chain, admission included, on its own.
        self._inline_ingress = False
        self.counters = {
            "windows": 0, "requests": 0, "players_matched": 0, "queued": 0,
            "rejected": 0, "deduped_replays": 0, "publish_batches": 0,
            "engine_failures": 0, "revives": 0, "outcome_errors": 0,
            "collector_errors": 0, "rescan_matches": 0, "rescan_skipped": 0,
            "timeouts": 0, "health_repromotions": 0, "health_tick_errors": 0,
            "spec_commits": 0, "spec_errors": 0, "flush_errors": 0,
            "engine_crashes": 0, "breaker_trips": 0,
            "breaker_degraded_revives": 0, "breaker_probes": 0,
            "breaker_probe_failures": 0, "breaker_closes": 0,
            "journal_compactions": 0, "journal_compact_errors": 0,
            "crash_recoveries": 0, "failover_takeovers": 0,
            "replication_pump_errors": 0, "fenced_publish_refused": 0}
        #: Overload control (None: no OverloadConfig knob set, and the
        #: ingress pays nothing for it). Its counters (``shed_requests``,
        #: ``expired_requests``, and per tier) land in ``counters``.
        self.admission: AdmissionController | None = (
            AdmissionController(self.cfg.overload, queue_cfg.name,
                                self.counters,
                                default_tier=queue_cfg.default_tier,
                                metrics=app.metrics, events=app.events)
            if self.cfg.overload.enabled() else None)
        #: Window-granular admission: the ladder runs once per cut window.
        self._batch_admission = (self.admission is not None
                                 and self.cfg.overload.batch_admission)
        #: Batcher submit sequence (``Delivery.arrival``).
        self._arrival_seq = 0
        #: The device engine's circuit breaker (a host-backend queue has
        #: nothing to demote to).
        self.breaker: CircuitBreaker | None = (
            CircuitBreaker(self.cfg.engine)
            if self.cfg.engine.backend == "gpu" else None)
        #: Scripted engine faults, handed to every device engine of this
        #: queue (the hook's indices outlive the engines).
        self._chaos_hook = (app.chaos.engine_hook(queue_cfg.name)
                            if app.chaos is not None
                            and app.chaos.applies(queue_cfg.name) else None)
        #: Online invariant checking (``Config.debug_invariants``; None:
        #: off): fed every outcome this queue publishes.
        self._invariants: InvariantChecker | None = (
            InvariantChecker(queue_cfg.team_size)
            if self.cfg.debug_invariants else None)
        #: The last half-open probe that passed: host ms of the engine
        #: build (``build_ms``), of its ``probe()`` (``probe_ms``) and of
        #: the pool's move (``move_ms``), and the players moved.
        self.last_probe: dict[str, float] | None = None
        #: Terminal-replay cache: player id → (response body, expiry),
        #: split by the ingress shards' hash of the player id.
        self._recent = ShardedRecent(self.cfg.broker.ingress_shards)
        self._next_prune = 0.0
        #: The burst decode of a 1v1 queue's consume bursts.
        self._shards = IngressShards(self.cfg.broker.ingress_shards)
        #: One callback per consume burst (1v1 queues): the burst is
        #: decoded at consume and the flush gathers its columns.
        self._consume_batch = self.cfg.broker.consume_batch and not self._team
        #: Token → (player id → delivery, deliveries) of every dispatched,
        #: not yet answered window.
        self._inflight_meta: dict[int, tuple[dict[str, Delivery],
                                             list[Delivery]]] = {}
        #: A collected window failed on the device: rebuild the engine once
        #: the pipeline is empty.
        self._needs_revive = False
        self._batcher: Batcher | None = None
        self._tag: str | None = None
        self._collector: asyncio.Task | None = None
        self._loops: list[asyncio.Task] = []
        #: Set by ``stop()``: no engine swap starts a collector after it.
        self._stopping = False
        #: Held by compaction and recovery for their whole span, and by
        #: every other entry point that mutates the pool or appends to the
        #: journal (a flush, a collector or speculation tick, a rescan
        #: dispatch or collection, a sweep, a health tick, the stop's
        #: drain) for its synchronous stretch: nothing changes the pool
        #: between a compaction's anchor and its rotation. Uncontended, it
        #: costs no yield.
        self._pool_lock = asyncio.Lock()
        #: The write-ahead journal (utils/journal.py; None: durability
        #: off). Construction attaches to what a predecessor left;
        #: ``start`` applies it (``recover_from_journal``) before the
        #: consumer exists.
        self.journal: PoolJournal | None = None
        #: Host ms of the journal's attach (its recovery parse).
        self.attach_ms = 0.0
        dur = self.cfg.durability
        if dur.enabled():
            t0 = time.perf_counter()
            self.journal = PoolJournal(
                dur.journal_dir, queue_cfg.name, fsync=dur.fsync,
                fsync_interval_s=dur.fsync_interval_s,
                compact_records=dur.compact_records,
                compact_bytes=dur.compact_bytes,
                keep_snapshots=dur.keep_snapshots)
            self.attach_ms = (time.perf_counter() - t0) * 1e3
        #: The journal's host cost: ms building ADMIT rows, appending and
        #: writing them, appending terminals, committing (in the settle
        #: thread) and the loop's wait for those commits, with counts.
        self.journal_stats = {"admit_rows_ms": 0.0, "admit_write_ms": 0.0,
                              "admit_records": 0, "terminals_ms": 0.0,
                              "terminal_records": 0, "commit_thread_ms": 0.0,
                              "commit_wait_ms": 0.0, "commits": 0}
        #: The last hard-crash recovery or failover adoption (None: a clean
        #: or fresh boot).
        self.last_recovery: dict[str, Any] | None = None
        #: Hot-standby replication (service/replication.py; None: off, and
        #: the journal has no tap and no fence). Set by
        #: ``start_replication``; the publish seams consult its role.
        self.replication: QueueReplication | None = None
        self._repl_task: asyncio.Task | None = None
        #: The baseline sent at attach: its journal seq, players, bytes
        #: and host ms under ``_pool_lock``.
        self.last_baseline: dict[str, Any] | None = None
        #: The compaction timer (armed after recovery).
        self._durability: asyncio.Task | None = None
        #: ``start`` got past the recovery: only then may ``stop`` mark the
        #: journal clean (a runtime that never recovered must leave an
        #: unclean journal as it found it).
        self._recovered = False
        #: Write-ahead settle: with an fsync policy, a window's answers and
        #: acks wait here (in order) while the commit that covers their
        #: records runs on a worker thread; every later effect queues
        #: behind them, so the order of answers is kept.
        self._settle_async = (self.journal is not None
                              and self.journal.fsync != "none")
        self._egress: list = []
        self._settler: asyncio.Task | None = None
        #: The "total" histogram's counts at the previous window cut (the
        #: adaptive p99 reads the traces settled since).
        self._stage_total_prev: tuple[list[int], int, int] | None = None
        self._publish_breaker_gauges()

    async def start(self) -> None:
        self._bind_engine(self._make_engine())
        if self.cfg.engine.warm_start:
            self.engine.warmup()
        self.broker.declare_queue(self.queue_cfg.name)
        # An unclean predecessor's pool, replay cache and admission state,
        # before any consumer or timer exists.
        await self.recover_from_journal()
        self._recovered = True
        # After the recovery (the baseline is the recovered pool), before
        # the consumer (an adopted pool is in place before any traffic).
        await self.start_replication()
        ov = self.cfg.overload
        self._batcher = Batcher(
            self.cfg.batcher, self._flush,
            observe_window=self._observe_window,
            sort_key=self._edf_key if ov.edf else None)
        # Admitted deliveries hold a prefetch slot until settled: keep
        # prefetch above the credit cap, so the excess reaches admission
        # (and is shed with an answer) instead of waiting in the broker.
        prefetch = self.cfg.broker.prefetch
        if ov.max_inflight > 0:
            prefetch = max(prefetch, 2 * ov.max_inflight)
        # Every callback but rpc auth's is non-blocking, so the deliveries
        # already buffered drain into one handler task a burst; rpc auth
        # keeps a task per delivery, so its round trips overlap.
        rpc = self.cfg.auth.mode == "rpc"
        self._tag = self.broker.basic_consume(
            self.queue_cfg.name, self._on_delivery, prefetch=prefetch,
            batch_hint=not rpc,
            batch_callback=(self._on_delivery_batch
                            if self._consume_batch and not rpc else None))
        if self.queue_cfg.rescan_interval_s > 0:
            self._loops.append(asyncio.create_task(self._rescan_loop()))
        if (self.queue_cfg.request_timeout_s is not None
                or ov.deadline_sweep_ms > 0):
            self._loops.append(asyncio.create_task(self._sweep_loop()))
        if self.cfg.engine.health_interval_s > 0:
            self._loops.append(asyncio.create_task(self._health_loop()))
        if (self.cfg.engine.spec_formation
                and self.cfg.engine.spec_interval_ms > 0
                and not self._team):
            self._loops.append(asyncio.create_task(self._spec_loop()))
        self.start_durability_timer()

    async def stop(self) -> None:
        """Cancel the loops (a compaction under way finishes first), drain
        the batcher (its last windows are answered and acked), collect
        every window in flight, settle every answer, cancel the consumer,
        then write the journal's clean-shutdown marker and close it."""
        for task in self._loops:
            task.cancel()
        await asyncio.gather(*self._loops, return_exceptions=True)
        self._loops = []
        if self._batcher is not None:
            await self._batcher.close()
            self._batcher = None
        self._stopping = True
        if self._collector is not None:
            self._collector.cancel()
            await asyncio.gather(self._collector, return_exceptions=True)
            self._collector = None
        if self.engine is not None:
            async with self._pool_lock:
                self._drain_engine(time.time())
        await self._settled()
        if self._tag is not None:
            self.broker.basic_cancel(self._tag)
            self._tag = None
        if (self.journal is not None and self._recovered
                and not self.journal._closed):
            # Its presence tells the next boot to skip recovery.
            self.journal.mark_clean()
            self.journal.close()
        if self.replication is not None:
            # The clean marker just streamed through the tap: a last pump
            # sweeps the acks and releases the lease, so a standby may
            # promote at once.
            self.replication.shutdown(time.monotonic())

    def abandon(self) -> None:
        """A hard crash's teardown: every task cancelled, the answers
        waiting for a commit dropped, the journal closed without a clean
        marker, a commit or its buffer: on disk is what ``kill -9`` would
        leave. The engine is closed (its device memory would otherwise
        outlive the crashed app)."""
        tasks = list(self._loops) + [self._collector, self._settler]
        if self._batcher is not None:
            tasks.append(self._batcher._task)
        for task in tasks:
            if task is not None:
                task.cancel()
        self._loops = []
        self._egress = []
        self._stopping = True
        if self.journal is not None:
            self.journal.abandon()
        if self._tag is not None:
            self.broker.basic_cancel(self._tag)
            self._tag = None
        self.engine.close()

    def dedup_cache_size(self) -> int:
        """The terminal-replay cache's entries (what ``/metrics`` reports
        as ``dedup_cache``)."""
        return len(self._recent)

    def faults(self) -> dict[str, object]:
        """The failures this queue caught and recovered from: the nonzero
        fault counters, and the engine's parked device error. Empty when
        every window, collection and tick ran clean."""
        out: dict[str, object] = {k: self.counters[k] for k in FAULT_COUNTERS
                                  if self.counters[k]}
        error = getattr(self.engine, "device_error", None)
        if error is not None:
            out["device_error"] = repr(error)
        return out

    # ---- engine lifecycle: build, bind, crash accounting ------------------

    def _make_engine(self):
        """This queue's engine for the breaker's state: the configured
        engine while it is closed; the host oracle while it is open or
        half-open, so matches keep flowing while the card is failing."""
        if self.breaker is not None and self.breaker.state != CLOSED:
            self.counters["breaker_degraded_revives"] += 1
            self.metrics.counters.inc("breaker_degraded_revives")
            self.events.append("degraded_revive", self.queue_cfg.name,
                               f"breaker {self.breaker.state}")
            log.warning("queue %r: breaker %s — serving on the host oracle",
                        self.queue_cfg.name, self.breaker.state)
            return CpuEngine(self.cfg, self.queue_cfg)
        return self._device_engine()

    def _device_engine(self):
        engine = make_engine(self.cfg, self.queue_cfg, device=self.device)
        if self._chaos_hook is not None and hasattr(engine, "chaos_hook"):
            engine.chaos_hook = self._chaos_hook
        return engine

    def _bind_engine(self, engine) -> None:
        """Install ``engine`` and recompute what depends on its kind: the
        ingress shape (columnar for a 1v1 device engine, objects for team
        and role queues and for the host oracle), the middleware chain,
        the pipelined API and the collector task that follows it. Every
        engine swap (start, revive, breaker demotion, probe re-promotion)
        comes through here."""
        self.engine = engine
        # Engine-side lifecycle events (delegation, re-promotion) go to the
        # app's log.
        engine.events = self.events
        self._objects = self._team or not hasattr(engine,
                                                  "search_columns_async")
        self.pipeline = (
            default_pipeline(self.cfg.auth, self.broker) if self._objects
            else columnar_pipeline(self.cfg.auth, self.broker))
        # Auth runs in the middleware chain: the inline columnar ingress
        # (no chain) holds only without it.
        self._inline_ingress = (
            not self._objects and self.cfg.auth.mode == "none"
            and (self.admission is None or self._batch_admission))
        self._async_api = hasattr(engine, "collect_ready")
        want = self._async_api and self.pipeline_depth > 1
        if want and not self._stopping and (self._collector is None
                                            or self._collector.done()):
            self._collector = asyncio.create_task(self._collector_loop())
        elif not want and self._collector is not None:
            self._collector.cancel()
            self._collector = None

    def _record_engine_crash(self, now: float) -> None:
        """Count one engine crash and feed the breaker: when this crash
        trips it, the engine rebuild that follows every crash is the host
        oracle."""
        self.counters["engine_failures"] += 1
        self.counters["engine_crashes"] += 1
        self.metrics.counters.inc("engine_crashes")
        self.events.append("engine_crash", self.queue_cfg.name)
        if self.breaker is not None and self.breaker.record_crash(now):
            self.counters["breaker_trips"] += 1
            self.metrics.counters.inc("breaker_trips")
            self.events.append(
                "breaker_trip", self.queue_cfg.name,
                f"{self.breaker.threshold} crashes in "
                f"{self.breaker.window_s:.1f}s",
                component="service",
                refs={"crashes": self.breaker.threshold})
            self._publish_breaker_gauges()
            log.error("queue %r: circuit breaker tripped (%d engine crashes "
                      "within %.1f s): demoting to the host oracle; first "
                      "half-open probe in %.2f s", self.queue_cfg.name,
                      self.breaker.threshold, self.breaker.window_s,
                      self.breaker.probe_delay_s)

    def _publish_breaker_gauges(self) -> None:
        """The breaker's state, probe delay and time degraded as gauges, on
        every transition."""
        if self.breaker is None:
            return
        snap = self.breaker.snapshot(time.time())
        q = self.queue_cfg.name
        m = self.metrics
        m.set_gauge(f"breaker_state[{q}]", STATE_CODE[snap["state"]])
        m.set_gauge(f"breaker_probe_delay_s[{q}]", snap["probe_delay_s"])
        m.set_gauge(f"breaker_time_degraded_s[{q}]", snap["time_degraded_s"])

    def restore(self, requests: Sequence[SearchRequest], now: float) -> None:
        """Re-admit waiting players without matching (the object path's
        checkpoint, an engine's ``waiting()``)."""
        self.engine.restore(requests, now)

    def restore_columns(self, cols: RequestColumns, regions, modes,
                        now: float) -> None:
        """Re-admit waiting players without matching — a checkpoint such as
        an engine's ``waiting_columns()``: ``cols`` with each row's region
        and mode given by name in ``regions`` / ``modes`` (the codes in
        ``cols`` are ignored)."""
        self._restore_into(self.engine, cols, regions, modes, now)

    @staticmethod
    def _restore_into(engine, cols: RequestColumns, regions, modes,
                      now: float) -> None:
        reg, mode = engine.intern_columns(list(regions), list(modes))
        engine.restore_columns(dataclasses.replace(cols, region=reg, mode=mode),
                               now)

    # ---- durability: compaction and crash recovery ------------------------

    def start_durability_timer(self) -> None:
        """Arm the compaction timer: after recovery, so that the first
        compaction snapshots a recovered (or fresh) pool, never the empty
        one a recovery is about to fill."""
        if (self.journal is not None and self._durability is None
                and self.cfg.durability.compact_interval_s > 0):
            self._durability = asyncio.create_task(self._durability_loop())
            self._loops.append(self._durability)

    async def _durability_loop(self) -> None:
        """Compact once the live segment crosses its record or byte
        budget. A failed compaction is logged and counted, and retried."""
        interval = self.cfg.durability.compact_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                if self.journal.wants_compact():
                    await self.compact_journal()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("journal compaction failed; retrying")
                self.counters["journal_compact_errors"] += 1
                self.metrics.counters.inc("journal_compact_errors")

    async def compact_journal(self) -> dict[str, Any]:
        """One compaction, under the pool lock with the pipeline drained:
        the anchor seq, the pool's snapshot (utils/checkpoint.py) and the
        segment's rotation, carrying the live replay entries and the
        admission checkpoint. The snapshot and the rotation run on a
        worker thread; a cancellation waits for the thread (it cannot be
        interrupted) before it propagates, so ``stop`` never writes its
        clean marker into a segment being retired."""
        j = self.journal
        async with self._pool_lock:
            now = time.time()
            self._drain_engine(now)
            anchor, snap_path = j.compact_begin()
            carry = [(pid, body, exp)
                     for pid, (body, exp) in self._recent.items() if exp > now]
            adm = (self.admission.checkpoint()
                   if self.admission is not None else None)
            engine, name = self.engine, self.queue_cfg.name

            def rotate() -> int:
                n = checkpoint.save_pool(engine, snap_path, queue_name=name)
                j.compact_finish(anchor, snap_path, carry, adm)
                return n

            task = asyncio.ensure_future(asyncio.to_thread(rotate))
            try:
                count = await asyncio.shield(task)
            except asyncio.CancelledError:
                while not task.done():
                    try:
                        await asyncio.shield(task)
                    except asyncio.CancelledError:
                        continue
                    except Exception:
                        break
                raise
        self.counters["journal_compactions"] += 1
        self.metrics.counters.inc("journal_compactions")
        self.events.append(
            "journal_compacted", self.queue_cfg.name,
            f"anchor seq {anchor}, {count} waiting players snapshotted",
            component="durability", refs={"anchor": anchor, "count": count})
        return {"anchor": anchor, "snapshot": snap_path, "count": count}

    async def recover_from_journal(self) -> dict[str, Any] | None:
        """Apply an unclean predecessor's journal (None on a clean or
        fresh boot): discard any speculation, load the newest valid
        snapshot (``restore_columns`` on a columnar engine), remove the
        players that reached a terminal after it, restore the journal's
        tail, ``heartbeat`` (a bucketed queue's index rebuilt exactly),
        refill the replay cache and the admission state, and re-anchor
        with a compaction. Its span is ``rto_ms``, split by step in
        ``split_ms`` (host ms; the journal's attach and parse happened at
        construction, ``attach_ms``)."""
        j = self.journal
        if j is None or j.recovered is None:
            return None
        rec = j.recovered
        q = self.queue_cfg.name
        for note in rec.corrupt:
            self.events.append("journal_corrupt", q, note)
            log.warning("queue %r: %s", q, note)
        if rec.clean:
            return None
        t0 = time.perf_counter()
        now = time.time()
        split: dict[str, float] = {}

        def lap(key: str, since: float) -> float:
            t = time.perf_counter()
            split[key] = (t - since) * 1e3
            return t

        async with self._pool_lock:
            eng = self.engine
            # The pool is rebuilt from the journal: a speculation is
            # against a pool that never was.
            self._spec_invalidate_audited("journal replay")
            t = time.perf_counter()
            n_snap = (checkpoint.load_pool(eng, rec.snapshot, now)
                      if rec.snapshot else 0)
            t = lap("snapshot_ms", t)
            removed = sorted(rec.removed)
            if removed:
                # One release in this order equals removing each in turn.
                eng.remove_many(removed)
            t = lap("removes_ms", t)
            tail = [row_to_request(rec.waiting[pid])
                    for pid in sorted(rec.waiting)]
            if tail:
                eng.restore(tail, now)
            t = lap("tail_ms", t)
            eng.heartbeat(now)
            lap("heartbeat_ms", t)
            for pid, (body, exp) in rec.recent.items():
                if exp > now:
                    self._recent.set(pid, (body, exp))
            if rec.admission is not None and self.admission is not None:
                self.admission.restore_state(rec.admission)
        t = time.perf_counter()
        # Re-anchor: the tail must not replay again after the next crash.
        await self.compact_journal()
        lap("compact_ms", t)
        rto_ms = (time.perf_counter() - t0) * 1e3
        self.counters["crash_recoveries"] += 1
        self.metrics.set_gauge(f"crash_rto_ms[{q}]", round(rto_ms, 3))
        self.metrics.counters.inc("crash_recoveries")
        self.events.append(
            "crash_recovered", q,
            f"unclean shutdown: {n_snap} snapshot + {len(tail)} journal-tail "
            f"players restored, {len(rec.recent)} dedup entries, "
            f"rto {rto_ms:.1f} ms"
            + (" (snapshot fallback)" if rec.fallback else ""),
            component="durability",
            refs={"snapshot_players": n_snap, "players": len(tail),
                  "rto_ms": round(rto_ms, 3)})
        log.warning("queue %r: recovered from an unclean shutdown: %d "
                    "snapshot + %d journal-tail players, %d replay entries, "
                    "rto %.1f ms", q, n_snap, len(tail), len(rec.recent),
                    rto_ms)
        self.last_recovery = {
            "rto_ms": round(rto_ms, 3),
            "attach_ms": round(self.attach_ms, 3),
            "split_ms": {k: round(v, 3) for k, v in split.items()},
            "snapshot_players": n_snap,
            "tail_players": len(tail),
            "removed_players": len(removed),
            "dedup_entries": len(rec.recent),
            "fallback": rec.fallback,
            "corrupt": list(rec.corrupt),
            "transcript": rec.transcript(),
        }
        return self.last_recovery

    # ---- hot-standby replication (service/replication.py) -----------------

    async def start_replication(self) -> None:
        """Attach this queue to the replication hub as its primary: adopt
        the shadow a standby's takeover left for this queue (a failover
        successor), take the lease (``LeaseHeldError`` while another
        owner's is live: two primaries cannot coexist), then, under
        ``_pool_lock`` with every window in flight collected, install the
        journal's tap and fence and send the baseline. Nothing appends
        between the tap's install and the baseline's capture (every append
        runs on the event loop under the lock, or in a compaction that
        holds it), so the standby's stream is gapless from the baseline's
        seq. Then the pump task starts."""
        hub = self.app.replication_hub
        rcfg = self.app.cfg.replication
        if hub is None or not rcfg.enabled():
            return
        j = self.journal
        if j is None:
            raise ValueError(
                "replication requires durability (journal_dir): the "
                "journal is the replication stream")
        q = self.queue_cfg.name
        adopted = hub.adopted.pop(q, None)
        if adopted is not None:
            await self.recover_from_replica(adopted)
        owner = rcfg.owner or "primary"
        epoch = hub.authority.acquire(q, owner, time.monotonic())
        repl = QueueReplication(q, owner, epoch, hub.authority, hub.link(q),
                                metrics=self.metrics, events=self.events)
        async with self._pool_lock:
            now = time.time()
            if self._async_api and self.engine.inflight() > 0:
                self._drain_engine(now)
            t0 = time.perf_counter()
            self.replication = repl
            j.tap = repl.on_record
            j.fence = repl.may_write
            players, payload = self._baseline_payload(now)
            repl.send_baseline(j.seq, payload)
            self.last_baseline = {
                "seq": j.seq, "players": players, "bytes": len(payload),
                "ms": round((time.perf_counter() - t0) * 1e3, 3)}
        self._repl_task = asyncio.create_task(self._replication_loop())
        self._loops.append(self._repl_task)
        self.events.append(
            "replication_attached", q,
            f"owner {owner!r} epoch {epoch}, baseline seq {j.seq}",
            component="replication", refs={"epoch": epoch, "records": j.seq})

    def _baseline_payload(self, now: float) -> tuple[int, bytes]:
        """The baseline (under ``_pool_lock``): the waiting pool as ADMIT
        rows in ``waiting()`` order (read from the mirror's columns on a
        columnar engine), the unexpired replay entries and the admission
        checkpoint. Returns (players, payload)."""
        if not self._objects:
            cols, regions, modes = self.engine.waiting_columns()
            rows = _admit_rows(cols, regions.tolist(), modes.tolist())
        else:
            rows = _admit_rows_of(self.engine.waiting())
        recent = [(pid, body, exp)
                  for pid, (body, exp) in self._recent.items() if exp > now]
        adm = (self.admission.checkpoint()
               if self.admission is not None else None)
        return len(rows), baseline_payload(rows, recent, adm)

    async def recover_from_replica(self, adopted: dict[str, Any]) -> dict:
        """A failover successor adopts the standby's shadow (waiting pool,
        replay cache, admission checkpoint: everything the stream
        delivered before the takeover) through the engine's admission
        path, ``heartbeat`` (a bucketed queue's index rebuilt exactly),
        then re-anchors its own journal with a compaction. The span is the
        failover RTO (``failover_rto_ms``), split by step in ``split_ms``
        (host ms); the takeover's chain of events (``lease_expired``,
        ``epoch_bump``, ``replay_window``, ``failover_takeover``) is
        stamped in cause order."""
        rec = adopted["state"]
        q = self.queue_cfg.name
        t0 = time.perf_counter()
        now = time.time()
        split: dict[str, float] = {}
        epoch = int(adopted["epoch"])
        self.events.append(
            "lease_expired", q,
            f"predecessor's lease lapsed; standby {adopted['owner']!r} "
            f"claimed the queue", component="replication",
            refs={"epoch": epoch - 1})
        self.events.append(
            "epoch_bump", q, f"takeover fenced epoch {epoch - 1} -> {epoch}",
            component="replication",
            refs={"epoch": epoch, "prev_epoch": epoch - 1})
        async with self._pool_lock:
            # The adopted pool replaces the empty boot pool a speculation
            # would be against.
            self._spec_invalidate_audited("replica adoption")
            t = time.perf_counter()
            tail = [row_to_request(rec.waiting[pid])
                    for pid in sorted(rec.waiting)]
            if tail:
                self.engine.restore(tail, now)
            split["restore_ms"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            if hasattr(self.engine, "heartbeat"):
                self.engine.heartbeat(now)
            split["heartbeat_ms"] = (time.perf_counter() - t) * 1e3
            for pid, (body, exp) in rec.recent.items():
                if exp > now:
                    self._recent.set(pid, (body, exp))
            if rec.admission is not None and self.admission is not None:
                self.admission.restore_state(rec.admission)
        t = time.perf_counter()
        if self.journal is not None:
            # The adopted pool in this host's own journal at once: a crash
            # right after the takeover recovers from the local disk.
            await self.compact_journal()
        split["compact_ms"] = (time.perf_counter() - t) * 1e3
        rto_ms = (time.perf_counter() - t0) * 1e3
        n_tail = len(tail)
        self.events.append(
            "replay_window", q,
            f"standby shadow applied: {n_tail} waiting players, "
            f"{len(rec.recent)} dedup entries (applied seq "
            f"{adopted.get('applied_seq', 0)})", component="replication",
            refs={"epoch": epoch, "players": n_tail,
                  "records": int(adopted.get("applied_seq", 0))})
        self.counters["failover_takeovers"] += 1
        self.metrics.set_gauge(f"failover_rto_ms[{q}]", round(rto_ms, 3))
        self.metrics.counters.inc("failover_takeovers")
        self.events.append(
            "failover_takeover", q,
            f"epoch {adopted['epoch']}: {n_tail} waiting players adopted, "
            f"{len(rec.recent)} dedup entries, rto {rto_ms:.1f} ms",
            component="replication",
            refs={"epoch": epoch, "players": n_tail,
                  "rto_ms": round(rto_ms, 3)})
        log.warning("queue %r: failover takeover (epoch %s): %d waiting "
                    "players adopted, %d replay entries, rto %.1f ms", q,
                    adopted["epoch"], n_tail, len(rec.recent), rto_ms)
        self.last_recovery = {
            "rto_ms": round(rto_ms, 3),
            "split_ms": {k: round(v, 3) for k, v in split.items()},
            "snapshot_players": 0,
            "tail_players": n_tail,
            "dedup_entries": len(rec.recent),
            "fallback": False,
            "corrupt": [],
            "transcript": rec.transcript(),
            "source": "replica",
            "epoch": adopted["epoch"],
        }
        return self.last_recovery

    async def _replication_loop(self) -> None:
        """The sender's pump every ``pump_interval_s``: acks, retransmission
        of a stalled tail, lease renewal, the lag gauges. A failed pump is
        logged and counted (``replication_pump_errors``), and retried."""
        interval = self.app.cfg.replication.pump_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                r = self.replication
                if r is not None:
                    r.pump(time.monotonic())
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("replication pump failed; retrying")
                self.counters["replication_pump_errors"] += 1
                self.metrics.counters.inc("replication_pump_errors")

    # ---- ingress ----------------------------------------------------------

    async def _on_delivery(self, delivery: Delivery) -> None:
        received_at = time.time()
        tr = self._trace(delivery)
        if tr is not None:
            tr.mark("consume", received_at)
        ac = self.admission
        if self._batch_admission:
            # Only the pre-checks run per delivery; the ladder runs at the
            # window cut (_admission_cut).
            decision = ac.pre_decide(delivery, received_at)
            if tr is not None:
                tr.tier = delivery.tier
            if decision is EXPIRED:
                self._expire_delivery(delivery, received_at)
                return
            if decision is not ADMIT:  # draining
                self._shed_delivery(delivery)
                return
        elif ac is not None:
            # Per-delivery admission, before any middleware work.
            pool_tiers = (self.engine.pool_tier_counts(ac.tiers)
                          if ac.tiers > 1 else None)
            decision = ac.decide(delivery, received_at,
                                 self.engine.pool_size(), pool_tiers)
            if tr is not None:
                tr.tier = delivery.tier
            if decision is EXPIRED and delivery.redelivered:
                # The player may have reached a terminal answer already:
                # the flush's terminal replay (or its deadline check)
                # answers it.
                decision = ADMIT
            if decision is not ADMIT:
                if decision is EXPIRED:
                    self._expire_delivery(delivery, received_at)
                else:
                    self._shed_delivery(delivery)
                return
            ac.admit(delivery.delivery_tag, delivery.tier)
            try:
                await self._ingress_submit(delivery, received_at, tr)
            except BaseException:
                # The broker settles a crashed callback itself (a nack that
                # does not pass through _nack): return the credit here.
                ac.release(delivery.delivery_tag)
                raise
            return
        await self._ingress_submit(delivery, received_at, tr)

    async def _ingress_submit(self, delivery: Delivery, received_at: float,
                              tr: TraceContext | None) -> None:
        """The middleware chain (the first-receive stamp; on the object
        path the decode too), then the batcher. On the columnar ingress
        (the chain is the stamp alone) its host time goes to the
        attribution's consume category, one delivery at a time."""
        ctx = MessageContext(delivery=delivery, queue=self.queue_cfg.name,
                             received_at=received_at)
        try:
            await self.pipeline.run(ctx)
        except MiddlewareReject as e:
            self._reject(delivery, e.code, e.reason)
            return
        if tr is not None:
            tr.mark("batch")
            if ctx.request is not None:
                tr.player_id = ctx.request.id
        delivery.arrival = self._arrival_seq
        self._arrival_seq += 1
        self._batcher.submit((ctx.request, delivery))
        if self._inline_ingress:
            self.app.attribution.observe_ingest(
                self.queue_cfg.name, "consume", time.time() - received_at, 1)

    async def _on_delivery_batch(self, deliveries: list[Delivery]) -> None:
        """One consume burst of a 1v1 queue: the admission pre-checks over
        the burst, one clock read for the first-receive stamp (and the
        consume, middleware and batch marks) of every delivery, a burst of
        at least ``_MIN_DECODE_BURST`` rows decoded in one native call
        (malformed and unservable rows are answered and acked here, as the
        flush's decode would have), then the whole burst to the batcher.
        Its consume and decode host time go to the attribution once per
        burst. While the queue is not on the columnar ingress (the host
        oracle serves it, or admission decides per delivery) each delivery
        takes the per-delivery path."""
        if not self._inline_ingress:
            for delivery in deliveries:
                await self._on_delivery(delivery)
            return
        received_at = time.time()
        t_burst = time.perf_counter()
        ac = self.admission
        decisions = (ac.pre_decide_batch(deliveries, received_at)
                     if ac is not None else None)
        live: list[Delivery] = []
        for idx, delivery in enumerate(deliveries):
            tr = self._trace(delivery)
            if tr is not None:
                tr.mark("consume", received_at)
            if decisions is not None:
                decision = decisions[idx]
                if tr is not None:
                    tr.tier = delivery.tier
                if decision is EXPIRED:
                    self._expire_delivery(delivery, received_at)
                    continue
                if decision is not ADMIT:  # draining
                    self._shed_delivery(delivery)
                    continue
            first = delivery.properties.headers.setdefault(
                "x-first-received", received_at)
            try:
                delivery.first_received = float(first)
            except (TypeError, ValueError):
                delivery.first_received = received_at
            if tr is not None:
                tr.mark("middleware", received_at)
                tr.mark("batch", received_at)
            delivery.arrival = self._arrival_seq
            self._arrival_seq += 1
            live.append(delivery)
        if not live:
            return
        decode_s = 0.0
        if len(live) >= _MIN_DECODE_BURST:
            t_dec = time.perf_counter()
            live, rejects = await self._shards.decode_burst(live)
            decode_s = time.perf_counter() - t_dec
            for delivery, code, reason in rejects:
                self._reject(delivery, code, reason)
            self.app.attribution.observe_ingest(
                self.queue_cfg.name, "decode", decode_s,
                len(live) + len(rejects))
        if live:
            self._batcher.submit_many([(None, d) for d in live])
        self.app.attribution.observe_ingest(
            self.queue_cfg.name, "consume",
            max(0.0, (time.perf_counter() - t_burst) - decode_s),
            len(deliveries))

    def _first_received(self, delivery: Delivery, now: float) -> float:
        if delivery.first_received >= 0.0:
            return delivery.first_received
        try:
            first = float(delivery.properties.headers.get("x-first-received",
                                                          now))
        except (TypeError, ValueError):
            first = now
        delivery.first_received = first
        return first

    @staticmethod
    def _delivery_deadline(delivery: Delivery) -> float:
        """The delivery's absolute deadline (0.0: none or garbled), from
        the cache admission filled, else parsed once from its header."""
        dl = delivery.deadline
        if dl < 0.0:
            dl = deadline_of(delivery.properties.headers) or 0.0
            delivery.deadline = dl
        return dl

    def _deadline_expired(self, delivery: Delivery, now: float) -> bool:
        """Has the delivery's deadline passed? Only with overload control
        (without it no header is read)."""
        if self.admission is None:
            return False
        dl = self._delivery_deadline(delivery)
        return dl > 0.0 and now >= dl

    def _edf_key(self, item: tuple[SearchRequest | None, Delivery]):
        """The EDF cut key: (tier, absolute deadline, no deadline last), a
        pure function of the delivery's cached tier and deadline."""
        delivery = item[1]
        dl = self._delivery_deadline(delivery)
        return (delivery.tier, dl if dl else float("inf"))

    def _observe_window(self, size: int, age_s: float) -> None:
        """The batcher cut a window: its wait (the ``batch_window`` stage)
        and fill (the ``batch_fill[q]`` gauge); with adaptive shedding,
        the controller gets the fill, the pipeline's occupancy and the p99
        of the traces settled since the previous cut."""
        m = self.metrics
        q = self.queue_cfg.name
        m.observe_stage(q, "batch_window", age_s)
        fill = size / max(1, self._batcher.max_batch)
        m.set_gauge(f"batch_fill[{q}]", fill)
        if self.admission is not None and self.cfg.overload.adaptive:
            frac = (self.engine.inflight() / self.pipeline_depth
                    if self._async_api else 0.0)
            hist = m.stages.get(q, {}).get("total")
            self.admission.observe_window(fill, frac, self._delta_p99(hist))

    def _delta_p99(self, hist) -> float | None:
        """The p99 (a bucket's upper edge) of the "total"-stage samples
        settled since the previous call, from the difference of two
        snapshots of the cumulative histogram; None when none settled."""
        if hist is None:
            return None
        prev = self._stage_total_prev
        cur = (list(hist.counts), hist.overflow, hist.count)
        self._stage_total_prev = cur
        if prev is None:
            prev = ([0] * len(cur[0]), 0, 0)
        n = cur[2] - prev[2]
        if n <= 0:
            return None
        rank = max(1, math.ceil(0.99 * n))
        cum = 0
        for edge, c0, c1 in zip(hist.buckets, prev[0], cur[0]):
            cum += c1 - c0
            if cum >= rank:
                return edge
        return hist.buckets[-1] if hist.buckets else None

    # ---- tracing ----------------------------------------------------------

    def _trace(self, delivery: Delivery) -> TraceContext | None:
        """The delivery's trace, made here for a delivery the broker did
        not stamp (its enqueue stage then reads 0). None with tracing off,
        and with sampling (``trace_sample_n`` > 1): an unstamped delivery
        was sampled out and stays untraced."""
        tr = delivery.trace
        if (tr is None and self.app.trace_enabled
                and self.app.trace_sample_n <= 1):
            tr = delivery.trace = TraceContext(
                self.queue_cfg.name, delivery.properties.correlation_id,
                redelivered=delivery.redelivered)
        return tr

    def _settle_trace(self, delivery: Delivery, status: str,
                      *marks: str) -> None:
        """Settle the delivery's trace after the effects queued before it
        (its answer and ack): ``marks`` (e.g. "dedup_replay"), then the
        "publish" mark, then the flight recorder. A nacked delivery keeps
        its trace open: the redelivery appends to it."""
        tr = delivery.trace
        if tr is None:
            return

        def settle() -> None:
            for name in marks:
                tr.mark(name)
            tr.status = status
            tr.mark("publish")
            self.app.recorder.complete(tr)
        self._effect(settle)

    def _settle_traces(self, pairs: list[tuple[TraceContext, str]]) -> None:
        """Settle a window's traces with one "publish" time, after the
        effects queued before them."""
        if not pairs:
            return

        def settle() -> None:
            t = time.time()
            complete = self.app.recorder.complete
            for tr, status in pairs:
                tr.status = status
                tr.mark("publish", t)
                complete(tr)
        self._effect(settle)

    def _settle_outcome_traces(self, out: SearchOutcome,
                               deliveries: list[Delivery]) -> None:
        """Settle each delivery's trace with the status its player reached
        in an object outcome."""
        if all(d.trace is None for d in deliveries):
            return
        matched = {r.id for m in out.matches for r in m.requests()}
        rejected = {r.id for r, _ in out.rejected}
        timed = {r.id for r in getattr(out, "timed_out", ())}
        pairs = []
        for d in deliveries:
            tr = d.trace
            if tr is None:
                continue
            pid = tr.player_id
            pairs.append((tr, "matched" if pid in matched else
                          "rejected" if pid in rejected else
                          "timeout" if pid in timed else "queued"))
        self._settle_traces(pairs)

    def _merge_window_marks(self, tok: int,
                            deliveries: list[Delivery]) -> None:
        """Append a collected window's engine marks (dispatch .. collect)
        to each member's trace; the engine's entry is popped either way."""
        wm = getattr(self.engine, "window_marks", None)
        if wm is None:
            return
        marks = wm.pop(tok, None)
        if not marks:
            return
        for d in deliveries:
            if d.trace is not None:
                d.trace.extend(marks)

    @staticmethod
    def _trace_maps(deliveries: list[Delivery]
                    ) -> tuple[dict[str, str], dict[str, TraceContext]]:
        """Player id → trace id and → trace, for a window's traced
        deliveries (only their own window's answers quote them)."""
        traces = {d.trace.player_id: d.trace for d in deliveries
                  if d.trace is not None and d.trace.player_id}
        return {pid: tr.trace_id for pid, tr in traces.items()}, traces

    def _decode_or_reject(self, delivery: Delivery,
                          now: float) -> SearchRequest | None:
        """The contract module's decode, for the rows the codec leaves to
        Python (and for a columnar delivery reaching an object flush); a
        malformed payload is answered and acked here."""
        try:
            return decode_request(
                delivery.body, reply_to=delivery.properties.reply_to,
                correlation_id=delivery.properties.correlation_id,
                queue=self.queue_cfg.name,
                enqueued_at=self._first_received(delivery, now))
        except ContractError as e:
            self._reject(delivery, e.code, e.reason)
            return None

    # ---- overload: shed, expire, the window cut, the debt -----------------

    def _shed_delivery(self, delivery: Delivery) -> None:
        """Refuse one request under overload, before any decode: a ``shed``
        answer with the retry-after hint (no player id: clients correlate
        by correlation id), then the ack."""
        ac = self.admission
        tr = self._trace(delivery)
        if tr is not None:
            tr.tier = delivery.tier
            tr.mark("shed")
        ac.record_shed(f"inflight={ac.inflight()} "
                       f"pool={self.engine.pool_size()}", tier=delivery.tier)
        self._publish(delivery.properties.reply_to,
                      delivery.properties.correlation_id,
                      encode_response(SearchResponse(
                          status="shed", player_id="",
                          retry_after_ms=self.cfg.overload.retry_after_ms,
                          trace_id=tr.trace_id if tr is not None else "",
                          tier=delivery.tier if ac.tiers > 1 else None)),
                      trace=tr)
        self._ack(delivery)
        self._settle_trace(delivery, "shed")

    def _shed_deliveries(self, deliveries: list[Delivery]) -> None:
        """``_shed_delivery`` for a window's refused rows: the bodies from
        the native batch encoder, one ``publish_batch``, then the acks."""
        ac = self.admission
        tiered = ac.tiers > 1
        retry = self.cfg.overload.retry_after_ms
        traces = []
        for d in deliveries:
            tr = self._trace(d)
            if tr is not None:
                tr.tier = d.tier
                tr.mark("shed")
            ac.record_shed(f"window cut tag={d.delivery_tag}", tier=d.tier)
            traces.append(tr)
        n = len(deliveries)
        bodies = codec.encode_simple_batch(
            np.full(n, codec.KIND_SHED, np.int32), [""] * n,
            np.zeros(n, np.float64), np.full(n, retry, np.float64),
            [tr.trace_id if tr is not None else "" for tr in traces],
            np.fromiter((d.tier if tiered else -1 for d in deliveries),
                        np.int32, n))
        rows: list[Row] = []
        for d, tr, body in zip(deliveries, traces, bodies):
            if body is None:  # a row the C encoder cannot express
                body = encode_response(SearchResponse(
                    status="shed", player_id="", retry_after_ms=retry,
                    trace_id=tr.trace_id if tr is not None else "",
                    tier=d.tier if tiered else None))
            if tr is not None:
                tr.mark("encode")
            rows.append((d.properties.reply_to, d.properties.correlation_id,
                         body, tr))
        self._publish_batch(rows)
        for d in deliveries:
            self._ack(d)
        self._settle_traces([(tr, "shed") for tr in traces if tr is not None])

    def _expire_delivery(self, delivery: Delivery, now: float,
                         player_id: str = "") -> None:
        """A request past its deadline: ``timeout``, with no device work
        spent on it (its trace's "expired" mark has no "dispatch" after
        it), then the ack."""
        ac = self.admission
        tiered = ac is not None and ac.tiers > 1
        tr = self._trace(delivery)
        if tr is not None:
            if player_id:
                tr.player_id = player_id
            tr.tier = delivery.tier
            tr.mark("expired", now)
        if ac is not None:
            ac.record_expired(
                f"player={player_id or '?'} tag={delivery.delivery_tag}",
                tier=delivery.tier)
        self._publish(delivery.properties.reply_to,
                      delivery.properties.correlation_id,
                      encode_response(SearchResponse(
                          status="timeout", player_id=player_id,
                          trace_id=tr.trace_id if tr is not None else "",
                          tier=delivery.tier if tiered else None)),
                      trace=tr)
        self._ack(delivery)
        self._settle_trace(delivery, "expired")

    def _admission_cut(self, deliveries: list[Delivery],
                       now: float) -> set[int] | None:
        """Window-granular admission over one cut window: one read of the
        pool's size and tier counts and one ``decide_batch`` pass in
        arrival order (the EDF sort reorders a window for its dispatch,
        never for admission); the refused rows are shed in one batch.
        Returns the delivery tags to drop (None: keep all). It runs before
        the decode, so a shed request costs no decode."""
        ac = self.admission
        if ac is None or not self._batch_admission:
            return None
        ordered = sorted(deliveries, key=lambda d: d.arrival)
        pool_tiers = (self.engine.pool_tier_counts(ac.tiers)
                      if ac.tiers > 1 else None)
        decisions = ac.decide_batch(ordered, now, self.engine.pool_size(),
                                    pool_tiers)
        shed = [d for d, dec in zip(ordered, decisions) if dec is not ADMIT]
        if not shed:
            return None
        self._shed_deliveries(shed)
        return {d.delivery_tag for d in shed}

    def _settle_expired(self, pairs: list[tuple[str, Delivery]],
                        now: float) -> set[str]:
        """The deadline check right before the dispatch (the cut's check
        raced the batcher wait and the pipeline's backpressure): expired
        rows are answered ``timeout``; returns their ids."""
        if self.admission is None:
            return set()
        expired: set[str] = set()
        for pid, delivery in pairs:
            if self._deadline_expired(delivery, now):
                expired.add(pid)
                self._expire_delivery(delivery, now, player_id=pid)
        return expired

    def _pick_victims(self, k: int, entering=()):
        """The ``k`` lowest-tier, longest-waiting candidates: the waiting
        pool (in ``waiting()`` order) then ``entering`` ((pid, tier,
        enqueued_at, delivery), in window order), sorted by (-tier,
        enqueue time), stable. Returns (pool victim ids, entering
        victims), each in pick order."""
        ids, tiers, enq = self.engine.waiting_qos()
        n_pool = len(ids)
        if entering:
            tiers = np.concatenate([tiers, np.fromiter(
                (e[1] for e in entering), np.int32, len(entering))])
            enq = np.concatenate([enq, np.fromiter(
                (e[2] for e in entering), np.float64, len(entering))])
        order = np.lexsort((enq, -tiers.astype(np.int64)))[:k].tolist()
        return ([ids[i] for i in order if i < n_pool],
                [entering[i - n_pool] for i in order if i >= n_pool])

    def _pay_debt(self, entering: list[tuple[str, int, float, Delivery]],
                  debt: int, now: float) -> set[str]:
        """Settle a dispatching window's waiting-cap debt
        (``shed_policy="oldest"``). Untiered: evict the ``debt``
        longest-waiting pool players. Tiered: pick the ``debt`` lowest-tier
        candidates over the pool and the window, oldest first in a tier:
        pool victims are evicted (in one batch) with ``shed`` answers by
        name, the window's own victims are shed before the dispatch (an
        entrant never displaces a higher tier the ladder protected).
        Returns the window ids to drop from the dispatch (settled here)."""
        if debt <= 0:
            return set()
        ac = self.admission
        tiered = ac.tiers > 1
        pool_ids, victims = self._pick_victims(
            debt, entering if tiered else ())
        if pool_ids:
            self._publish_shed_evictions(self.engine.remove_many(pool_ids),
                                         now)
        drop: set[str] = set()
        for pid, _, _, delivery in victims:
            drop.add(pid)
            tr = delivery.trace
            if tr is not None:
                tr.mark("shed")
            ac.record_shed(f"window debt {pid}", tier=delivery.tier)
            self._publish(delivery.properties.reply_to,
                          delivery.properties.correlation_id,
                          encode_response(SearchResponse(
                              status="shed", player_id=pid,
                              retry_after_ms=self.cfg.overload.retry_after_ms,
                              trace_id=tr.trace_id if tr is not None else "",
                              tier=delivery.tier)),
                          trace=tr)
            self._ack(delivery)
            self._settle_trace(delivery, "shed")
        return drop

    def _publish_shed_evictions(self, evicted: list[SearchRequest],
                                now: float) -> None:
        """``shed`` answers for pool players evicted by the debt,
        remembered for terminal replay (a redelivered copy replays the
        shed instead of entering again)."""
        ac = self.admission
        tiered = ac.tiers > 1
        for req in evicted:
            ac.record_shed(f"evicted oldest {req.id}", tier=req.tier)
            body = encode_response(SearchResponse(
                status="shed", player_id=req.id,
                retry_after_ms=self.cfg.overload.retry_after_ms,
                latency_ms=((now - req.enqueued_at) * 1e3
                            if req.enqueued_at else 0.0),
                tier=req.tier if tiered else None))
            self._remember(req.id, body, now)
            self._publish(req.reply_to, req.correlation_id, body)

    # ---- one window -------------------------------------------------------

    async def _flush(self, window: list) -> None:
        """One cut window. Whatever goes wrong, its deliveries are settled:
        a delivery left unacked holds a prefetch slot (and a credit) for
        good. A nack of a delivery already settled does nothing."""
        try:
            async with self._pool_lock:
                if self._objects:
                    await self._flush_objects(window)
                else:
                    await self._flush_columnar([d for _, d in window])
        except Exception:
            log.exception("window flush failed; nacking its deliveries")
            self.counters["flush_errors"] += 1
            self.metrics.counters.inc("flush_errors")
            for _, delivery in window:
                self._nack(delivery)

    async def _flush_objects(
            self, window: list[tuple[SearchRequest | None, Delivery]]) -> None:
        """The admission cut, the decode of deliveries still undecoded
        (they entered through the columnar ingress before the host oracle
        took the queue over), terminal replays and the deadline check;
        then the window goes to the engine: pipelined
        (``engine.search_async``) on a device engine, or in one
        synchronous ``search`` on the host oracle."""
        now = time.time()
        if self._batch_admission:
            dropped = self._admission_cut([d for _, d in window], now)
            if dropped:
                window = [(r, d) for r, d in window
                          if d.delivery_tag not in dropped]
                if not window:
                    return
        if any(req is None for req, _ in window):
            window = [(req if req is not None
                       else self._decode_or_reject(d, now), d)
                      for req, d in window]
            window = [(r, d) for r, d in window if r is not None]
        self._prune_recent(now)
        stamp_qos = self.admission is not None
        fresh: list[tuple[SearchRequest, Delivery]] = []
        for req, delivery in window:
            if stamp_qos:
                deadline = self._delivery_deadline(delivery)
                if delivery.tier or deadline:
                    req = dataclasses.replace(req, tier=delivery.tier,
                                              deadline_at=deadline)
            tr = delivery.trace
            if tr is not None:
                tr.player_id = req.id
                tr.mark("flush", now)
            cached = self._recent.get(req.id)
            if cached is not None and cached[1] <= now:
                self._recent.pop(req.id)  # expired: a genuine re-queue
                cached = None
            if cached is not None:
                self._replay(delivery, cached[0])
            elif self._deadline_expired(delivery, now):
                self._expire_delivery(delivery, now, player_id=req.id)
            else:
                fresh.append((req, delivery))
        if not fresh:
            return
        if not self._async_api:
            self._search_sync(fresh, now)
            return
        requests = [r for r, _ in fresh]

        def dispatch(drop: set[str]) -> int:
            reqs = ([r for r in requests if r.id not in drop] if drop
                    else requests)
            tok = self.engine.search_async(reqs, now)[0]
            self._journal_admit_reqs(reqs)
            return tok

        await self._dispatch_window(
            dispatch, [(r.id, d) for r, d in fresh], now)

    def _search_sync(self, fresh: list[tuple[SearchRequest, Delivery]],
                     now: float) -> None:
        """An object window on an engine without the pipelined API (the
        host oracle): the debt, one ``search``, the answers, the acks. A
        crash is counted for the breaker, the engine rebuilt and the
        window nacked."""
        try:
            if self.admission is not None:
                debt = self.admission.eviction_debt(len(fresh),
                                                    self.engine.pool_size())
                drop = self._pay_debt([(r.id, r.tier, r.enqueued_at, d)
                                       for r, d in fresh], debt, now)
                if drop:
                    fresh = [(r, d) for r, d in fresh if r.id not in drop]
                    if not fresh:
                        return
            requests = [r for r, _ in fresh]
            # After the debt: a window entrant shed as a victim carries no
            # dispatch mark (no engine work was spent on it).
            t_disp = time.time()
            for _, d in fresh:
                if d.trace is not None:
                    d.trace.mark("dispatch", t_disp)
            # The sync step admits and matches in one call: the admits
            # are journaled first, so the replay order holds either way.
            self._journal_admit_reqs(requests)
            outcome = self.engine.search(requests, now)
        except Exception:
            log.exception("engine step crashed; reviving the engine from "
                          "its waiting players")
            self._record_engine_crash(now)
            self._revive(now)
            for _, d in fresh:
                self._nack(d)
            return
        t_col = time.time()
        for _, d in fresh:
            if d.trace is not None:
                d.trace.mark("collect", t_col)
        self._handle_object_out(outcome, [d for _, d in fresh], now)

    async def _flush_columnar(self, deliveries: list[Delivery]) -> None:
        """The admission cut, then terminal replays and the deadline check;
        the rest assembled as columns and dispatched. A window whose every
        delivery was decoded at consume (``Delivery.row``) gathers its
        columns from the bursts; any other window is decoded here,
        natively, as a whole. Per-row Python is the replay probe and the
        rows the codec leaves to the contract module."""
        now = time.time()
        self._prune_recent(now)
        if self._batch_admission:
            dropped = self._admission_cut(deliveries, now)
            if dropped:
                deliveries = [d for d in deliveries
                              if d.delivery_tag not in dropped]
                if not deliveries:
                    return
        native = None
        pre = all(d.row is not None for d in deliveries)
        t_dec = time.perf_counter()
        if not pre:
            native = codec.decode_batch([bytes(d.body) for d in deliveries])
        traced = any(d.trace is not None for d in deliveries)
        if traced:
            for d in deliveries:
                if d.trace is not None:
                    d.trace.mark("flush", now)
        if pre:
            # Decoded at consume: every row is valid (the others were
            # answered there), and its columns are gathered below.
            rows = [(i, d.row[0].ids[d.row[1]], None)
                    for i, d in enumerate(deliveries)]
        else:
            rows = self._window_rows(deliveries, native[-1], native[0], now)
            self.app.attribution.observe_ingest(
                self.queue_cfg.name, "decode", time.perf_counter() - t_dec,
                len(deliveries))
        if traced:
            for src, pid, _ in rows:
                tr = deliveries[src].trace
                if tr is not None:
                    tr.player_id = pid
                    tr.tier = deliveries[src].tier
        keep = []
        for src, pid, req in rows:
            cached = self._recent.get(pid)
            if cached is not None and cached[1] <= now:
                self._recent.pop(pid)  # expired: a genuine re-queue
                cached = None
            if cached is not None:
                self._replay(deliveries[src], cached[0])
            elif self._deadline_expired(deliveries[src], now):
                # After the decode, so the timeout names the player.
                self._expire_delivery(deliveries[src], now, player_id=pid)
            else:
                keep.append((src, pid, req))
        if not keep:
            return
        k = len(keep)
        # The QoS columns, from the caches admission filled: the mirror
        # keeps them for the tiered debt and the deadline sweep.
        tier_col = dl_col = None
        if self.admission is not None:
            tier_col = np.fromiter((deliveries[s].tier for s, _, _ in keep),
                                   np.int32, k)
            dl_col = np.fromiter((self._delivery_deadline(deliveries[s])
                                  for s, _, _ in keep), np.float64, k)
            if self.cfg.overload.edf and k > 1:
                # EDF again after the filtering above: a window split into
                # chunks sends its near-deadline tier-0 lanes first; the
                # arange keeps arrival order within equal keys.
                order = np.lexsort((np.arange(k),
                                    np.where(dl_col > 0.0, dl_col, np.inf),
                                    tier_col))
                keep = [keep[j] for j in order.tolist()]
                tier_col, dl_col = tier_col[order], dl_col[order]
        picked = [deliveries[s] for s, _, _ in keep]
        if native is None:
            ids, rating, rd, thr, region_names, mode_names = gather_rows(
                [d.row for d in picked])
        elif all(req is None for _, _, req in keep):
            ids_n, rating_n, rd_n, thr_n, regions_n, modes_n, _ = native
            sel = np.fromiter((s for s, _, _ in keep), np.int64, k)
            ids, rating, rd, thr = ids_n[sel], rating_n[sel], rd_n[sel], thr_n[sel]
            region_names, mode_names = regions_n[sel], modes_n[sel]
        else:
            _, rating_n, rd_n, thr_n, regions_n, modes_n, _ = native
            ids = np.fromiter((pid for _, pid, _ in keep), object, k)
            rating, rd, thr = (np.empty(k, np.float32) for _ in range(3))
            region_names, mode_names = np.empty(k, object), np.empty(k, object)
            for j, (s, _, req) in enumerate(keep):
                if req is None:
                    rating[j], rd[j], thr[j] = rating_n[s], rd_n[s], thr_n[s]
                    region_names[j], mode_names[j] = regions_n[s], modes_n[s]
                else:
                    rating[j], rd[j] = req.rating, req.rating_deviation
                    thr[j] = (np.nan if req.rating_threshold is None
                              else req.rating_threshold)
                    region_names[j], mode_names[j] = req.region, req.game_mode
        cols = RequestColumns(
            ids=ids, rating=rating, rd=rd,
            region=region_names, mode=mode_names,  # names until dispatch
            threshold=thr,
            enqueued_at=np.fromiter((self._first_received(d, now)
                                     for d in picked), np.float64, k),
            reply_to=np.fromiter((d.properties.reply_to for d in picked),
                                 object, k),
            correlation_id=np.fromiter(
                (d.properties.correlation_id for d in picked), object, k),
            tier=tier_col, deadline=dl_col)

        def dispatch(drop: set[str]) -> int:
            # Region/mode are interned here, into the current engine's
            # interners (a revive between the flush and this dispatch
            # rebuilds them).
            c = cols
            if drop:
                c = c.take(np.fromiter((i not in drop for i in c.ids.tolist()),
                                       bool, len(c)))
            reg, mode = self.engine.intern_columns(
                ["*" if r == "" else r for r in c.region.tolist()],
                ["*" if m == "" else m for m in c.mode.tolist()])
            c = dataclasses.replace(c, region=reg, mode=mode)
            tok = self.engine.search_columns_async(c, now)
            # After the stale, expired and debt drops: the journal holds
            # exactly what entered the pool.
            self._journal_admit_cols(c)
            return tok

        await self._dispatch_window(
            dispatch, [(pid, d) for (_, pid, _), d in zip(keep, picked)],
            now)

    def _window_rows(self, deliveries: list[Delivery], status, ids,
                     now: float) -> list[tuple[int, str, SearchRequest | None]]:
        """The rows of a window the flush decoded natively (``status`` and
        ``ids`` per delivery): (delivery index, player id, the request
        decoded in Python for a NEEDS_PYTHON row, else None). Malformed
        rows and parties are answered and acked here."""
        rows: list[tuple[int, str, SearchRequest | None]] = []
        for i, (delivery, st) in enumerate(zip(deliveries, status.tolist())):
            if st == codec.OK:
                rows.append((i, ids[i], None))
            elif st != codec.NEEDS_PYTHON:
                self._reject(delivery, codec.error_code(st),
                             "malformed payload")
            else:
                req = self._decode_or_reject(delivery, now)
                if req is None:
                    continue
                if req.party_size > 1:  # a 1v1 queue serves no parties
                    self._reject(delivery, "party_not_supported",
                                 "engine rejected request: party_not_supported")
                    continue
                rows.append((i, req.id, req))
        return rows

    async def _dispatch_window(self, dispatch,
                               pairs: list[tuple[str, Delivery]],
                               now: float) -> None:
        """Dispatch one window on a device engine (``dispatch(drop)``
        returns its token), then collect what has landed; with a full
        pipeline, hold this flush (and so the batcher) until a slot frees.
        Before the dispatch: collect, the terminal-replay and deadline
        re-checks, and the debt of ``shed_policy="oldest"`` (paid when the
        pipeline is empty, or once it reaches a whole batch: eviction
        needs a drained pipeline). A dispatch that raises is an engine
        crash: the engine is rebuilt and the window's deliveries nacked."""
        recorded = False
        deliveries_in = [d for _, d in pairs]
        try:
            self._collect_ready(time.time())
            if self._needs_revive:
                # A collected window failed: the device pool diverged from
                # the mirror. Revive before dispatching into it.
                self._drain_engine(now)
                if not self._async_api:
                    # The revive tripped the breaker: the host oracle took
                    # the queue, and this window was never dispatched. The
                    # redelivery takes the object path.
                    for d in deliveries_in:
                        self._nack(d)
                    return
            stale = self._settle_terminal(pairs, now)
            stale |= self._settle_expired(
                [p for p in pairs if p[0] not in stale], now)
            if stale:
                pairs = [(p, d) for p, d in pairs if p not in stale]
                deliveries_in = [d for _, d in pairs]
                if not pairs:
                    return
            if self.admission is not None:
                debt = self.admission.eviction_debt(len(pairs),
                                                    self.engine.pool_size())
                if debt and (self.engine.inflight() == 0
                             or debt >= self._batcher.max_batch):
                    self._drain_engine(now)
                    drop = self._pay_debt(
                        [(pid, d.tier, self._first_received(d, now), d)
                         for pid, d in pairs], debt, now)
                    if drop:
                        stale |= drop
                        pairs = [(p, d) for p, d in pairs if p not in drop]
                        deliveries_in = [d for _, d in pairs]
                        if not pairs:
                            return
            # The window is a cut: a still-valid speculation commits first
            # (then [commit; window] equals [rescan at its time; window]),
            # and is otherwise discarded by the window's admission.
            self._spec_cut(now)
            tok = dispatch(stale)
            self._inflight_meta[tok] = (dict(pairs), deliveries_in)
            recorded = True
            if self.pipeline_depth > 1:
                self._collect_ready(time.time())
            else:
                self._drain_engine(now)
        except Exception:
            log.exception("window dispatch failed; reviving the engine "
                          "from its mirror")
            self._record_engine_crash(now)
            self._revive_after_failure(
                now, extra_nack=None if recorded else deliveries_in)
            return
        # The engine may be swapped meanwhile (a revive onto the host
        # oracle nacks this window's meta): nothing is left to wait for.
        while self._async_api and self.engine.inflight() >= self.pipeline_depth:
            await asyncio.sleep(0.001)
            self._collect_ready(time.time())

    def _settle_terminal(self, pairs: list[tuple[str, Delivery]],
                         now: float) -> set[str]:
        """Second terminal-replay probe, right before the dispatch: the
        flush's probe ran before the collection of earlier windows, and a
        player those windows just matched is out of the pool (so the
        engine's dedupe no longer sees it) but in ``_recent``.
        Replays and acks such rows; returns their ids."""
        stale: set[str] = set()
        for pid, delivery in pairs:
            cached = self._recent.get(pid)
            if cached is None or cached[1] <= now:
                continue
            stale.add(pid)
            self._replay(delivery, cached[0])
        return stale

    # ---- collection -------------------------------------------------------

    def _collect_ready(self, now: float) -> None:
        """Answer every landed window. The results were copied to the host
        behind each step, so this is numpy and publishing."""
        if not self._async_api:
            return
        for tok, out in self.engine.collect_ready():
            self._finish_token(tok, out, now)

    def _finish_token(self, tok: int, out: ColumnarOutcome | SearchOutcome,
                      now: float) -> None:
        meta = self._inflight_meta.pop(tok, None)
        if meta is None:  # a rescan tick (or a window already settled)
            # Its marks go to the queue's rescan attribution (a rescan is
            # no trace); popped either way.
            marks = self.engine.window_marks.pop(tok, None)
            if tok in self.engine.rescan_tokens:
                if marks:
                    self.app.attribution.observe_rescan(self.queue_cfg.name,
                                                        marks)
                self.engine.rescan_tokens.discard(tok)
                if tok in self.engine.failed_tokens:
                    self.engine.failed_tokens.discard(tok)
                    log.error("rescan window %d failed on the device; "
                              "revive scheduled", tok)
                    self._record_engine_crash(now)
                    self._needs_revive = True
                    return
                self._publish_rescan_outcome(out, now)
            return
        by_id, deliveries = meta
        self._merge_window_marks(tok, deliveries)
        if tok in self.engine.failed_tokens:
            self.engine.failed_tokens.discard(tok)
            log.error("window %d failed on the device; nack + revive "
                      "scheduled", tok)
            self._record_engine_crash(now)
            self.events.append("window_failed", self.queue_cfg.name,
                               f"token {tok}, {len(deliveries)} nacked")
            for d in deliveries:
                self._nack(d)
            self._needs_revive = True
            return
        try:
            if isinstance(out, SearchOutcome):
                self._handle_object_out(out, deliveries, now)
            else:
                self._handle_columnar_out(out, by_id, deliveries, now)
        except Exception:
            # A failure mid-publish must still settle the deliveries: nack
            # (at-least-once; redeliveries are deduped against the pool and
            # the replay cache).
            log.exception("window %d outcome handling failed; nacking", tok)
            self.counters["outcome_errors"] += 1
            self.metrics.counters.inc("outcome_errors")
            for d in deliveries:
                self._nack(d)

    def _handle_columnar_out(self, out: ColumnarOutcome,
                             by_id: dict[str, Delivery],
                             deliveries: list[Delivery], now: float) -> None:
        """Publish one collected window's answers in one ``publish_batch``
        (matched bodies and queued acks, both batch-encoded natively, each
        with its trace id), then the engine's rejections, then ack the
        window and settle its traces."""
        trace_ids, traces = self._trace_maps(deliveries)
        # Queued acks first: in a window of several chunks, a player queued
        # by one chunk can be matched by a later chunk of the same window,
        # and its ack must not arrive after its match.
        rows: list[Row] = []
        metas = ([(pid, by_id[pid]) for pid in out.q_ids.tolist() if pid in by_id]
                 if self.queue_cfg.send_queued_ack else [])
        if metas:
            nq = len(metas)
            tids = [trace_ids.get(pid, "") for pid, _ in metas]
            bodies = codec.encode_simple_batch(
                np.full(nq, codec.KIND_QUEUED, np.int32),
                [pid for pid, _ in metas], np.zeros(nq, np.float64), None,
                tids if trace_ids else None, None)
            for (pid, d), tid, body in zip(metas, tids, bodies):
                if body is None:  # a row the C encoder cannot express
                    body = encode_response(SearchResponse(
                        status="queued", player_id=pid, trace_id=tid))
                if d.trace is not None:
                    d.trace.mark("encode")
                rows.append((d.properties.reply_to,
                             d.properties.correlation_id, body, d.trace))
        rows += self._build_columnar_rows(out, now, trace_ids, traces)
        self._publish_batch(rows)
        for pid, code in out.rejected:
            self.metrics.counters.inc("rejected_by_engine")
            d = by_id.get(pid)
            if d is not None:
                self._respond_error(d, code, f"engine rejected request: {code}")
        for d in deliveries:
            self._ack(d)
        if traces:
            matched_ids = set(out.m_id_a.tolist()) | set(out.m_id_b.tolist())
            rejected_ids = {pid for pid, _ in out.rejected}
            self._settle_traces([
                (d.trace, "matched" if d.trace.player_id in matched_ids else
                 "rejected" if d.trace.player_id in rejected_ids else
                 "queued")
                for d in deliveries if d.trace is not None])
        self.counters["windows"] += 1
        self.counters["requests"] += len(deliveries)
        self.counters["queued"] += len(out.q_ids)
        self.metrics.counters.inc("windows")
        self.metrics.counters.inc("requests_batched", len(deliveries))

    def _build_columnar_rows(self, out: ColumnarOutcome, now: float,
                             trace_ids: dict[str, str] | None = None,
                             traces: dict[str, TraceContext] | None = None,
                             ) -> list[Row]:
        """Matched bodies for a ColumnarOutcome, batch-encoded natively
        (byte-identical to ``encode_response``, trace ids included; rows
        the encoder flags re-encode in Python), remembered for terminal
        replay. Each matched player's wait (``match_wait`` latency and the
        ``e2e`` stage) goes to the metrics, and a traced player's trace
        gets its quality, wait and "encode" mark. The invariant checker
        sees every columnar outcome here (windows and rescan ticks)."""
        if self._invariants is not None:
            self._invariants.observe_outcome(out)
        n = out.n_matches
        if n == 0:
            return []
        # One vectorized ledger observe per window: both sides' samples.
        self.quality.observe(
            self.queue_cfg.name,
            np.concatenate([out.m_quality, out.m_quality]),
            np.concatenate([out.m_wait_a, out.m_wait_b]),
            np.concatenate([out.m_tier_a, out.m_tier_b]))
        lat_a = np.where(out.m_enq_a != 0.0, (now - out.m_enq_a) * 1e3, 0.0)
        lat_b = np.where(out.m_enq_b != 0.0, (now - out.m_enq_b) * 1e3, 0.0)
        wa_ms, wb_ms = out.m_wait_a * 1e3, out.m_wait_b * 1e3
        ids_a, ids_b = out.m_id_a.tolist(), out.m_id_b.tolist()
        mids = out.m_match_id.tolist()
        qual = out.m_quality.astype(np.float64)
        tr_a = [trace_ids.get(p, "") for p in ids_a] if trace_ids else None
        tr_b = [trace_ids.get(p, "") for p in ids_b] if trace_ids else None
        bodies = codec.encode_matched_batch(ids_a, ids_b, mids, lat_a, lat_b,
                                            qual, wa_ms, wb_ms, tr_a, tr_b)
        m = self.metrics
        m.counters.inc("players_matched", 2 * n)
        rec = m.latency["match_wait"]
        q = self.queue_cfg.name
        for enq in (out.m_enq_a, out.m_enq_b):
            for w in (now - enq[enq != 0.0]).tolist():
                rec.record(w)
                m.observe_stage(q, "e2e", w)
        reply_a, reply_b = out.m_reply_a.tolist(), out.m_reply_b.tolist()
        corr_a, corr_b = out.m_corr_a.tolist(), out.m_corr_b.tolist()
        wa_l, wb_l = wa_ms.tolist(), wb_ms.tolist()
        qual_l = qual.tolist()
        traces = traces or {}
        rows: list[Row] = []
        terminals: list[tuple[str, bytes]] = []
        for j in range(n):
            body_a, body_b = bodies[2 * j], bodies[2 * j + 1]
            if body_a is None or body_b is None:
                result = MatchResult(
                    match_id=mids[j], players=(ids_a[j], ids_b[j]),
                    teams=((ids_a[j],), (ids_b[j],)), quality=qual_l[j])
                if body_a is None:
                    body_a = encode_response(SearchResponse(
                        status="matched", player_id=ids_a[j], match=result,
                        latency_ms=float(lat_a[j]), waited_ms=wa_l[j],
                        trace_id=tr_a[j] if tr_a else ""))
                if body_b is None:
                    body_b = encode_response(SearchResponse(
                        status="matched", player_id=ids_b[j], match=result,
                        latency_ms=float(lat_b[j]), waited_ms=wb_l[j],
                        trace_id=tr_b[j] if tr_b else ""))
            tr_ja = traces.get(ids_a[j]) if traces else None
            tr_jb = traces.get(ids_b[j]) if traces else None
            if tr_ja is not None:
                tr_ja.quality = qual_l[j]
                tr_ja.waited_s = wa_l[j] / 1e3
                tr_ja.mark("encode")
            if tr_jb is not None:
                tr_jb.quality = qual_l[j]
                tr_jb.waited_s = wb_l[j] / 1e3
                tr_jb.mark("encode")
            terminals.append((ids_a[j], body_a))
            terminals.append((ids_b[j], body_b))
            rows.append((reply_a[j], corr_a[j], body_a, tr_ja))
            rows.append((reply_b[j], corr_b[j], body_b, tr_jb))
        self._remember_window(terminals, now)
        self.counters["players_matched"] += 2 * n
        return rows

    def _handle_object_out(self, out: SearchOutcome,
                           deliveries: list[Delivery], now: float) -> None:
        """Publish one collected object window's answers in one
        ``publish_batch`` (queued acks, then every matched player's
        answer), then the engine's rejections, then ack the window and
        settle its traces. Queued acks go first for the reason the
        columnar path gives: a player queued by one chunk (or, on the host
        oracle, at its own arrival) can be matched later in the same
        window."""
        if self._invariants is not None:
            self._invariants.observe_outcome(out)
        trace_ids, traces = self._trace_maps(deliveries)
        rows: list[Row] = []
        if self.queue_cfg.send_queued_ack:
            rows += [(r.reply_to, r.correlation_id, encode_response(
                SearchResponse(status="queued", player_id=r.id,
                               trace_id=trace_ids.get(r.id, ""))),
                traces.get(r.id)) for r in out.queued]
        rows += self._build_object_rows(out, now, trace_ids, traces)
        self._publish_batch(rows)
        for req, code in out.rejected:
            self.counters["rejected"] += 1
            self.metrics.counters.inc("rejected_by_engine")
            self._publish(req.reply_to, req.correlation_id, encode_response(
                SearchResponse(status="error", player_id=req.id,
                               error_code=code,
                               error_reason=f"engine rejected request: {code}",
                               trace_id=trace_ids.get(req.id, ""))),
                trace=traces.get(req.id))
        for d in deliveries:
            self._ack(d)
        self._settle_outcome_traces(out, deliveries)
        self.counters["windows"] += 1
        self.counters["requests"] += len(deliveries)
        self.counters["queued"] += len(out.queued)
        self.metrics.counters.inc("windows")
        self.metrics.counters.inc("requests_batched", len(deliveries))

    def _build_object_rows(self, out: SearchOutcome, now: float,
                           trace_ids: dict[str, str] | None = None,
                           traces: dict[str, TraceContext] | None = None,
                           ) -> list[Row]:
        """Matched answers of a ``SearchOutcome``, one per player with the
        whole match (both teams), remembered for terminal replay. The
        object path has no dispatch stamp: ``waited_ms`` is the latency,
        as in the JAX service."""
        trace_ids = trace_ids or {}
        traces = traces or {}
        m = self.metrics
        q = self.queue_cfg.name
        rows: list[Row] = []
        terminals: list[tuple[str, bytes]] = []
        # The ledger's samples, one per member, observed once per window.
        qualities: list[float] = []
        lats_ms: list[float] = []
        tiers: list[int] = []
        for match in out.matches:
            result = match.result()
            members = match.requests()
            lats = [(now - r.enqueued_at) * 1e3 if r.enqueued_at else 0.0
                    for r in members]
            qualities += [result.quality] * len(members)
            lats_ms += lats
            tiers += [r.tier for r in members]
            for req, lat in zip(members, lats):
                m.counters.inc("players_matched")
                if req.enqueued_at:
                    m.record_latency("match_wait", now - req.enqueued_at)
                    m.observe_stage(q, "e2e", now - req.enqueued_at)
                body = encode_response(SearchResponse(
                    status="matched", player_id=req.id, match=result,
                    latency_ms=lat, waited_ms=lat,
                    trace_id=trace_ids.get(req.id, "")))
                tr = traces.get(req.id)
                if tr is not None:
                    tr.quality = result.quality
                    tr.waited_s = lat / 1e3
                terminals.append((req.id, body))
                rows.append((req.reply_to, req.correlation_id, body, tr))
        self.quality.observe(self.queue_cfg.name, qualities,
                             np.asarray(lats_ms) / 1e3, tiers)
        self._remember_window(terminals, now)
        self.counters["players_matched"] += len(terminals)
        return rows

    def _publish_rescan_outcome(self, out: ColumnarOutcome | SearchOutcome,
                                now: float) -> None:
        """Publish a rescan tick's matches. Its unmatched players were
        already waiting, and are never acked again."""
        if isinstance(out, SearchOutcome):
            if self._invariants is not None:
                self._invariants.observe_outcome(out)
            self._publish_batch(self._build_object_rows(out, now))
            n = len(out.matches)
        else:
            self._publish_batch(self._build_columnar_rows(out, now))
            n = out.n_matches
        self.counters["rescan_matches"] += n
        if n:
            self.metrics.counters.inc("rescan_matches", n)

    # ---- engine lifecycle -------------------------------------------------

    def _drain_engine(self, now: float) -> None:
        """Discard a held speculation (the caller is about to change,
        read out or replace the pool); collect and answer every in-flight
        window (blocking); then revive, if a window failed."""
        self._spec_invalidate_audited("drain")
        if self._async_api and self.engine.inflight() > 0:
            for tok, out in self.engine.flush():
                self._finish_token(tok, out, now)
        if self._needs_revive:
            self._revive(now)

    def _revive_after_failure(self, now: float,
                              extra_nack: list[Delivery] | None = None) -> None:
        """After a failed dispatch: answer what landed, nack the rest and
        rebuild the engine from its mirror."""
        outs = []
        if self._async_api:
            try:
                outs = self.engine.flush()
            except Exception:
                log.exception("flush during revive failed; every in-flight "
                              "window is nacked")
        for tok, out in outs:
            self._finish_token(tok, out, now)
        for d in extra_nack or ():
            self._nack(d)
        self._revive(now)

    def _revive(self, now: float) -> None:
        """Rebuild the engine (``_make_engine``: the host oracle while the
        breaker is open) and re-admit the old engine's waiting players:
        as columns between two 1v1 device engines, as ``waiting()``
        requests otherwise (team and role queues, and any move to or from
        the host oracle). The quality counters are carried across and the
        old engine is closed. Every window still tracked is nacked (the
        new engine numbers its tokens from 0); nothing is in flight on the
        old engine, or what is will never be collected."""
        self._needs_revive = False
        old = self.engine
        self._spec_invalidate_audited("revive")
        for tok, (_, deliveries) in list(self._inflight_meta.items()):
            for d in deliveries:
                self._nack(d)
            del self._inflight_meta[tok]
        engine = self._make_engine()
        columns = (not self._team and hasattr(old, "waiting_columns")
                   and hasattr(engine, "restore_columns"))
        if columns:
            waiting = old.waiting_columns()
            n = len(waiting[0])
        else:
            waiting = old.waiting()
            n = len(waiting)
        # The quality counters stay monotone across the rebuild.
        quality = old.quality_checkpoint()
        old.close()
        if columns:
            self._restore_into(engine, *waiting, now)
        else:
            engine.restore(waiting, now)
        engine.quality_restore(quality)
        self._bind_engine(engine)
        self.counters["revives"] += 1
        self.events.append("engine_revive", self.queue_cfg.name,
                           f"{n} players restored from mirror")
        log.warning("engine revived (%s): %d waiting players restored",
                    type(engine).__name__, n)

    async def _collector_loop(self) -> None:
        """Collect landed windows when no flush is running (traffic stops:
        the windows in flight must still be answered). One failed tick must
        not end the loop. A swap onto the host oracle cancels it."""
        while True:
            try:
                if self.engine.inflight() > 0 or self._needs_revive:
                    async with self._pool_lock:
                        now = time.time()
                        if self._async_api:
                            self._collect_ready(now)
                            if (self._needs_revive
                                    and self.engine.inflight() == 0):
                                self._revive(now)
                    await asyncio.sleep(0.001)
                else:
                    await asyncio.sleep(0.01)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("collector tick failed; retrying")
                self.counters["collector_errors"] += 1
                self.metrics.counters.inc("collector_errors")
                await asyncio.sleep(0.05)

    async def _rescan_loop(self) -> None:
        """Every ``rescan_interval_s``, dispatch a rescan tick into the
        pipeline (it may overlap windows in flight) and wait, without
        draining, for the shared collection to publish it. A tick still
        outstanding after 30 s makes the next ticks skip until it lands.
        On the host oracle the tick is its synchronous ``rescan``."""
        interval = self.queue_cfg.rescan_interval_s
        window = self.queue_cfg.rescan_window or self.cfg.batcher.max_batch
        outstanding: int | None = None
        while True:
            await asyncio.sleep(interval)
            now = time.time()
            if (outstanding is not None
                    and outstanding in getattr(self.engine, "rescan_tokens",
                                               ())):
                log.warning("rescan token %d still outstanding; skipping "
                            "this tick", outstanding)
                self.counters["rescan_skipped"] += 1
                self.metrics.counters.inc("rescan_skipped_outstanding")
                continue
            outstanding = None
            try:
                async with self._pool_lock:
                    now = time.time()
                    if not self._async_api:
                        self._publish_rescan_outcome(
                            self.engine.rescan(window, now), now)
                        continue
                    # A rescan tick is a cut too: a valid speculation
                    # commits, and the tick then widens over the pool
                    # after it.
                    self._spec_cut(now)
                    tok = self.engine.rescan_async(window, now)
                if tok is None:
                    continue
                deadline = time.monotonic() + 30.0
                done = False
                while not done and time.monotonic() < deadline:
                    async with self._pool_lock:
                        self._collect_ready(time.time())
                        done = tok not in getattr(self.engine,
                                                  "rescan_tokens", ())
                        if (self._needs_revive
                                and self.engine.inflight() == 0):
                            self._revive(time.time())
                    if not done:
                        await asyncio.sleep(0.01)
                if not done:
                    outstanding = tok
                    log.warning("rescan token %d exceeded its 30 s "
                                "collection deadline", tok)
                    self.metrics.counters.inc("rescan_deadline_overruns")
                    self.events.append("rescan_overrun", self.queue_cfg.name,
                                       f"token {tok}")
            except Exception:
                log.exception("rescan failed; reviving the engine from its "
                              "mirror")
                async with self._pool_lock:
                    self._record_engine_crash(now)
                    self._revive(now)

    async def _sweep_loop(self) -> None:
        """Timeouts (``request_timeout_s``, on a quarter of it) and
        per-player deadline expiry (``deadline_sweep_ms``), on a drained
        pipeline. A deadline tick with no deadline in the pool does not
        drain it."""
        timeout = self.queue_cfg.request_timeout_s
        sweep_ms = self.cfg.overload.deadline_sweep_ms
        timeout_interval = (max(0.05, timeout / 4.0)
                            if timeout is not None else None)
        dl_interval = max(0.01, sweep_ms / 1e3) if sweep_ms > 0 else None
        interval = min(x for x in (timeout_interval, dl_interval) if x)
        next_timeout = (time.monotonic() + timeout_interval
                        if timeout_interval else None)
        while True:
            await asyncio.sleep(interval)
            now = time.time()
            run_timeout = (next_timeout is not None
                           and time.monotonic() >= next_timeout)
            if run_timeout:
                next_timeout = time.monotonic() + timeout_interval
            run_dl = dl_interval is not None and self.engine.deadline_count() != 0
            if not run_timeout and not run_dl:
                continue
            async with self._pool_lock:
                self._sweep(now, timeout if run_timeout else None, run_dl)

    def _sweep(self, now: float, timeout: float | None, run_dl: bool) -> None:
        """One expiry sweep on a drained pipeline: ``timeout`` answers for
        players waiting past ``timeout`` (None: no timeout sweep), and the
        deadline expiries with ``run_dl``."""
        try:
            self._drain_engine(now)
            expired = (self.engine.expire(now, timeout)
                       if timeout is not None else [])
            dl_expired = self.engine.expire_deadlines(now) if run_dl else []
        except Exception:
            log.exception("expiry sweep failed; reviving the engine from "
                          "its mirror")
            self._record_engine_crash(now)
            self._revive(now)
            return
        for removed in expired:
            self.counters["timeouts"] += 1
            self.metrics.counters.inc("timeouts")
            body = encode_response(SearchResponse(
                status="timeout", player_id=removed.id,
                latency_ms=((now - removed.enqueued_at) * 1e3
                            if removed.enqueued_at else 0.0)))
            self._remember(removed.id, body, now)
            self._publish(removed.reply_to, removed.correlation_id, body)
        for removed in dl_expired:
            self._publish_pool_expiry(removed, now)

    def _publish_pool_expiry(self, removed: SearchRequest, now: float) -> None:
        """A waiting player the deadline sweep removed: ``timeout``
        (remembered, so a redelivered copy replays it), counted as expired
        in its tier. With tracing on the expiry is a trace of its own
        (enqueue, expired, publish: no dispatch mark); the player's first
        trace settled "queued" with its window."""
        self.counters["timeouts"] += 1
        ac = self.admission
        if ac is not None:
            ac.record_expired(f"pool waiter {removed.id} deadline",
                              tier=removed.tier)
        tr = None
        if self.app.trace_enabled:
            tr = TraceContext(self.queue_cfg.name, removed.correlation_id,
                              t=removed.enqueued_at or now)
            tr.player_id = removed.id
            tr.tier = removed.tier
            tr.mark("expired", now)
        body = encode_response(SearchResponse(
            status="timeout", player_id=removed.id,
            latency_ms=((now - removed.enqueued_at) * 1e3
                        if removed.enqueued_at else 0.0),
            trace_id=tr.trace_id if tr is not None else "",
            tier=removed.tier if ac is not None and ac.tiers > 1 else None))
        self._remember(removed.id, body, now)
        self._publish(removed.reply_to, removed.correlation_id, body, trace=tr)
        if tr is not None:
            self._settle_traces([(tr, "expired")])

    async def _health_loop(self) -> None:
        """The health timer, every ``EngineConfig.health_interval_s``:
        ``engine.heartbeat(now)`` (a team or role queue handed to the host
        oracle goes back onto the card once its blockers drained and the
        quiet period passed; a bucketed queue rebuilds its index), and,
        while the breaker is open and a probe is due, the half-open probe
        (``_probe_device``). Nothing else would do either under zero
        traffic. The tick runs on the event loop, as every other engine
        call does. Supervised: a tick that raises is logged, counted and
        retried on the next interval; it never ends the loop."""
        interval = self.cfg.engine.health_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                async with self._pool_lock:
                    now = time.time()
                    if self.engine.heartbeat(now):
                        self.counters["health_repromotions"] += 1
                        self.metrics.counters.inc("health_repromotions")
                    if (self.breaker is not None
                            and self.breaker.probe_due(now)):
                        self._probe_device(now)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("health tick failed; retrying")
                self.counters["health_tick_errors"] += 1
                self.metrics.counters.inc("health_tick_errors")

    def _probe_build(self):
        """A fresh device engine that passed its ``probe()``, and the host
        ms of its build and of the probe (on the card: the capture of the
        probed graph, its replay and the synchronize). On a failed probe
        the engine is closed and the error raised."""
        t0 = time.perf_counter()
        engine = self._device_engine()
        t1 = time.perf_counter()
        try:
            engine.probe()
        except BaseException:
            engine.close()
            raise
        return engine, {"build_ms": (t1 - t0) * 1e3,
                        "probe_ms": (time.perf_counter() - t1) * 1e3}

    def _probe_device(self, now: float) -> None:
        """The half-open probe: a fresh device engine is built and probed
        while the host oracle keeps the pool. On success the waiting
        players move onto it (``waiting()`` requests, restored before the
        oracle is dropped, so a failed move leaves the oracle serving),
        with the quality counters, and the breaker closes; on failure the
        breaker backs off and the oracle stays."""
        self.breaker.begin_probe(now)
        self.counters["breaker_probes"] += 1
        self.metrics.counters.inc("breaker_probes")
        self.events.append("breaker_probe", self.queue_cfg.name)
        self._publish_breaker_gauges()
        try:
            candidate, times = self._probe_build()
        except Exception as e:
            self._probe_failed(str(e))
            return
        t0 = time.perf_counter()
        swap_now = time.time()
        self._drain_engine(swap_now)
        old = self.engine
        try:
            waiting = old.waiting()
            candidate.restore(waiting, swap_now)
            candidate.quality_restore(old.quality_checkpoint())
        except Exception as e:
            candidate.close()
            self._probe_failed(f"pool transfer: {e}")
            return
        old.close()
        self._bind_engine(candidate)
        self.breaker.probe_succeeded(time.time())
        self.counters["breaker_closes"] += 1
        self.metrics.counters.inc("breaker_closes")
        self.events.append("breaker_closed", self.queue_cfg.name,
                           f"{len(waiting)} waiting players transferred")
        self._publish_breaker_gauges()
        self.last_probe = {**times, "move_ms": (time.perf_counter() - t0) * 1e3,
                           "moved": len(waiting)}
        log.info("queue %r: half-open probe passed; breaker closed, %d "
                 "waiting players back on the device engine",
                 self.queue_cfg.name, len(waiting))

    def _probe_failed(self, why: str) -> None:
        self.breaker.probe_failed(time.time())
        self.counters["breaker_probe_failures"] += 1
        self.metrics.counters.inc("breaker_probe_failures")
        self.events.append("probe_failed", self.queue_cfg.name, why)
        self._publish_breaker_gauges()
        log.warning("queue %r: half-open probe failed (%s); next probe in "
                    "%.2f s", self.queue_cfg.name, why,
                    self.breaker.probe_delay_s)

    def _spec_cut(self, now: float) -> bool:
        """Commit the held speculation at a cut if it is still valid (no
        pool mutation since it was taken, and at most
        ``spec_staleness_ms`` old): ``spec_validate`` then ``spec_commit``
        with nothing in between; the committed window is collected and
        published as a rescan tick's. True when one committed. A failed
        commit is counted and discarded: the cut's own step that follows
        is the full step."""
        eng = self.engine
        try:
            tok = eng.spec_validate(
                now, max_age_s=self.cfg.engine.spec_staleness_ms / 1e3)
            if tok is None:
                return False
            eng.spec_commit(tok, now)
        except Exception:
            log.exception("speculative commit failed; the cut runs its "
                          "full step")
            self.counters["spec_errors"] += 1
            self.metrics.counters.inc("spec_errors")
            self._spec_invalidate_audited("cut-commit failure")
            return False
        self.counters["spec_commits"] += 1
        self.metrics.counters.inc("spec_commits")
        return True

    def _spec_invalidate_audited(self, reason: str) -> None:
        """Discard a held speculation; when one was held, the
        ``spec_invalidate`` event records why."""
        eng = self.engine
        had = getattr(eng, "_spec", None) is not None
        eng.spec_invalidate(reason)
        if had:
            self.events.append("spec_invalidate", self.queue_cfg.name,
                               reason, component="engine")

    async def _spec_loop(self) -> None:
        """Every ``spec_interval_ms``, in the gap between windows (nothing
        in flight, no revive pending, a device engine): commit the
        speculation left by the last tick if still valid (the tick is a
        cut), let the engine speculate at the current time, and collect
        what has landed. With windows in flight it only collects (a flush
        yields to the loop only while its windows are in flight). A tick
        that raises is counted and its speculation discarded; the loop
        goes on. It runs on the event loop, as every engine call does."""
        interval = max(0.001, self.cfg.engine.spec_interval_ms / 1e3)
        while True:
            await asyncio.sleep(interval)
            try:
                async with self._pool_lock:
                    if self._needs_revive or not self._async_api:
                        continue
                    if self.engine.inflight() > 0:
                        self._collect_ready(time.time())
                        continue
                    now = time.time()
                    self._spec_cut(now)
                    self.engine.speculate(now)
                    self._collect_ready(time.time())
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("speculation tick failed; discarding it")
                self.counters["spec_errors"] += 1
                self.metrics.counters.inc("spec_errors")
                self._spec_invalidate_audited("tick failure")

    # ---- egress: every answer and settle, behind its journal commit -------

    def _effect(self, fn, *, hold: bool = False) -> None:
        """Run ``fn`` (a publish, an ack or a nack) after a journal commit
        that covers every record appended so far (write-ahead). Inline,
        commit then ``fn``, unless the settle is asynchronous and ``hold``
        asks for it (a window's publish, with a commit owed), or earlier
        effects still wait: then ``fn`` queues for the settler, whose
        commit runs on a worker thread."""
        if self._egress or (hold and self._settle_async
                            and self.journal.needs_commit):
            self._egress.append(fn)
            if self._settler is None:
                self._settler = asyncio.create_task(self._settle_loop())
            return
        self._journal_commit()
        fn()

    async def _settle_loop(self) -> None:
        """Commit on a worker thread, then run the effects queued before
        the commit began, in order; again until none wait. An effect that
        raises is logged and counted; the rest still run."""
        stats = self.journal_stats
        try:
            while self._egress:
                batch, self._egress = self._egress, []
                t0 = time.perf_counter()
                thread_ms = await asyncio.to_thread(self._timed_commit)
                stats["commit_wait_ms"] += (time.perf_counter() - t0) * 1e3
                stats["commit_thread_ms"] += thread_ms
                stats["commits"] += 1
                for fn in batch:
                    try:
                        fn()
                    except Exception:
                        log.exception("a settle after the journal commit "
                                      "failed")
                        self.counters["outcome_errors"] += 1
        finally:
            self._settler = None

    def _timed_commit(self) -> float:
        t0 = time.perf_counter()
        self.journal.commit()
        return (time.perf_counter() - t0) * 1e3

    async def _settled(self) -> None:
        """Wait until no effect waits for a commit."""
        while self._settler is not None:
            await asyncio.gather(self._settler, return_exceptions=True)

    def _journal_commit(self) -> None:
        """Write (and fsync, per policy) the journal's records before an
        effect leaves: nothing with durability off or nothing owed."""
        j = self.journal
        if j is not None and j.needs_commit:
            j.commit()

    def _journal_admit_cols(self, cols: RequestColumns) -> None:
        """One dispatched columnar window's ADMIT record (region and mode
        codes of this engine's interners, journaled by name), written out
        at once without an fsync: a crash mid-window recovers the window's
        players as waiting. The rows are the JAX package's, value for
        value (the same dtypes, read in the same order)."""
        j = self.journal
        if j is None or not len(cols):
            return
        t0 = time.perf_counter()
        rows = _admit_rows(
            cols, self.engine.pool.regions.names()[cols.region].tolist(),
            self.engine.pool.modes.names()[cols.mode].tolist())
        t1 = time.perf_counter()
        j.append_admits(rows)
        j.flush_buffer()
        stats = self.journal_stats
        stats["admit_rows_ms"] += (t1 - t0) * 1e3
        stats["admit_write_ms"] += (time.perf_counter() - t1) * 1e3
        stats["admit_records"] += 1

    def _journal_admit_reqs(self, requests: Sequence[SearchRequest]) -> None:
        """The object path's ADMIT record (team and role queues, and the
        host oracle's synchronous flush)."""
        j = self.journal
        if j is None or not requests:
            return
        j.append_admits(_admit_rows_of(requests))
        j.flush_buffer()
        self.journal_stats["admit_records"] += 1

    def _publish_batch(self, rows: list[Row]) -> None:
        """One broker ``publish_batch`` call for a window's responses
        (rows without a reply queue are dropped), after the commit that
        covers them; each traced row's trace gets its "respond" mark as
        the batch leaves."""
        items = [(reply_to, body, Properties(correlation_id=corr))
                 for reply_to, corr, body, _ in rows if reply_to]
        if not items:
            return
        traces = [tr for reply_to, _, _, tr in rows
                  if reply_to and tr is not None]

        def publish() -> None:
            # The fence is read as the batch leaves: a window held for its
            # commit may be superseded while the commit runs.
            if not self._may_publish(len(items)):
                return
            if traces:
                t = time.time()
                for tr in traces:
                    tr.mark("respond", t)
            self.broker.publish_batch(items)
            self.counters["publish_batches"] += 1
        self._effect(publish, hold=True)

    def _publish(self, reply_to: str, correlation_id: str, body: bytes,
                 trace: TraceContext | None = None) -> None:
        """One response, after the commit that covers it; ``trace`` gets
        its "respond" mark as it leaves."""
        if not reply_to:
            return
        props = Properties(correlation_id=correlation_id)

        def publish() -> None:
            if not self._may_publish(1):
                return
            if trace is not None:
                trace.mark("respond")
            self.broker.publish(reply_to, body, props)
        self._effect(publish)

    def _may_publish(self, n: int) -> bool:
        """The epoch fence of both publish seams, read as the publish
        leaves (after its commit): a superseded ex-primary makes no answer
        visible (the successor owns these players now); its ``n`` refused
        publishes are counted."""
        r = self.replication
        if r is None or r.may_publish():
            return True
        self.counters["fenced_publish_refused"] += n
        self.metrics.counters.inc("fenced_publish_refused", n)
        return False

    def _replay(self, delivery: Delivery, body: bytes) -> None:
        """Answer a redelivered request with its cached terminal body."""
        self.counters["deduped_replays"] += 1
        self.metrics.counters.inc("deduped_replays")
        self._publish(delivery.properties.reply_to,
                      delivery.properties.correlation_id, body,
                      trace=delivery.trace)
        self._ack(delivery)
        self._settle_trace(delivery, "deduped", "dedup_replay")

    def _respond_error(self, delivery: Delivery, code: str, reason: str) -> None:
        self.counters["rejected"] += 1
        tr = delivery.trace
        self._publish(delivery.properties.reply_to,
                      delivery.properties.correlation_id,
                      encode_response(SearchResponse(
                          status="error", player_id="", error_code=code,
                          error_reason=reason,
                          trace_id=tr.trace_id if tr is not None else "")))

    def _reject(self, delivery: Delivery, code: str, reason: str) -> None:
        """A middleware, decode or party reject: the error answer, the ack
        and the trace's "reject" mark."""
        self.metrics.counters.inc("rejected_by_engine"
                                  if code == "party_not_supported"
                                  else "rejected_by_middleware")
        self._respond_error(delivery, code, reason)
        self._ack(delivery)
        self._settle_trace(delivery, "rejected", "reject")

    def _remember(self, player_id: str, body: bytes, now: float) -> None:
        """Every terminal answer lands here or in ``_remember_window``: in
        the replay cache and, as a TERMINAL record, in the journal."""
        expiry = now + self.queue_cfg.dedup_ttl_s
        self._recent.set(player_id, (body, expiry))
        if self.journal is not None:
            self.journal.append_terminal(player_id, body, expiry)

    def _remember_window(self, terminals: list[tuple[str, bytes]],
                         now: float) -> None:
        """A window's terminals: the replay cache, and one TERMINALS
        record written out at once."""
        if not terminals:
            return
        expiry = now + self.queue_cfg.dedup_ttl_s
        for pid, body in terminals:
            self._recent.set(pid, (body, expiry))
        if self.journal is not None:
            t0 = time.perf_counter()
            self.journal.append_terminals(
                [(pid, body, expiry) for pid, body in terminals])
            self.journal_stats["terminals_ms"] += (
                time.perf_counter() - t0) * 1e3
            self.journal_stats["terminal_records"] += 1

    def _prune_recent(self, now: float) -> None:
        """Drop expired replay entries, at most every ``dedup_ttl_s / 2``."""
        if len(self._recent) > 4096 and now >= self._next_prune:
            self._recent.prune(now)
            self._next_prune = now + self.queue_cfg.dedup_ttl_s / 2.0

    def _ack(self, delivery: Delivery) -> None:
        """Ack and return the delivery's admission credit, after the
        journal commit: every settle comes through here or ``_nack``, so
        ``admission.inflight()`` counts exactly the admitted, unsettled
        deliveries."""
        def settle() -> None:
            self.broker.ack(self._tag, delivery.delivery_tag)
            if self.admission is not None:
                self.admission.release(delivery.delivery_tag)
        self._effect(settle)

    def _nack(self, delivery: Delivery) -> None:
        """Nack (requeue) and return the credit: the redelivery takes
        admission again."""
        def settle() -> None:
            self.broker.nack(self._tag, delivery.delivery_tag, requeue=True)
            if self.admission is not None:
                self.admission.release(delivery.delivery_tag)
        self._effect(settle)


class MatchmakingApp:
    """Serves every queue of ``cfg.queues`` from ``broker`` (a fresh
    in-process broker by default), each through its own ``_QueueRuntime``
    with an engine on ``device`` (default: the card).

    ``engine``, ``counters`` and ``queue_cfg`` are the first queue's (a
    one-queue app's); ``runtime(name)`` gives any queue's. ``spine``,
    ``events``, ``metrics``, ``recorder``, ``attribution``, ``quality``,
    ``telemetry`` and ``incidents`` are the app's observability sinks
    (built in the JAX app's order: all of them before any runtime starts,
    since a recovery at ``start`` stamps ``crash_recovered``)."""

    def __init__(self, cfg: Config, broker: InProcBroker | None = None,
                 device=None, replication_hub=None):
        self.cfg = cfg
        self.device = device
        #: The replication fabric (service/replication.ReplicationHub or
        #: net/link.SocketReplicationHub; None: none), shared by a primary
        #: app, its standbys and a failover successor. A hub passed in is
        #: never closed here; one built from ``cfg.net`` at ``start`` is
        #: owned, and closed by ``stop``, ``crash`` and ``drain``.
        self.replication_hub = replication_hub
        self._owns_net_hub = False
        obs = cfg.observability
        #: The causal spine every lifecycle event is stamped onto (one per
        #: app: each run's seq starts at 1).
        self.spine = EventSpine(ring=cfg.forensics.spine_ring)
        #: The lifecycle event log (appended by the runtimes, the engines,
        #: the admission controllers, the chaos hooks and the broker).
        self.events = EventLog(obs.event_ring, spine=self.spine)
        #: Trace stamping (ObservabilityConfig.trace) and its sampling.
        self.trace_enabled = obs.trace
        self.trace_sample_n = max(1, obs.trace_sample_n)
        #: Counters under the JAX package's names, gauges, latencies and
        #: the per-stage histograms.
        self.metrics = Metrics(stage_buckets=obs.stage_buckets or None)
        #: Settled traces (per-queue rings and slow exemplars); feeds the
        #: stage histograms and the attribution.
        self.recorder = FlightRecorder(
            self.metrics, ring=obs.trace_ring, slow_ring=obs.slow_trace_ring,
            slow_threshold_s=obs.slow_trace_ms / 1e3)
        #: Work against wait over settled traces, per queue and category.
        self.attribution = Attribution(
            buckets=obs.stage_buckets or None,
            slo_target_s=obs.slo_target_ms / 1e3,
            tiers=max(1, cfg.overload.tiers))
        self.recorder.attribution = self.attribution
        #: Per-queue, per-tier quality and wait of matched players, fed
        #: when their answers are published.
        self.quality = QualityLedger(
            QualitySpec.from_config(obs),
            quality_target=obs.quality_slo_target)
        #: The telemetry ring, sampled every ``snapshot_interval_s`` by
        #: ``_telemetry_loop`` (and by ``sample_telemetry`` on demand).
        self.telemetry = TelemetryRing(obs.telemetry_ring)
        #: The SLO burn monitors by key (queue, ``queue@tN``,
        #: ``queue#quality``), built at ``start`` after the recovery.
        self._slo_monitors: dict[str, SloMonitor] = {}
        self._telemetry_task: asyncio.Task | None = None
        #: The fault script's state (None: no chaos configured): the
        #: broker's fault decisions, and each queue runtime's engine hook.
        self.chaos = (ChaosState(cfg.chaos, events=self.events)
                      if cfg.chaos.enabled() else None)
        self.broker = broker or InProcBroker(cfg.broker, cfg.seed,
                                             chaos=self.chaos)
        self.broker.events = self.events
        self.broker.trace_enabled = self.trace_enabled
        self.broker.trace_sample_n = self.trace_sample_n
        names = [q.name for q in cfg.queues]
        if len(set(names)) != len(names):
            raise ValueError(f"queue names must be distinct: {names}")
        self._runtimes = {q.name: _QueueRuntime(self, q) for q in cfg.queues}
        self._first = self._runtimes[names[0]]
        #: Incident capture: subscribes to the spine (with
        #: ``forensics.capture``), after ``_runtimes`` exists.
        self.incidents = IncidentRecorder(self, cfg.forensics)
        #: The HTTP server (``metrics_port``), from ``start`` on.
        self._observability = None

    async def start(self) -> None:
        """Load the codec, then start every queue: its engine, the
        recovery of an unclean predecessor's journal, its consumer and
        loops, and then its compaction timer. Then the SLO burn monitors,
        the telemetry sampler and, with ``metrics_port``, the HTTP
        server."""
        codec.load()  # a codec that cannot build raises here
        if self.cfg.replication.enabled():
            # Every queue boots as its primary: a hub is the fabric its
            # standby attaches through, and the journal is the stream.
            if not self.cfg.durability.enabled():
                raise ValueError(
                    "replication requires durability (journal_dir): the "
                    "journal is the replication stream")
            if self.replication_hub is None and self.cfg.net.enabled():
                # cfg.net names a lease service and a replication target:
                # across processes no in-process hub can be shared, so
                # this app builds, and owns, its socket fabric.
                from matchmaking_tpu_torch.net.link import (
                    SocketReplicationHub,
                )

                self.replication_hub = SocketReplicationHub(
                    net=self.cfg.net, chaos=self.cfg.chaos,
                    seed=self.cfg.chaos.seed,
                    owner=self.cfg.replication.owner or "primary")
                self._owns_net_hub = True
            if self.replication_hub is None:
                raise ValueError(
                    "cfg.replication.role is set but no ReplicationHub was "
                    "passed to MatchmakingApp(replication_hub=...): the hub "
                    "is the shared fabric (links and lease authority) a "
                    "standby attaches through")
        for rt in self._runtimes.values():
            await rt.start()
        obs = self.cfg.observability

        def monitor(key: str, target: float, objective: float,
                    **series) -> None:
            self._slo_monitors[key] = SloMonitor(
                key, target_ms=target, objective=objective,
                fast_window_s=obs.slo_fast_window_s,
                slow_window_s=obs.slo_slow_window_s,
                burn_threshold=obs.slo_burn_threshold,
                events=self.events, metrics=self.metrics, **series)

        for name in self._runtimes:
            if obs.slo_target_ms > 0:
                monitor(name, obs.slo_target_ms, obs.slo_objective)
                # One monitor per tier too: tier 0 holding while tier 2
                # burns must not average into one number.
                if self.cfg.overload.tiers > 1:
                    for t in range(self.cfg.overload.tiers):
                        monitor(f"{name}@t{t}", obs.slo_target_ms,
                                obs.slo_objective)
        for name in self._runtimes:
            if obs.quality_slo_target > 0:
                monitor(f"{name}#quality", obs.quality_slo_target,
                        obs.quality_slo_objective,
                        good_key=f"quality_good[{name}]",
                        total_key=f"quality_total[{name}]", kind="quality")
        if obs.snapshot_interval_s > 0:
            self._telemetry_task = asyncio.create_task(self._telemetry_loop())
        elif self._slo_monitors:
            # The monitors evaluate on telemetry ticks only.
            log.warning(
                "slo_target_ms is set but snapshot_interval_s=0 disables "
                "the telemetry sampler — SLO burn monitors will never "
                "evaluate (call sample_telemetry() manually, or set an "
                "interval)")
        if self.cfg.metrics_port:
            from matchmaking_tpu_torch.service.observability import (
                ObservabilityServer,
            )

            self._observability = ObservabilityServer(
                self, host=self.cfg.metrics_host, port=self.cfg.metrics_port)
            await self._observability.start()

    async def stop(self) -> None:
        await self._stop_telemetry()
        await self._stop_observability()
        for rt in self._runtimes.values():
            await rt.stop()
        self._close_owned_net_hub()

    def _close_owned_net_hub(self) -> None:
        """Close a socket fabric this app built from ``cfg.net`` (its
        sockets and IO tasks end with the host); a hub passed in is left
        alone."""
        hub = self.replication_hub
        if self._owns_net_hub and hub is not None:
            try:
                hub.close()
            except Exception:
                log.exception("socket replication hub close failed")
            self.replication_hub = None
            self._owns_net_hub = False

    async def crash(self) -> None:
        """A hard crash, for tests and the smoke: no drain, no checkpoint,
        no clean marker; windows in flight and answers waiting for their
        commit are dropped and the broker's consumers die. A successor on
        the same ``journal_dir`` must recover what is on disk. Without an
        HTTP server it never yields: one ``send(None)`` runs it to its
        end."""
        self._cancel_telemetry()
        await self._stop_observability()
        for rt in self._runtimes.values():
            rt.abandon()
        self.broker.close()
        self._close_owned_net_hub()

    async def drain(self, checkpoint_dir: str | None = None) -> dict[str, int]:
        """The graceful drain (SIGTERM, see ``serve``): admission stops on
        every queue first (late arrivals are shed with a retry-after),
        every queue stops (its last windows answered and acked, its
        journal marked clean), then, with a directory (default
        ``OverloadConfig.drain_checkpoint_dir``), each queue's waiting
        pool is saved there with the ``_admission.json`` sidecar and the
        ``_backlog.json`` of the deliveries no consumer took. Returns the
        players saved per queue ({} without a directory)."""
        directory = (checkpoint_dir if checkpoint_dir is not None
                     else self.cfg.overload.drain_checkpoint_dir)
        await self._stop_telemetry()
        self.events.append("drain_begin", "",
                           f"checkpoint={'on' if directory else 'off'}")
        for rt in self._runtimes.values():
            if rt.admission is not None:
                rt.admission.begin_drain()
        for rt in self._runtimes.values():
            await rt.stop()
        counts: dict[str, int] = {}
        if directory:
            counts = await self.save_checkpoint(directory)
            adm = {name: rt.admission.checkpoint()
                   for name, rt in self._runtimes.items()
                   if rt.admission is not None}
            if adm:
                checkpoint.save_admission(
                    os.path.join(directory, "_admission.json"), adm)
            backlog = {name: self.broker.drain_backlog(name)
                       for name in self._runtimes}
            backlog = {k: v for k, v in backlog.items() if v}
            n = checkpoint.save_backlog(
                os.path.join(directory, "_backlog.json"), backlog)
            if n:
                self.events.append(
                    "backlog_checkpointed", "",
                    f"{n} unconsumed deliveries across "
                    f"{len(backlog)} queue(s)")
                log.info("drain: %d unconsumed deliveries checkpointed", n)
        self.events.append(
            "drain_complete", "",
            f"{sum(counts.values())} waiting players checkpointed"
            if directory else "no checkpoint directory")
        # Only now: /healthz says "draining" for the whole drain.
        await self._stop_observability()
        self.broker.close()
        self._close_owned_net_hub()
        return counts

    # ---- telemetry (utils/timeseries.py) and the HTTP server ------------

    def sample_telemetry(self, now: float | None = None) -> dict[str, float]:
        """Take one telemetry snapshot into the ring and run the SLO burn
        monitors. ``_telemetry_loop`` calls it every
        ``snapshot_interval_s``; tests call it with explicit ``now``
        values. Reads host state only (pool sizes, gauges, monotone
        counters, ``util_report`` and ``spec_report``: no device read)."""
        now = time.time() if now is None else now
        prev = self.telemetry.latest()
        prev_vals = prev["values"] if prev is not None else {}
        vals: dict[str, float] = {
            "players_matched": self.metrics.counters.get("players_matched"),
        }
        gauges = self.metrics.gauges
        tiers = self.cfg.overload.tiers
        for name, rt in self._runtimes.items():
            vals[f"pool_size[{name}]"] = float(rt.engine.pool_size())
            for gauge in ("batch_fill", "breaker_state"):
                g = gauges.get(f"{gauge}[{name}]")
                if g is not None:
                    vals[f"{gauge}[{name}]"] = g
            adm = rt.admission
            if adm is not None:
                vals[f"shed_total[{name}]"] = float(adm.shed_total)
                vals[f"expired_total[{name}]"] = float(adm.expired_total)
                if adm.tiers > 1:
                    for t in range(adm.tiers):
                        vals[f"shed_total[{name}@t{t}]"] = float(
                            adm.shed_by_tier[t])
                        vals[f"expired_total[{name}@t{t}]"] = float(
                            adm.expired_by_tier[t])
            hist = self.metrics.stages.get(name, {}).get("total")
            if hist is not None and hist.count:
                vals[f"stage_total_p99_ms[{name}]"] = round(
                    hist.percentile(99) * 1e3, 3)
            totals = self.attribution.queue_totals(name)
            vals[f"work_s[{name}]"] = round(totals["work_s"], 6)
            vals[f"wait_s[{name}]"] = round(totals["wait_s"], 6)
            good, total = self.attribution.slo_counts(name)
            vals[f"slo_good[{name}]"] = float(good)
            vals[f"slo_total[{name}]"] = float(total)
            if self.cfg.observability.quality_slo_target > 0:
                qg, qt = self.quality.slo_counts(name)
                vals[f"quality_good[{name}]"] = float(qg)
                vals[f"quality_total[{name}]"] = float(qt)
            if tiers > 1:
                for t in range(tiers):
                    tg, tt = self.attribution.slo_counts_tier(name, t)
                    vals[f"slo_good[{name}@t{t}]"] = float(tg)
                    vals[f"slo_total[{name}@t{t}]"] = float(tt)
            if hasattr(rt.engine, "util_report"):
                u = rt.engine.util_report()
                vals[f"device_busy_s[{name}]"] = u["device_busy_s"]
                vals[f"device_idle_s[{name}]"] = u["device_idle_s"]
                vals[f"effective_occupancy[{name}]"] = (
                    u["effective_occupancy"])
                # Idle fraction over the interval since the last snapshot;
                # a negative delta means a revive or breaker swap reset the
                # counters, and then the new engine's lifetime fraction.
                db = u["device_busy_s"] - prev_vals.get(
                    f"device_busy_s[{name}]", 0.0)
                di = u["device_idle_s"] - prev_vals.get(
                    f"device_idle_s[{name}]", 0.0)
                vals[f"idle_frac[{name}]"] = (
                    round(di / (db + di), 6)
                    if db >= 0.0 and di >= 0.0 and db + di > 0
                    else u["idle_fraction"])
                vals[f"spec_commit_share[{name}]"] = u.get(
                    "spec_commit_share", 0.0)
            sr = rt.engine.spec_report()
            if sr is not None:
                for k in ("spec_hit", "spec_miss", "spec_wasted"):
                    vals[f"{k}[{name}]"] = float(sr[k])
                vals[f"spec_hit_rate[{name}]"] = sr["spec_hit_rate"]
        self.telemetry.append(now, vals)
        for mon in self._slo_monitors.values():
            mon.evaluate(self.telemetry, now)
        return vals

    async def _telemetry_loop(self) -> None:
        """The sampler: a failed tick is logged and counted
        (``telemetry_errors``), and the next one runs."""
        interval = self.cfg.observability.snapshot_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                self.sample_telemetry()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("telemetry snapshot failed; retrying")
                self.metrics.counters.inc("telemetry_errors")

    def _cancel_telemetry(self) -> asyncio.Task | None:
        task, self._telemetry_task = self._telemetry_task, None
        if task is not None:
            task.cancel()
        return task

    async def _stop_telemetry(self) -> None:
        task = self._cancel_telemetry()
        if task is not None:
            await asyncio.gather(task, return_exceptions=True)

    async def _stop_observability(self) -> None:
        server, self._observability = self._observability, None
        if server is not None:
            await server.stop()

    async def save_checkpoint(self, directory: str) -> dict[str, int]:
        """Write every queue's waiting pool to ``directory``, one
        ``<queue>.npz`` each, with its windows in flight collected first.
        Returns the players saved per queue."""
        os.makedirs(directory, exist_ok=True)
        counts: dict[str, int] = {}
        for name, rt in self._runtimes.items():
            async with rt._pool_lock:
                rt._drain_engine(time.time())
                counts[name] = checkpoint.save_pool(
                    rt.engine, os.path.join(directory, f"{name}.npz"),
                    queue_name=name)
        return counts

    async def restore_checkpoint(self, directory: str,
                                 now: float | None = None) -> dict[str, int]:
        """Re-admit the pools saved in ``directory`` without matching (a
        queue without a file is skipped; one whose file does not read
        starts empty, with a warning), restore the admission sidecar, and
        re-publish the backlog sidecar's deliveries to their queues.
        Returns the players restored per queue."""
        counts: dict[str, int] = {}
        for name, rt in self._runtimes.items():
            path = os.path.join(directory, f"{name}.npz")
            if not os.path.exists(path):
                continue
            async with rt._pool_lock:
                rt._drain_engine(time.time() if now is None else now)
                try:
                    counts[name] = checkpoint.load_pool(rt.engine, path, now)
                except Exception as e:
                    self.events.append(
                        "checkpoint_corrupt", name,
                        f"{os.path.basename(path)}: {e} — starting empty")
                    log.warning("pool checkpoint %s unreadable (%s); queue "
                                "%r starts empty", path, e, name)
        adm_path = os.path.join(directory, "_admission.json")
        if os.path.exists(adm_path):
            try:
                restored = checkpoint.load_admission(adm_path)
            except Exception as e:
                restored = {}
                self.events.append("checkpoint_corrupt", "",
                                   f"_admission.json: {e} — skipped")
                log.warning("admission sidecar %s unreadable: %s",
                            adm_path, e)
            for qname, state in restored.items():
                rt = self._runtimes.get(qname)
                if rt is not None and rt.admission is not None:
                    rt.admission.restore_state(state)
        backlog_path = os.path.join(directory, "_backlog.json")
        if os.path.exists(backlog_path):
            try:
                per_queue = checkpoint.load_backlog(backlog_path)
            except Exception as e:
                per_queue = {}
                self.events.append("checkpoint_corrupt", "",
                                   f"_backlog.json: {e} — skipped")
                log.warning("backlog sidecar %s unreadable: %s",
                            backlog_path, e)
            republished = 0
            for qname, rows in per_queue.items():
                for row in rows:
                    self.broker.publish(
                        qname, row["body"],
                        Properties(reply_to=row["reply_to"],
                                   correlation_id=row["correlation_id"],
                                   headers=dict(row["headers"])))
                    republished += 1
            if republished:
                self.events.append(
                    "backlog_restored", "",
                    f"{republished} unconsumed deliveries re-published "
                    f"from drain checkpoint")
        return counts

    def runtime(self, queue_name: str) -> _QueueRuntime:
        return self._runtimes[queue_name]

    @property
    def engine(self):
        return self._first.engine

    @property
    def counters(self) -> dict[str, int]:
        return self._first.counters

    @property
    def queue_cfg(self) -> QueueConfig:
        return self._first.queue_cfg

    def faults(self) -> dict[str, object]:
        """The failures the app caught and recovered from, over every
        queue: each nonzero fault counter summed, and each parked device
        error under ``device_error`` by queue name. Empty when every
        window, collection and tick ran clean."""
        out: dict[str, object] = {}
        errors = {}
        for name, rt in self._runtimes.items():
            for k, v in rt.faults().items():
                if k == "device_error":
                    errors[name] = v
                else:
                    out[k] = out.get(k, 0) + v
        if errors:
            out["device_error"] = errors
        return out

    def restore(self, requests: Sequence[SearchRequest], now: float,
                queue: str | None = None) -> None:
        """Re-admit waiting players of ``queue`` (default: the first)
        without matching (the object path's checkpoint, an engine's
        ``waiting()``)."""
        self._queue(queue).restore(requests, now)

    def restore_columns(self, cols: RequestColumns, regions, modes,
                        now: float, queue: str | None = None) -> None:
        """Re-admit waiting players of ``queue`` (default: the first)
        without matching — a checkpoint such as an engine's
        ``waiting_columns()``: ``cols`` with each row's region and mode
        given by name in ``regions`` / ``modes`` (the codes in ``cols``
        are ignored)."""
        self._queue(queue).restore_columns(cols, regions, modes, now)

    def _queue(self, name: str | None) -> _QueueRuntime:
        return self._first if name is None else self._runtimes[name]


async def run_demo(device=None, players: int = 10,
                   cfg: Config | None = None) -> list[SearchResponse]:
    """Spin the app (``cfg``, or a small one-queue config), submit
    ``players`` players to each of its queues, return their answers (in
    queue order). A role queue's players take its role slots in turn.
    Raises if the app caught a failure on the way (``faults()``)."""
    if cfg is None:
        cfg = Config(engine=EngineConfig(backend="gpu", pool_capacity=1024,
                                         pool_block=256, batch_buckets=(16, 64),
                                         warm_start=True))
    app = MatchmakingApp(cfg, device=device)
    await app.start()
    try:
        client = MatchmakingClient(app.broker, cfg.broker.request_queue)
        searches = []
        for q in cfg.queues:
            prefix = "" if len(cfg.queues) == 1 else f"{q.name}:"
            for i in range(players):
                player = {"id": f"{prefix}p{i}", "rating": 1500 + (i % 7) * 12}
                if q.role_slots:
                    player["roles"] = [q.role_slots[i % len(q.role_slots)]]
                searches.append(client.search_until_matched(
                    player, queue=q.name, timeout=10.0))
        answers = list(await asyncio.gather(*searches))
    finally:
        await app.stop()
    if app.faults():
        raise RuntimeError(f"the demo's service caught failures: "
                           f"{app.faults()}")
    return answers


async def serve(stop: asyncio.Event | None = None, device=None) -> None:
    """The service's entry point: the config from the ``MM_*`` variables
    (``Config.from_env``), on the in-process broker, until SIGTERM or
    SIGINT (or until ``stop`` is set). With ``MM_METRICS_PORT`` the app
    serves ``/healthz``, ``/metrics`` and ``/debug/*`` there (on
    ``MM_METRICS_HOST``, default 127.0.0.1). With
    ``MM_OVERLOAD_DRAIN_CHECKPOINT_DIR`` the start restores what a
    predecessor's drain saved there, and the shutdown is a drain into it
    (``/healthz`` answers ``draining`` until it completes);
    with ``MM_DURABILITY_JOURNAL_DIR`` a crashed predecessor's journal is
    recovered at start; with ``MM_REPLICATION_ROLE=primary`` and
    ``MM_NET_TRANSPORT=socket`` each queue streams its journal to
    ``MM_NET_REPL_TARGET`` under a lease held at ``MM_NET_LEASE_ADDR``.
    An ``amqp://`` broker URL is refused: the AMQP transport
    (``service/amqp_transport.py``) is not carried by the port."""
    import signal

    cfg = Config.from_env()
    if cfg.broker.url.startswith(("amqp://", "amqps://")):
        raise ValueError(
            f"broker url {cfg.broker.url!r} needs the AMQP transport "
            f"(service/amqp_transport.py), which the port does not carry; "
            f"serve on the in-process broker")
    app = MatchmakingApp(cfg, device=device)
    await app.start()
    drain_dir = cfg.overload.drain_checkpoint_dir
    if drain_dir and os.path.isdir(drain_dir):
        restored = await app.restore_checkpoint(drain_dir)
        if restored:
            log.info("restored %d waiting players from %s",
                     sum(restored.values()), drain_dir)
    if stop is None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        if drain_dir:
            await app.drain(drain_dir)
        else:
            await app.stop()


def _main(argv: Sequence[str]) -> int:
    device = argv[argv.index("--device") + 1] if "--device" in argv else None
    if "serve" in argv:
        asyncio.run(serve(device=device))
        return 0
    if "--demo" not in argv:
        print("usage: python -m matchmaking_tpu_torch.service.app "
              "(serve | --demo [--config PATH]) [--device cpu|cuda]")
        return 2
    cfg = (Config.from_json(argv[argv.index("--config") + 1], backend="gpu")
           if "--config" in argv else None)
    for resp in asyncio.run(run_demo(device, cfg=cfg)):
        # The id TAIL: the head is the per-process prefix shared by all.
        match_id = resp.match.match_id[-8:] if resp.match else "-"
        print(f"{resp.player_id}: {resp.status} match={match_id}")
    return 0


if __name__ == "__main__":
    import sys

    logging.basicConfig(level=logging.INFO)
    sys.exit(_main(sys.argv[1:]))
