"""The GPU engine: batched window matching over a device-resident pool.

Port of ``matchmaking_tpu/engine/tpu.py``'s single-card ``TpuEngine``: the
pipelined window API (object and columnar), the rescan tick, the expiry
sweeps and the mirror restores. A window of requests is admitted into the
device pool and matched by one window step: for 1v1 queues
engine/kernels.py, whose candidate stage is the hand-written
``block_best`` kernel on the card; for team queues (config #3)
engine/teams.py, for role queues (config #5) engine/role_kernels.py.

Team and role queues speak the object API only (``search_async`` /
``search``). Their device steps group players by exact region/mode code
and pack solo players only, so the first request with a wildcard region
or mode (or, on a role queue, a party) hands the whole queue to the host
oracle (engine/cpu.py ``CpuEngine``) with every waiting player; once no
such request has arrived for ``TEAM_REPROMOTE_QUIET_S`` and none waits,
the queue moves back onto the card (``team_delegated`` /
``team_repromoted`` in ``counters``).

Host/device split:

- Host (this class): slot allocation and the request mirror (= the
  checkpoint), padding windows to batch buckets, mapping matched slot pairs
  back to requests. No internal locks: one caller at a time drives every
  public method (the service calls them from its event loop only).
- Device: the pool tensors, updated in place, and the window step. On
  the card each step variant runs as one CUDA graph per batch bucket
  (engine/graphs.py ``StepGraphs``), the counterpart of the JAX package's
  jitted step set: a window chunk is one copy of its packed rows into the
  graph's static input, one replay, and one copy of its static output.
  The step reads the window's time on the device (the packed ``now``
  row). Graphs are captured on first use or by ``warmup()``, and dropped
  whenever the device pool is replaced (a team or role queue handed to
  the host oracle parks its pool and clears it on its return, so its
  graphs stay valid). On the CPU the steps run eagerly.

Pipelining. ``search_async`` / ``search_columns_async`` / ``rescan_async``
queue a window's work and return a token without waiting; the results come
back through ``collect_ready`` (non-blocking, FIFO) or ``flush``
(blocking), under the same token. Windows chain on the device in stream
order, because every step updates the one pool in place on the current
stream, so a later window never sees a player an earlier one matched. The
host mirror lags: slots are released at finalize, and never reallocated in
between (the free list only shrinks until then).

The asynchrony is PyTorch's, kept free of implicit host syncs:

- each window chunk is packed into a pinned host buffer and copied to the
  card with ``non_blocking=True`` (a pageable copy would wait for the
  stream, and so for the previous window's step);
- each result is copied into a pinned host buffer with ``non_blocking=True``
  and a CUDA event is recorded behind the copy; ``collect_ready`` asks the
  event (``query``, which never blocks) and reads the buffer only after
  ``synchronize`` on it — before that the buffer holds stale bytes;
- device errors surface at that ``synchronize`` (or at a later launch):
  the window is then reported as queued (the mirror still holds its
  players), its token lands in ``failed_tokens`` and the error in
  ``device_error``.

Bucketed formation (``EngineConfig.bucketed``, 1v1 queues). The device
pool carries the bucket index (``kernels.INDEX_FIELDS``): every traffic
and rescan step, restore and eviction keeps its counts exact and its
bounds wide enough, so each window scores only its chunks' spans of
blocks, with no O(P) pass; ``heartbeat`` re-tightens the bounds with one
exact scan (the service's health timer calls it under zero traffic too).
The mirror counts the waiting players per block (``PlayerPool``
segments); the steps return a fourth row, the pool slots each lane
scored, which ``formation_report()`` sums.

Speculative formation (``EngineConfig.spec_formation``, 1v1 queues).
``speculate`` copies the live pool into a spare pool of the same geometry
(allocated once) and runs up to ``spec_max_steps`` passes of the rescan
step over the longest-waiting players there (on the card, replays of a
graph captured against the spare pool), holding the results off the
books. Every operation that changes the pool advances ``pool_mutations``
and discards it; ``spec_validate`` checks that the clock has not moved
(and the age), and ``spec_commit`` copies the spare pool back into the
live pool in place, folds the held results into the quality state and
submits them as one rescan window. A committed speculation is the rescan
ticks a cold ``rescan_async`` at its time would run, bit for bit; a
discarded one leaves the live pool untouched.

Match quality. A 1v1 queue folds every window step's matches into a
device-resident quality state (``kernels.QualityAccumKernel``: one
``quality_accum`` launch behind each step, on the same stream). Every
``quality_report_every`` finalized windows ``_finalize`` queues one copy of
that state into pinned memory behind a CUDA event and a later finalize
takes it once the event has fired, so the report never blocks; ``flush()``
reads it at once. Team and role matches, and the host oracle's while a
queue is delegated, go to a ``HostQualityAccum``. ``quality_report()``
merges them.

The circuit breaker (service/breaker.py). ``probe()`` is its half-open
probe: one all-padding window of the smallest bucket through the traffic
step (on the card, one replay of its graph), then a device synchronize,
so that a failing card raises there; it changes no pool, index or quality
state. ``close()`` releases the device state when the service replaces
the engine. ``chaos_hook`` (utils/chaos.py, set by the service) is asked
before each search step is dispatched, before any state of the chunk is
touched, so a scripted failure leaves the mirror and the device pool as
they were.

Trace marks. Every window records host wall-clock stage marks
(``time.time()``, no device read) at the JAX engine's program points and
in its order: "dispatch" when it is accepted; per chunk "h2d" once its
input copy is queued and "device_step" ("formation_bucketed" for a
bucketed step) once its step is queued; "readback_seal" once every
result copy is queued; "collect" at its finalize. A delegated window is
"dispatch", "oracle_step"; a committed speculation starts with
"spec_snapshot", "spec_commit"; a rescan tick has only the last two. The
marks wait in ``window_marks[token]`` (at most 512, oldest dropped first)
for the service to merge into the window's traces. ``events`` (the
service's event log, or None) gets ``team_delegated`` and
``team_repromoted``.

Runs on ``device`` (default ``"cuda"``, which must exist); ``device="cpu"``
runs the plain PyTorch versions of the kernels synchronously: every result
is ready as soon as it is dispatched, and no pinned memory is used.
"""

from __future__ import annotations

import collections
import functools
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from matchmaking_tpu_torch.config import Config, QueueConfig
from matchmaking_tpu_torch.core.pool import (
    PACKED_ROWS,
    BatchArrays,
    PlayerPool,
    band_edges_from_spec,
    pack_batch,
)
from matchmaking_tpu_torch.engine import kernels, scoring
from matchmaking_tpu_torch.engine.cpu import CpuEngine
from matchmaking_tpu_torch.engine.graphs import StepGraphs, uncounted
from matchmaking_tpu_torch.engine.interface import (
    ColumnarOutcome,
    Engine,
    Match,
    SearchOutcome,
    empty_columnar_outcome,
)
from matchmaking_tpu_torch.engine.quality import (
    HostQualityAccum,
    QualitySpec,
    add_arrays,
    build_report,
    empty_arrays,
)
from matchmaking_tpu_torch.engine.role_kernels import role_kernel_set
from matchmaking_tpu_torch.engine.teams import team_kernel_set
from matchmaking_tpu_torch.service.contract import (
    RequestColumns,
    SearchRequest,
    is_wildcard,
    new_match_id,
    new_match_ids,
)

log = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means the card. A CUDA device
    on a machine without CUDA raises instead of running elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "GpuEngine needs a CUDA device and torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


class _Readback:
    """One result on its way to the host. For a CUDA tensor: a pinned host
    buffer filled by a non-blocking copy, and the event recorded on the
    stream behind it. For a CPU tensor (everything ran synchronously): the
    tensor itself."""

    __slots__ = ("host", "event")

    def __init__(self, out: torch.Tensor):
        if out.device.type == "cuda":
            self.host = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(out.device))
        else:
            self.host, self.event = out, None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()  # raises a device error, if any
        return self.host.numpy()


@dataclass
class _Speculation:
    """A speculation held off the books: the spare pool holds its result,
    and the live pool is untouched until ``spec_commit``."""

    #: ``pool_mutations`` when it was taken: it commits only while the
    #: clock still reads this.
    basis_seq: int
    #: The time every pass ran at.
    spec_now: float
    #: ``time.time()`` when it was taken (a commit's "spec_snapshot" mark).
    wall_t: float
    #: ``now`` as the steps read it (f32[1] on the pool's device), for the
    #: quality fold at commit.
    now_dev: torch.Tensor
    #: ``_Pending``-shaped chunks: ((cols, slots), readback, spec_now).
    chunks: list[tuple[Any, Any, float]] = field(default_factory=list)
    #: Each chunk's result on the device (a copy taken right after its
    #: step), for the quality fold at commit.
    outs: list[torch.Tensor] = field(default_factory=list)
    #: Pinned staging buffers of its host→device copies.
    staging: list[torch.Tensor] = field(default_factory=list)
    steps: int = 0
    lanes_valid: int = 0
    lanes_padded: int = 0


@dataclass
class _Pending:
    """One dispatched-but-uncollected window."""

    token: int
    #: Per device chunk: (payload, result, now). The payload is the request
    #: list (object path) or (RequestColumns, slots) (columnar path); the
    #: result is the ``_Readback`` queued behind the chunk's step.
    chunks: list[tuple[Any, Any, float]] = field(default_factory=list)
    #: perf_counter at dispatch, for the turnaround span.
    created: float = 0.0
    #: Object path: the outcome, with dispatch-time rejections.
    outcome: SearchOutcome = field(default_factory=SearchOutcome)
    #: Columnar path: the outcome (set instead of ``outcome``).
    columnar: ColumnarOutcome | None = None
    #: Host results per chunk, filled by ``_fetch``.
    raw: list[np.ndarray] | None = None
    #: A device failure met by ``_fetch``, parked for ``_finalize``.
    error: Exception | None = None
    #: perf_counter when the result copies were queued (the readback span
    #: runs from here to the collection).
    queued_readback: float = 0.0
    #: Pinned staging buffers of the window's host→device copies, held
    #: until its results are read (the copies have run by then).
    staging: list[torch.Tensor] = field(default_factory=list)
    #: The window's trace marks, (stage, time.time()) in time order; they
    #: move to ``GpuEngine.window_marks`` at finalize.
    marks: list[tuple[str, float]] = field(default_factory=list)


class GpuEngine(Engine):
    #: Seconds (in the callers' ``now``) a delegated team/role queue must
    #: go without a device-blocking arrival, with none left waiting,
    #: before it moves back onto the card: bounds the promote/demote thrash
    #: of alternating traffic (each move rebuilds the pool).
    TEAM_REPROMOTE_QUIET_S = 5.0

    def __init__(self, cfg: Config, queue: QueueConfig, device=None):
        super().__init__(cfg, queue)
        self.device = resolve_device(device)
        #: Host buffers are pinned for the card only (pinning needs CUDA).
        self._pinned = self.device.type == "cuda"
        ec = cfg.engine
        if ec.bucket_frontier_k > 0:
            raise ValueError("the sharded bucket frontier (bucket_frontier_k "
                             "> 0) is not supported by GpuEngine; bucketed "
                             "formation on one device is")
        #: Team-family queues: role queues (config #5) run the solo role
        #: step, plain team queues (config #3) the team step.
        self._role_device = queue.team_size > 1 and bool(queue.role_slots)
        self._team_device = queue.team_size > 1
        #: Bucketed formation: 1v1 queues only (team and role steps form
        #: windows pool-wide).
        self._bucketed = bool(ec.bucketed) and not self._team_device
        if self._role_device:
            self.kernels = role_kernel_set(
                capacity=ec.pool_capacity, team_size=queue.team_size,
                role_slots=tuple(queue.role_slots),
                widen_per_sec=queue.widen_per_sec,
                max_threshold=queue.max_threshold,
                max_matches=ec.team_max_matches, rounds=ec.team_rounds)
        elif self._team_device:
            self.kernels = team_kernel_set(
                capacity=ec.pool_capacity, team_size=queue.team_size,
                widen_per_sec=queue.widen_per_sec,
                max_threshold=queue.max_threshold,
                max_matches=ec.team_max_matches, rounds=ec.team_rounds)
        elif queue.role_slots:
            raise ValueError("role_slots need team_size > 1")
        else:
            self.kernels = kernels.KernelSet(
                capacity=ec.pool_capacity,
                top_k=ec.top_k,
                pool_block=min(ec.pool_block, ec.pool_capacity),
                glicko2=queue.glicko2,
                widen_per_sec=queue.widen_per_sec,
                max_threshold=queue.max_threshold,
                pair_rounds=ec.pair_rounds,
                prune_window_blocks=ec.prune_window_blocks,
                prune_chunk=ec.prune_chunk,
                bucketed=self._bucketed,
            )
        #: Rating bands of the slot allocator, one per pool block of a 1v1
        #: queue (``band_spec``; None: off). They keep each block's live
        #: rating interval narrow, which the pruned step needs.
        self._band_edges = band_edges_from_spec(
            ec.band_spec, 0 if self._team_device else self.kernels.n_blocks)
        #: The mirror's segments: one per device block of a bucketed queue
        #: (its bucket occupancy), else none.
        self._segments = self.kernels.n_blocks if self._bucketed else 0
        self.pool = self._new_pool()
        #: Bucketed formation: pool slots the steps scored and the flat
        #: step's equivalent, summed at finalize from result row 3.
        self.formation = {"touched_slots": 0.0, "total_slots": 0.0,
                          "windows": 0}
        #: Speculation: the validation clock (advanced by every operation
        #: that changes the pool), the held speculation, the clock value
        #: ``spec_validate`` last stamped, and the spare pool (made at the
        #: first speculation).
        self.pool_mutations = 0
        self._spec: _Speculation | None = None
        self._spec_validated_seq: int | None = None
        self._spec_pool: kernels.DevicePool | None = None
        #: The captured window steps (the card only; None on the CPU).
        self._graphs = (StepGraphs(self.kernels, self.device)
                        if self.device.type == "cuda" else None)
        self.dev_pool = self._fresh_device_pool()
        #: A delegated team/role queue's device pool, kept for its return.
        self._parked_pool: kernels.DevicePool | None = None
        #: The host oracle while a team/role queue is delegated (else None).
        self._team_delegate: CpuEngine | None = None
        #: ``now`` of the last device-blocking arrival while delegated.
        self._delegate_last_wc = float("-inf")
        #: Windows finalized out of turn (in flight when the queue was
        #: delegated), returned first by the next collect_ready()/flush().
        self._done_early: list[tuple[int, SearchOutcome]] = []
        #: Lifecycle counters: team_delegated / team_repromoted.
        self.counters: dict[str, int] = {}
        self.buckets = tuple(sorted(ec.batch_buckets))
        # Device times are f32, so every device-visible time is relative to
        # the first timestamp this engine sees.
        self._t0: float | None = None
        # The pipeline: dispatched, not yet finalized windows (FIFO).
        self._open = 0
        self._pending: collections.deque[_Pending] = collections.deque()
        self._next_token = 0
        if ec.readback_group > 1:
            # The JAX package stacks k windows' results into one transfer to
            # save a per-copy cost of its device link; a copy here is one
            # non-blocking pinned f32[3, B] copy, and no measurement shows a
            # per-copy cost that grouping would remove.
            raise ValueError("readback_group > 1 is not supported by "
                             "GpuEngine: each window is read back by itself")
        #: First device failure since the last check; pipelined callers
        #: read it after collect_ready()/flush(), sync search() raises it.
        self.device_error: Exception | None = None
        #: Tokens whose window failed on the device (reported as queued:
        #: the mirror still holds them). Callers discard what they consume.
        self.failed_tokens: set[int] = set()
        #: Tokens of in-flight rescan windows, so a shared collector can
        #: route them apart from delivery-backed windows. Callers discard.
        self.rescan_tokens: set[int] = set()
        #: Token → the finalized window's trace marks; the service pops
        #: them. At most 512 kept (oldest dropped first).
        self.window_marks: dict[int, list[tuple[str, float]]] = {}
        #: The service's event log (utils/trace.EventLog), or None.
        self.events = None
        #: Chunks one rescan tick may queue ahead of traffic windows.
        self._rescan_chunk_cap = max(1, ec.pipeline_depth)
        #: Host stage spans: cumulative seconds and counts (span_report).
        self.spans = {
            "windows": 0, "requests": 0, "matches": 0,
            "dispatch_s": 0.0,   # search_*_async host time
            "turnaround_s": 0.0, # dispatch → finalized
            "dedupe_s": 0.0, "alloc_s": 0.0, "pack_s": 0.0,
            "h2d_s": 0.0, "step_s": 0.0, "finalize_s": 0.0,
        }
        #: Device-utilization counters: busy while >= 1 window is
        #: dispatched but not finalized, idle otherwise, accrued at the
        #: 0 ↔ 1 transitions of the open count.
        self.util = {"busy_s": 0.0, "idle_s": 0.0, "readback_s": 0.0,
                     "lanes_valid": 0, "lanes_padded": 0}
        self._util_mark = time.perf_counter()
        #: Match-quality accounting: the device accumulator of 1v1 queues
        #: (None for team and role queues, whose matches go to the host
        #: accumulator at finalize) and its state on the card.
        self._q_spec = QualitySpec.from_config(cfg.observability)
        self._quality: kernels.QualityAccumKernel | None = None
        self._q_dev: kernels.QualityState | None = None
        if not self._team_device:
            self._quality = kernels.QualityAccumKernel(
                capacity=self.kernels.capacity,
                widen_per_sec=queue.widen_per_sec,
                max_threshold=queue.max_threshold,
                rating_edges=self._q_spec.rating_edges,
                n_quality=self._q_spec.n_quality,
                wait_edges=self._q_spec.wait_edges)
            self._q_dev = self._quality.init_state(self.device)
        self._q_host_accum = HostQualityAccum(self._q_spec)
        #: The last device state read back (numpy; what quality_report
        #: merges), and the copy in flight, if any.
        self._q_host: dict[str, np.ndarray] | None = None
        self._q_sync: _Readback | None = None
        self._q_sync_every = max(1, cfg.observability.quality_report_every)
        self._q_windows = 0
        #: Scripted faults (utils/chaos.py ``EngineChaosHook``; None: none),
        #: set by the service on every engine it builds for the queue.
        self.chaos_hook = None

    # ---- Engine API -------------------------------------------------------

    def search(self, requests: Sequence[SearchRequest], now: float) -> SearchOutcome:
        """Synchronous window: ``search_async`` + ``flush`` (a delegated
        team/role queue: the host oracle's ``search``)."""
        if self._team_delegate is not None:
            self._note_wildcards(requests, now)
            if not self._maybe_repromote_team(now):
                return self._team_delegate.search(requests, now)
        self._require_idle("search()")
        self.search_async(requests, now)
        out = SearchOutcome()
        # flush() returns the full outcome (dispatch-time rejections too).
        for tok, o in self.flush():
            self.failed_tokens.discard(tok)
            self.window_marks.pop(tok, None)  # a sync caller merges none
            out.matches.extend(o.matches)
            out.queued.extend(o.queued)
            out.rejected.extend(o.rejected)
        if self.device_error is not None:
            err, self.device_error = self.device_error, None
            raise err
        return out

    def remove(self, player_id: str) -> SearchRequest | None:
        if self._team_delegate is not None:
            return self._team_delegate.remove(player_id)
        self._require_idle("remove()")
        slot = self.pool.slot_of(player_id)
        if slot is None:
            return None
        req = self.pool.request_at(slot)
        self._release_and_evict(np.array([slot], np.int32))
        return req

    def remove_many(self, player_ids: Sequence[str]) -> list[SearchRequest]:
        """Evict the named waiting players (absent ids are skipped) with
        one mirror release and one device eviction, and return their
        requests in the order named. The mirror's free-slot order after it
        is what ``remove`` of each in turn leaves, so later windows
        allocate the same slots."""
        if self._team_delegate is not None:
            out = [self._team_delegate.remove(pid) for pid in player_ids]
            return [r for r in out if r is not None]
        self._require_idle("remove_many()")
        slots = np.fromiter(
            (s for s in (self.pool.slot_of(pid) for pid in player_ids)
             if s is not None), np.int32)
        if slots.size == 0:
            return []
        reqs = [self.pool.request_at(int(s)) for s in slots]
        self._release_and_evict(slots, in_order=True)
        return reqs

    def waiting_qos(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, tiers, enqueue times) of the waiting players in
        ``waiting()`` order, read from the mirror's columns: what the
        service's debt pick sorts, with no request object built."""
        if self._team_delegate is not None:
            return super().waiting_qos()
        slots = self.pool.waiting_slots()
        return (self.pool.m_id[slots], self.pool.m_tier[slots],
                self.pool.m_enqueued[slots])

    def expire(self, now: float, timeout: float) -> list[SearchRequest]:
        """Timeout sweep over the mirror (enqueue time 0.0 means unstamped
        and never expires): O(expired) request objects, one eviction."""
        if self._team_delegate is not None:
            out = self._team_delegate.expire(now, timeout)
            self._maybe_repromote_team(now)  # it may drain the last blocker
            return out
        self._require_idle("expire()")
        slots = self.pool.waiting_slots()
        if slots.size == 0:
            return []
        enq = self.pool.m_enqueued[slots]
        return self._expire_slots(slots[(enq != 0.0) & (now - enq > timeout)])

    def expire_deadlines(self, now: float) -> list[SearchRequest]:
        """Deadline sweep over the mirror's per-player ``x-deadline``
        column (0.0 = none): every waiter whose deadline has passed, exact
        to its own deadline. No matching work is spent on them: a host
        scan of the mirror, then one eviction."""
        if self._team_delegate is not None:
            out = self._team_delegate.expire_deadlines(now)
            self._maybe_repromote_team(now)
            return out
        self._require_idle("expire_deadlines()")
        slots = self.pool.waiting_slots()
        if slots.size == 0:
            return []
        dl = self.pool.m_deadline[slots]
        return self._expire_slots(slots[(dl != 0.0) & (now >= dl)])

    def pool_size(self) -> int:
        if self._team_delegate is not None:
            return self._team_delegate.pool_size()
        return len(self.pool)

    def deadline_count(self) -> int:
        if self._team_delegate is not None:
            return self._team_delegate.deadline_count()
        return self.pool.deadline_count()

    def pool_tier_counts(self, n_tiers: int) -> list[int]:
        """Waiting players per QoS tier: the mirror's counts, O(tiers)."""
        if self._team_delegate is not None:
            return self._team_delegate.pool_tier_counts(n_tiers)
        return self.pool.tier_counts(n_tiers)

    def waiting(self) -> list[SearchRequest]:
        if self._team_delegate is not None:
            return self._team_delegate.waiting()
        return self.pool.waiting()

    def waiting_columns(self) -> tuple[RequestColumns, np.ndarray, np.ndarray]:
        """The mirror as columns, with region and mode names (see
        ``PlayerPool.waiting_columns``): the revive payload that builds no
        request objects. 1v1 queues only (team and role queues carry roles
        and parties: use ``waiting()``)."""
        self._require_columnar("waiting_columns()")
        return self.pool.waiting_columns()

    def restore(self, requests: Sequence[SearchRequest], now: float) -> None:
        """Re-admit a checkpoint without matching (device state is a pure
        function of the mirror). A checkpoint with wildcards (or parties,
        on a role queue) hands a team/role queue to the host oracle."""
        if self._team_delegate is not None:
            self._note_wildcards(requests, now)
            self._team_delegate.restore(requests, now)
            return
        if self._maybe_delegate_team(requests, now):
            self._team_delegate.restore(requests, now)
            return
        fresh = [r for r in requests if r.id not in self.pool]
        if fresh:
            self._pool_mutated()
        top = self.buckets[-1]
        for start in range(0, len(fresh), top):
            chunk = fresh[start:start + top]
            slots = self.pool.allocate(chunk)
            self._admit(self.pool.batch_arrays(chunk, slots, top,
                                               self._rel_base(now)), chunk)

    def restore_columns(self, cols: RequestColumns, now: float) -> None:
        """Columnar restore: re-admit without matching. Dedupes against the
        pool and within the columns (a checkpoint replayed at least once
        may repeat a player). Queues the admissions with no host sync.
        1v1 queues only."""
        self._require_columnar("restore_columns()")
        waiting = self.pool._slot_of
        seen: set[str] = set()
        keep = np.empty(len(cols), bool)
        for j, pid in enumerate(cols.ids.tolist()):
            keep[j] = pid not in waiting and pid not in seen
            if keep[j]:
                seen.add(pid)
        if not keep.all():
            cols = cols.take(keep)
        if len(cols):
            self._pool_mutated()
        top = self.buckets[-1]
        t0 = self._rel_base(now)
        for start in range(0, len(cols), top):
            chunk = cols.slice(start, start + top)
            slots = self.pool.allocate_columns(chunk)
            self._admit(self.pool.batch_arrays_cols(chunk, slots, top, t0))

    def intern_columns(self, regions, modes) -> tuple[np.ndarray, np.ndarray]:
        """str sequences → int32 codes in this pool's interners."""
        rc, mc = self.pool.regions.code, self.pool.modes.code
        n = len(regions)
        return (np.fromiter((rc(r) for r in regions), np.int32, n),
                np.fromiter((mc(m) for m in modes), np.int32, n))

    def heartbeat(self, now: float) -> bool:
        """Health-timer tick: moves an idle delegated team/role queue back
        onto the card once its blockers drained (nothing else would notice
        under zero traffic); True when it did. A bucketed queue rebuilds
        its bucket index here (one exact O(P) pass, queued behind any
        window in flight): between rebuilds the bounds only widen, and a
        drifting rating distribution would otherwise push every window to
        the dense fallback."""
        if self._team_delegate is not None:
            return self._maybe_repromote_team(now)
        if self._bucketed and self.dev_pool is not None:
            self._pool_mutated()
            self.kernels.index_rebuild(self.dev_pool)
        return False

    def warmup(self) -> None:
        """Make every (step variant, bucket) ready, so that no
        first-of-its-kind window pays a first use: on the card, capture
        each one's CUDA graph (``StepGraphs``: what ``TpuEngine.warmup``'s
        compiles are to the JAX engine); on the CPU, run each bucket's
        all-padding window through every variant, read back as a window
        is. 1v1 steps run on the pool itself (nothing is admitted, matched
        or evicted); the team and role steps form matches pool-wide, so
        they run on a scratch pool. No warm-up counts as a pruned window
        (``prune_report``). A delegated queue has nothing to warm."""
        if self._team_delegate is not None:
            return
        self._require_idle("warmup()")
        self._pool_mutated()
        variants = self._variants()
        if self._speculates():
            variants += ("spec",)
        if self._graphs is not None:
            for bucket in self.buckets:
                for variant in variants:
                    self._step_graph(variant, bucket)
        else:
            with uncounted(self.kernels):
                for bucket in self.buckets:
                    batch = self.pool.batch_arrays([], [], bucket)
                    for variant in variants:
                        packed = self._stage(batch, 0.0).to(self.device,
                                                            non_blocking=True)
                        _Readback(self._step_fn(variant)(
                            self._pool_for(variant, warm=True),
                            packed)).numpy()
                    self._admit(batch)
            self._evict(np.empty(0, np.int32))
        # Finalize's numpy calls pay their first-use imports here (numpy
        # 2.3 imports numpy.ma on the first np.unique: ~50 ms where no
        # bytecode is cached). Nothing is freed.
        self.pool.release(np.empty(0, np.int32))
        np.isin(np.empty(0, np.int32), np.empty(0, np.int32))
        new_match_ids(1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def probe(self) -> None:
        """The breaker's half-open probe: the chaos hook's probe stream
        first, then one all-padding window of the smallest bucket through
        the base traffic step (on the card, one replay of its graph,
        captured now if this engine has not yet; ``block_best`` and
        ``quality_accum`` launch), then a device synchronize, so that a
        failed launch raises here. Nothing is admitted, matched or evicted:
        the pool, the bucket index and the quality state stay as they
        were, and the step counts in no ``prune_report``. A team or role
        step forms matches pool-wide, so it runs eagerly on a scratch
        pool."""
        if self.chaos_hook is not None:
            self.chaos_hook.on_probe()
        if self._team_delegate is not None:
            return  # the oracle serves the queue: nothing on the card
        variant = self._variants()[0]
        bucket = self.buckets[0]
        staging = self._stage(self.pool.batch_arrays([], [], bucket), 0.0)
        with uncounted(self.kernels):
            if self._graphs is not None and not self._team_device:
                g = self._step_graph(variant, bucket)
                g.static_in.copy_(staging, non_blocking=True)
                self._graphs.replay(g)
            else:
                self._step_fn(variant)(
                    self._pool_for(variant, warm=True),
                    staging.to(self.device, non_blocking=True))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Release the device state when the service replaces this engine:
        the captured graphs (and their private memory), the live, spare
        and parked device pools, the quality state and the windows still
        pending with their staging buffers. The engine is not used again;
        its host reports still read (the quality state as last read
        back)."""
        self._spec = None
        self._spec_validated_seq = None
        self._pending.clear()
        self._done_early = []
        self._open = 0
        self.dev_pool = None  # drops every graph
        self._spec_pool = None
        self._parked_pool = None
        self._quality = None
        self._q_dev = None
        self._q_sync = None

    # ---- pipelined window API ---------------------------------------------

    def inflight(self) -> int:
        """Windows dispatched but not yet finalized."""
        return self._open

    def search_async(self, requests: Sequence[SearchRequest],
                     now: float) -> tuple[int, SearchOutcome]:
        """Dispatch an object window without waiting. Returns (token,
        dispatch-time rejections); the full outcome arrives through
        collect_ready()/flush() under the same token.

        A delegated team/role queue answers the window on the host oracle
        at once (its outcome still arrives under the token). A window
        with a device-blocking request (``_device_blocker``) first hands
        the queue to the oracle."""
        if self._team_delegate is not None:
            self._note_wildcards(requests, now)
            if not self._maybe_repromote_team(now):
                t_disp = time.time()
                out = self._team_delegate.search(requests, now)
                pending = _Pending(token=self._next_token, outcome=out,
                                   raw=[])
                # The oracle ran the whole window inline: two marks bound it.
                pending.marks = [("dispatch", t_disp),
                                 ("oracle_step", time.time())]
                self._next_token += 1
                self._submit(pending)
                return pending.token, SearchOutcome()
        if self._maybe_delegate_team(requests, now):
            return self.search_async(requests, now)  # through the oracle
        t_start = time.perf_counter()
        pending = _Pending(token=self._next_token, created=t_start)
        pending.marks.append(("dispatch", time.time()))
        self._next_token += 1
        fresh: list[SearchRequest] = []
        seen: set[str] = set()
        for req in requests:
            if req.party_size > 1:
                pending.outcome.rejected.append((req, "party_not_supported"))
            elif req.id in self.pool or req.id in seen:
                continue  # idempotent redelivery (waiting, or twice here)
            else:
                seen.add(req.id)
                fresh.append(req)
        if fresh:
            self._pool_mutated()
        top = self.buckets[-1]
        for start in range(0, len(fresh), top):
            self._dispatch(fresh[start:start + top], now, pending)
        self._submit(pending)
        self.spans["requests"] += len(fresh)
        self.spans["dispatch_s"] += time.perf_counter() - t_start
        return pending.token, SearchOutcome(
            rejected=list(pending.outcome.rejected))

    def search_columns_async(self, cols: RequestColumns, now: float) -> int:
        """Dispatch a columnar 1v1 window (region/mode already interned
        with ``intern_columns``) without waiting; returns its token. The
        ColumnarOutcome, dispatch-time rejections included, arrives through
        collect_ready()/flush(). The only per-row Python is the id
        membership probe (redelivery dedupe). 1v1 queues only."""
        self._require_columnar("search_columns_async()")
        t_start = time.perf_counter()
        pending = _Pending(token=self._next_token, created=t_start)
        pending.marks.append(("dispatch", time.time()))
        pending.columnar = empty_columnar_outcome()
        self._next_token += 1
        ids = cols.ids.tolist()
        waiting = self.pool._slot_of
        _t = time.perf_counter()
        if len(set(ids)) == len(ids):  # common case: no duplicate in window
            keep = np.fromiter((i not in waiting for i in ids), bool, len(ids))
        else:
            local: set[str] = set()
            keep = np.empty(len(ids), bool)
            for j, pid in enumerate(ids):
                keep[j] = pid not in waiting and pid not in local
                if keep[j]:
                    local.add(pid)
        if not keep.all():
            cols = cols.take(keep)
        self.spans["dedupe_s"] += time.perf_counter() - _t
        if len(cols):
            self._pool_mutated()
        top = self.buckets[-1]
        for start in range(0, len(cols), top):
            self._dispatch_cols(cols.slice(start, start + top), now, pending)
        self._submit(pending)
        self.spans["requests"] += len(cols)
        self.spans["dispatch_s"] += time.perf_counter() - t_start
        return pending.token

    def rescan_async(self, max_window: int, now: float) -> int | None:
        """Re-submit the longest-waiting players as a window, so threshold
        widening can resolve between players already in the pool (matching
        is otherwise arrival-triggered). Returns a token, or None for an
        empty pool.

        Safe with windows in flight: the rescan step admits nothing and
        gates every lane on its slot's device-side ``active`` flag. A tick
        covers at most ``max_window`` players in at most ``pipeline_depth``
        chunks of the largest bucket, lowest (tier, deadline, enqueue time)
        first; the rest roll over to later ticks. The outcome's ``q_ids``
        are the unmatched rescanned players, not new arrivals: callers must
        not ack them as queued. The token lands in ``rescan_tokens``.

        Team/role queues rescan with ``_rescan_team``; a delegated one
        checks whether it can move back onto the card (the tick is also
        the idle queue's re-promotion heartbeat) and otherwise returns
        None: the oracle re-forms on arrival."""
        if self._team_delegate is not None:
            if not self._maybe_repromote_team(now):
                return None
        if self._team_device:
            tok = self._rescan_team(now)
            if tok is not None:
                self.rescan_tokens.add(tok)
            return tok
        top = self.buckets[-1]
        max_window = min(max_window, self._rescan_chunk_cap * top)
        pool = self.pool
        if len(pool) == 0:
            return None
        t_start = time.perf_counter()
        pending = _Pending(token=self._next_token, created=t_start)
        pending.columnar = empty_columnar_outcome()
        self._next_token += 1
        self._pool_mutated()
        variant = self._variants()[2]
        for payload, batch, bucket in self._rescan_chunks(max_window, now):
            self._chaos_step()
            out = self._launch(variant, batch, now, pending.staging)
            self.util["lanes_valid"] += int(payload[1].size)
            self.util["lanes_padded"] += bucket
            pending.chunks.append((payload, out, now))
        self._submit(pending)
        self.rescan_tokens.add(pending.token)
        return pending.token

    def _rescan_chunks(self, max_window: int, now: float):
        """A rescan tick's chunks (a speculation's too): at most
        ``max_window`` waiting players, lowest (tier, deadline, enqueue
        time) first, in slot order, cut into chunks of the largest bucket,
        each as ((cols, slots), padded batch, bucket)."""
        pool = self.pool
        slots_all = pool.waiting_slots()
        if slots_all.size > max_window:
            enq = pool.m_enqueued[slots_all]
            dl = pool.m_deadline[slots_all]
            order = np.lexsort((enq, np.where(dl > 0.0, dl, np.inf),
                                pool.m_tier[slots_all]))[:max_window]
            chosen = np.sort(slots_all[order]).astype(np.int32)
        else:
            chosen = np.sort(slots_all).astype(np.int32)
        t0 = self._rel_base(now)
        top = self.buckets[-1]
        out = []
        for start in range(0, chosen.size, top):
            slots = chosen[start:start + top]
            cols = RequestColumns(
                ids=pool.m_id[slots], rating=pool.m_rating[slots],
                rd=pool.m_rd[slots], region=pool.m_region[slots],
                mode=pool.m_mode[slots], threshold=pool.m_threshold[slots],
                enqueued_at=pool.m_enqueued[slots],
                reply_to=pool.m_reply[slots],
                correlation_id=pool.m_corr[slots])
            bucket = self._bucket_for(slots.size)
            out.append(((cols, slots),
                        pool.batch_arrays_cols(cols, slots, bucket, t0),
                        bucket))
        return out

    def _rescan_team(self, now: float) -> int | None:
        """Team/role rescan: the step's window formation is pool-wide (the
        batch only admits), so an all-padding window of the smallest bucket
        re-runs it with current effective thresholds; without it, waiting
        players whose thresholds widened into range would never match
        under zero traffic. Safe with windows in flight: it admits nothing,
        and formation reads only the device pool, in stream order."""
        if len(self.pool) < self.kernels.need:
            return None
        self._chaos_step()
        pending = _Pending(token=self._next_token, created=time.perf_counter())
        self._next_token += 1
        batch = self.pool.batch_arrays([], [], self.buckets[0])
        out = self._launch(self._variants()[0], batch, now, pending.staging)
        pending.chunks.append(([], out, now))
        self._submit(pending)
        return pending.token

    def collect_ready(self) -> list[tuple[int, SearchOutcome | ColumnarOutcome]]:
        """Finalize every window whose results have landed, without
        blocking, in dispatch order (a ready window behind an unfinished
        one waits its turn); windows finalized out of turn come first."""
        done, self._done_early = self._done_early, []
        while self._pending and self._is_ready(self._pending[0]):
            done.append(self._collect(self._pending.popleft()))
        return done

    def flush(self) -> list[tuple[int, SearchOutcome | ColumnarOutcome]]:
        """Block until every in-flight window is collected and finalized;
        then read the quality state back (it blocks anyway), so the
        report is exact."""
        done, self._done_early = self._done_early, []
        while self._pending:
            done.append(self._collect(self._pending.popleft()))
        self._quality_force_sync()
        return done

    def span_report(self) -> dict[str, float]:
        """Per-window averages of the host stage spans (ms)."""
        w = max(1, self.spans["windows"])
        return {
            "windows": self.spans["windows"],
            "requests": self.spans["requests"],
            "matches": self.spans["matches"],
            **{k[:-2] + "_ms_avg": v / w * 1e3
               for k, v in self.spans.items() if k.endswith("_s")},
        }

    def util_report(self) -> dict[str, float]:
        """Device-utilization counters: monotone busy/idle seconds (the
        open span added read-only, so two reads delta cleanly), the idle
        fraction, the host's h2d / step-launch / readback split, and the
        batch fill. Busy means a window is dispatched and not finalized:
        an upper bound on the device's own busy time."""
        open_span = max(0.0, time.perf_counter() - self._util_mark)
        busy = self.util["busy_s"] + (open_span if self._open else 0.0)
        idle = self.util["idle_s"] + (0.0 if self._open else open_span)
        valid, padded = self.util["lanes_valid"], self.util["lanes_padded"]
        return {
            "device_busy_s": round(busy, 6),
            "device_idle_s": round(idle, 6),
            "idle_fraction": round(idle / max(1e-9, busy + idle), 6),
            "h2d_s": round(self.spans["h2d_s"], 6),
            "device_step_s": round(self.spans["step_s"], 6),
            "readback_s": round(self.util["readback_s"], 6),
            "windows": self.spans["windows"],
            "lanes_valid": valid,
            "lanes_padded": padded,
            "effective_occupancy": round(valid / max(1, padded), 6),
            # Finalized windows that were speculative commits.
            "spec_commit_share": round(self.counters.get("spec_hit", 0)
                                       / max(1, self.spans["windows"]), 6),
        }

    def quality_report(self) -> dict:
        """Per-rating-bucket quality/wait report over every match this
        engine formed (engine/quality.build_report): the last device state
        read back, the host accumulator, and a delegated queue's oracle.
        Syncs nothing: at most ``quality_report_every`` windows stale,
        exact after ``flush()``."""
        return build_report(self._quality_arrays(), self._q_spec)

    def quality_checkpoint(self) -> dict[str, np.ndarray]:
        """The merged accumulator arrays, for a successor engine's
        ``quality_restore`` (a revive): after a blocking read of the device
        state, or, if that read fails (a broken card: what a revive is
        for), with the last state read back."""
        try:
            self._quality_force_sync()
        except RuntimeError:  # CUDA errors surface as RuntimeError
            log.warning("quality checkpoint: the device state could not be "
                        "read; using the last state read back")
        return self._quality_arrays()

    def quality_restore(self, arrays: dict[str, np.ndarray] | None) -> None:
        """Fold a predecessor engine's ``quality_checkpoint`` into this
        engine's host accumulator (merged into every report)."""
        if arrays is not None:
            add_arrays(self._q_host_accum.arrays, arrays)

    def prune_report(self) -> dict[str, int] | None:
        """The pruned step's windows and how many took the span path
        rather than the dense fallback: one host read of a device counter
        (call it after ``flush()``). None without pruning."""
        ks = self.kernels
        if not getattr(ks, "prune_window_blocks", 0):
            return None
        span = 0 if ks.span_steps is None else int(ks.span_steps.item())
        return {"windows": ks.pruned_steps, "span_windows": span}

    def formation_report(self) -> dict | None:
        """Bucketed formation: the buckets (device blocks), the windows and
        pool slots their steps scored against the flat step's (every lane
        the whole pool), the touched fraction, each bucket's waiting
        players (the mirror's segment counts) and the bands. None when not
        bucketed. Host counters only: no device read."""
        if not self._bucketed:
            return None
        total = self.formation["total_slots"]
        rep: dict = {
            "mode": "bucketed",
            "buckets": self._segments,
            "windows": self.formation["windows"],
            "touched_slots": self.formation["touched_slots"],
            "total_slots": total,
            "formation_touched_frac": (
                round(self.formation["touched_slots"] / total, 6)
                if total else None),
        }
        seg = self.pool.segment_counts()
        if seg is not None:
            rep["bucket_occupancy"] = seg.tolist()
            rep["peak_bucket_occupancy"] = self.pool.segment_max()
        band = self.pool.band_report()
        if band is not None:
            rep["bands"] = band
        return rep

    def _formation_observe(self, result: np.ndarray) -> None:
        """Fold a collected chunk's touched row (row 3 of a bucketed
        result; flat results have three rows) into ``formation``."""
        if result.ndim < 2 or result.shape[0] <= 3:
            return
        self.formation["touched_slots"] += float(result[3, 0])
        self.formation["total_slots"] += float(self.kernels.capacity)
        self.formation["windows"] += 1

    # ---- speculative formation ---------------------------------------------

    def _pool_mutated(self) -> None:
        """Advance the validation clock and discard any held speculation.
        Runs before every operation that changes the pool (admission,
        matching, eviction, restore, the index rebuild, warm-up, a hand-
        over to the host oracle and back); a sweep that changes nothing
        does not run it, so an idle pool keeps its speculation."""
        self.pool_mutations += 1
        self._spec_validated_seq = None
        if self._spec is not None:
            self._spec = None
            self._count("spec_wasted")

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _speculates(self) -> bool:
        return bool(self.cfg.engine.spec_formation) and not self._team_device

    def _spec_device_pool(self) -> kernels.DevicePool:
        """The spare pool speculation runs on (made once: the ``spec``
        graphs hold its addresses)."""
        if self._spec_pool is None:
            self._spec_pool = self._fresh_device_pool()
        return self._spec_pool

    @staticmethod
    def _copy_pool(dst: kernels.DevicePool, src: kernels.DevicePool) -> None:
        """Every column of ``src`` into ``dst``, in place, on the stream."""
        for name, col in src.full.items():
            dst.full[name].copy_(col, non_blocking=True)

    def speculate(self, now: float) -> bool:
        """Run up to ``spec_max_steps`` chained passes of the rescan step
        at ``now`` over the longest-waiting players (a rescan tick's pick
        and chunks) on a copy of the live pool, and hold the results off
        the books: no mirror, token, quality state or live pool changes.
        A later pass sees the earlier passes' matches as inactive lanes, so
        a commit equals that many ``rescan_async`` ticks at ``now``. True
        when a speculation is held (already, or now)."""
        if not self._speculates():
            return False
        if self._spec is not None:
            return True
        if len(self.pool) < 2:
            return False
        top = self.buckets[-1]
        chunks = self._rescan_chunks(self._rescan_chunk_cap * top, now)
        now_rel = float(np.float32(now - self._rel_base(now)))
        held = _Speculation(
            basis_seq=self.pool_mutations, spec_now=now, wall_t=time.time(),
            now_dev=torch.full((1,), now_rel, dtype=torch.float32,
                               device=self.device))
        self._copy_pool(self._spec_device_pool(), self.dev_pool)
        for _ in range(max(1, self.cfg.engine.spec_max_steps)):
            for payload, batch, bucket in chunks:
                rb = self._launch("spec", batch, now, held.staging,
                                  keep=held.outs)
                held.chunks.append((payload, rb, now))
                held.lanes_valid += int(payload[1].size)
                held.lanes_padded += bucket
                held.steps += 1
        self._count("spec_steps", held.steps)
        self._spec = held
        return True

    def spec_validate(self, now: float, max_age_s: float = 0.0) -> int | None:
        """The held speculation's token (its clock value) if no pool
        mutation happened since it was taken and, with ``max_age_s`` > 0,
        it is at most that old at ``now``; else it is discarded
        (``spec_miss``) and None returned. O(1): a compare, no scan."""
        s = self._spec
        if s is None:
            return None
        if (s.basis_seq != self.pool_mutations
                or (max_age_s > 0.0 and now - s.spec_now > max_age_s)):
            self._spec = None
            self._spec_validated_seq = None
            self._count("spec_miss")
            return None
        self._spec_validated_seq = s.basis_seq
        return s.basis_seq

    def spec_commit(self, token: int | None, now: float) -> int | None:
        """Commit the validated speculation as a rescan window: copy the
        spare pool back into the live pool in place (the captured steps
        keep their addresses), fold each held result into the quality
        state (one ``quality_accum`` launch a chunk), and submit the held
        chunks under a token in ``rescan_tokens``, collected as any window
        is. ``token`` must be what ``spec_validate`` just returned, with no
        pool mutation since: a stale or unvalidated token raises. Returns
        the window's token, or None when nothing was held and ``token`` is
        None."""
        s = self._spec
        if s is None:
            if token is None:
                return None
            raise RuntimeError(
                f"spec_commit token {token} refers to a discarded "
                f"speculation (pool_mutations={self.pool_mutations}): a pool "
                f"mutation ran between spec_validate and spec_commit")
        if (self._spec_validated_seq is None
                or token != self._spec_validated_seq
                or token != s.basis_seq or token != self.pool_mutations):
            raise RuntimeError(
                f"spec_commit token {token} is not freshly validated "
                f"(validated={self._spec_validated_seq}, basis={s.basis_seq}"
                f", pool_mutations={self.pool_mutations}): call "
                f"spec_validate right before spec_commit, with no pool "
                f"mutation in between")
        self._spec = None
        self._spec_validated_seq = None
        self.pool_mutations += 1  # the commit changes the pool
        self._copy_pool(self.dev_pool, self._spec_pool)
        if self._quality is not None:
            # The spare pool's rating, enqueue and threshold columns are the
            # live pool's (the passes change only ``active``), so the fold
            # reads what the rescan tick's would.
            for out in s.outs:
                self._quality.accum(self._q_dev, self.dev_pool, out[:3],
                                    s.now_dev)
        pending = _Pending(token=self._next_token, created=time.perf_counter())
        pending.columnar = empty_columnar_outcome()
        pending.marks.append(("spec_snapshot", s.wall_t))
        pending.marks.append(("spec_commit", time.time()))
        pending.chunks = s.chunks
        pending.staging = s.staging
        self._next_token += 1
        self.util["lanes_valid"] += s.lanes_valid
        self.util["lanes_padded"] += s.lanes_padded
        self._count("spec_hit")
        self._count("spec_committed_steps", s.steps)
        self._submit(pending)
        self.rescan_tokens.add(pending.token)
        return pending.token

    def spec_invalidate(self, reason: str = "external") -> None:
        """Discard the held speculation without advancing the clock (the
        service's drain and revive). It owns no player, so none is lost."""
        if self._spec is not None:
            self._spec = None
            self._count("spec_wasted")
        self._spec_validated_seq = None

    def spec_report(self) -> dict | None:
        """Speculation counts (hits, misses, discarded, passes run and
        committed, one held or not), the hit rate and the share of passes
        wasted; None for team and role queues."""
        if self._team_device:
            return None
        c = self.counters
        hits, miss = c.get("spec_hit", 0), c.get("spec_miss", 0)
        wasted, steps = c.get("spec_wasted", 0), c.get("spec_steps", 0)
        committed = c.get("spec_committed_steps", 0)
        return {
            "spec_hit": hits, "spec_miss": miss, "spec_wasted": wasted,
            "spec_steps": steps, "spec_committed_steps": committed,
            "spec_pending": int(self._spec is not None),
            "spec_hit_rate": round(hits / max(1, hits + miss + wasted), 6),
            "spec_wasted_step_fraction": round(
                (steps - committed) / max(1, steps), 6),
        }

    def _quality_arrays(self) -> dict[str, np.ndarray]:
        arrays = empty_arrays(self._q_spec)
        add_arrays(arrays, self._q_host_accum.arrays)
        add_arrays(arrays, self._q_host)
        if self._team_delegate is not None:
            add_arrays(arrays, self._team_delegate.quality_accum.arrays)
        return arrays

    def graph_report(self) -> dict | None:
        """The captured steps (``StepGraphs.report``: per variant and
        bucket, capture and warm-up host ms, memory, replays); None on the
        CPU."""
        return None if self._graphs is None else self._graphs.report()

    def _quality_sync_finalize(self) -> None:
        """At each finalize: take the state copy in flight if its event has
        fired (never waiting for it), and every ``quality_report_every``
        windows queue a new one (the state as of the last window queued)."""
        if self._quality is None:
            return
        if self._q_sync is not None and self._q_sync.ready():
            self._q_host = self._quality.arrays(self._q_sync.numpy())
            self._q_sync = None
        self._q_windows += 1
        if self._q_windows >= self._q_sync_every and self._q_sync is None:
            self._q_windows = 0
            flat = self._q_dev.flat
            # A CPU state is updated in place: read back a copy of it.
            self._q_sync = _Readback(flat if flat.is_cuda else flat.clone())

    def _quality_force_sync(self) -> None:
        """Blocking read of the device state (flush and checkpoint)."""
        if self._quality is None:
            return
        self._q_host = self._quality.arrays(self._q_dev.flat.cpu().numpy())
        self._q_sync = None
        self._q_windows = 0

    # ---- internals: dispatch ----------------------------------------------

    def _chaos_step(self) -> None:
        """A search step is about to be dispatched: the chaos hook may
        fail it, before any state of the chunk is touched."""
        if self.chaos_hook is not None:
            self.chaos_hook.on_step()

    def _require_idle(self, what: str) -> None:
        if self._open:
            raise RuntimeError(f"{what} with windows in flight — collect "
                               f"with flush() first")

    def _require_columnar(self, what: str) -> None:
        if self._team_device:
            raise ValueError(f"{what}: the columnar API serves 1v1 queues; "
                             f"team and role queues use the object API")

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _rel_base(self, now: float) -> float:
        if self._t0 is None:
            self._t0 = now
        return self._t0

    def _stage(self, batch: BatchArrays, now_rel: float,
               requests: Sequence[SearchRequest] = ()) -> torch.Tensor:
        """Pack a window into a host staging buffer f32[pack_rows, B]
        (pinned for the card), which must outlive its copy to the device.
        Role steps get the ``role_mask`` row of ``requests`` (lane order)
        before the trailing ``now`` row; padding lanes carry mask 0."""
        staging = torch.empty((self.kernels.pack_rows, batch.slot.shape[0]),
                              dtype=torch.float32, pin_memory=self._pinned)
        rows = staging.numpy()
        pack_batch(batch, now_rel, out=rows[:len(PACKED_ROWS) + 1])
        if self.kernels.is_role:
            rows[-1] = now_rel
            rows[len(PACKED_ROWS)] = 0.0
            rows[len(PACKED_ROWS), :len(requests)] = [
                self.kernels.mask_of(r.roles) for r in requests]
        return staging

    def _admit(self, batch: BatchArrays,
               requests: Sequence[SearchRequest] = ()) -> None:
        """Queue the admission of a padded window (restore paths), eagerly.
        The pinned allocator keeps the staging block until the copy has
        run."""
        self.kernels.admit_packed(self.dev_pool, self._stage(
            batch, 0.0, requests).to(self.device, non_blocking=True))

    def _variants(self) -> tuple[str, ...]:
        """The step variants of this queue (one graph each per bucket):
        the team or role step; for 1v1 queues the traffic step with and
        without filters (dense, pruned with ``prune_window_blocks``, or
        bucketed) and the rescan step (dense, or bucketed). A speculating
        queue has one more, ``spec``: the rescan step on the spare pool,
        with no quality fold."""
        if self._team_device:
            return ("role",) if self._role_device else ("team",)
        if self._bucketed:
            return "bucketed", "bucketed_nofilter", "bucketed_rescan"
        base = "pruned" if self.kernels.prune_window_blocks else "dense"
        return base, base + "_nofilter", "rescan"

    def _step_fn(self, variant: str):
        """The step a variant runs, as a graph captures it: (device pool,
        packed window) → the result, with a 1v1 step's quality fold behind
        it (one ``quality_accum`` launch on the result's first three rows;
        it reads the window's time from the packed ``now`` row, its last,
        on the device). The ``spec`` step folds nothing: a speculation's
        results are folded at its commit, and a discarded one never."""
        ks = self.kernels
        if variant in ("rescan", "bucketed_rescan", "spec"):
            step = ks.search_step_packed_rescan
        elif self._team_device:
            step = ks.search_step_packed
        else:
            step = functools.partial(ks.search_step_packed,
                                     skip_filters=variant.endswith("nofilter"))
        quality = self._quality
        if quality is None or variant == "spec":
            return step
        state = self._q_dev

        def run(pool, packed):
            out = step(pool, packed)
            quality.accum(state, pool, out[:3], packed[-1])
            return out
        return run

    def _pool_for(self, variant: str, warm: bool = False) -> kernels.DevicePool:
        """The pool a variant's step runs on: the spare pool for ``spec``,
        else the live pool. For an eager warm-up (``warm``) a team or role
        step gets a scratch pool (they form matches pool-wide); a 1v1 step
        runs on its own pool, which an all-padding window leaves as it
        is."""
        if variant == "spec":
            return self._spec_device_pool()
        if warm and self._team_device:
            return self._fresh_device_pool()
        return self.dev_pool

    def _step_graph(self, variant: str, bucket: int):
        """The graph of (variant, bucket), captured at its first use."""
        g = self._graphs.get(variant, bucket)
        if g is None:
            empty = self._stage(self.pool.batch_arrays([], [], bucket), 0.0)
            g = self._graphs.capture(variant, bucket, self._step_fn(variant),
                                     self._pool_for(variant), empty,
                                     self._pool_for(variant, warm=True))
        return g

    def _launch(self, variant: str, batch: BatchArrays, now: float,
                staging_list: list[torch.Tensor],
                requests: Sequence[SearchRequest] = (),
                keep: list[torch.Tensor] | None = None,
                marks: list[tuple[str, float]] | None = None) -> _Readback:
        """Copy one window chunk to the device, queue the ``variant`` step
        on it (on the card, one replay of its graph) and the copy of its
        result to the host right behind it: the next replay of the graph
        (a later chunk of this window) overwrites its static output.
        Returns that ``_Readback`` of the result (1v1: f32[3, B] q_slot,
        c_slot, dist, and a fourth row, the touched slots, when bucketed;
        team/role: f32[need + 2 (+1), M]). The staging buffer goes to
        ``staging_list``; with ``keep``, a device copy of the result,
        taken before anything else is queued, goes there too. With
        ``marks`` (a traffic window's), the "h2d" and "device_step" (or
        "formation_bucketed") marks are appended once the input copy and
        the step are queued."""
        t0 = self._rel_base(now)
        now_rel = float(np.float32(now - t0))  # the packed now row's value
        _t = time.perf_counter()
        staging = self._stage(batch, now_rel, requests)
        staging_list.append(staging)
        if self._graphs is not None:
            g = self._step_graph(variant, batch.slot.shape[0])
            g.static_in.copy_(staging, non_blocking=True)
        else:  # eager (the CPU: no copy)
            packed = staging.to(self.device, non_blocking=True)
        self.spans["h2d_s"] += time.perf_counter() - _t
        if marks is not None:
            marks.append(("h2d", time.time()))
        _t = time.perf_counter()
        if self._graphs is not None:
            out = self._graphs.replay(g)
        else:
            out = self._step_fn(variant)(self._pool_for(variant), packed)
        if marks is not None:
            marks.append(("formation_bucketed"
                          if variant.startswith("bucketed")
                          else "device_step", time.time()))
        if keep is not None:
            out = out.clone()
            keep.append(out)
        readback = _Readback(out)
        self.spans["step_s"] += time.perf_counter() - _t
        return readback

    def _step_for(self, batch: BatchArrays) -> str:
        """The variant of a traffic window. The all-ANY variant drops the
        region/mode tests: exact when no lane carries a filter (padding
        lanes hold code 0). Team and role steps have one variant."""
        base = self._variants()[0]
        if self._team_device or batch.region.any() or batch.mode.any():
            return base
        return base + "_nofilter"

    def _dispatch(self, window: list[SearchRequest], now: float,
                  pending: _Pending) -> None:
        """Admit + queue the step for one object chunk; no waiting."""
        if not window:
            return
        self._chaos_step()
        free = self.pool.free_count()
        if len(window) > free:  # admit what fits, reject the overflow
            for req in window[free:]:
                pending.outcome.rejected.append((req, "pool_full"))
            window = window[:free]
            if not window:
                return
        _t = time.perf_counter()
        slots = self.pool.allocate(window)
        self.spans["alloc_s"] += time.perf_counter() - _t
        bucket = self._bucket_for(len(window))
        _t = time.perf_counter()
        batch = self.pool.batch_arrays(window, slots, bucket,
                                       self._rel_base(now))
        self.spans["pack_s"] += time.perf_counter() - _t
        out = self._launch(self._step_for(batch), batch, now,
                           pending.staging, window, marks=pending.marks)
        self.util["lanes_valid"] += len(window)
        self.util["lanes_padded"] += bucket
        pending.chunks.append((list(window), out, now))

    def _dispatch_cols(self, cols: RequestColumns, now: float,
                       pending: _Pending) -> None:
        """Columnar twin of ``_dispatch``."""
        if not len(cols):
            return
        self._chaos_step()
        free = self.pool.free_count()
        if len(cols) > free:
            assert pending.columnar is not None
            pending.columnar.rejected.extend(
                (pid, "pool_full") for pid in cols.ids[free:].tolist())
            cols = cols.slice(0, free)
            if not len(cols):
                return
        _t = time.perf_counter()
        slots = self.pool.allocate_columns(cols)
        self.spans["alloc_s"] += time.perf_counter() - _t
        bucket = self._bucket_for(len(cols))
        _t = time.perf_counter()
        batch = self.pool.batch_arrays_cols(cols, slots, bucket,
                                            self._rel_base(now))
        self.spans["pack_s"] += time.perf_counter() - _t
        out = self._launch(self._step_for(batch), batch, now,
                           pending.staging, marks=pending.marks)
        self.util["lanes_valid"] += len(cols)
        self.util["lanes_padded"] += bucket
        pending.chunks.append(((cols, slots), out, now))

    def _submit(self, pending: _Pending) -> None:
        """Track the window FIFO (each chunk's result copy is already
        queued behind its step: the "readback_seal" mark)."""
        if pending.chunks:
            pending.marks.append(("readback_seal", time.time()))
        pending.queued_readback = time.perf_counter()
        if self._open == 0:
            now_pc = time.perf_counter()
            self.util["idle_s"] += max(0.0, now_pc - self._util_mark)
            self._util_mark = now_pc
        self._open += 1
        self._pending.append(pending)

    # ---- internals: collection --------------------------------------------

    @staticmethod
    def _is_ready(pending: _Pending) -> bool:
        return all(h.ready() for _, h, _ in pending.chunks)

    def _fetch(self, pending: _Pending) -> None:
        """Read the window's results on the host (already copied in the
        common case); a device failure is parked on the window."""
        if pending.raw is not None:
            return
        try:
            pending.raw = [h.numpy() for _, h, _ in pending.chunks]
        except RuntimeError as e:  # CUDA errors surface as RuntimeError
            pending.error = e
        pending.staging.clear()

    def _collect(self, pending: _Pending):
        self._fetch(pending)
        self._finalize(pending)
        return pending.token, (pending.columnar if pending.columnar is not None
                               else pending.outcome)

    def _finalize(self, pending: _Pending) -> None:
        """Map one window's results back to requests. A device failure does
        not raise here (that would drop outcomes already finalized in the
        same collect): the window's requests are reported as queued — true,
        the mirror still holds them, and a revive restores from the mirror —
        its token goes to ``failed_tokens`` and the error to
        ``device_error``."""
        _t = time.perf_counter()
        self._open -= 1
        if self._open == 0:
            now_pc = time.perf_counter()
            self.util["busy_s"] += max(0.0, now_pc - self._util_mark)
            self._util_mark = now_pc
        self._quality_sync_finalize()
        if pending.created:
            self.spans["windows"] += 1
            self.spans["turnaround_s"] += time.perf_counter() - pending.created
        if pending.chunks:
            self.util["readback_s"] += _t - pending.queued_readback
        pending.marks.append(("collect", time.time()))
        marks = self.window_marks
        marks[pending.token] = pending.marks
        while len(marks) > 512:
            # Unclaimed marks (sync callers, failed windows): oldest first.
            marks.pop(next(iter(marks)))
        if pending.error is not None:
            self.device_error = pending.error
            self.failed_tokens.add(pending.token)
            for payload, _, _ in pending.chunks:
                if pending.columnar is not None:
                    pending.columnar.q_ids = np.concatenate(
                        [pending.columnar.q_ids, payload[0].ids])
                else:
                    pending.outcome.queued.extend(payload)
        elif pending.columnar is not None:
            self._finalize_columnar(pending)
        elif self._team_device:
            self._finalize_team(pending)
        else:
            self._finalize_objects(pending)
        self.spans["finalize_s"] += time.perf_counter() - _t

    def _finalize_objects(self, pending: _Pending) -> None:
        out = pending.outcome
        for (window, _, now), result in zip(pending.chunks, pending.raw or ()):
            self._formation_observe(result)
            q_slot = result[0].astype(np.int32)
            c_slot = result[1].astype(np.int32)
            hit = q_slot < self.kernels.capacity
            matched_ids: set[str] = set()
            if hit.any():
                qs_l = q_slot[hit].tolist()
                cs_l = c_slot[hit].tolist()
                for qs, cs, d in zip(qs_l, cs_l, result[2][hit].tolist()):
                    req_q = self.pool.request_at(qs)
                    req_c = self.pool.request_at(cs)
                    matched_ids.add(req_q.id)
                    matched_ids.add(req_c.id)
                    qual = scoring.quality(
                        d, self.effective_threshold(req_q, now),
                        self.effective_threshold(req_c, now))
                    out.matches.append(Match(match_id=new_match_id(),
                                             teams=((req_q,), (req_c,)),
                                             quality=qual))
                self._pool_mutated()
                self.pool.release(qs_l)
                self.pool.release(cs_l)
            for req in window:
                if req.id not in matched_ids:
                    out.queued.append(req)
        self.spans["matches"] += len(out.matches)

    def _eff_vec(self, thr: np.ndarray, enqueued: np.ndarray,
                 now: float) -> np.ndarray:
        """``effective_threshold`` over mirror columns."""
        if self.queue.widen_per_sec <= 0.0:
            return thr
        waited = np.maximum(0.0, now - enqueued)
        return np.minimum(self.queue.max_threshold,
                          thr + self.queue.widen_per_sec * waited
                          ).astype(np.float32)

    def _finalize_columnar(self, pending: _Pending) -> None:
        """Columnar finalize: vectorized over the window, with the object
        path's formulas (quality from both sides' effective thresholds at
        the chunk's dispatch time)."""
        out = pending.columnar
        assert out is not None
        pool = self.pool
        for (payload, _, now), result in zip(pending.chunks, pending.raw or ()):
            cols, slots = payload
            self._formation_observe(result)
            q_slot = result[0].astype(np.int32)
            c_slot = result[1].astype(np.int32)
            hit = q_slot < self.kernels.capacity
            qs, cs, d = q_slot[hit], c_slot[hit], result[2][hit]
            if qs.size:
                eff_a = self._eff_vec(pool.m_threshold[qs], pool.m_enqueued[qs], now)
                eff_b = self._eff_vec(pool.m_threshold[cs], pool.m_enqueued[cs], now)
                limit = np.minimum(eff_a, eff_b)
                quality = np.where(
                    limit > 0.0,
                    np.clip(1.0 - d / np.maximum(limit, 1e-30), 0.0, 1.0),
                    0.0,
                ).astype(np.float32)
                enq_a, enq_b = pool.m_enqueued[qs], pool.m_enqueued[cs]
                # Wait at match: this chunk's dispatch time minus the
                # enqueue stamp (0 where unstamped).
                wait_a = np.where(enq_a != 0.0, np.maximum(0.0, now - enq_a), 0.0)
                wait_b = np.where(enq_b != 0.0, np.maximum(0.0, now - enq_b), 0.0)
                for name, col in (
                        ("m_id_a", pool.m_id[qs]), ("m_id_b", pool.m_id[cs]),
                        ("m_match_id", new_match_ids(qs.size)),
                        ("m_dist", d), ("m_quality", quality),
                        ("m_reply_a", pool.m_reply[qs]),
                        ("m_reply_b", pool.m_reply[cs]),
                        ("m_corr_a", pool.m_corr[qs]),
                        ("m_corr_b", pool.m_corr[cs]),
                        ("m_enq_a", enq_a), ("m_enq_b", enq_b),
                        ("m_wait_a", wait_a), ("m_wait_b", wait_b),
                        ("m_tier_a", pool.m_tier[qs]),
                        ("m_tier_b", pool.m_tier[cs])):
                    setattr(out, name, np.concatenate([getattr(out, name), col]))
                matched = np.concatenate([qs, cs])
                self._pool_mutated()
                pool.release(matched)
                queued_ids = cols.ids[~np.isin(slots, matched)]
            else:
                queued_ids = cols.ids
            out.q_ids = np.concatenate([out.q_ids, queued_ids])
        self.spans["matches"] += out.n_matches

    def _finalize_team(self, pending: _Pending) -> None:
        """Team/role results (member slots M×need, spread, limit; role
        steps a split-bits row too) → matches of two teams: the snake split
        for team queues (``scoring.snake_split``), the step's own split for
        role queues (bit i set ⇔ rating-ordered member i on team A).
        Quality = 1 − spread/limit. Each match's slots are released by
        themselves, in match order, as the JAX engine does: the free list,
        and so the next window's slot layout and tie order, stay equal."""
        out = pending.outcome
        need = self.kernels.need
        is_role = self.kernels.is_role
        capacity = self.kernels.capacity
        for (window, _, now), result in zip(pending.chunks, pending.raw or ()):
            slots = result[:need].T.astype(np.int32)
            hit = np.nonzero(slots[:, 0] < capacity)[0]
            spread = result[need][hit].astype(np.float64)
            limit = result[need + 1][hit].astype(np.float64)
            quality = np.where(limit > 0, np.maximum(
                0.0, 1.0 - spread / np.where(limit > 0, limit, 1.0)), 0.0)
            split = result[need + 2][hit].astype(np.int32) if is_role else None
            # No device accumulator on the team steps: one host sample per
            # member (match order, then slot order), its wait at the
            # chunk's dispatch time, read from the mirror before release.
            members_at = slots[hit]
            enq = self.pool.m_enqueued[members_at].ravel()
            self._q_host_accum.observe(
                rating=self.pool.m_rating[members_at].ravel(),
                quality=np.repeat(quality, need),
                wait_s=np.where(enq != 0.0, np.maximum(0.0, now - enq), 0.0),
                spread=np.repeat(spread, need))
            matched_ids: set[str] = set()
            for k, m in enumerate(hit.tolist()):
                row = slots[m].tolist()
                members = [self.pool.request_at(s) for s in row]
                matched_ids.update(r.id for r in members)
                if is_role:
                    bits = int(split[k])
                    team_a = tuple(members[i] for i in range(need)
                                   if bits >> i & 1)
                    team_b = tuple(members[i] for i in range(need)
                                   if not bits >> i & 1)
                else:
                    team_a, team_b = scoring.snake_split(members)
                out.matches.append(Match(match_id=new_match_id(),
                                         teams=(team_a, team_b),
                                         quality=float(quality[k])))
                self.pool.release(row)
            for req in window:
                if req.id not in matched_ids:
                    out.queued.append(req)
        self.spans["matches"] += len(out.matches)

    # ---- internals: delegation to the host oracle (team/role queues) -----

    @property
    def dev_pool(self) -> kernels.DevicePool | None:
        """The device pool. Replacing it drops every captured step, whose
        graphs hold the old pool's addresses."""
        return self._dev_pool

    @dev_pool.setter
    def dev_pool(self, pool: kernels.DevicePool | None) -> None:
        self._dev_pool = pool
        if self._graphs is not None:
            self._graphs.clear()

    def _fresh_device_pool(self) -> kernels.DevicePool:
        """An empty device pool for the kernel set (with its extra columns:
        the role step's ``role_mask``, a bucketed set's index, written
        empty): at start, as the scratch pool of a team or role step's
        warm-up, and as the spare pool of speculation."""
        pool = kernels.fresh_pool(self.kernels.capacity, self.device,
                                  self.kernels.extra_pool_fields)
        if self._bucketed:
            self.kernels.index_rebuild(pool)
        return pool

    def _new_pool(self) -> PlayerPool:
        """An empty mirror of this queue's geometry."""
        return PlayerPool(self.kernels.capacity, self.queue.rating_threshold,
                          band_edges=self._band_edges,
                          segments=self._segments)

    def _device_blocker(self, req: SearchRequest) -> bool:
        """True if the device step cannot serve ``req``: a wildcard region
        or mode (the steps group by exact code) on any team-family queue,
        or a party on a role queue (the role step packs solo units)."""
        return is_wildcard(req) or (self._role_device and req.party_size > 1)

    def _note_wildcards(self, requests: Sequence[SearchRequest],
                        now: float) -> None:
        """While delegated: a device-blocking arrival restarts the quiet
        period that gates re-promotion."""
        if any(self._device_blocker(r) for r in requests):
            self._delegate_last_wc = now

    def _maybe_delegate_team(self, requests: Sequence[SearchRequest],
                             now: float) -> bool:
        """Hand a team/role queue to the host oracle when ``requests`` hold
        a device-blocking request. Windows in flight are finalized first
        (the mirror must be post-match), their outcomes kept for the next
        collect_ready()/flush() under their tokens; every waiting player
        moves to a ``CpuEngine`` with its enqueue time; the device pool is
        parked (``dev_pool`` is None while delegated). True when the queue
        was handed over."""
        if not self._team_device or self._team_delegate is not None:
            return False
        if not any(self._device_blocker(r) for r in requests):
            return False
        log.warning(
            "team queue %r: a wildcard region/mode%s request arrived; the "
            "device step groups by exact codes%s, so the queue is served by "
            "the host oracle until none waits", self.queue.name,
            " or party" if self._role_device else "",
            " and packs solo players" if self._role_device else "")
        if self._open:
            # flush() takes (and rebinds) _done_early: read it after.
            finished = self.flush()
            self._done_early.extend(finished)
        self._pool_mutated()
        delegate = CpuEngine(self.cfg, self.queue)
        waiting = self.pool.waiting()
        if waiting:
            delegate.restore(waiting, now)
        self._team_delegate = delegate
        self._delegate_last_wc = now
        self.counters["team_delegated"] = (
            self.counters.get("team_delegated", 0) + 1)
        if self.events is not None:
            self.events.append("team_delegated", self.queue.name,
                               f"{len(waiting)} waiting transferred")
        # The device pool is parked, not dropped: re-promotion clears and
        # reuses it, so the captured steps, which hold its addresses, stay
        # valid.
        self._parked_pool, self._dev_pool = self._dev_pool, None
        self.pool = self._new_pool()
        return True

    def _maybe_repromote_team(self, now: float) -> bool:
        """Move a delegated team/role queue back onto the card once no
        device-blocking request arrived for ``TEAM_REPROMOTE_QUIET_S`` and
        none waits, and the waiting players fit the device pool with one
        arrival batch of headroom (else it stays delegated, rechecked a
        quiet period later). The players move with their enqueue times,
        into the device pool parked at delegation, cleared. True if the
        queue is now on the card."""
        d = self._team_delegate
        if d is None:
            return False
        if now - self._delegate_last_wc < self.TEAM_REPROMOTE_QUIET_S:
            return False
        headroom = min(self.buckets[-1], self.kernels.capacity // 4)
        if d.pool_size() > self.kernels.capacity - headroom:
            self._delegate_last_wc = now
            return False
        if d.has_wildcards() or (self._role_device and d.has_parties()):
            self._delegate_last_wc = now  # scan again a quiet period later
            return False
        waiting = d.waiting()
        # The oracle's matches were this queue's: its quality samples stay.
        add_arrays(self._q_host_accum.arrays, d.quality_accum.arrays)
        self._pool_mutated()
        self._team_delegate = None
        self._delegate_last_wc = float("-inf")
        self.pool = self._new_pool()
        pool, self._parked_pool = self._parked_pool, None
        for col in pool.full.values():
            col.zero_()  # as fresh: every slot inactive
        self._dev_pool = pool
        if waiting:
            self.restore(waiting, now)
        self.counters["team_repromoted"] = (
            self.counters.get("team_repromoted", 0) + 1)
        if self.events is not None:
            self.events.append("team_repromoted", self.queue.name,
                               f"{len(waiting)} waiting transferred")
        log.info("team queue %r: back on the device (%d waiting players "
                 "moved)", self.queue.name, len(waiting))
        return True

    # ---- internals: eviction ------------------------------------------------

    def _expire_slots(self, slots: np.ndarray) -> list[SearchRequest]:
        if slots.size == 0:
            return []
        reqs = [self.pool.request_at(int(s)) for s in slots]
        self._release_and_evict(slots)
        return reqs

    def _release_and_evict(self, slots: np.ndarray,
                           in_order: bool = False) -> None:
        self._pool_mutated()
        self.pool.release(slots, in_order=in_order)
        self._evict(slots)

    def _evict(self, slots: np.ndarray) -> None:
        """One device eviction of exactly ``slots`` (a bucketed queue's
        counts them out of its index). (The JAX package evicts in chunks
        of ``evict_bucket`` padded with the sentinel ``capacity``, for a
        fixed compiled shape; the eviction takes any length, so one call
        over the slots marks the same ones.) The slots are staged in
        pinned memory on the card and copied without blocking (a pageable
        copy would synchronize the stream; the pinned allocator keeps the
        block until the copy has run)."""
        staging = torch.empty(len(slots), dtype=torch.int32,
                              pin_memory=self._pinned)
        staging.numpy()[:] = slots
        t = staging.to(self.device, non_blocking=True)
        if self._team_device:
            kernels.evict(self.dev_pool, t)
        else:
            self.kernels.evict(self.dev_pool, t)
