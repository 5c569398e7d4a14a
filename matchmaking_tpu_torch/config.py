"""Typed configuration for the PyTorch/CUDA port.

The port's own copy of the configuration tree, trimmed to what the window
engines (1v1, team and role queues) and the service read, under the JAX
package's names and defaults. ``Config.from_json`` reads the repository's
``configs/*.json`` files; those name the JAX package's ``"tpu"`` backend,
so the loader takes the port's backend as an explicit override
(``Config.from_json(path, backend="gpu")``) instead of reinterpreting the
JAX name (``Config.from_env`` does the same for the ``MM_*`` variables).
Sections and keys the port does not carry yet (placement, autotune,
``workers``, ...) are ignored with a warning; a value that needs a module
the port does not have yet is refused, with the module named: the
multi-GPU chaos faults at construction.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class QueueConfig:
    """Per-matchmaking-queue knobs."""

    #: Broker queue this engine consumes.
    name: str = "matchmaking.search"
    #: Game mode this queue serves (carried from the JSON files; like the
    #: JAX package, nothing reads it: the mode comes with each request).
    game_mode: str | None = None
    #: Players per team (1 → 1v1; > 1 → team queues, config #3).
    team_size: int = 1
    #: Default max rating distance for a valid match.
    rating_threshold: float = 100.0
    #: Threshold widening, rating points per second waited (0 disables).
    widen_per_sec: float = 0.0
    #: Cap on the widened threshold.
    max_threshold: float = 400.0
    #: Glicko-2 rating-deviation-weighted distance.
    glicko2: bool = False
    #: Role slots each team must fill, one per member (config #5). Parties
    #: and region/mode wildcards hand the queue to the host oracle until
    #: they drain (engine/gpu.py ``_maybe_delegate_team``).
    role_slots: tuple[str, ...] = ()
    #: Evict waiting players after this many seconds and answer
    #: ``timeout`` (None: wait forever).
    request_timeout_s: float | None = None
    #: Publish a ``queued`` ack when a request enters the pool.
    send_queued_ack: bool = True
    #: Terminal-replay horizon: a redelivered request whose player was
    #: matched within this many seconds gets the cached response again.
    dedup_ttl_s: float = 30.0
    #: QoS tier of a request that arrives without an ``x-tier`` header
    #: (service/overload.py: tier 0 is the most latency-critical, higher
    #: tiers are shed first). Read only when ``OverloadConfig.tiers > 1``.
    default_tier: int = 0
    #: Periodic rescan of the longest-waiting players (seconds; 0 = off).
    #: Matching is otherwise arrival-triggered, so two waiting players
    #: whose thresholds widened into range would never match without it.
    rescan_interval_s: float = 0.0
    #: Players covered per rescan tick (0: the batcher's ``max_batch``). A
    #: tick dispatches at most ``EngineConfig.pipeline_depth`` chunks of
    #: the largest bucket; the oldest-first pick rolls the rest over.
    rescan_window: int = 0


@dataclass(frozen=True)
class EngineConfig:
    """Engine selection + device-pool geometry."""

    #: ``"gpu"`` → the batched PyTorch/CUDA engine (engine/gpu.py);
    #: ``"cpu"`` → the host oracle (engine/cpu.py). The repository's JSON
    #: files say ``"tpu"``; override it at load time.
    backend: str = "gpu"
    #: Fixed device-pool capacity P (slots are recycled).
    pool_capacity: int = 131_072
    #: Candidates kept per request before conflict resolution (shapes the
    #: block geometry through ``kernels.effective_pool_block``).
    top_k: int = 8
    #: Request-window batch buckets (windows pad to the smallest bucket ≥
    #: their size; larger windows split into chunks of the largest).
    batch_buckets: tuple[int, ...] = (16, 64, 256, 1024)
    #: Pool block width: candidates are the best slot per block.
    pool_block: int = 8192
    #: Proposal rounds of the parallel greedy pairing.
    pair_rounds: int = 8
    #: Team/role queues: most matches one window step can form (clamped to
    #: ``pool_capacity // (2 * team_size)``).
    team_max_matches: int = 1024
    #: Team/role queues: rounds of the parallel greedy window selection.
    team_rounds: int = 16
    #: Dispatched-but-uncollected windows the service keeps in flight on
    #: the columnar path (1: dispatch, then wait, per window).
    pipeline_depth: int = 2
    #: Result readbacks per device→host copy: this many windows' results
    #: are stacked on the device and copied to the host at once (1: one
    #: copy per window chunk).
    readback_group: int = 1
    #: Age (ms) after which a partial readback group is copied anyway.
    readback_group_wait_ms: float = 8.0
    #: Run every step variant once at service start (``Engine.warmup``),
    #: so no first-of-its-kind window pays a first use while serving.
    warm_start: bool = False
    #: Device-engine circuit breaker (service/breaker.py): after this many
    #: engine crashes within ``breaker_window_s`` the queue's breaker trips
    #: and the queue is served by the host oracle (engine/cpu.py) until a
    #: half-open probe proves the card again. 0 disables it (every crash
    #: revives the device engine at once).
    breaker_threshold: int = 0
    #: Sliding window of the crash count (seconds).
    breaker_window_s: float = 30.0
    #: Half-open probes while the breaker is open: the first
    #: ``breaker_probe_initial_s`` after the trip; each failed probe
    #: multiplies the delay by ``breaker_probe_backoff``, up to
    #: ``breaker_probe_max_s``. A probe builds a fresh device engine and
    #: replays one all-padding window step; success moves the pool back.
    breaker_probe_initial_s: float = 1.0
    breaker_probe_backoff: float = 2.0
    breaker_probe_max_s: float = 60.0
    #: The service's health timer (seconds; 0 disables): each queue's
    #: heartbeat moves an idle team or role queue that was handed to the
    #: host oracle back onto the card once its blockers drained,
    #: independent of the rescan loop (configs #3 and #5 run none), and the
    #: timer runs the breaker's half-open probes.
    health_interval_s: float = 1.0
    #: Rating-banded candidate pruning of the 1v1 step (0: every pool
    #: block is scored). N > 0: each rating-sorted chunk of a window scores
    #: only an N-block span of the pool, chosen from the blocks' live
    #: rating bounds, with a whole-window dense fallback where a span does
    #: not fit (``kernels.KernelSet``); exact either way. It narrows the
    #: spans only with ``band_spec`` set.
    prune_window_blocks: int = 0
    #: Rows per rating-sorted window chunk of the pruned step.
    prune_chunk: int = 128
    #: Rating bands of the host slot allocator (``core.pool.
    #: band_edges_from_spec``), one band per pool block: "" (off),
    #: "uniform:LO:HI" or "gaussian:MEAN:STD" (equal-mass bands).
    band_spec: str = ""
    #: Rating-bucketed formation of the 1v1 step: the device pool carries a
    #: bucket index (per pool block: live count, rating bounds that only
    #: widen between rebuilds, max rating deviation), kept by every admit,
    #: match and evict, and each rating-sorted chunk of a window scores
    #: only the span of blocks the index admits (``prune_window_blocks``
    #: wide; ≤ 0 means a quarter of the blocks), with the pruned step's
    #: whole-window dense fallback. Exact either way. The health timer's
    #: heartbeat re-tightens the bounds.
    bucketed: bool = False
    #: The sharded frontier exchange of bucketed formation (multi-device):
    #: carried so that a file naming it loads, and refused by ``GpuEngine``
    #: when > 0 (not ported).
    bucket_frontier_k: int = 0
    #: Speculative formation: between windows the engine runs up to
    #: ``spec_max_steps`` no-admission rescan passes over the resident
    #: pool into a spare pool, off the books; the next cut (a traffic
    #: window, a rescan tick, the next speculation tick) commits them in
    #: O(1) if no pool mutation happened since, or discards them. 1v1
    #: queues only.
    spec_formation: bool = False
    #: Chained speculative passes per gap (each over the previous pass's
    #: pool, at the same time).
    spec_max_steps: int = 2
    #: A speculation older than this (ms) at the cut is discarded even if
    #: no mutation invalidated it.
    spec_staleness_ms: float = 500.0
    #: The service's speculation loop cadence (ms; 0 disables the loop,
    #: and the cut-time commit still runs).
    spec_interval_ms: float = 10.0


@dataclass(frozen=True)
class BrokerConfig:
    """In-process broker knobs."""

    #: Transport URL. The port serves on the in-process broker only: an
    #: ``amqp://`` URL is refused by ``service.app.serve``.
    url: str = "inproc://matchmaking"
    request_queue: str = "matchmaking.search"
    #: Per-consumer unacked-message cap.
    prefetch: int = 2048
    #: Redelivery attempts for nacked deliveries before dead-lettering.
    max_redelivery: int = 3
    #: Burst consume: the broker drains the deliveries already buffered on
    #: a queue into one burst and a columnar (1v1) queue's runtime gets ONE
    #: callback per burst, which decodes the burst's bodies in one native
    #: call at consume (``service/ingress.py``); the window flush then
    #: gathers columns from the decoded bursts instead of decoding again.
    #: False = the per-delivery path, byte for byte.
    consume_batch: bool = True
    #: Deliveries per consume burst (the burst callback's most rows).
    consume_batch_max: int = 256
    #: Ingress shard workers per queue: a burst's rows that the native
    #: decoder leaves to Python are consistent-hashed (crc32 of the
    #: correlation id) into N slices, each decoded on a worker thread, and
    #: the terminal-replay cache is split into N dicts by player id. 1 =
    #: one slice, decoded inline.
    ingress_shards: int = 1
    #: Probabilistic faults (one ``random.Random(Config.seed)`` stream, so
    #: their order follows the event loop's): a delivery dropped before
    #: its handler runs (requeued), a publish delivered twice, and a delay
    #: before each delivery is handled. ``ChaosConfig`` has the seeded,
    #: replayable twins of the first two.
    drop_prob: float = 0.0
    dup_prob: float = 0.0
    delay_ms: float = 0.0


@dataclass(frozen=True)
class BatcherConfig:
    """Request windowing: collect a batch per queue, dispatch one step."""

    max_batch: int = 1024
    max_wait_ms: float = 5.0


@dataclass(frozen=True)
class AuthConfig:
    """Auth middleware (service/middleware.py): ``"none"`` (off),
    ``"static"`` (the request's ``authorization`` header must start with a
    shared secret) or ``"rpc"`` (a round trip over the broker to an auth
    service's queue, whose reply must be ``b"ok"``)."""

    mode: str = "none"
    static_secret: str = "open-matchmaking"
    rpc_queue: str = "auth.token.verify"
    rpc_timeout_ms: float = 250.0


@dataclass(frozen=True)
class OverloadConfig:
    """Overload control (service/overload.py): per-queue admission with a
    credit limiter and a waiting-pool cap, QoS tiers, deadline propagation
    and expiry, earliest-deadline-first window cutting and adaptive
    shedding. Every decision is a pure function of the controller's counts
    at the decision point."""

    #: Most admitted-but-unsettled deliveries per queue (a credit is held
    #: from admission to the delivery's ack or nack); 0 = unlimited. The
    #: broker consumer's prefetch is raised to twice this.
    max_inflight: int = 0
    #: Most waiting players counted at admission (the live pool plus the
    #: admitted credits on their way into it); 0 = unlimited.
    max_waiting: int = 0
    #: At the waiting cap: ``"reject"`` sheds the arriving request;
    #: ``"oldest"`` admits it and sheds the longest-waiting pool player of
    #: the lowest tier instead, at the dispatch.
    shed_policy: str = "reject"
    #: Retry-after hint (ms) carried on shed responses.
    retry_after_ms: float = 1000.0
    #: Requests without an ``x-deadline`` header get one at admission:
    #: first-received + this budget (ms; 0 = none stamped).
    default_deadline_ms: float = 0.0
    #: QoS tiers (``x-tier`` header, 0 = the most latency-critical; a
    #: missing header reads as the queue's ``default_tier``). Every cap is
    #: split into a nested ladder, so the lowest tier is shed first.
    tiers: int = 1
    #: Share of each cap tier ``t`` may fill, counting tiers 0..t only
    #: (element 0 is forced to 1.0; () = the equal ladder (tiers-t)/tiers).
    tier_shares: tuple[float, ...] = ()
    #: Earliest-deadline-first window cutting: the batcher and the flush
    #: order a window by (tier, absolute deadline), stable within equal
    #: keys.
    edf: bool = False
    #: Sweep the waiting pool's per-player ``x-deadline`` column this often
    #: (ms; 0 = off) and answer ``timeout`` exactly at each deadline.
    deadline_sweep_ms: float = 0.0
    #: Adaptive shedding: scale both caps by a credit fraction that
    #: tightens (``tighten_step``) while the pipeline is full or the stage
    #: p99 is over ``target_p99_ms``, and relaxes (``relax_step``) once
    #: both recover, within [``min_credit_fraction``, 1].
    adaptive: bool = False
    target_p99_ms: float = 250.0
    min_credit_fraction: float = 0.25
    tighten_step: float = 0.5
    relax_step: float = 1.25
    #: Graceful drain's checkpoint directory (``MatchmakingApp.drain``): the
    #: waiting pools, the admission state and the broker backlog are saved
    #: there, and ``serve`` restores them at its next start ("" = a drain
    #: without a checkpoint).
    drain_checkpoint_dir: str = ""
    #: Window-granular admission: the credit and occupancy ladder runs once
    #: per cut window at the top of the flush, in arrival order; ingress
    #: keeps only the pre-checks (expired at receive, draining). False =
    #: the per-delivery decision at ingress.
    batch_admission: bool = True

    def __post_init__(self) -> None:
        if self.shed_policy not in ("reject", "oldest"):
            raise ValueError(f"overload.shed_policy must be 'reject' or "
                             f"'oldest', not {self.shed_policy!r}")

    def enabled(self) -> bool:
        """Any admission, deadline or drain machinery configured? With none
        the ingress pays nothing for it."""
        return bool(self.max_inflight > 0 or self.max_waiting > 0
                    or self.default_deadline_ms > 0 or self.adaptive
                    or self.drain_checkpoint_dir or self.tiers > 1
                    or self.deadline_sweep_ms > 0)


@dataclass(frozen=True)
class DurabilityConfig:
    """Crash durability (utils/journal.py): a write-ahead journal per
    queue and periodic compaction snapshots, so a hard crash (OOM, host
    loss, ``kill -9``) recovers the waiting pool, the terminal-replay
    cache and the admission state. Admissions, matches, evictions and
    expiries append CRC-framed records, one per cut window, committed
    before the answers and acks they cover leave; a boot without the
    clean-shutdown marker replays the newest valid snapshot and the
    journal's tail into the engine."""

    #: Directory of the journal segments and snapshots ("" = off: no
    #: files, no work on the hot path).
    journal_dir: str = ""
    #: ``"none"``: no fsync (a process crash loses nothing written, a host
    #: loss may lose the tail); ``"interval"``: at most every
    #: ``fsync_interval_s``; ``"window"``: at every commit.
    fsync: str = "none"
    fsync_interval_s: float = 0.05
    #: Compact once the live segment holds this many records…
    compact_records: int = 50_000
    #: …or this many bytes. Compaction runs on the durability timer, with
    #: the pipeline drained and the pool held still.
    compact_bytes: int = 8 << 20
    #: The durability timer's cadence (seconds; 0 = no timer).
    compact_interval_s: float = 1.0
    #: Snapshot generations kept (a corrupt newest one falls back).
    keep_snapshots: int = 2

    def enabled(self) -> bool:
        return bool(self.journal_dir)


@dataclass(frozen=True)
class ChaosConfig:
    """The fault script (utils/chaos.py). Every decision is a pure function
    of an index or of a hash of one, so a run replays identically under
    any interleaving of the event loop:

    - broker faults, per queue publish sequence number (``drop_seqs``,
      ``dup_seqs``, ``partitions``) or decided by ``hash01(seed, ...)`` of
      the message's identity (``drop_prob``, ``dup_prob``);
    - engine faults, per device search-step index and breaker probe,
      counted outside the engine so the indices survive revives;
    - replication-link faults, per stream record seq (the ``repl_*``
      keys, read by ``service/replication.py``);
    - socket-transport faults (the ``net_*`` keys, read by
      ``net/nemesis.py``), per flow and frame seq. A flow is named by a
      substring of its id (``repl:<queue>:fwd``, ``repl:<queue>:ack``,
      ``lease:<owner>``); the seq is the record seq on a replication flow
      and a per-flow frame counter elsewhere."""

    seed: int = 0
    #: Queues the broker faults apply to; () = every queue, reply queues
    #: included.
    queues: tuple[str, ...] = ()
    #: Consume-side drop probability, decided per (queue, seq, attempt):
    #: the delivery is requeued before its handler runs.
    drop_prob: float = 0.0
    #: Publish-side duplicate probability, decided per (queue, seq).
    dup_prob: float = 0.0
    #: Publish seqs whose FIRST delivery attempt is dropped.
    drop_seqs: tuple[int, ...] = ()
    #: (seq, extra copies): that publish is delivered 1 + extra times.
    dup_seqs: tuple[tuple[int, int], ...] = ()
    #: [pause seq, resume seq): the queue's consumers pause when the pause
    #: seq is published and resume when the resume seq is.
    partitions: tuple[tuple[int, int], ...] = ()
    #: A paused queue resumes after this many seconds in any case.
    partition_max_s: float = 5.0
    #: Device search-step indices that raise ``ChaosInjectedError``.
    fail_steps: tuple[int, ...] = ()
    #: The same, as [start, stop) ranges.
    fail_step_ranges: tuple[tuple[int, int], ...] = ()
    #: The first N half-open breaker probes raise.
    fail_probes: int = 0
    #: Device-loss steps: they need the multi-GPU engine (ROADMAP Queue 1
    #: item 6) and are refused.
    device_lost_steps: tuple[int, ...] = ()
    #: Replication stream record seqs whose first transmission is dropped.
    repl_drop_seqs: tuple[int, ...] = ()
    #: Stream record seqs delivered twice.
    repl_dup_seqs: tuple[int, ...] = ()
    #: (seq, hold): the record is held until ``hold`` further first
    #: transmissions pass, then delivered late.
    repl_delay_seqs: tuple[tuple[int, int], ...] = ()
    #: [pause seq, resume seq): the link holds what it sends from the pause
    #: record's first transmission until any transmission reaches the
    #: resume seq.
    repl_partitions: tuple[tuple[int, int], ...] = ()
    #: Seeded stream drop probability, decided per (queue, seq).
    repl_drop_prob: float = 0.0
    #: Lease-renewal call indices the lease authority refuses.
    repl_fail_renewals: tuple[int, ...] = ()
    #: (flow, frame seq): the first transmission is dropped.
    net_drop_frames: tuple[tuple[str, int], ...] = ()
    #: (flow, frame seq): the first transmission is sent twice.
    net_dup_frames: tuple[tuple[str, int], ...] = ()
    #: (flow, seq, hold): the frame is held until ``hold`` further first
    #: transmissions pass, then sent late.
    net_delay_frames: tuple[tuple[str, int, int], ...] = ()
    #: (flow, seq): the sender closes the connection abruptly instead of
    #: sending the frame (a reconnect and the retransmitted tail carry it).
    net_reset_frames: tuple[tuple[str, int], ...] = ()
    #: (flow, pause seq, resume seq): frames are held at the sender from
    #: the pause seq's first transmission until any transmission reaches
    #: the resume seq.
    net_partitions: tuple[tuple[str, int, int], ...] = ()
    #: Flows whose inbound frames this process drops from the start (an
    #: asymmetric partition; heartbeats are dropped too).
    net_deaf_flows: tuple[str, ...] = ()
    #: Seeded frame-drop probability, decided per (seed, "net", flow, seq).
    net_drop_prob: float = 0.0
    #: (flow, bytes per second): the sender paces frames to this rate.
    net_bandwidth_caps: tuple[tuple[str, int], ...] = ()

    def __post_init__(self) -> None:
        if self.device_lost_steps:
            raise ValueError(
                "chaos.device_lost_steps needs the sharded multi-GPU engine "
                "(ROADMAP Queue 1 item 6), which the port does not carry yet")

    def enabled(self) -> bool:
        return bool(
            self.drop_prob > 0 or self.dup_prob > 0 or self.drop_seqs
            or self.dup_seqs or self.partitions or self.fail_steps
            or self.fail_step_ranges or self.fail_probes)

    def consume_faults(self) -> bool:
        """A consume-side broker fault is scripted."""
        return bool(self.drop_prob > 0 or self.drop_seqs)

    def publish_faults(self) -> bool:
        """A publish-side broker fault is scripted."""
        return bool(self.dup_prob > 0 or self.dup_seqs or self.partitions)

    def replication_faults(self) -> bool:
        """A replication-link fault is scripted."""
        return bool(
            self.repl_drop_seqs or self.repl_dup_seqs or self.repl_delay_seqs
            or self.repl_partitions or self.repl_drop_prob > 0
            or self.repl_fail_renewals)

    def net_faults(self) -> bool:
        """A socket-transport fault is scripted."""
        return bool(
            self.net_drop_frames or self.net_dup_frames
            or self.net_delay_frames or self.net_reset_frames
            or self.net_partitions or self.net_deaf_flows
            or self.net_drop_prob > 0 or self.net_bandwidth_caps)


@dataclass(frozen=True)
class ReplicationConfig:
    """Hot-standby replication with fenced failover
    (service/replication.py): the primary streams its write-ahead journal
    to a standby under a lease and an epoch. Needs durability (the journal
    is the stream) and a hub: a ``ReplicationHub`` or a
    ``SocketReplicationHub`` passed to
    ``MatchmakingApp(replication_hub=...)``, or ``NetConfig.transport``
    ``"socket"``, with which the app builds and owns its own."""

    #: "" = off (no journal tap, no fence checks, no pump); "primary" =
    #: this app streams and serves. The standby is the hub's
    #: ``StandbyApplier``, not an app role.
    role: str = ""
    #: This host's lease identity; a failover successor boots with the
    #: owner that took the queue over.
    owner: str = "primary"
    #: The sender's pump cadence (seconds): acks, retransmission of a
    #: stalled tail, lease renewal, the lag gauges.
    pump_interval_s: float = 0.02

    def enabled(self) -> bool:
        if self.role and self.role != "primary":
            raise ValueError(
                f"unknown replication role {self.role!r} (\"\" or "
                f"\"primary\"; the standby is a hub-side StandbyApplier, "
                f"not an app role)")
        return bool(self.role)


@dataclass(frozen=True)
class NetConfig:
    """The socket transport under replication and the lease (net/):
    length-prefixed, CRC-framed messages over Unix-domain or TCP sockets,
    heartbeats with a deadline-based liveness verdict, seeded reconnect
    backoff and bounded send buffers. Addresses are ``"unix:/path.sock"``
    or ``"tcp:host:port"``. ``lease_rtt_budget_s`` is taken off every
    lease grant the remote client caches, so a renewal still in flight
    when the budgeted deadline passes does not count."""

    #: "inproc" (the in-process fabric, no sockets) or "socket" (an app
    #: with replication on and no hub passed builds a
    #: ``SocketReplicationHub`` from the addresses below).
    transport: str = "inproc"
    #: The lease service's address ("": an embedded loopback service).
    lease_addr: str = ""
    #: Where this primary streams its records (the standby's listen
    #: address); "" with a ``lease_addr``: the hub needs ``set_target``
    #: before a queue attaches (``link()`` raises without one).
    repl_target: str = ""
    #: Dial timeout of one connect attempt (seconds).
    connect_timeout_s: float = 1.0
    #: Timeout of a blocking lease request (acquire, takeover, expired,
    #: release, the re-confirm of a lapsed lease).
    request_timeout_s: float = 1.0
    #: Heartbeat cadence per connection.
    heartbeat_interval_s: float = 0.1
    #: No inbound frame for this long: the peer is dead (counted as
    #: ``liveness_lost``; the connection closes and redials).
    heartbeat_timeout_s: float = 0.6
    #: Reconnect backoff: min(cap, base · 2^attempt), scaled into
    #: [0.5, 1] by ``hash01(seed, "backoff", conn, attempt)``.
    reconnect_base_s: float = 0.02
    reconnect_cap_s: float = 1.0
    #: A frame larger than this is refused at encode and a header that
    #: announces more is a ``FrameError`` (the connection dies).
    max_frame_bytes: int = 1 << 20
    #: Bounded send buffer per link: past it a send is dropped and counted
    #: (``backpressure_dropped``).
    send_buffer_bytes: int = 4 << 20
    #: Taken off every cached lease grant: a grant sent at t is valid
    #: until t + lease_s − this.
    lease_rtt_budget_s: float = 0.05

    def enabled(self) -> bool:
        if self.transport not in ("", "inproc", "socket"):
            raise ValueError(
                f"unknown net transport {self.transport!r} "
                f"(\"inproc\" or \"socket\")")
        return self.transport == "socket"


@dataclass(frozen=True)
class ObservabilityConfig:
    """The JAX package's observability keys: tracing (utils/trace.py:
    trace contexts stamped at broker publish, the flight recorder, the
    event log, the per-stage histograms), the ``/debug/profile`` capture
    directory, the telemetry sampler and the SLO burn monitors
    (utils/timeseries.py), the attribution's SLO target
    (service/attribution.py) and match quality (engine/quality.py,
    service/quality.py)."""

    #: Trace-context stamping and flight recording; on, as in the JAX
    #: package.
    trace: bool = True
    #: Trace every Nth request publish (1: every one). With N > 1 a
    #: delivery the broker did not stamp stays untraced.
    trace_sample_n: int = 1
    #: Settled traces kept per queue.
    trace_ring: int = 256
    #: Slow-trace exemplars kept per queue.
    slow_trace_ring: int = 64
    #: A settled trace whose enqueue→publish span reaches this is kept in
    #: the slow ring.
    slow_trace_ms: float = 250.0
    #: Lifecycle events kept in the event log.
    event_ring: int = 512
    #: Stage histogram upper bounds in seconds; () → 100 µs · 2^k, 24
    #: buckets (utils/metrics.DEFAULT_STAGE_BUCKETS).
    stage_buckets: tuple[float, ...] = ()
    #: Where ``/debug/profile?secs=N`` writes its torch.profiler Chrome
    #: trace; "" → one temporary directory per server lifetime.
    profile_dir: str = ""
    #: The telemetry sampler (utils/timeseries.TelemetryRing): a snapshot
    #: of per-queue signals (pool size, batch fill, breaker state,
    #: shed/expired, stage p99, work/wait, SLO good/total, device busy/idle,
    #: speculation) every this many seconds; 0 disables the sampler.
    snapshot_interval_s: float = 1.0
    #: Snapshots kept in the telemetry ring (newest wins).
    telemetry_ring: int = 512
    #: A settled trace is good for the attribution's SLO counters when it
    #: was served (matched, queued, deduped) within this many ms; with a
    #: target the app runs SLO burn monitors (0: off).
    slo_target_ms: float = 0.0
    #: The fraction of requests that must be good.
    slo_objective: float = 0.99
    #: The burn monitors' fast and slow windows: a queue burns (a
    #: ``slo_burn`` event, the ``slo_burning`` gauge) when both windows'
    #: burn rates reach ``slo_burn_threshold``.
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 300.0
    slo_burn_threshold: float = 1.0

    #: Rating-bucket edges of the quality accounting (() → the default
    #: eight buckets around N(1500, 300)).
    quality_rating_edges: tuple[float, ...] = ()
    #: Linear quality-histogram buckets over [0, 1].
    quality_buckets: int = 20
    #: Wait-at-match bucket upper bounds in seconds (() → 1 ms · 2^k, 22
    #: buckets, plus an overflow bucket).
    quality_wait_buckets: tuple[float, ...] = ()
    #: The engine reads its device-resident quality state back every this
    #: many finalized windows (without blocking); ``flush()`` reads it at
    #: once.
    quality_report_every: int = 16
    #: A matched player is good when the match quality is at least this
    #: (0 disables the service ledger's good/total counters).
    quality_slo_target: float = 0.0
    #: Fraction of matched players that must be good.
    quality_slo_objective: float = 0.9


@dataclass(frozen=True)
class ForensicsConfig:
    """The JAX package's forensics section (utils/forensics.py): the event
    spine's ring and the incident capture, which freezes the app's rings
    into a schema-versioned bundle when a trigger kind is stamped (SLO
    burn and its clearing, breaker trip, crash recovery, ...)."""

    #: Events kept in the app's causal ring.
    spine_ring: int = 4096
    #: Incident capture on (the spine runs either way).
    capture: bool = True
    #: Where bundles are written as JSON; "" keeps them in memory only.
    incident_dir: str = ""
    #: Bundles kept in memory (newest wins).
    incident_ring: int = 16
    #: Bundle files kept under ``incident_dir`` (oldest removed).
    retention_files: int = 32
    #: Least seconds between two captures of one trigger class; a capture
    #: dropped by it is counted (``incidents_dropped``).
    min_interval_s: float = 5.0
    #: Spine events frozen per bundle.
    spine_window: int = 512
    #: Telemetry snapshots frozen per bundle.
    telemetry_tail: int = 32
    #: Slow-trace exemplars frozen per queue per bundle.
    trace_slice: int = 8
    #: Placement and autotune audit records frozen per bundle.
    audit_slice: int = 32
    #: A placement action whose blackout exceeds this many ms triggers a
    #: capture (0: that trigger off).
    blackout_budget_ms: float = 0.0
    #: Knob moves remembered per (queue, knob) by the autotune oscillation
    #: detector.
    oscillation_window: int = 8

    def enabled(self) -> bool:
        return self.capture


_SECTIONS = {"engine": EngineConfig, "broker": BrokerConfig,
             "batcher": BatcherConfig, "auth": AuthConfig,
             "overload": OverloadConfig, "chaos": ChaosConfig,
             "observability": ObservabilityConfig,
             "durability": DurabilityConfig, "replication": ReplicationConfig,
             "net": NetConfig, "forensics": ForensicsConfig}


#: Top-level scalar keys the port carries (the JAX package's ``workers``
#: is not carried).
_SCALARS = ("seed", "debug_invariants", "metrics_port", "metrics_host")


def _tuples(v):
    """JSON lists → tuples, nested ones too (``fail_step_ranges``)."""
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _known(cls, section: str, d: Mapping[str, Any]) -> dict[str, Any]:
    """Drop keys the port does not carry (logged, not fatal) and turn JSON
    lists into tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for k, v in d.items():
        if k not in names:
            logging.getLogger(__name__).warning(
                "config: ignoring %s.%s (not carried by the port)", section, k)
            continue
        out[k] = _tuples(v)
    return out


@dataclass(frozen=True)
class Config:
    queues: tuple[QueueConfig, ...] = (QueueConfig(),)
    engine: EngineConfig = field(default_factory=EngineConfig)
    broker: BrokerConfig = field(default_factory=BrokerConfig)
    batcher: BatcherConfig = field(default_factory=BatcherConfig)
    auth: AuthConfig = field(default_factory=AuthConfig)
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    #: Write-ahead journal and crash recovery (off by default).
    durability: DurabilityConfig = field(default_factory=DurabilityConfig)
    #: Hot-standby replication and fenced failover (off by default;
    #: needs durability).
    replication: ReplicationConfig = field(default_factory=ReplicationConfig)
    #: The socket transport under replication and the lease ("inproc" by
    #: default: no sockets).
    net: NetConfig = field(default_factory=NetConfig)
    #: The fault script (empty: no broker fault, no engine hook).
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    #: The event spine's ring and the incident capture.
    forensics: ForensicsConfig = field(default_factory=ForensicsConfig)
    #: The HTTP observability server's port (service/observability.py:
    #: /healthz, /metrics, /debug/*); 0: no server.
    metrics_port: int = 0
    #: Its bind host (containers set ``0.0.0.0``).
    metrics_host: str = "127.0.0.1"
    #: Seeds the broker's probabilistic faults (``BrokerConfig.drop_prob``
    #: and ``dup_prob``).
    seed: int = 0
    #: Online invariant checking (utils/invariants.py): no player in two
    #: matches without a re-queue between, well-formed teams. One dict op
    #: per matched player.
    debug_invariants: bool = False

    @staticmethod
    def from_dict(d: Mapping[str, Any], *, backend: str | None = None) -> "Config":
        """Build a Config; ``backend`` overrides ``engine.backend``."""
        kw: dict[str, Any] = {}
        if "queues" in d:
            kw["queues"] = tuple(QueueConfig(**_known(QueueConfig, "queues", q))
                                 for q in d["queues"])
        for name, cls in _SECTIONS.items():
            if name in d:
                kw[name] = cls(**_known(cls, name, d[name]))
        for scalar in _SCALARS:
            if scalar in d:
                kw[scalar] = d[scalar]
        for name in d:
            if name not in _SECTIONS and name not in _SCALARS \
                    and name != "queues" and not name.startswith("_"):
                logging.getLogger(__name__).warning(
                    "config: ignoring section %r (not carried by the port)",
                    name)
        cfg = Config(**kw)
        if backend is not None:
            cfg = dataclasses.replace(
                cfg, engine=dataclasses.replace(cfg.engine, backend=backend))
        return cfg

    @staticmethod
    def from_json(path: str, *, backend: str | None = None) -> "Config":
        with open(path) as f:
            return Config.from_dict(json.load(f), backend=backend)

    @staticmethod
    def from_env(prefix: str = "MM_", *, backend: str = "gpu") -> "Config":
        """A Config from ``MM_*`` variables, under the JAX package's names:
        ``MM_<SECTION>_<KEY>`` (``MM_DURABILITY_JOURNAL_DIR``) with values
        parsed as JSON where they parse; ``MM_CONFIG_JSON=<path>`` loads a
        whole tree first (the variables win over it) and
        ``MM_QUEUE_NAMES=a,b`` keeps only the named queues;
        ``MM_SEED``, ``MM_DEBUG_INVARIANTS``, ``MM_METRICS_PORT`` and
        ``MM_METRICS_HOST`` set the top-level scalars. The engine
        backend is ``backend`` unless ``MM_ENGINE_BACKEND`` names one: the
        files say the JAX package's ``"tpu"``."""
        env = {k[len(prefix):].lower(): v for k, v in os.environ.items()
               if k.startswith(prefix)}
        d: dict[str, Any] = {}
        if "config_json" in env:
            with open(env.pop("config_json")) as f:
                d = json.load(f)
        queue_names = env.pop("queue_names", None)
        for key, raw in env.items():
            try:
                val: Any = json.loads(raw)
            except ValueError:
                val = raw
            if key in _SCALARS:
                d[key] = val
                continue
            section, _, name = key.partition("_")
            if name:
                d.setdefault(section, {})[name] = val
        chosen = (d.get("engine") or {}).get("backend") \
            if "engine_backend" in env else backend
        cfg = Config.from_dict(d, backend=chosen)
        if queue_names is not None:
            names = [n for n in str(queue_names).split(",") if n]
            keep = tuple(q for q in cfg.queues if q.name in names)
            missing = set(names) - {q.name for q in keep}
            if missing:
                raise KeyError(
                    f"MM_QUEUE_NAMES not in config: {sorted(missing)}")
            cfg = dataclasses.replace(cfg, queues=keep)
        return cfg
