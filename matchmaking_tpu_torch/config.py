"""Typed configuration for the PyTorch/CUDA port.

The port's own copy of the configuration tree, trimmed to what the window
engines (1v1, team and role queues) and the service read, under the JAX
package's names and defaults. ``Config.from_json`` reads the repository's
``configs/*.json`` files; those name the JAX package's ``"tpu"`` backend,
so the loader takes the port's backend as an explicit override
(``Config.from_json(path, backend="gpu")``) instead of reinterpreting the
JAX name. Sections and keys the port does not carry yet (chaos, durability,
most of overload, ...) are ignored with a warning.
"""

from __future__ import annotations

import dataclasses
import json
import logging
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

    #: ``"gpu"`` → the batched PyTorch/CUDA engine (engine/gpu.py). The
    #: repository's JSON files say ``"tpu"``; override it at load time.
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
    #: The service's health timer (seconds; 0 disables): each queue's
    #: heartbeat moves an idle team or role queue that was handed to the
    #: host oracle back onto the card once its blockers drained,
    #: independent of the rescan loop (configs #3 and #5 run none). The
    #: JAX package's timer also drives breaker probes; the port's does not.
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


@dataclass(frozen=True)
class BatcherConfig:
    """Request windowing: collect a batch per queue, dispatch one step."""

    max_batch: int = 1024
    max_wait_ms: float = 5.0


@dataclass(frozen=True)
class AuthConfig:
    """Auth middleware; this slice serves ``mode="none"`` only."""

    mode: str = "none"


@dataclass(frozen=True)
class OverloadConfig:
    """The one overload knob the port carries: the pool-resident deadline
    sweep (admission control, shedding and EDF are not ported yet)."""

    #: Sweep the waiting pool's per-player ``x-deadline`` column this often
    #: (ms; 0 = off) and answer ``timeout`` exactly at each deadline.
    deadline_sweep_ms: float = 0.0


@dataclass(frozen=True)
class ObservabilityConfig:
    """The match-quality keys of the JAX package's observability section
    (engine/quality.py, service/quality.py); its tracing, SLO and
    telemetry keys are not carried."""

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


_SECTIONS = {"engine": EngineConfig, "broker": BrokerConfig,
             "batcher": BatcherConfig, "auth": AuthConfig,
             "overload": OverloadConfig,
             "observability": ObservabilityConfig}


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
        out[k] = tuple(v) if isinstance(v, list) else v
    return out


@dataclass(frozen=True)
class Config:
    queues: tuple[QueueConfig, ...] = (QueueConfig(),)
    engine: EngineConfig = field(default_factory=EngineConfig)
    broker: BrokerConfig = field(default_factory=BrokerConfig)
    batcher: BatcherConfig = field(default_factory=BatcherConfig)
    auth: AuthConfig = field(default_factory=AuthConfig)
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)

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
        for name in d:
            if name not in _SECTIONS and name != "queues" \
                    and not name.startswith("_"):
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
