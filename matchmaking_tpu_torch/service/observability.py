"""The HTTP observability server: /healthz, /metrics and /debug/*.

The port's copy of ``matchmaking_tpu/service/observability.py``: the same
eleven routes, bodies and query parameters, over aiohttp on the app's own
event loop. ``MatchmakingApp.start`` starts it when ``Config.metrics_port``
is set; ``stop`` and ``crash`` stop it, and ``drain`` only after the drain
completes, so ``/healthz`` answers ``draining`` for the whole drain.

- ``/healthz``: per queue the configured backend, the live engine class
  (``GpuEngine``, or ``CpuEngine`` while the breaker demotes the queue),
  pool size, breaker, overload and SLO monitors; ``status`` is
  ``draining``, then ``degraded`` (a breaker not closed), then ``ok``;
  the burning monitors and the incident counters.
- ``/metrics``: the JSON report (``build_report``); ``?format=prom``
  renders Prometheus exposition text (one ``# TYPE`` line per family,
  escaped label values, the stage, quality and wait histograms as
  histogram families).
- ``/debug/traces`` (``?queue=``, ``?id=``, ``?n=``), ``/debug/attribution``
  (``?queue=``, ``?p=``: the exemplar's decomposition),
  ``/debug/quality`` (``?queue=``), ``/debug/telemetry`` (``?n=``,
  ``?key=``), ``/debug/events`` (``?queue=``, ``?n=``),
  ``/debug/incidents`` (``?id=``, ``?bundles=1``).
- ``/debug/placement`` (``?n=``): the placement controller's snapshot
  (bindings, decision ring, blackouts, the arbiter, each queue's live
  binding and engine class), each bucketed queue's
  ``formation_report()`` and the device-loss failover audit; the JAX
  package's 404 body when all three are empty. ``/debug/autotune``: the
  autotuner's target, ranges, knobs and decision ring (``?n=``), or the
  JAX package's 404 body without one.
- ``/debug/profile?secs=N`` (0.05-30 s): a ``torch.profiler`` capture of
  the live process (CPU activity, and CUDA when any queue's engine is on
  the card), exported as a Chrome trace under
  ``ObservabilityConfig.profile_dir`` or one temporary directory per server
  lifetime. One capture at a time (409); a non-number ``secs`` is a 400.

A scrape and a telemetry tick read host state only: no handler but the
profile's waits for the device.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Any

try:
    from aiohttp import web
except ImportError:  # pragma: no cover - aiohttp is installed with the port
    web = None

from matchmaking_tpu_torch.service.attribution import decompose


def build_report(app) -> dict[str, Any]:
    """The full /metrics JSON payload for a MatchmakingApp — module-level so
    non-HTTP consumers (the smoke, tests) share one report shape with the
    endpoint. Reads host state only: ``util_report`` and ``quality_report``
    read no device memory."""
    report = app.metrics.report()
    report["pools"] = {
        name: rt.engine.pool_size()
        for name, rt in app._runtimes.items()
    }
    # Dedup-cache occupancy: a long dedup_ttl_s under a high match rate
    # holds one TTL's worth of encoded bodies per queue. Via the public
    # accessor, not the private cache.
    report["dedup_cache"] = {
        name: rt.dedup_cache_size()
        for name, rt in app._runtimes.items()
        if hasattr(rt, "dedup_cache_size")
    }
    report["broker"] = dict(app.broker.stats)
    # Engine lifecycle counters (e.g. team_delegated/team_repromoted:
    # the wildcard delegation round-trip must be visible, not silent).
    counters = {
        name: dict(rt.engine.counters)
        for name, rt in app._runtimes.items()
        if getattr(rt.engine, "counters", None)
    }
    if counters:
        report["engine_counters"] = counters
    # Circuit-breaker state (service/breaker.py): live snapshots so
    # time_degraded_s includes the current open stretch, not just the
    # gauge written at the last transition.
    now = time.time()
    breakers = {
        name: rt.breaker.snapshot(now)
        for name, rt in app._runtimes.items()
        if getattr(rt, "breaker", None) is not None
    }
    if breakers:
        report["breakers"] = breakers
    # Overload admission control (service/overload.py): credits held,
    # adaptive credit fraction, shed/expired totals, drain state — the
    # shed story must be readable from /metrics alone.
    overload = {
        name: rt.admission.snapshot()
        for name, rt in app._runtimes.items()
        if getattr(rt, "admission", None) is not None
    }
    if overload:
        report["overload"] = overload
    # Device-utilization counters: monotone busy/idle seconds +
    # h2d/step/readback split + effective occupancy per device-engine
    # queue — idle FRACTION over any interval is a delta of two scrapes.
    util = {
        name: rt.engine.util_report()
        for name, rt in app._runtimes.items()
        if hasattr(rt.engine, "util_report")
    }
    if util:
        report["device_util"] = util
    # Crash durability: per-queue journal accounting (live
    # seq, segment growth, lifetime write amplification) + the last
    # hard-crash recovery record — the RTO story must be readable from
    # /metrics alone.
    durability = {
        name: {
            "seq": rt.journal.seq,
            "synced_seq": rt.journal.synced_seq,
            "fsync": rt.journal.fsync,
            "segment_records": rt.journal.segment_records,
            "segment_bytes": rt.journal.segment_bytes,
            "bytes_written": rt.journal.bytes_written,
            "payload_bytes": rt.journal.payload_bytes,
            "write_amplification": (
                round(rt.journal.bytes_written
                      / rt.journal.payload_bytes, 3)
                if rt.journal.payload_bytes else None),
            "last_recovery": rt.last_recovery,
        }
        for name, rt in app._runtimes.items()
        if getattr(rt, "journal", None) is not None
    }
    if durability:
        report["durability"] = durability
    # Hot-standby replication: per-queue role/epoch/watermark block.
    replication = {
        name: rt.replication.snapshot()
        for name, rt in app._runtimes.items()
        if rt.replication is not None
    }
    if replication:
        report["replication"] = replication
    # Critical-path attribution + SLO burn state.
    attribution = getattr(app, "attribution", None)
    if attribution is not None:
        report["attribution"] = attribution.snapshot()
    slo = {
        name: mon.snapshot()
        for name, mon in getattr(app, "_slo_monitors", {}).items()
    }
    if slo:
        report["slo"] = slo
    telemetry = getattr(app, "telemetry", None)
    if telemetry is not None:
        latest = telemetry.latest()
        if latest is not None:
            report["telemetry_last"] = latest
    # Match-quality & fairness: the service-level per-queue/
    # per-tier ledger plus each engine's per-rating-bucket report (device
    # accumulator snapshot / host equivalent — lock-free cached reads).
    quality = getattr(app, "quality", None)
    if quality is not None:
        report["quality"] = quality.snapshot()
    engine_quality = {}
    for name, rt in app._runtimes.items():
        rep = (rt.engine.quality_report()
               if hasattr(rt.engine, "quality_report") else None)
        if rep is not None:
            engine_quality[name] = rep
    if engine_quality:
        report["quality_engine"] = engine_quality
    # Incident forensics: capture/drop counters, per-class
    # split and bundle summaries — the black box must be discoverable
    # from /metrics (and prom, via the incidents_* counters) without
    # knowing /debug/incidents exists.
    incidents = getattr(app, "incidents", None)
    if incidents is not None:
        report["incidents"] = incidents.snapshot()
    return report


def _esc(value: Any) -> str:
    """Prometheus label-value escaping (exposition format spec: backslash,
    double-quote and newline must be escaped inside quoted label values)."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_labels(labels: dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


class _PromFamilies:
    """Collects samples grouped by metric family so the exposition text
    carries exactly ONE ``# TYPE`` line per family, before its samples."""

    def __init__(self) -> None:
        self._fams: dict[str, tuple[str, list[str]]] = {}

    def add(self, family: str, mtype: str, labels: dict[str, Any],
            value: Any, suffix: str = "") -> None:
        fam = self._fams.get(family)
        if fam is None:
            fam = self._fams[family] = (mtype, [])
        fam[1].append(f"{family}{suffix}{_fmt_labels(labels)} {value}")

    def render(self) -> str:
        lines: list[str] = []
        for family in sorted(self._fams):
            mtype, samples = self._fams[family]
            lines.append(f"# TYPE {family} {mtype}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"


def _flatten_prom(report: dict[str, Any]) -> str:
    """Report dict → valid Prometheus exposition text."""
    fams = _PromFamilies()
    for name, value in report.get("counters", {}).items():
        fams.add(f"matchmaking_{name}", "counter", {}, value)
    for name, value in report.get("gauges", {}).items():
        # Gauge names may carry a [queue] suffix → a prom label; several
        # queues then share ONE family (and its single TYPE line).
        base, _, queue = name.partition("[")
        labels = {"queue": queue.rstrip("]")} if queue else {}
        fams.add(f"matchmaking_{base}", "gauge", labels, value)
    for queue, snap in report.get("breakers", {}).items():
        for stat in ("trips", "probes", "probe_failures"):
            fams.add(f"matchmaking_breaker_{stat}", "counter",
                     {"queue": queue}, snap[stat])
    for series, summary in report.get("latency", {}).items():
        # A series named "x[queue]" (the replication ack lag) is the
        # family x_<stat> with a queue label, as a gauge's name is.
        base, _, queue = series.partition("[")
        labels = {"queue": queue.rstrip("]")} if queue else {}
        for stat, value in summary.items():
            fams.add(f"matchmaking_{base}_{stat}", "gauge", labels, value)
    for queue, depth in report.get("pools", {}).items():
        fams.add("matchmaking_pool_size", "gauge", {"queue": queue}, depth)
    for queue, size in report.get("dedup_cache", {}).items():
        fams.add("matchmaking_dedup_cache_size", "gauge",
                 {"queue": queue}, size)
    for queue, counters in report.get("engine_counters", {}).items():
        for stat, value in counters.items():
            fams.add(f"matchmaking_engine_{stat}", "counter",
                     {"queue": queue}, value)
    # Device utilization (monotone counters + one gauge): idle fraction
    # between any two scrapes is delta(idle) / delta(busy + idle).
    for queue, u in report.get("device_util", {}).items():
        fams.add("matchmaking_device_busy_seconds", "counter",
                 {"queue": queue}, u["device_busy_s"])
        fams.add("matchmaking_device_idle_seconds", "counter",
                 {"queue": queue}, u["device_idle_s"])
        fams.add("matchmaking_device_readback_seconds", "counter",
                 {"queue": queue}, u["readback_s"])
        fams.add("matchmaking_device_effective_occupancy", "gauge",
                 {"queue": queue}, u["effective_occupancy"])
    # Attribution work/wait: cumulative seconds per queue and per category
    # (counters — rate() in PromQL gives the live wait-vs-work split).
    for queue, entry in report.get("attribution", {}).get("queues",
                                                          {}).items():
        fams.add("matchmaking_attributed_work_seconds", "counter",
                 {"queue": queue}, entry["work_s"])
        fams.add("matchmaking_attributed_wait_seconds", "counter",
                 {"queue": queue}, entry["wait_s"])
        for cat, c in entry.get("categories", {}).items():
            fams.add("matchmaking_attribution_seconds", "counter",
                     {"queue": queue, "category": cat, "kind": c["kind"]},
                     c["total_s"])
        # Per-QoS-tier work/wait split (tiered serving): cumulative, so
        # rate() gives the live per-tier wait fraction.
        for t, ts in entry.get("tiers", {}).items():
            fams.add("matchmaking_attributed_work_seconds", "counter",
                     {"queue": queue, "tier": t}, ts["work_s"])
            fams.add("matchmaking_attributed_wait_seconds", "counter",
                     {"queue": queue, "tier": t}, ts["wait_s"])
        rescan = entry.get("rescan")
        if rescan:
            fams.add("matchmaking_rescan_attributed_seconds", "counter",
                     {"queue": queue}, rescan["total_s"])
            fams.add("matchmaking_rescan_windows", "counter",
                     {"queue": queue}, rescan["windows"])
    # Match-quality & fairness families. Per-queue/per-tier
    # quality histogram from the service ledger…
    q_meta = report.get("quality", {})
    n_q = int(q_meta.get("quality_buckets", 0) or 0)
    for queue, entry in q_meta.get("queues", {}).items():
        for tier, tq in entry.get("tiers", {}).items():
            labels = {"queue": queue, "tier": tier}
            counts = tq.get("quality_hist", [])
            cum = 0
            for k, c in enumerate(counts):
                cum += int(c)
                le = format((k + 1) / max(1, n_q or len(counts)), ".6g")
                fams.add("matchmaking_match_quality", "histogram",
                         {**labels, "le": le}, cum, suffix="_bucket")
            fams.add("matchmaking_match_quality", "histogram",
                     {**labels, "le": "+Inf"}, cum, suffix="_bucket")
            fams.add("matchmaking_match_quality", "histogram", labels,
                     tq.get("quality_sum", 0.0), suffix="_sum")
            fams.add("matchmaking_match_quality", "histogram", labels,
                     tq.get("count", 0), suffix="_count")
    # …and the per-RATING-BUCKET wait-at-match histogram from the engine
    # accumulators (the fairness axis), plus the disparity gauges.
    for queue, rep in report.get("quality_engine", {}).items():
        for b in rep.get("buckets", ()):
            if not b.get("count"):
                continue
            labels = {"queue": queue, "bucket": b["bucket"]}
            for le, cum in b.get("wait_le", {}).items():
                fams.add("matchmaking_wait_at_match_seconds", "histogram",
                         {**labels, "le": le}, cum, suffix="_bucket")
            fams.add("matchmaking_wait_at_match_seconds", "histogram",
                     labels, b.get("wait_sum_s", 0.0), suffix="_sum")
            fams.add("matchmaking_wait_at_match_seconds", "histogram",
                     labels, b["count"], suffix="_count")
            fams.add("matchmaking_bucket_quality_mean", "gauge", labels,
                     b.get("quality_mean") or 0.0)
        disp = rep.get("disparity", {})
        fams.add("matchmaking_quality_disparity", "gauge", {"queue": queue},
                 disp.get("quality_gap", 0.0))
        fams.add("matchmaking_wait_p90_disparity_seconds", "gauge",
                 {"queue": queue}, disp.get("wait_p90_gap_s", 0.0))
        if rep.get("quality_mean") is not None:
            fams.add("matchmaking_quality_mean", "gauge", {"queue": queue},
                     rep["quality_mean"])
    # Incident forensics: the aggregate incidents_captured /
    # incidents_dropped counters already flow through the counters block
    # above; the per-trigger-class split gets its own labeled family so
    # alert rules can page on "failover captured a bundle" specifically.
    for cls, n in report.get("incidents", {}).get("by_class", {}).items():
        fams.add("matchmaking_incidents_by_class", "counter",
                 {"class": cls}, n)
    # True per-stage latency histograms (the flight recorder's output) as a
    # proper histogram family: cumulative le buckets + _sum + _count.
    for queue, stages in report.get("stage_seconds", {}).items():
        for stage, hist in stages.items():
            labels = {"queue": queue, "stage": stage}
            for le, cum in hist["le"].items():
                fams.add("matchmaking_stage_seconds", "histogram",
                         {**labels, "le": le}, cum, suffix="_bucket")
            fams.add("matchmaking_stage_seconds", "histogram", labels,
                     hist["sum_s"], suffix="_sum")
            fams.add("matchmaking_stage_seconds", "histogram", labels,
                     hist["count"], suffix="_count")
    return fams.render()


class ObservabilityServer:
    """Owns the aiohttp runner; start()/stop() from the app's event loop."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 9100):
        if web is None:
            raise RuntimeError("aiohttp unavailable: observability disabled")
        self.app = app
        self.host = host
        self.port = port
        self._runner: Any = None
        self._site: Any = None
        self._profiling = False
        #: One capture directory per server lifetime: a fresh temporary
        #: directory per request would leak directories.
        self._profile_dir = ""
        #: Captures exported so far (each trace file's number).
        self._profiles = 0

    def _report(self) -> dict[str, Any]:
        return build_report(self.app)

    async def _healthz(self, request) -> "web.Response":
        now = time.time()
        queues: dict[str, Any] = {}
        degraded: list[str] = []
        monitors = getattr(self.app, "_slo_monitors", {})
        for name, rt in self.app._runtimes.items():
            entry: dict[str, Any] = {
                "backend": rt.app.cfg.engine.backend,
                # The LIVE engine class, not the configured backend: a
                # breaker-demoted queue reports the host oracle it runs on.
                "engine": type(rt.engine).__name__,
                "pool_size": rt.engine.pool_size(),
                "team_size": rt.queue_cfg.team_size,
            }
            breaker = getattr(rt, "breaker", None)
            if breaker is not None:
                entry["breaker"] = breaker.snapshot(now)
                if breaker.state != "closed":
                    degraded.append(name)
            admission = getattr(rt, "admission", None)
            if admission is not None:
                entry["overload"] = admission.snapshot()
            monitor = monitors.get(name)
            if monitor is not None:
                entry["slo"] = monitor.snapshot()
            # The per-tier burn monitors ("queue@tN"): which tier burns.
            tier_mons = {k.rsplit("@", 1)[1]: m.snapshot()
                         for k, m in monitors.items()
                         if k.startswith(name + "@t")}
            if tier_mons:
                entry["slo_tiers"] = tier_mons
            q_mon = monitors.get(name + "#quality")
            if q_mon is not None:
                entry["slo_quality"] = q_mon.snapshot()
            # The replication role and lag: a fenced queue is degraded (a
            # load balancer stops routing here: its successor owns it).
            repl = rt.replication
            if repl is not None:
                entry["replication"] = {
                    "role": repl.role,
                    "epoch": repl.epoch,
                    "lag": repl.lag(),
                    "acked_seq": repl.acked_seq,
                    "sent_seq": repl.sent_seq,
                }
                if repl.role == "fenced":
                    degraded.append(name)
            queues[name] = entry
        burning = [key for key, mon in monitors.items() if mon.burning]
        body = {
            # Degraded is not dead (matches still flow on the host path);
            # draining trumps both: a load balancer must stop routing here.
            "status": ("draining" if any(
                q.get("overload", {}).get("draining") for q in queues.values())
                else "degraded" if degraded else "ok"),
            "degraded_queues": degraded,
            # SLO burn is orthogonal to liveness.
            "slo_burning_queues": burning,
            "queues": queues,
        }
        incidents = getattr(self.app, "incidents", None)
        if incidents is not None:
            inc = incidents.snapshot()
            body["incidents"] = {
                "captured": inc["captured"],
                "dropped": inc["dropped"],
                "by_class": inc["by_class"],
                "last_id": (inc["incidents"][-1]["id"]
                            if inc["incidents"] else None),
            }
        return web.json_response(body)

    async def _metrics(self, request) -> "web.Response":
        report = self._report()
        if request.query.get("format") == "prom":
            return web.Response(text=_flatten_prom(report),
                                content_type="text/plain")
        return web.Response(text=json.dumps(report, sort_keys=True),
                            content_type="application/json")

    async def _debug_traces(self, request) -> "web.Response":
        """Flight recorder: recent + slow-exemplar traces. ``?queue=``
        filters; ``?id=`` looks one trace up; ``?n=`` caps the per-ring
        count (default 32)."""
        recorder = getattr(self.app, "recorder", None)
        if recorder is None or not getattr(self.app, "trace_enabled", True):
            # "Tracing off" is not "no slow requests".
            return web.json_response({"error": "tracing disabled"},
                                     status=404)
        trace_id = request.query.get("id")
        if trace_id:
            tr = recorder.get(trace_id)
            if tr is None:
                return web.json_response(
                    {"error": f"trace {trace_id!r} not found (rings are "
                              "bounded — it may have been evicted)"},
                    status=404)
            return web.json_response(tr.to_dict())
        try:
            limit = max(1, int(request.query.get("n", "32")))
        except ValueError:
            limit = 32
        return web.json_response(
            recorder.snapshot(queue=request.query.get("queue"), limit=limit))

    async def _debug_attribution(self, request) -> "web.Response":
        """Critical-path attribution (service/attribution.py): per queue
        the wait-vs-work decomposition of settled spans, the device
        counters, the SLO monitor, and the ``?p=`` (default 99) exemplar
        trace's gap waterfall. ``?queue=`` filters."""
        attribution = getattr(self.app, "attribution", None)
        if attribution is None or not getattr(self.app, "trace_enabled", True):
            return web.json_response({"error": "attribution disabled"},
                                     status=404)
        try:
            p = min(100.0, max(0.0, float(request.query.get("p", "99"))))
        except ValueError:
            p = 99.0
        body = attribution.snapshot(queue=request.query.get("queue"))
        for q, entry in body["queues"].items():
            rt = self.app._runtimes.get(q)
            if rt is not None and hasattr(rt.engine, "util_report"):
                entry["device_util"] = rt.engine.util_report()
            monitor = getattr(self.app, "_slo_monitors", {}).get(q)
            if monitor is not None:
                entry["slo"] = monitor.snapshot()
            exemplar = self.app.recorder.percentile_exemplar(q, p)
            if exemplar is not None:
                entry[f"p{p:g}_exemplar"] = decompose(exemplar)
        return web.json_response(body)

    async def _debug_quality(self, request) -> "web.Response":
        """Match quality and fairness: per queue the service ledger's
        per-tier histograms, the engine's per-rating-bucket report (the
        last state read back: never a device read on the loop), its
        disparity gaps and the quality-SLO monitor. ``?queue=`` filters."""
        queue = request.query.get("queue") or None
        ledger = self.app.quality.snapshot(queue=queue)
        body: dict[str, Any] = {
            "quality_buckets": ledger["quality_buckets"],
            "wait_edges_s": ledger["wait_edges_s"],
            "queues": {},
        }
        monitors = getattr(self.app, "_slo_monitors", {})
        names = ([queue] if queue is not None
                 else sorted(self.app._runtimes))
        for name in names:
            rt = self.app._runtimes.get(name)
            if rt is None:
                continue
            entry: dict[str, Any] = {
                "service": ledger["queues"].get(name, {}),
            }
            rep = (rt.engine.quality_report()
                   if hasattr(rt.engine, "quality_report") else None)
            if rep is not None:
                entry["engine"] = rep
                entry["disparity"] = rep.get("disparity")
            mon = monitors.get(name + "#quality")
            if mon is not None:
                entry["slo_quality"] = mon.snapshot()
            body["queues"][name] = entry
        return web.json_response(body)

    async def _debug_placement(self, request) -> "web.Response":
        """The elastic placement control plane: each queue's binding
        (shard degree, generation, typestate), the decision audit ring
        (each record with the signals that drove it and the measured
        blackout), per-queue blackout stats and the dispatch arbiter's
        state; ``?n=`` caps the decision history (default: the whole
        ring). Beside it, whether or not the controller runs: formation
        state (each bucketed queue's ``formation_report()``) and the
        device-loss failover audit (each queue's live binding and its
        D → D − 1 demotions). 404 when all three are empty."""
        ctrl = getattr(self.app, "placement", None)
        formation = {
            name: rep
            for name, rt in self.app._runtimes.items()
            if (rep := (rt.engine.formation_report()
                        if hasattr(rt.engine, "formation_report")
                        else None)) is not None
        }
        failover = {
            name: {"binding": (list(rt.placement)
                               if rt.placement is not None else None),
                   "demotions": list(rt.failover_log)}
            for name, rt in self.app._runtimes.items()
            if rt.failover_log
        }
        if ctrl is None:
            if formation or failover:
                body = {}
                if formation:
                    body["formation"] = formation
                if failover:
                    body["failover"] = failover
                return web.json_response(body)
            return web.json_response(
                {"error": "placement control plane disabled "
                          "(set placement.interval_s)"}, status=404)
        try:
            history = max(0, int(request.query.get("n", "0")))
        except ValueError:
            history = 0
        body = ctrl.snapshot(history=history)
        if formation:
            body["formation"] = formation
        if failover:
            body["failover"] = failover
        return web.json_response(body)

    async def _debug_autotune(self, request) -> "web.Response":
        """The online autotuner (control/autotune.py): the steering target,
        the safe ranges, the live knob values per queue and the decision
        audit ring, each record with its driving signals and the effect
        observed one tick later. ``?n=`` caps the history (default: the
        whole ring). 404 without a tuner."""
        tuner = getattr(self.app, "autotune", None)
        if tuner is None:
            return web.json_response(
                {"error": "autotuner disabled (set autotune.interval_s)"},
                status=404)
        try:
            history = max(0, int(request.query.get("n", "0")))
        except ValueError:
            history = 0
        return web.json_response(tuner.snapshot(history=history))

    async def _debug_telemetry(self, request) -> "web.Response":
        """The telemetry ring (utils/timeseries.py): ``?n=`` tail length,
        ``?key=`` comma-separated key-prefix filter (``idle_frac`` matches
        every queue's ``idle_frac[q]`` series)."""
        telemetry = getattr(self.app, "telemetry", None)
        if telemetry is None:
            return web.json_response({"error": "telemetry disabled"},
                                     status=404)
        try:
            limit = int(request.query.get("n", "0"))
        except ValueError:
            limit = 0
        prefixes = tuple(k for k in request.query.get("key", "").split(",")
                         if k)
        return web.json_response({
            "snapshots": telemetry.snapshot(limit=limit, prefixes=prefixes)})

    async def _debug_events(self, request) -> "web.Response":
        """Lifecycle event timeline (``?queue=`` filter, ``?n=`` tail)."""
        events = getattr(self.app, "events", None)
        if events is None:
            return web.json_response({"error": "event log disabled"},
                                     status=404)
        try:
            limit = int(request.query.get("n", "0"))
        except ValueError:
            limit = 0
        return web.json_response({
            "events": events.snapshot(queue=request.query.get("queue"),
                                      limit=limit)})

    async def _debug_incidents(self, request) -> "web.Response":
        """Incident bundles: summaries and the capture/drop counters;
        ``?id=inc-NNNNNN`` fetches one full bundle, ``?bundles=1`` inlines
        them all."""
        incidents = getattr(self.app, "incidents", None)
        if incidents is None or not self.app.cfg.forensics.enabled():
            return web.json_response({"error": "incident capture disabled"},
                                     status=404)
        incident_id = request.query.get("id")
        if incident_id:
            bundle = incidents.get(incident_id)
            if bundle is None:
                return web.json_response(
                    {"error": f"no incident {incident_id!r} in the ring"},
                    status=404)
            return web.Response(text=json.dumps(bundle, sort_keys=True),
                                content_type="application/json")
        body = incidents.snapshot(
            include_bundles=request.query.get("bundles") == "1")
        return web.Response(text=json.dumps(body, sort_keys=True),
                            content_type="application/json")

    def _on_card(self) -> bool:
        """Any queue's live engine holds its pool on the card."""
        return any(getattr(getattr(rt.engine, "device", None), "type",
                           None) == "cuda"
                   for rt in self.app._runtimes.values())

    async def _debug_profile(self, request) -> "web.Response":
        """torch.profiler capture of the live process: ``?secs=N`` (clamped
        to 0.05-30 s), exported as a Chrome trace. One capture at a time:
        the profiler is process-wide."""
        if self._profiling:
            return web.json_response(
                {"error": "a profile capture is already running"}, status=409)
        try:
            secs = min(max(0.05, float(request.query.get("secs", "2"))), 30.0)
        except ValueError:
            return web.json_response({"error": "secs must be a number"},
                                     status=400)
        trace_dir = (getattr(self.app.cfg.observability, "profile_dir", "")
                     or self._profile_dir)
        if not trace_dir:
            import tempfile

            trace_dir = self._profile_dir = tempfile.mkdtemp(
                prefix="mm_profile_")
        self._profiling = True
        try:
            import torch.profiler as tp

            activities = [tp.ProfilerActivity.CPU]
            if self._on_card():
                activities.append(tp.ProfilerActivity.CUDA)
            os.makedirs(trace_dir, exist_ok=True)
            self._profiles += 1
            path = os.path.join(
                trace_dir, f"trace_{os.getpid()}_{self._profiles:04d}.json")
            prof = tp.profile(activities=activities)
            prof.start()
            try:
                # The loop keeps serving during the capture: that traffic
                # is what the profile is for.
                await asyncio.sleep(secs)
            finally:
                prof.stop()
            prof.export_chrome_trace(path)
        except Exception as e:
            return web.json_response({"error": f"profiler failed: {e}"},
                                     status=500)
        finally:
            self._profiling = False
        return web.json_response({
            "trace_dir": trace_dir, "secs": secs,
            "viewer": "open " + path + " in Perfetto (ui.perfetto.dev) or "
                      "chrome://tracing"})

    async def start(self) -> None:
        http_app = web.Application()
        http_app.router.add_get("/healthz", self._healthz)
        http_app.router.add_get("/metrics", self._metrics)
        http_app.router.add_get("/debug/traces", self._debug_traces)
        http_app.router.add_get("/debug/attribution", self._debug_attribution)
        http_app.router.add_get("/debug/quality", self._debug_quality)
        http_app.router.add_get("/debug/placement", self._debug_placement)
        http_app.router.add_get("/debug/autotune", self._debug_autotune)
        http_app.router.add_get("/debug/telemetry", self._debug_telemetry)
        http_app.router.add_get("/debug/events", self._debug_events)
        http_app.router.add_get("/debug/incidents", self._debug_incidents)
        http_app.router.add_get("/debug/profile", self._debug_profile)
        self._runner = web.AppRunner(http_app)
        await self._runner.setup()
        self._site = web.TCPSite(self._runner, self.host, self.port)
        await self._site.start()

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
