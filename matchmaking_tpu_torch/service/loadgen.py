"""The self-driving load worker and the load function the tests, the card
smoke and the worker share (``offered_load``). The port's copy of the JAX
package's ``service/loadgen.py``.

The worker boots the app from the ``MM_*`` variables (the snapshot
plumbing ``service.multiproc`` workers use), offers a seeded request load
to its own in-process broker, and writes one JSON result line: the whole
ingress path (broker → decode → middleware → batcher → engine → publish)
runs in one process, the per-consumer work a fleet fans out over AMQP.

- Overload (``--offered-rate`` above the clearing rate): every response
  class is accounted (matched / queued / shed / timeout / error), and
  ``--deadline-ms`` stamps a per-request deadline.
- Tiers (``--tier-mix 0:0.2,1:0.5,2:0.3``): a seeded ``x-tier`` per
  arrival, and the accounting split per tier (the loadgen maps each
  correlation id to its tier).
- Scenarios (``--scenario``, ``scenario.py``): a population model —
  piecewise rate curves, rating-mixture cohorts with their tiers,
  deadlines and retry-on-shed, scripted incidents. The arrival transcript
  is a pure function of ``(seed, scenario, scales)``; ``steady`` reduces
  to the flat Poisson load byte for byte.

The worker runs on the card unless ``--device`` (default ``cuda``) says
otherwise; ``MM_ENGINE_BACKEND=cpu`` serves on the host oracle, which reads
no device. Variables (a flag wins over its variable):

    MM_LOADGEN_RATE         offered req/s (Poisson)      (--offered-rate)
    MM_LOADGEN_SECONDS      measured duration            (--seconds)
    MM_LOADGEN_SEED         arrival/rating RNG seed      (--seed)
    MM_LOADGEN_DEADLINE_MS  per-request deadline, 0=off  (--deadline-ms)
    MM_LOADGEN_TIER_MIX     tier mix, "" = untiered      (--tier-mix)
    MM_LOADGEN_QUALITY      "1" = quality accounting     (--quality)
    MM_LOADGEN_SCENARIO     scenario name/path, "" = off (--scenario)
    MM_LOADGEN_RATE_SCALE   scenario rate multiplier     (--rate-scale)
    MM_LOADGEN_TIME_SCALE   scenario time compression    (--time-scale)
    MM_LOADGEN_OUT          path for the JSON result     (--out)

    python -m matchmaking_tpu_torch.service.loadgen [--device cpu|cuda]
"""

from __future__ import annotations

import asyncio
import json
import os
import time

import numpy as np

#: Response classes tallied from reply bodies (cheap substring probes — at
#: overload rates a full json.loads per reply would bill the loadgen, not
#: the service, for the decode).
_STATUS_PROBES = (
    ("matched", b'"status":"matched"'),
    ("queued", b'"status":"queued"'),
    ("shed", b'"status":"shed"'),
    ("timeout", b'"status":"timeout"'),
    ("error", b'"status":"error"'),
)


def parse_tier_mix(spec: str) -> "dict[int, float] | None":
    """``"0:0.2,1:0.5,2:0.3"`` → {0: 0.2, 1: 0.5, 2: 0.3} (weights
    normalized); ""/None → None (untiered)."""
    if not spec:
        return None
    mix: dict[int, float] = {}
    for part in spec.split(","):
        t, _, w = part.partition(":")
        mix[int(t)] = float(w)
    total = sum(mix.values())
    if total <= 0:
        raise ValueError(f"tier mix has no mass: {spec!r}")
    return {t: w / total for t, w in sorted(mix.items())}


async def offered_load(app, queue: str, *, rate: float, duration: float,
                       seed: int, deadline_s: float = 0.0,
                       tier_mix: "dict[int, float] | None" = None,
                       reply_q: str = "loadgen.replies",
                       drain_polls: int = 200,
                       quality_stats: bool = False,
                       rating_sigma: float | None = None,
                       scenario=None, rate_scale: float = 1.0,
                       time_scale: float = 1.0) -> dict:
    """Offer a seeded Poisson load to ``app``'s broker and account for
    every response class. The worker below, the tests and the card smoke
    all drive this one function.

    Consecutive near-equal ratings: arrivals pair off almost immediately,
    keeping the pool small so the measured cost is INGRESS (decode →
    middleware → batcher → publish) — or, when ``rate`` exceeds the
    clearing rate, ADMISSION (the shed path).

    ``tier_mix`` (tier → weight) stamps a seeded ``x-tier`` per arrival
    and splits the accounting per tier (statuses + matched-latency p99) —
    correlation ids carry the assignment, so the per-tier split is exact
    even for response bodies that don't echo the tier.

    ``quality_stats`` parses every MATCHED reply for the match
    ``quality``, the engine-observed ``waited_ms``, and the wire
    ``latency_ms`` — the client-observed/engine-observed wait cross-check:
    ``wait_gap_ms_mean`` = mean(latency − waited), the collect+publish
    queueing the engine did NOT charge the match for. Costs one json.loads
    per matched reply (like tiered runs).

    ``scenario`` replaces the flat (rate, duration,
    rating_sigma, tier_mix) model with a population spec
    (``scenario.py``): the arrival transcript — times,
    ratings, cohorts, tiers, deadlines, retry flags — is built up front as
    a pure function of ``(seed, scenario, rate_scale, time_scale)``, and
    per-cohort accounting joins the result. Mutually exclusive with
    ``tier_mix``/``rating_sigma`` (the scenario's cohorts own both).
    """
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.overload import stamp_deadline, stamp_tier
    from matchmaking_tpu_torch.testing.drain import fully_drained

    arrivals = None
    if scenario is not None:
        if tier_mix or rating_sigma is not None:
            raise ValueError("scenario mode owns the tier/rating model — "
                             "drop tier_mix/rating_sigma")
        arrivals = scenario.build_arrivals(
            seed, rate_scale=rate_scale, time_scale=time_scale)
        duration = arrivals.duration_s

    app.broker.declare_queue(reply_q)
    tally = {name: 0 for name, _ in _STATUS_PROBES}
    tally["replies"] = 0
    tier_of_corr: dict[str, int] = {}
    per_tier: dict[int, dict] = {}
    tier_keys: "tuple[int, ...]" = tuple(tier_mix or ())
    if arrivals is not None and arrivals.stamp_tiers:
        # matchlint: ignore[blocking-call] the scenario's numpy tier column: host memory, no device tensor
        tier_keys = tuple(sorted(set(arrivals.tier.tolist())))
    if tier_keys:
        per_tier = {t: {**{name: 0 for name, _ in _STATUS_PROBES},
                        "offered": 0, "retries": 0, "latencies_ms": []}
                    for t in tier_keys}
    #: Scenario mode: correlation id → cohort index + per-cohort rows, and
    #: the once-per-arrival retry machinery (retry decisions were drawn in
    #: the transcript; only the send time follows the reply).
    cohort_of_corr: dict[str, int] = {}
    idx_of_corr: dict[str, int] = {}
    per_cohort: dict[int, dict] = {}
    retried: set[str] = set()
    retry_tasks: list = []
    retries_sent = 0
    if arrivals is not None:
        per_cohort = {j: {**{name: 0 for name, _ in _STATUS_PROBES},
                          "offered": 0, "retries": 0}
                      for j in range(len(scenario.cohorts))}

    #: quality_stats rows: (quality, waited_ms, latency_ms) per matched
    #: reply.
    q_rows: list[tuple[float, float, float]] = []

    async def on_reply(delivery) -> None:
        tally["replies"] += 1
        body = bytes(delivery.body)
        status = ""
        for name, probe in _STATUS_PROBES:
            if probe in body:
                tally[name] += 1
                status = name
                break
        if quality_stats and status == "matched":
            try:
                d = json.loads(body)
                q_rows.append((
                    float((d.get("match") or {}).get("quality", 0.0)),
                    float(d.get("waited_ms", 0.0)),
                    float(d.get("latency_ms", 0.0))))
            except (ValueError, TypeError):
                pass
        if not status:
            return
        corr = delivery.properties.correlation_id
        if per_cohort:
            j = cohort_of_corr.get(corr)
            if j is not None:
                per_cohort[j][status] += 1
            if status == "shed":
                i = idx_of_corr.get(corr)
                if (i is not None and arrivals.retry[i]
                        and corr not in retried):
                    # One client retry per shed arrival, seeded decision
                    # (arr.retry), delayed by the cohort's backoff — the
                    # retry-storm ingredient.
                    retried.add(corr)
                    retry_tasks.append(
                        asyncio.ensure_future(retry_arrival(i, corr)))
        if not per_tier:
            return
        t = tier_of_corr.get(corr)
        if t is None:
            return
        row = per_tier[t]
        row[status] += 1
        if status == "matched":
            # Tiered runs pay one json.loads per MATCHED reply for the
            # per-tier latency split; the untiered path keeps the cheap
            # substring probes.
            try:
                row["latencies_ms"].append(
                    float(json.loads(body).get("latency_ms", 0.0)))
            except (ValueError, TypeError):
                pass

    tag = app.broker.basic_consume(reply_q, on_reply, prefetch=1_000_000)

    # Counter BASELINES: shed/expired are app-lifetime monotone counters,
    # and this function is reused (warmup + measured phases, soak re-runs) —
    # reporting deltas keeps a second call from inheriting the first's.
    counters = app.metrics.counters
    shed0 = counters.get("shed_requests")
    expired0 = counters.get("expired_requests")
    tier_base = {t: (counters.get(f"shed_requests_t{t}"),
                     counters.get(f"expired_requests_t{t}"))
                 for t in tier_keys}

    if arrivals is not None:
        # Scenario mode: the whole transcript was drawn up front.
        sched = arrivals.t
        ratings = arrivals.rating
        n_max = len(arrivals)
        tiers = arrivals.tier if arrivals.stamp_tiers else None
        deadlines = arrivals.deadline_s
    else:
        rng = np.random.default_rng(seed)
        n_max = int(rate * duration * 2) + 16
        # Default (rating_sigma=None): consecutive near-equal ratings, so
        # the measured cost is ingress/admission (see the docstring). A
        # quality/frontier run wants the OPPOSITE — iid diverse ratings,
        # so the rating threshold actually bites and wait/quality trade
        # off.
        if rating_sigma is None:
            ratings = np.repeat(
                rng.normal(1500.0, 300.0, size=n_max // 2 + 1), 2)
        else:
            ratings = rng.normal(1500.0, rating_sigma, size=n_max)
        gaps = rng.exponential(1.0 / rate, size=n_max)
        sched = np.cumsum(gaps)
        tiers = None
        deadlines = None
        if tier_mix:
            # Seeded per-arrival tier draw (pure function of the seed,
            # drawn up front like ratings/gaps — replay-identical by
            # construction).
            tiers = rng.choice(
                np.fromiter(tier_mix, np.int64, len(tier_mix)),
                size=n_max,
                p=np.fromiter(tier_mix.values(), np.float64,
                              len(tier_mix)))

    def publish_arrival(i: int, corr: str) -> None:
        """One request publish (arrival or scenario retry): headers
        stamped from the per-arrival deadline/tier columns; a retry keeps
        its PLAYER id (the same player re-requesting) under a fresh
        correlation id."""
        headers: dict = {}
        budget = deadline_s
        if deadlines is not None and deadlines[i] > 0:
            budget = float(deadlines[i])
        if budget > 0:
            stamp_deadline(headers, time.time(), budget)
        if tiers is not None:
            t = int(tiers[i])
            stamp_tier(headers, t)
            tier_of_corr[corr] = t
        app.broker.publish(
            queue,
            f'{{"id":"g{seed}_{i}","rating":{ratings[i]:.2f}}}'.encode(),
            Properties(reply_to=reply_q, correlation_id=corr,
                       headers=headers))

    async def retry_arrival(i: int, corr: str) -> None:
        nonlocal retries_sent
        await asyncio.sleep(float(arrivals.retry_delay_s[i]))
        rid = corr + "r"
        j = int(arrivals.cohort[i])
        cohort_of_corr[rid] = j
        per_cohort[j]["retries"] += 1
        if per_tier:
            # The retry's reply will land in this tier's status row (its
            # corr id is tier-mapped by publish_arrival) — count the
            # retry SEND too, so per-tier statuses never exceed
            # offered + retries.
            per_tier[int(arrivals.tier[i])]["retries"] += 1
        retries_sent += 1
        publish_arrival(i, rid)

    t0 = time.perf_counter()
    i = 0
    while i < n_max and sched[i] <= duration:
        now_rel = time.perf_counter() - t0
        while i < n_max and sched[i] <= min(now_rel, duration):
            pid = f"g{seed}_{i}"
            if tiers is not None:
                per_tier[int(tiers[i])]["offered"] += 1
            if arrivals is not None:
                j = int(arrivals.cohort[i])
                cohort_of_corr[pid] = j
                idx_of_corr[pid] = i
                per_cohort[j]["offered"] += 1
            publish_arrival(i, pid)
            i += 1
        if i < n_max and sched[i] > now_rel:
            await asyncio.sleep(min(sched[i] - now_rel, 0.005))
    span = time.perf_counter() - t0
    for _ in range(drain_polls):
        await asyncio.sleep(0.025)
        if retry_tasks:
            # Late sheds during the drain can still schedule retries —
            # let them publish before judging the broker quiet.
            pending = [tk for tk in retry_tasks if not tk.done()]
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
                continue
        # The whole request path, not only the broker: deliveries the
        # consumer handed on wait in the batcher and in windows in flight,
        # and their answers must reach the reply consumer before the count
        # (the JAX loadgen stops at an empty broker, and a slow service's
        # last windows go uncounted).
        if (fully_drained(app, app.runtime(queue), queue, 0,
                          replication=False)
                and app.broker.queue_depth(reply_q) == 0):
            break
    # A shed reply consumed on the drain loop's last poll can still have
    # scheduled a retry whose sleep outlives the loop — cancel and reap
    # so no task publishes after the reply consumer is gone (and no
    # "Task was destroyed but it is pending" lands at loop close).
    for tk in retry_tasks:
        if not tk.done():
            tk.cancel()
    if retry_tasks:
        await asyncio.gather(*retry_tasks, return_exceptions=True)
    app.broker.basic_cancel(tag)
    result = {
        "queue": queue,
        "offered_req_s": rate,
        "sent": i,
        "sent_req_s": round(i / span, 1),
        "players_matched": tally["matched"],
        "matched_per_s": round(tally["matched"] / span, 1),
        "replies": tally["replies"],
        "queued_acks": tally["queued"],
        "shed": tally["shed"],
        "timeout": tally["timeout"],
        "error": tally["error"],
        "shed_requests": int(counters.get("shed_requests") - shed0),
        "expired_requests": int(counters.get("expired_requests") - expired0),
    }
    if quality_stats:
        if q_rows:
            # Host data: np.array, never a device tensor read.
            arr = np.array(q_rows, np.float64)
            qual, waited, lat = arr[:, 0], arr[:, 1], arr[:, 2]
            gap = lat - waited
            result["quality"] = {
                "matched": len(q_rows),
                "quality_mean": round(float(qual.mean()), 6),
                "quality_p10": round(float(np.percentile(qual, 10)), 6),
                "quality_p50": round(float(np.percentile(qual, 50)), 6),
                "waited_ms_p50": round(float(np.percentile(waited, 50)), 3),
                "waited_ms_p99": round(float(np.percentile(waited, 99)), 3),
                "latency_ms_p99": round(float(np.percentile(lat, 99)), 3),
                # Client-observed minus engine-observed wait: the
                # collect/publish queueing the engine did not charge the
                # match for — cross-checkable against attribution's
                # publish_lag/readback categories.
                "wait_gap_ms_mean": round(float(gap.mean()), 3),
            }
        else:
            result["quality"] = {"matched": 0}
    if per_tier:
        result["tiers"] = {
            str(t): {
                "offered": row["offered"],
                "retries": row["retries"],
                "matched": row["matched"],
                "queued_acks": row["queued"],
                "shed": row["shed"],
                "timeout": row["timeout"],
                "error": row["error"],
                "p99_ms": (round(float(np.percentile(
                    row["latencies_ms"], 99)), 3)
                    if row["latencies_ms"] else None),
                "shed_requests": int(counters.get(f"shed_requests_t{t}")
                                     - tier_base[t][0]),
                "expired_requests": int(
                    counters.get(f"expired_requests_t{t}")
                    - tier_base[t][1]),
            }
            for t, row in sorted(per_tier.items())
        }
    if arrivals is not None:
        result["scenario"] = scenario.name
        # Replay pin: pure function of (seed, scenario, scales) — two runs
        # of the same load must agree.
        result["scenario_digest"] = arrivals.digest()
        result["duration_s"] = round(duration, 3)
        result["retries_sent"] = retries_sent
        result["cohorts"] = {
            scenario.cohorts[j].name: dict(row)
            for j, row in sorted(per_cohort.items())
        }
    return result


async def _run(args) -> dict:
    from matchmaking_tpu_torch.config import Config
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    cfg = Config.from_env()
    app = MatchmakingApp(cfg, device=args.device)
    await app.start()
    scenario = None
    if args.scenario:
        from matchmaking_tpu_torch.scenario import load_scenario

        scenario = load_scenario(args.scenario)
    result = await offered_load(
        app, cfg.queues[0].name,
        rate=args.offered_rate, duration=args.seconds, seed=args.seed,
        deadline_s=args.deadline_ms / 1e3 if args.deadline_ms > 0 else 0.0,
        # Passed through even in scenario mode: offered_load raises the
        # speakable conflict error instead of this CLI silently dropping
        # an operator's explicit tier mix.
        tier_mix=parse_tier_mix(args.tier_mix),
        quality_stats=bool(args.quality),
        scenario=scenario, rate_scale=args.rate_scale,
        time_scale=args.time_scale)
    result["pid"] = os.getpid()
    await app.stop()
    return result


def _parse_args(argv=None):
    import argparse

    env = os.environ
    p = argparse.ArgumentParser(
        description="self-driving offered-load worker (overload mode: set "
                    "--offered-rate above the clearing rate and read the "
                    "shed/timeout accounting)")
    p.add_argument("--offered-rate", type=float,
                   default=float(env.get("MM_LOADGEN_RATE", "10000")),
                   help="offered req/s (Poisson)")
    p.add_argument("--seconds", type=float,
                   default=float(env.get("MM_LOADGEN_SECONDS", "4")),
                   help="measured duration")
    p.add_argument("--seed", type=int,
                   default=int(env.get("MM_LOADGEN_SEED", str(os.getpid()))),
                   help="arrival/rating RNG seed (defaults to the pid so "
                        "multiproc workers don't correlate)")
    p.add_argument("--deadline-ms", type=float,
                   default=float(env.get("MM_LOADGEN_DEADLINE_MS", "0")),
                   help="stamp x-deadline on every request (0 = off)")
    p.add_argument("--tier-mix",
                   default=env.get("MM_LOADGEN_TIER_MIX", ""),
                   help="per-class offered load, e.g. '0:0.2,1:0.5,2:0.3' "
                        "— stamps a seeded x-tier per arrival and splits "
                        "the response accounting per tier ('' = untiered)")
    p.add_argument("--quality", action="store_true",
                   default=env.get("MM_LOADGEN_QUALITY", "") == "1",
                   help="parse matched replies for match quality + the "
                        "engine-observed waited_ms and report the "
                        "client/engine wait cross-check")
    p.add_argument("--scenario",
                   default=env.get("MM_LOADGEN_SCENARIO", ""),
                   help="population-model scenario name (configs/"
                        "scenarios/) or spec path — replaces "
                        "the flat rate/tier-mix model ('' = off)")
    p.add_argument("--rate-scale", type=float,
                   default=float(env.get("MM_LOADGEN_RATE_SCALE", "1")),
                   help="scenario mode: multiply every segment's rate")
    p.add_argument("--time-scale", type=float,
                   default=float(env.get("MM_LOADGEN_TIME_SCALE", "1")),
                   help="scenario mode: compress/stretch the curve "
                        "(0.5 replays the scenario in half its time)")
    p.add_argument("--out", default=env.get("MM_LOADGEN_OUT", ""),
                   help="path for the one-line JSON result")
    p.add_argument("--device", default="cuda",
                   help="the engine's device (the card unless 'cpu')")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = _parse_args(argv)
    result = asyncio.run(_run(args))
    line = json.dumps(result, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
