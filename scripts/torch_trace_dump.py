#!/usr/bin/env python
"""Fetch + pretty-print flight-recorder traces from the port's service.

The /debug/traces endpoint (service/observability.py) returns raw JSON; this
helper renders a trace as a readable stage waterfall — the "why was THIS
request slow" workflow:

    # list the slow exemplars for one queue
    python scripts/torch_trace_dump.py --queue matchmaking.search --slow

    # dump one trace by id (ids appear in the listing)
    python scripts/torch_trace_dump.py --id 'matchmaking.search#1234'

    # recent lifecycle events (breaker trips, probes, chaos faults),
    # causally ordered by the spine seq
    python scripts/torch_trace_dump.py --events

    # incident bundles: the live ring, or one bundle offline
    python scripts/torch_trace_dump.py --incident live
    python scripts/torch_trace_dump.py --incident incident_inc-000001_failover.json

    # wait-vs-work gap waterfall (the attribution taxonomy)
    python scripts/torch_trace_dump.py --queue matchmaking.search --slow --gaps

    # per-queue attribution summary (/debug/attribution)
    python scripts/torch_trace_dump.py --attribution

    # match-quality & fairness summary (/debug/quality) — live,
    # or offline from a BENCH json's e2e_frontier rows
    python scripts/torch_trace_dump.py --quality
    python scripts/torch_trace_dump.py --quality --bench-json BENCH_r06.json

Stdlib (urllib) transport — usable inside the service container; the
``--gaps`` classifier imports the port's
``matchmaking_tpu_torch.service.attribution``, which is on the path
wherever the service runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.parse
import urllib.request


def _get(base: str, path: str, params: dict) -> dict:
    qs = urllib.parse.urlencode({k: v for k, v in params.items() if v})
    url = f"{base}{path}" + (f"?{qs}" if qs else "")
    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            detail = json.loads(e.read()).get("error", "")
        except Exception:
            detail = ""
        sys.exit(f"HTTP {e.code} from {url}: {detail}")
    except OSError as e:
        sys.exit(f"cannot reach {url}: {e} (is the service running with "
                 "metrics_port set?)")


def render_trace(tr: dict, out=sys.stdout) -> None:
    """One trace as a stage waterfall: absolute offset + per-stage delta."""
    marks = tr.get("marks", [])
    head = (f"{tr.get('trace_id', '?')}  queue={tr.get('queue', '?')} "
            f"player={tr.get('player_id') or '-'} "
            f"status={tr.get('status') or '-'} "
            f"total={tr.get('total_ms', 0):.3f}ms"
            + ("  [redelivered]" if tr.get("redelivered") else ""))
    print(head, file=out)
    if not marks:
        return
    t0 = marks[0][1]
    prev = t0
    for name, t in marks:
        off = (t - t0) * 1e3
        delta = (t - prev) * 1e3
        bar = "#" * min(40, max(0, int(delta)))
        print(f"  {off:10.3f}ms  +{delta:9.3f}ms  {name:<14} {bar}",
              file=out)
        prev = t
    print("", file=out)


def render_gaps(tr: dict, out=sys.stdout) -> None:
    """One trace as a wait-vs-work gap waterfall. Rendering only — the
    classification comes from attribution.decompose_marks, the SAME walk
    /debug/attribution uses, so the CLI can never disagree with the
    server-side decomposition."""
    from matchmaking_tpu_torch.service.attribution import WAIT, decompose_marks

    marks = tr.get("marks", [])
    head = (f"{tr.get('trace_id', '?')}  queue={tr.get('queue', '?')} "
            f"player={tr.get('player_id') or '-'} "
            f"status={tr.get('status') or '-'} "
            f"total={tr.get('total_ms', 0):.3f}ms")
    print(head, file=out)
    if len(marks) < 2:
        return
    gaps, work_s, wait_s = decompose_marks(marks)
    for gap in gaps:
        delta = gap["ms"]
        bar = ("." if gap["kind"] == WAIT
               else "#") * min(40, max(0, int(delta)))
        print(f"  +{delta:9.3f}ms  {gap['kind']:<4} {gap['category']:<20} "
              f"{gap['from']}->{gap['to']:<14} {bar}", file=out)
    total = work_s + wait_s
    frac = wait_s / total if total else 0.0
    print(f"  = work {work_s * 1e3:.3f}ms + wait {wait_s * 1e3:.3f}ms "
          f"({frac:.0%} waiting)\n", file=out)


def render_attribution(body: dict, out=sys.stdout) -> None:
    """Per-queue attribution summary (/debug/attribution)."""
    print(f"SLO target: {body.get('slo_target_ms', 0):.1f} ms", file=out)
    for queue, entry in sorted(body.get("queues", {}).items()):
        wait_frac = entry.get("wait_fraction", 0.0)
        print(f"== {queue}: {entry.get('spans', 0)} spans, "
              f"p99 {entry.get('p99_total_ms')} ms, "
              f"{wait_frac:.0%} waiting", file=out)
        util = entry.get("device_util")
        if util:
            print(f"   device: idle {util['idle_fraction']:.1%}, "
                  f"occupancy {util['effective_occupancy']:.1%}, "
                  f"busy {util['device_busy_s']:.1f}s / "
                  f"idle {util['device_idle_s']:.1f}s", file=out)
        slo = entry.get("slo")
        if slo:
            print(f"   slo: attainment fast={slo['attainment_fast']} "
                  f"slow={slo['attainment_slow']} "
                  f"burn fast={slo['burn_fast']} slow={slo['burn_slow']}"
                  f"{'  BURNING' if slo.get('burning') else ''}", file=out)
        for name, cat in sorted(
                entry.get("categories", {}).items(),
                key=lambda kv: -kv[1]["total_s"]):
            print(f"   {cat['kind']:<4} {name:<22} "
                  f"{cat['total_s'] * 1e3:12.1f}ms total "
                  f"({cat['share']:6.1%})  p99 {cat['p99_ms']} ms  "
                  f"[{cat['traces']} traces / {cat['gaps']} gaps]", file=out)
        exemplar = next((v for k, v in entry.items()
                         if k.endswith("_exemplar")), None)
        if exemplar:
            print(f"   p99 exemplar {exemplar['trace_id']}: "
                  f"{exemplar['total_ms']:.1f}ms = "
                  f"work {exemplar['work_ms']:.1f}ms + "
                  f"wait {exemplar['wait_ms']:.1f}ms", file=out)
        print("", file=out)


def render_quality(body: dict, out=sys.stdout) -> None:
    """Per-queue quality/wait/disparity summary (/debug/quality shape)."""
    for queue, entry in sorted(body.get("queues", {}).items()):
        eng = entry.get("engine") or {}
        svc = entry.get("service") or {}
        print(f"== {queue}: {eng.get('samples', 0)} matched-player "
              f"samples", file=out)
        if eng.get("samples"):
            print(f"   quality: mean {eng.get('quality_mean')}  "
                  f"p10 {eng.get('quality_p10')}  "
                  f"p50 {eng.get('quality_p50')}  "
                  f"spread mean {eng.get('spread_mean')}", file=out)
            print(f"   wait-at-match: p50 {eng.get('wait_p50_s')}s  "
                  f"p90 {eng.get('wait_p90_s')}s  "
                  f"p99 {eng.get('wait_p99_s')}s", file=out)
            for b in eng.get("buckets", ()):
                if not b.get("count"):
                    continue
                print(f"     [{b['bucket']:>10}] n={b['count']:<7} "
                      f"quality {b.get('quality_mean')}  "
                      f"wait p90 {b.get('wait_p90_s')}s", file=out)
        disp = entry.get("disparity") or {}
        if disp:
            print(f"   disparity: quality gap {disp.get('quality_gap')} "
                  f"({disp.get('quality_gap_bucket') or '-'}), "
                  f"wait p90 gap {disp.get('wait_p90_gap_s')}s "
                  f"({disp.get('wait_gap_bucket') or '-'})", file=out)
        for tier, tq in (svc.get("tiers") or {}).items():
            print(f"   tier {tier}: n={tq.get('count')} "
                  f"quality mean {tq.get('quality_mean')} "
                  f"p10 {tq.get('quality_p10')}  "
                  f"wait p99 {tq.get('wait_p99_s')}s", file=out)
        slo = entry.get("slo_quality")
        if slo:
            print(f"   quality slo: target {slo.get('target_ms')}  "
                  f"attainment fast={slo.get('attainment_fast')} "
                  f"slow={slo.get('attainment_slow')}"
                  f"{'  BURNING' if slo.get('burning') else ''}", file=out)
        print("", file=out)


def render_frontier(doc: dict, out=sys.stdout) -> None:
    """The quality-vs-latency frontier from a BENCH json (e2e_frontier
    rows)."""
    if isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    rows = doc.get("e2e_frontier", [])
    if not rows:
        print("no e2e_frontier rows in this BENCH json "
              "(run bench.py --e2e-quality)", file=out)
        return
    print("quality-vs-latency frontier (stricter threshold -> closer "
          "matches, longer waits):", file=out)
    print(f"  {'thr':>6} {'matched':>8} {'q_mean':>8} {'q_p10':>8} "
          f"{'spread':>8} {'waitp50ms':>10} {'waitp99ms':>10} "
          f"{'disparity':>10}", file=out)
    for r in sorted(rows, key=lambda r: r.get("threshold", 0.0)):
        print(f"  {r.get('threshold', 0):>6g} {r.get('matched', 0):>8} "
              f"{r.get('quality_mean')!s:>8} {r.get('quality_p10')!s:>8} "
              f"{r.get('spread_mean')!s:>8} "
              f"{r.get('wait_at_match_ms_p50')!s:>10} "
              f"{r.get('wait_at_match_ms_p99')!s:>10} "
              f"{r.get('quality_disparity')!s:>10}", file=out)
    for key in ("e2e_frontier_spread_monotone", "e2e_frontier_wait_monotone"):
        if key in doc:
            print(f"  {key}: {doc[key]}", file=out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9100)
    ap.add_argument("--queue", default="", help="filter by queue name")
    ap.add_argument("--id", default="", help="dump one trace by id")
    ap.add_argument("--slow", action="store_true",
                    help="show slow exemplars only (default: recent)")
    ap.add_argument("--n", type=int, default=16, help="traces per ring")
    ap.add_argument("--events", action="store_true",
                    help="show the lifecycle event log instead of traces")
    ap.add_argument("--incident", default="",
                    help="incident forensics: 'live' lists the "
                         "service's bundle ring (with --id, fetches one "
                         "bundle and renders its timeline); a file path "
                         "renders that bundle offline via torch_postmortem.py")
    ap.add_argument("--gaps", action="store_true",
                    help="render traces as a wait-vs-work gap waterfall "
                         "(attribution taxonomy) instead of raw stages")
    ap.add_argument("--attribution", action="store_true",
                    help="per-queue attribution summary "
                         "(/debug/attribution)")
    ap.add_argument("--quality", action="store_true",
                    help="match-quality & fairness summary "
                         "(/debug/quality; with --bench-json, the "
                         "e2e_frontier rows of a BENCH artifact)")
    ap.add_argument("--scenario", action="store_true",
                    help="the /debug/autotune knob-decision ring (the "
                         "port has no scenario-matrix artifact: no "
                         "--bench-json here)")
    ap.add_argument("--bench-json", default="",
                    help="read a BENCH json instead of a live service "
                         "(with --quality)")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON instead of the waterfall rendering")
    args = ap.parse_args(argv)
    base = f"http://{args.host}:{args.port}"

    if args.scenario:
        if args.bench_json:
            sys.exit("--scenario reads the live service only: the port "
                     "has no scenario-matrix artifact")
        body = _get(base, "/debug/autotune", {"n": args.n})
        if args.json:
            print(json.dumps(body, indent=2))
            return
        print(f"autotune: target {body.get('target_p99_ms')} ms, "
              f"{body.get('moves')} move(s) over {body.get('ticks')} "
              f"tick(s); knobs {body.get('knobs')}")
        for d in body.get("decisions", []):
            print(f"  #{d.get('seq')} t={d.get('t')} {d.get('queue')} "
                  f"{d.get('knob')}: {d.get('from')} -> {d.get('to')} "
                  f"[{d.get('status')}] — {d.get('reason')}")
            if d.get("effect"):
                print(f"      effect: {d['effect']}")
        return

    if args.quality:
        if args.bench_json:
            with open(args.bench_json, encoding="utf-8") as f:
                doc = json.load(f)
            if args.json:
                print(json.dumps(doc.get("e2e_frontier", []), indent=2))
            else:
                render_frontier(doc)
            return
        body = _get(base, "/debug/quality", {"queue": args.queue})
        if args.json:
            print(json.dumps(body, indent=2))
        else:
            render_quality(body)
        return

    if args.attribution:
        body = _get(base, "/debug/attribution", {"queue": args.queue})
        if args.json:
            print(json.dumps(body, indent=2))
        else:
            render_attribution(body)
        return

    if args.incident:
        import torch_postmortem as postmortem

        if args.incident != "live":
            with open(args.incident, encoding="utf-8") as f:
                bundle = json.load(f)
            if args.json:
                print(json.dumps(postmortem.analyze(bundle), indent=2,
                                 sort_keys=True))
            else:
                postmortem.render(bundle, limit=args.n)
            return
        if args.id:
            bundle = _get(base, "/debug/incidents", {"id": args.id})
            if args.json:
                print(json.dumps(postmortem.analyze(bundle), indent=2,
                                 sort_keys=True))
            else:
                postmortem.render(bundle, limit=args.n)
            return
        body = _get(base, "/debug/incidents", {})
        if args.json:
            print(json.dumps(body, indent=2))
            return
        print(f"incidents: {body.get('captured', 0)} captured, "
              f"{body.get('dropped', 0)} dropped "
              f"(by class {body.get('by_class', {})}); "
              f"capture p99 {body.get('capture_ms_p99')} ms")
        for inc in body.get("incidents", []):
            print(f"  {inc['id']}  class={inc['class']:<20} "
                  f"queue={inc['queue'] or '-':<22} seq={inc['seq']:<7} "
                  f"{inc['spine_events']} spine events, "
                  f"captured in {inc['capture_ms']:.1f} ms")
        return

    if args.events:
        body = _get(base, "/debug/events",
                    {"queue": args.queue, "n": args.n})
        if args.json:
            print(json.dumps(body, indent=2))
            return
        # Causal order: rows arrive seq-sorted from the server; render
        # the seq + component so two events in the same millisecond read
        # in their true order (the old wall-clock print hid ties).
        for ev in body.get("events", []):
            print(f"#{ev.get('seq', 0):<6} {ev['t']:.3f}  "
                  f"[{ev.get('component', '?')}/{ev['kind']}] {ev['queue']}"
                  + (f" — {ev['detail']}" if ev.get("detail") else ""))
        return

    render = render_gaps if args.gaps else render_trace

    if args.id:
        tr = _get(base, "/debug/traces", {"id": args.id})
        if args.json:
            print(json.dumps(tr, indent=2))
        else:
            render(tr)
        return

    body = _get(base, "/debug/traces", {"queue": args.queue, "n": args.n})
    if args.json:
        print(json.dumps(body, indent=2))
        return
    ring = "slow" if args.slow else "recent"
    print(f"slow threshold: {body.get('slow_threshold_ms', 0):.1f} ms")
    for queue, rings in sorted(body.get("queues", {}).items()):
        traces = rings.get(ring, [])
        print(f"== {queue}: {len(traces)} {ring} trace(s)")
        for tr in traces:
            render(tr)


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:
        # downstream pager/head closed the pipe; exit quietly like other CLIs
        sys.stderr.close()
