#!/usr/bin/env python
"""Offline incident analyzer of the port: bundle → causal narrative.

Takes one incident bundle (the schema-versioned JSON the IncidentRecorder
freezes at a trigger — ``/debug/incidents?id=...`` or a file from the
configured ``incident_dir``) and renders, with NO live service required:

- the trigger (class, kind, queue, firing spine row),
- the ordered causal timeline: the bundle's spine window in seq order
  with per-row gap annotations from ``mono_ns`` (a wide gap between two
  causally adjacent rows is usually the finding) and refs inline,
- the ROOT CHAIN: cross-component ref resolution walking the trigger
  back through its causes (burn clear ← takeover ← replay window ←
  epoch bump ← lease expiry, matched on epoch refs + nearest preceding
  seq), printed in cause order and emitted machine-readable via --json,
- the latency evidence: slow-trace exemplars and capture cost.

    python scripts/torch_postmortem.py incident_inc-000003_failover.json
    python scripts/torch_postmortem.py bundle.json --json   # machine-readable
    python scripts/torch_postmortem.py bundle.json --n 40   # longer timeline

Validates the bundle first (``matchmaking_tpu_torch.utils.forensics.
validate_bundle``) and exits 2 on schema problems, so the analyzer
doubles as a bundle linter. The bundles are the port's, byte-equal to
the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

if __package__ is None and "matchmaking_tpu_torch" not in sys.modules:
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from matchmaking_tpu_torch.utils.forensics import validate_bundle  # noqa: E402

#: Mono-gap width (ms) past which the timeline flags the gap — wide
#: silence between causally adjacent rows is where the incident hid.
GAP_FLAG_MS = 50.0

#: Kinds whose burn-side consequence terminates a chain: a burn that
#: started right after one of these was (in the absence of other
#: evidence) caused by it.
_BURN_CAUSES = ("failover_takeover", "crash_recovered", "breaker_trip",
                "placement_blackout_over_budget", "autotune_oscillation")


def _epoch(ev: dict) -> Any:
    return (ev.get("refs") or {}).get("epoch")


def _prev_epoch(ev: dict) -> Any:
    return (ev.get("refs") or {}).get("prev_epoch")


def _parent_of(ev: dict, spine: "list[dict]") -> "dict | None":
    """One resolution step: the nearest PRECEDING spine row the rule
    table names as this event's cause, matched on queue + the ref that
    links the pair (epoch for the takeover chain, decision id for
    control moves). None ends the chain — that row is the root."""
    kind, queue, seq = ev["kind"], ev["queue"], ev["seq"]

    def nearest(match) -> "dict | None":
        best = None
        for row in spine:
            if row["seq"] < seq and match(row):
                best = row  # spine is seq-ascending: last match wins
        return best

    if kind == "slo_burn_clear":
        return nearest(lambda r: r["kind"] == "slo_burn"
                       and r["queue"] == queue)
    if kind == "slo_burn":
        return nearest(lambda r: r["kind"] in _BURN_CAUSES
                       and r["queue"] == queue)
    if kind == "failover_takeover":
        return nearest(lambda r: r["kind"] == "replay_window"
                       and r["queue"] == queue
                       and (_epoch(r) is None or _epoch(r) == _epoch(ev)))
    if kind == "replay_window":
        return nearest(lambda r: r["kind"] == "epoch_bump"
                       and r["queue"] == queue
                       and (_epoch(r) is None or _epoch(r) == _epoch(ev)))
    if kind == "epoch_bump":
        return nearest(lambda r: r["kind"] == "lease_expired"
                       and r["queue"] == queue
                       and (_epoch(r) is None
                            or _epoch(r) == _prev_epoch(ev)))
    if kind == "breaker_trip":
        return nearest(lambda r: r["kind"] == "engine_crash"
                       and r["queue"] == queue)
    if kind == "crash_recovered":
        return nearest(lambda r: r["kind"] == "journal_corrupt"
                       and r["queue"] == queue)
    if kind == "autotune_oscillation":
        dec = (ev.get("refs") or {}).get("decision")
        return nearest(lambda r: r["kind"].startswith("autotune_")
                       and r["kind"] != "autotune_oscillation"
                       and r["queue"] == queue
                       and (dec is None
                            or (r.get("refs") or {}).get("decision") == dec))
    return None


def root_chain(bundle: dict) -> "list[dict]":
    """The machine-readable causal chain, CAUSE-FIRST: walk the trigger
    event back through the rule table until no parent resolves, then
    reverse. Each element is the full spine row."""
    spine = sorted(bundle.get("spine", []), key=lambda r: r["seq"])
    trig = bundle["trigger"]
    # The trigger block mirrors its spine row; prefer the in-window row
    # (it has mono_ns neighbors) but fall back to the block so a trigger
    # that rotated out of the window still anchors the chain.
    ev = next((r for r in spine if r["seq"] == trig["seq"]), None)
    if ev is None:
        ev = {"seq": trig["seq"], "kind": trig["kind"],
              "queue": trig["queue"], "detail": trig["detail"],
              "refs": trig.get("refs") or {},
              "mono_ns": trig.get("mono_ns", 0),
              "wall": trig.get("wall", 0.0),
              "component": trig.get("component", "")}
    chain = [ev]
    seen = {ev["seq"]}
    while True:
        parent = _parent_of(chain[-1], spine)
        if parent is None or parent["seq"] in seen:
            break
        chain.append(parent)
        seen.add(parent["seq"])
    chain.reverse()
    return chain


def _fmt_refs(refs: dict) -> str:
    if not refs:
        return ""
    return " {" + ", ".join(f"{k}={v}" for k, v in sorted(refs.items())) + "}"


def render_timeline(bundle: dict, limit: int = 0, out=sys.stdout) -> None:
    """Seq-ordered spine window with mono-gap annotations."""
    spine = sorted(bundle.get("spine", []), key=lambda r: r["seq"])
    if limit:
        spine = spine[-limit:]
    chain_seqs = {r["seq"] for r in root_chain(bundle)}
    trig_seq = bundle["trigger"]["seq"]
    prev_ns = None
    for ev in spine:
        gap_ms = ((ev["mono_ns"] - prev_ns) / 1e6
                  if prev_ns is not None else 0.0)
        prev_ns = ev["mono_ns"]
        marks = ("*" if ev["seq"] == trig_seq
                 else "|" if ev["seq"] in chain_seqs else " ")
        flag = "  << gap" if gap_ms > GAP_FLAG_MS else ""
        print(f"  {marks} #{ev['seq']:<6} +{gap_ms:9.3f}ms "
              f"[{ev['component']:<11}] {ev['kind']:<28} "
              f"{ev['queue'] or '-':<22}"
              f"{_fmt_refs(ev.get('refs') or {})}{flag}", file=out)
        if ev["seq"] == trig_seq and ev.get("detail"):
            print(f"             trigger: {ev['detail']}", file=out)


def render(bundle: dict, limit: int = 0, out=sys.stdout) -> None:
    trig = bundle["trigger"]
    print(f"incident {bundle['id']} — trigger class "
          f"{trig['class']!r} (kind {trig['kind']!r}, queue "
          f"{trig['queue'] or '-'!r})", file=out)
    print(f"  captured at wall {bundle['captured_wall']:.3f} in "
          f"{bundle['capture_ms']:.3f} ms; spine window "
          f"{len(bundle.get('spine', []))} events, digest "
          f"{bundle.get('spine_digest', '')[:16]}…", file=out)
    if trig.get("detail"):
        print(f"  detail: {trig['detail']}", file=out)
    chain = root_chain(bundle)
    print(f"\nroot chain ({len(chain)} link(s), cause first):", file=out)
    for i, ev in enumerate(chain):
        arrow = "   " if i == 0 else "-> "
        print(f"  {arrow}#{ev['seq']} [{ev['component']}] {ev['kind']} "
              f"{ev['queue'] or '-'}{_fmt_refs(ev.get('refs') or {})}",
              file=out)
        if ev.get("detail"):
            print(f"       {ev['detail']}", file=out)
    print(f"\ntimeline ('*' trigger, '|' root-chain link, gaps "
          f">{GAP_FLAG_MS:.0f}ms flagged):", file=out)
    render_timeline(bundle, limit=limit, out=out)
    slow = bundle.get("slow_traces") or {}
    n_slow = sum(len(v) for v in slow.values())
    if n_slow:
        print(f"\nlatency evidence: {n_slow} slow exemplar(s):", file=out)
        for q, traces in sorted(slow.items()):
            for tr in traces:
                print(f"  {tr.get('trace_id')}  queue={q} "
                      f"status={tr.get('status') or '-'} "
                      f"total={tr.get('total_ms', 0):.3f}ms", file=out)
    journal = bundle.get("journal") or {}
    for q, wm in sorted(journal.items()):
        lo, hi = wm.get("lsn_range", [0, 0])
        print(f"\njournal[{q}]: seq {wm.get('seq')} (synced "
              f"{wm.get('synced_seq')}), bundle names LSN range "
              f"{lo}..{hi} — slice it offline with:\n"
              f"  python scripts/torch_journal_dump.py <journal_dir> --queue {q} "
              f"--lsn-range {lo},{hi}", file=out)
    repl = bundle.get("replication") or {}
    for q, snap in sorted(repl.items()):
        print(f"replication[{q}]: role={snap.get('role')} "
              f"epoch={snap.get('epoch')} lag={snap.get('lag')} "
              f"(sent {snap.get('sent_seq')} / acked {snap.get('acked_seq')})",
              file=out)


def analyze(bundle: dict) -> dict:
    """--json payload: validation + the machine-readable root chain."""
    chain = root_chain(bundle)
    return {
        "id": bundle.get("id"),
        "schema": bundle.get("schema"),
        "trigger": bundle.get("trigger"),
        "problems": validate_bundle(bundle),
        "spine_digest": bundle.get("spine_digest"),
        "spine_events": len(bundle.get("spine", [])),
        "capture_ms": bundle.get("capture_ms"),
        "root_chain": chain,
        "root_chain_kinds": [ev["kind"] for ev in chain],
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle", help="incident bundle JSON file")
    ap.add_argument("--n", type=int, default=0,
                    help="timeline tail length (default: full window)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable analysis (root chain included)")
    args = ap.parse_args(argv)
    with open(args.bundle, encoding="utf-8") as f:
        bundle = json.load(f)
    problems = validate_bundle(bundle)
    if problems:
        for p in problems:
            print(f"schema problem: {p}", file=sys.stderr)
        return 2
    try:
        if args.as_json:
            json.dump(analyze(bundle), sys.stdout, indent=2, sort_keys=True)
            print()
        else:
            render(bundle, limit=args.n)
    except BrokenPipeError:
        # downstream pager/head closed the pipe; exit quietly like other CLIs
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
