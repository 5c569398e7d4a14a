#!/usr/bin/env python
"""Offline WAL/segment inspector for the port's per-queue pool journal.

The on-call workflow after a crash (or a refused failover): point this at
a ``journal_dir`` and see what the disk ACTUALLY holds — per-record type
counts, the seq watermarks a replication standby would ack against, CRC
status frame by frame, and a torn-tail diagnosis (where the intact prefix
ends, how many trailing bytes a re-attaching writer would truncate).
Read-only: it never truncates, repairs, or appends.

    # one directory, every queue found in it
    python scripts/torch_journal_dump.py /var/lib/matchmaking/journal

    # one queue, machine-readable
    python scripts/torch_journal_dump.py /path/to/dir --queue matchmaking.search --json

    # slice the LSN window an incident bundle names: record
    # seq + type + payload size for every frame in [A, B]
    python scripts/torch_journal_dump.py /path/to/dir --queue matchmaking.search \
        --lsn-range 120,180

Exit status is 0 when every inspected artifact is intact, 1 when any
segment has a torn tail / CRC-bad frame or any snapshot fails
verification — so the script doubles as a fleet health probe.

Importable: :func:`inspect_queue` / :func:`inspect_dir` return the same
dicts ``--json`` prints. The journals are the port's
``utils/journal.py`` files, byte-equal to the JAX package's.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

if __package__ is None and "matchmaking_tpu_torch" not in sys.modules:
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from matchmaking_tpu_torch.service.replication import (  # noqa: E402
    RT_REPL_SNAPSHOT)
from matchmaking_tpu_torch.utils.journal import (  # noqa: E402
    RT_ADMISSION, RT_ADMIT, RT_CLEAN, RT_SEGMENT, RT_TERMINAL, RT_TERMINALS,
    _verify_snapshot, journal_path, list_snapshots, read_segment)

#: Record-type names for reports (RT_SEGMENT appears only as the header).
#: Must cover every RT_* constant in the tree — the ``protocol`` rule's
#: vocabulary check enforces it.
RT_NAMES = {
    RT_SEGMENT: "segment",
    RT_ADMIT: "admit",
    RT_TERMINAL: "terminal",
    RT_ADMISSION: "admission",
    RT_CLEAN: "clean",
    RT_TERMINALS: "terminals",
    RT_REPL_SNAPSHOT: "repl_snapshot",
}


def inspect_segment(path: str) -> dict:
    """One segment file → framing report: header, per-type record counts,
    seq watermarks (min/max + contiguity gaps), torn-tail diagnosis."""
    size = os.path.getsize(path)
    try:
        header, records, torn, intact = read_segment(path)
    except ValueError as e:
        return {"path": path, "readable": False, "error": str(e),
                "bytes": size, "torn": True, "intact_bytes": 0}
    counts: dict[str, int] = {}
    seqs = []
    for seq, rtype, _payload in records:
        counts[RT_NAMES.get(rtype, f"rtype{rtype}")] = (
            counts.get(RT_NAMES.get(rtype, f"rtype{rtype}"), 0) + 1)
        seqs.append(seq)
    gaps = []
    for a, b in zip(seqs, seqs[1:]):
        if b != a + 1:
            gaps.append([a, b])
    clean = bool(records) and records[-1][1] == RT_CLEAN
    out = {
        "path": path,
        "readable": True,
        "bytes": size,
        "header": header,
        "records": len(records),
        "counts": counts,
        "seq_min": seqs[0] if seqs else 0,
        "seq_max": seqs[-1] if seqs else 0,
        "seq_gaps": gaps,
        "clean_tail": clean,
        "torn": torn,
        "intact_bytes": intact,
    }
    if torn:
        out["torn_bytes"] = size - intact
        out["diagnosis"] = (
            f"torn tail: last intact frame ends at byte {intact} of {size} "
            f"({size - intact} trailing bytes fail CRC/length — the normal "
            "post-crash shape; a re-attaching writer truncates here)")
    return out


def inspect_queue(directory: str, queue: str) -> dict:
    """Everything on disk for one queue: the live segment plus every
    compaction snapshot (newest first) with full-read verification."""
    seg_path = journal_path(directory, queue)
    report: dict = {"queue": queue, "directory": directory}
    report["segment"] = (inspect_segment(seg_path)
                         if os.path.exists(seg_path) else None)
    snaps = []
    for seq, path in list_snapshots(directory, queue):
        snaps.append({
            "path": path,
            "anchor_seq": seq,
            "bytes": os.path.getsize(path),
            "verified": _verify_snapshot(path),
        })
    report["snapshots"] = snaps
    seg = report["segment"]
    report["intact"] = (
        (seg is None or (seg["readable"] and not seg["torn"]))
        and all(s["verified"] for s in snaps))
    return report


def slice_lsn_range(directory: str, queue: str, lo: int,
                    hi: int) -> dict:
    """The live segment's records with ``lo <= seq <= hi`` — the slice an
    incident bundle's journal watermark names (``lsn_range``), so the
    forensics workflow is: read the bundle, then dump exactly that WAL
    window. Read-only, torn tails tolerated (the intact prefix is
    sliced)."""
    seg_path = journal_path(directory, queue)
    out: dict = {"queue": queue, "lsn_range": [lo, hi], "records": []}
    if not os.path.exists(seg_path):
        out["error"] = f"no segment for queue {queue!r}"
        return out
    try:
        _header, records, torn, _intact = read_segment(seg_path)
    except ValueError as e:
        out["error"] = str(e)
        return out
    out["torn"] = torn
    seqs = [seq for seq, _rtype, _payload in records]
    if seqs:
        out["segment_range"] = [min(seqs), max(seqs)]
    for seq, rtype, payload in records:
        if lo <= seq <= hi:
            out["records"].append({
                "seq": seq,
                "type": RT_NAMES.get(rtype, f"rtype{rtype}"),
                "payload_bytes": len(payload),
            })
    if not out["records"] and seqs and hi < min(seqs):
        out["note"] = (
            f"window {lo}..{hi} predates the live segment "
            f"(seq {min(seqs)}..{max(seqs)}) — compaction carried it into "
            "a snapshot; check the snapshot at or above this range")
    return out


def inspect_dir(directory: str) -> dict:
    """Every queue with artifacts under ``directory`` → its report."""
    queues: set[str] = set()
    for path in glob.glob(os.path.join(directory, "*.journal")):
        queues.add(os.path.basename(path)[:-len(".journal")])
    for path in glob.glob(os.path.join(directory, "*.snap.*.npz")):
        queues.add(os.path.basename(path).split(".snap.")[0])
    return {q: inspect_queue(directory, q) for q in sorted(queues)}


def _render(report: dict, out=sys.stdout) -> None:
    seg = report["segment"]
    print(f"queue {report['queue']!r}", file=out)
    if seg is None:
        print("  segment: (none)", file=out)
    elif not seg.get("readable"):
        print(f"  segment: UNREADABLE — {seg['error']}", file=out)
    else:
        counts = ", ".join(f"{k}={v}" for k, v in sorted(seg["counts"].items()))
        print(f"  segment: {seg['records']} records "
              f"(seq {seg['seq_min']}..{seg['seq_max']}), {counts or 'empty'}",
              file=out)
        if seg["seq_gaps"]:
            print(f"  seq gaps: {seg['seq_gaps']} (expected after "
                  "compaction carries; replay filters by seq)", file=out)
        print(f"  clean tail: {seg['clean_tail']}", file=out)
        if seg["torn"]:
            print(f"  TORN: {seg['diagnosis']}", file=out)
    for s in report["snapshots"]:
        mark = "ok" if s["verified"] else "CORRUPT (falls back)"
        print(f"  snapshot seq {s['anchor_seq']}: {s['bytes']} bytes — "
              f"{mark}", file=out)
    print(f"  intact: {report['intact']}", file=out)


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory", help="journal_dir to inspect")
    ap.add_argument("--queue", default="",
                    help="inspect one queue (default: every queue found)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--lsn-range", default="",
                    help="A,B — dump the records with A <= seq <= B from "
                         "the live segment (the window an incident "
                         "bundle's journal watermark names); requires "
                         "--queue")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.directory):
        sys.exit(f"not a directory: {args.directory}")
    if args.lsn_range:
        if not args.queue:
            sys.exit("--lsn-range requires --queue")
        try:
            lo_s, hi_s = args.lsn_range.split(",", 1)
            lo, hi = int(lo_s), int(hi_s)
        except ValueError:
            sys.exit(f"--lsn-range wants A,B integers, got "
                     f"{args.lsn_range!r}")
        sliced = slice_lsn_range(args.directory, args.queue, lo, hi)
        if args.as_json:
            json.dump(sliced, sys.stdout, indent=2, sort_keys=True)
            print()
        else:
            print(f"queue {args.queue!r} LSN range {lo}..{hi}:")
            if sliced.get("error"):
                print(f"  error: {sliced['error']}")
            for rec in sliced["records"]:
                print(f"  seq {rec['seq']:<8} {rec['type']:<10} "
                      f"{rec['payload_bytes']} bytes")
            print(f"  {len(sliced['records'])} record(s) in range"
                  + ("  [torn tail]" if sliced.get("torn") else ""))
            if sliced.get("note"):
                print(f"  note: {sliced['note']}")
        return 0 if not sliced.get("error") else 1
    if args.queue:
        reports = {args.queue: inspect_queue(args.directory, args.queue)}
    else:
        reports = inspect_dir(args.directory)
    if args.as_json:
        json.dump(reports, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        if not reports:
            print(f"no journal artifacts under {args.directory}")
        for q in sorted(reports):
            _render(reports[q])
    return 0 if all(r["intact"] for r in reports.values()) else 1


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:
        # downstream pager/head closed the pipe; exit quietly like other CLIs
        sys.stderr.close()
        raise SystemExit(0)
