#!/usr/bin/env python3
"""A service soak on one GPU, two checkouts of the port in turns.

    python3 scripts/torch_service_ab.py --tree build/parent --tree . \
        [--soak team|elo] [--rounds 3] [--interval-ms 0,250]
        [--out results.json]

``--soak team`` (the default) is config #3's: ``chip_smoke.service_team``
of this checkout (50k players restored through the app, 8,192 requests in
bursts of 512, every answer checked). ``--soak elo`` is config #1's:
``chip_smoke.service_soak`` (phase 4's soak: 100k restored, 16,384
requests in bursts of 512, unpaced; ``--interval-ms`` is ignored). A tree
named ``PATH:off`` is PATH with tracing off (``ObservabilityConfig.trace``
False; a tree without tracing runs as it is). Each soak runs in a process
of its own whose ``matchmaking_tpu_torch`` is the named tree's. Per interval, the trees take turns, the first tree first
in even rounds and last in odd ones (A B B A A B for two trees and three
rounds). An interval of 0 publishes the bursts 5 ms apart, as the smoke
does: the publisher shares the event loop with the service, so a tree that
frees the loop sooner is offered more load at once, and its latency holds
a longer backlog. A positive interval publishes burst k at k x interval, so
every tree is offered the same load and the latency is the service's.

Prints the card, one JSON line per soak (tree, interval, offered and
served requests/s, latency p50/p99/max, windows, GC ms), and a last JSON
line with every soak. Exits non-zero if a soak fails its checks.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KEYS = ("offered_per_s", "requests_per_s", "latency_ms_p50",
        "latency_ms_p99", "latency_ms_max", "windows", "publish_batches",
        "gc_ms", "publish_s", "soak_s")
ELO_KEYS = ("requests_per_s", "latency_ms_p50", "latency_ms_p99",
            "latency_ms_max", "windows", "publish_batches", "gc_ms",
            "soak_s")


def load_smoke():
    """This checkout's chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def soak(tree: str, interval_ms: float, kind: str = "team") -> dict:
    """One soak on ``tree``'s package (this process imports it first)."""
    path, _, variant = tree.partition(":")
    sys.path.insert(0, os.path.abspath(path))
    import numpy as np

    from matchmaking_tpu_torch.config import Config, ObservabilityConfig
    from matchmaking_tpu_torch.service.contract import (
        RequestColumns,
        SearchRequest,
    )

    smoke = load_smoke()
    if kind == "team":
        res = asyncio.run(smoke.service_team(
            np, (Config, None, None, SearchRequest), "configs/team_5v5.json",
            waiting=50_000, requests=8_192, burst=512, seed=11,
            interval_s=interval_ms / 1e3))
        return {k: res[k] for k in KEYS}
    from matchmaking_tpu_torch.engine import cuda_kernels as ck

    obs = ({"trace": False} if variant == "off"
           and "trace" in ObservabilityConfig.__dataclass_fields__ else None)
    res = asyncio.run(smoke.service_soak(
        np, ck, (Config, None, RequestColumns, SearchRequest),
        "configs/elo_1v1.json", waiting=100_000, requests=16_384, burst=512,
        seed=6, observability=obs))
    return {k: res[k] for k in ELO_KEYS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout of the port (repeat for each tree)")
    ap.add_argument("--soak", choices=("team", "elo"), default="team")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--interval-ms", default="0,250",
                    help="comma-separated burst intervals (0: unpaced)")
    ap.add_argument("--out", help="write every soak's result here (JSON)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    intervals = [float(x) for x in args.interval_ms.split(",")]
    if args.child:
        print(json.dumps(soak(args.child, intervals[0], args.soak)))
        return 0
    if args.soak == "elo":
        intervals = [0.0]
    print(load_smoke().card_line())
    results = []
    for interval in intervals:
        for r in range(args.rounds):
            for tree in (args.tree if r % 2 == 0 else args.tree[::-1]):
                p = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--tree",
                     tree, "--child", tree, "--interval-ms", str(interval),
                     "--soak", args.soak],
                    capture_output=True, text=True, check=False)
                if p.returncode:
                    sys.stderr.write(p.stderr[-4000:])
                    print(f"soak on {tree} at {interval} ms failed "
                          f"(exit {p.returncode})")
                    return 1
                res = {"tree": tree, "interval_ms": interval, "round": r,
                       **json.loads(p.stdout.strip().splitlines()[-1])}
                print(json.dumps(res), flush=True)
                results.append(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"soaks": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
