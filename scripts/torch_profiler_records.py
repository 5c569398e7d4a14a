#!/usr/bin/env python3
"""Does torch.profiler see every kernel of the captured window steps on one
GPU, session after session, and which form of capture makes it lose some?

    python3 scripts/torch_profiler_records.py [--sessions 10] [--windows 8]
                                              [--shards D] [--age S]
                                              [--live-engines N]

Config #1 at full width (P = 131,072, 100k restored, ``chip_smoke``'s
seeded population), its windows of 1,024 replayed from CUDA graphs at
depth 2, on the dense engine or (``--shards D``) on the pool sharded D
ways over the one card (``chip_smoke.sharded_engine``). Each session
profiles ``--windows`` windows and prints one JSON line: the kernels the
device ran a window and the hand kernels by name, and ``short`` when a
hand kernel was counted fewer times than the windows launched it. A graph replay runs all of its kernels, so
every session of the same windows should count the same. ``--age``
seconds pass idle before the first session. The forms of capture,
``--sessions`` of each, in this order, each form followed by
``--sessions`` plain ones (``--live-engines`` N: N more engines of the
config, their graphs captured, stay alive throughout):

- ``plain``: the ``with profile(...)`` form (``chip_smoke.device_busy``);
- ``start/stop``: ``start()``, the windows, ``stop()``, no export;
- ``export``: the ``with`` form, then ``export_chrome_trace``;
- ``start/stop+export``: as ``/debug/profile`` takes it.

Prints the card first and a last JSON line with every session and, by
form, the sessions that came out short.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_smoke():
    """This checkout's chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=10)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--age", type=float, default=0.0)
    ap.add_argument("--live-engines", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.profiler as tp

    if not torch.cuda.is_available():
        print("this script needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from matchmaking_tpu_torch.config import Config
    from matchmaking_tpu_torch.engine.gpu import GpuEngine
    from matchmaking_tpu_torch.service.contract import RequestColumns

    smoke = load_smoke()
    print(smoke.card_line(), flush=True)
    cfg = Config.from_json(os.path.join(ROOT, "configs", "elo_1v1.json"),
                           backend="gpu")
    waiting, b = 100_000, smoke.FULL_B
    total = 7 * args.sessions * args.windows
    t0 = 1_700_000_000.0
    pop = smoke.Population(np, np.random.default_rng(40), waiting + total * b,
                           t0, filters=False, glicko2=False)
    eng = (smoke.sharded_engine((Config, GpuEngine, RequestColumns, None),
                                cfg, args.shards, False) if args.shards
           else GpuEngine(cfg, cfg.queues[0], device="cuda"))
    eng.warmup()
    eng.restore_columns(pop.columns(RequestColumns, eng, 0, waiting, t0), t0)
    next_w = [0]

    def windows():
        lo = next_w[0]
        next_w[0] += args.windows
        now_of = [t0 + 1.0 + 0.05 * w for w in range(lo, next_w[0])]
        return [pop.columns(RequestColumns, eng, waiting + w * b,
                            waiting + (w + 1) * b, now_of[w - lo])
                for w in range(lo, next_w[0])], now_of

    def count(prof, n):
        """``device_busy``'s counts from a finished capture."""
        kernels = [(e.count, e.key) for e in smoke.device_work(prof)]
        return {"kernels_per_window": sum(c for c, _ in kernels) / n,
                "own_kernels": {name: sum(c for c, k in kernels if name in k)
                                for name in smoke.OWN_KERNELS}}

    def session(kind):
        stream, now_of = windows()

        def run():
            smoke.drive_columnar(torch, eng, stream, now_of,
                                 cfg.engine.pipeline_depth)
            torch.cuda.synchronize()
            return args.windows
        if kind == "plain":
            got = smoke.device_busy(torch, run)
        else:
            torch.cuda.synchronize()
            if kind == "export":
                with tp.profile(activities=acts) as prof:
                    run()
            else:
                prof = tp.profile(activities=acts)
                prof.start()
                run()
                prof.stop()
            if kind.endswith("export"):
                prof.export_chrome_trace(os.path.join(tempfile.mkdtemp(),
                                                      "trace.json"))
            got = count(prof, args.windows)
        own = got["own_kernels"]
        row = {"session": kind,
               "kernels_per_window": got["kernels_per_window"],
               "own_kernels": own,
               "short": (own["block_best_kernel"] < per_window
                         * args.windows or own["prep_kernel"]
                         < per_window * args.windows
                         or (not args.shards and own["quality_accum_kernel"]
                             < args.windows))}
        print(json.dumps(row), flush=True)
        return row

    acts = [tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]
    per_window = max(1, args.shards)
    # Engines of the same config, warmed up (their graphs captured) and
    # kept alive beside the measured one.
    live = [GpuEngine(cfg, cfg.queues[0], device="cuda")
            for _ in range(args.live_engines)]
    for e in live:
        e.warmup()
    time.sleep(args.age)
    rows = [session("plain") for _ in range(args.sessions)]
    for form in ("start/stop", "export", "start/stop+export"):
        rows += [session(form) for _ in range(args.sessions)]
        rows += [session("plain") for _ in range(args.sessions)]
    short = {}
    for i, row in enumerate(rows):
        # A plain session is filed under the form of capture before it.
        kind = row["session"] if row["session"] != "plain" else next(
            (r["session"] for r in reversed(rows[:i])
             if r["session"] != "plain"), "none")
        key = kind if row["session"] != "plain" else f"plain after {kind}"
        tally = short.setdefault(key, [0, 0])
        tally[0] += row["short"]
        tally[1] += 1
    print(json.dumps({"card": smoke.card_line(), "shards": args.shards,
                      "age_s": args.age,
                      "live_engines": len(live),
                      "short_of_sessions": short, "sessions": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
