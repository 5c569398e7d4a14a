#!/usr/bin/env python
"""Where does the per-window wall time go in the port's columnar engine
loop? (The port of ``scripts/profile_engine.py``.)

Per window, through the port's ``GpuEngine`` at config #1's geometry (P =
131,072, blocks of 8,192, buckets 16/64/256/W, 100k players restored):
column generation, ``search_columns_async`` (the host dispatch: dedupe,
allocate, pack, the pinned copy and the graph replay), ``flush`` (the
collect and finalize) and the refill; then one window's dispatch
internals by hand: ``allocate_columns``, ``batch_arrays_cols``, the copy
to the device (waited for), the eager ``KernelSet.search_step`` call
(host time only), the device wait and the copy back; and the engine's own
``span_report()`` beside them. Host clock throughout: the card only sets
how long the waits take.

With ``--device cpu`` the engine runs on the CPU (the kernels' plain
versions): a check of the script, not a device number. Without a card,
and without ``--device cpu``, it exits non-zero.

    python scripts/torch_profile_engine.py                 # W = 1,024
    python scripts/torch_profile_engine.py --window 2048 --windows 30
    python scripts/torch_profile_engine.py --device cpu --capacity 4096 \\
        --pool-block 512 --pool 3000 --window 64 --windows 4
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

#: The shared helpers live beside this script (its directory is already on
#: the path when it runs as a script; importers get it last).
HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.append(HERE)
from torch_profile_step import (  # noqa: E402
    CHECKED_WINDOW,
    check_candidates,
    device_line,
    resolve_device,
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_columns(rng, n, start_id, now):
    from matchmaking_tpu_torch.service.contract import RequestColumns

    return RequestColumns(
        ids=np.char.add("p", np.arange(start_id, start_id + n).astype(str)).astype(object),
        rating=rng.normal(1500.0, 300.0, size=n).astype(np.float32),
        rd=np.zeros(n, np.float32),
        region=np.zeros(n, np.int32),
        mode=np.zeros(n, np.int32),
        threshold=np.full(n, np.nan, np.float32),
        enqueued_at=np.full(n, now, np.float64),
    )


def profile(window: int = 1024, windows: int = 30, pool: int = 100_000,
            capacity: int = 131_072, pool_block: int = 8192,
            device="cuda") -> dict:
    """The per-window split and one window's dispatch internals (ms).
    Returns every number it logs."""
    import torch

    from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
    from matchmaking_tpu_torch.engine.interface import make_engine
    from matchmaking_tpu_torch.engine.kernels import packed_now, unpack_batch

    device = torch.device(device)
    W = window
    cfg = Config(
        queues=(QueueConfig(rating_threshold=100.0),),
        engine=EngineConfig(backend="gpu", pool_capacity=capacity,
                            pool_block=pool_block,
                            batch_buckets=tuple(sorted({16, 64, 256, W}))),
    )
    eng = make_engine(cfg, cfg.queues[0], device=device)
    rng = np.random.default_rng(0)
    log(f"{device_line(device)}  window={W}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Fill the pool.
    nid = 0
    t0 = time.perf_counter()
    while eng.pool_size() < pool:
        n = min(8192, pool - eng.pool_size())
        eng.restore_columns(make_columns(rng, n, nid, 0.0), 0.0)
        nid += n
    sync()
    fill_s = time.perf_counter() - t0
    log(f"fill: {fill_s:.1f}s")

    # Warm-up (the graphs' captures).
    for _ in range(3):
        eng.search_columns_async(make_columns(rng, W, nid, 1.0), 1.0)
        nid += W
        eng.flush()
    for k in eng.spans:  # the span report covers the timed windows only
        eng.spans[k] = type(eng.spans[k])(0)

    gen = disp = coll = refill = 0.0
    matches = 0
    for i in range(windows):
        t = time.perf_counter()
        cols = make_columns(rng, W, nid, 2.0 + i)
        nid += W
        gen += time.perf_counter() - t
        t = time.perf_counter()
        eng.search_columns_async(cols, 2.0 + i)
        disp += time.perf_counter() - t
        t = time.perf_counter()
        outs = eng.flush()
        coll += time.perf_counter() - t
        matches += sum(o.n_matches for _, o in outs)
        t = time.perf_counter()
        deficit = pool - eng.pool_size()
        if deficit > 0:
            eng.restore_columns(make_columns(rng, deficit, nid, 2.0 + i),
                                2.0 + i)
            nid += deficit
        refill += time.perf_counter() - t
    per_window = {"make_columns": gen, "dispatch(search_columns_async)": disp,
                  "collect+finalize(flush)": coll, "refill(restore)": refill}
    per_window = {k: v / windows * 1e3 for k, v in per_window.items()}
    for name, v in per_window.items():
        log(f"{name:32s} {v:8.2f} ms/window")
    log(f"matches/window: {matches / windows:.0f}")
    spans = eng.span_report()
    log("span_report: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in spans.items()))

    # Dispatch internals, one window.
    cols = make_columns(rng, W, nid, 99.0)
    nid += W
    host_pool = eng.pool
    t = time.perf_counter()
    slots = host_pool.allocate_columns(cols)
    t1 = time.perf_counter() - t
    t = time.perf_counter()
    batch = host_pool.batch_arrays_cols(cols, slots, W, 0.0)
    t2 = time.perf_counter() - t
    staging = eng._stage(batch, 99.0)
    t = time.perf_counter()
    packed = staging.to(device, non_blocking=True)
    sync()
    t3 = time.perf_counter() - t
    tb = unpack_batch(packed)
    check = None
    if device.type == "cuda" and W > CHECKED_WINDOW:
        check = check_candidates(eng.kernels, eng.dev_pool, tb,
                                 tb["threshold"], packed_now(packed))
        log(f"candidate pass vs plain at B={W}: slots equal, values "
            f"bit-equal")
        sync()
    t = time.perf_counter()
    q, c, d = eng.kernels.search_step(eng.dev_pool, tb, packed_now(packed))
    t4 = time.perf_counter() - t
    t = time.perf_counter()
    sync()
    t5 = time.perf_counter() - t
    t = time.perf_counter()
    raw = [x.cpu() for x in (q, c, d)]
    t6 = time.perf_counter() - t
    internals = {"allocate_columns": t1, "batch_arrays_cols": t2,
                 "h2d (blocked)": t3, "search_step call (dispatch only)": t4,
                 "device exec (block)": t5, "d2h": t6}
    internals = {k: v * 1e3 for k, v in internals.items()}
    for name, v in internals.items():
        log(f"{name:32s} {v:8.2f} ms")
    one_matches = int((raw[0] < eng.kernels.capacity).sum())
    log(f"matches in that window: {one_matches}/{W}")
    eng.close()
    return {"device": str(device), "window": W, "windows": windows,
            "fill_s": fill_s, "ms_per_window": per_window,
            "matches_per_window": matches / windows, "span_report": spans,
            "dispatch_internals_ms": internals, "check": check}


def main(argv: "list[str] | None" = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--window", type=int, default=1024)
    p.add_argument("--windows", type=int, default=30)
    p.add_argument("--pool", type=int, default=100_000)
    p.add_argument("--capacity", type=int, default=131_072)
    p.add_argument("--pool-block", type=int, default=8192)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    profile(args.window, args.windows, args.pool, args.capacity,
            args.pool_block, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
