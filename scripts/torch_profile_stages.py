#!/usr/bin/env python
"""Stage-level profiling of the port's engine hot path (the port of
``scripts/profile_stages.py``).

Modes (``--mode``):

  device       device time of the engine's step: its captured CUDA graph
               of ``search_step_packed`` (with the quality fold, as the
               main path replays it; with and without filters) replayed N
               times back to back between two CUDA events, one sync. No
               host work and no host sync among the replays.
  dispatch     host cost of ONE window dispatch with 0/1/2/4/8 steps
               already queued: "h2d" (the pinned copy of the packed
               window into the graph's input), "jit_call" (the replay's
               host time) and "sync_after" (the wait for the device).
  window       window latency (dispatch → host collect) and matches/s at
               one (window, depth), through ``search_columns_async`` /
               ``collect_ready`` / ``flush`` with the pool refilled.
  sweep        ``window`` over a (window, depth) matrix: p50/p99 latency
               and matches/s, the operating-point picker.
  prunecheck   the rating-banded pruned step against the dense one from
               one pool state: outputs and pool bit-identical (else the
               run fails), the window's path through the pruned step
               (its spans, or the dense fallback when a chunk reaches
               past W blocks), then ms a step for both, with and without
               filters.
  rescanstall  the dent a rescan tick makes under pipelined traffic: one
               rescan every ``--rescan-every`` windows, OVERLAP (the
               rescan joins the stream) against DRAIN (flush, rescan,
               flush), through ``rescan_async`` / ``rescan_tokens``.

Every engine is the port's ``GpuEngine`` (``EngineConfig(backend="gpu")``
with ``batch_buckets=(window,)``, ``top_k=8``), filled to ``--pool``
players through ``restore_columns`` from ``np.random.default_rng(0)``.
At a window above 1,024 the modes that take the step first hold the
candidate pass to its plain version on the same CUDA tensors (equal
slots, bit-equal values). Timed phases repeat ``--reps`` times.

With ``--device cpu`` every mode runs on the CPU (the kernels' plain
versions, no graphs) and each time is the host's wall clock: a check of
the script, not a device number. Without a card, and without ``--device
cpu``, it exits non-zero.

    python scripts/torch_profile_stages.py --mode device --window 1024
    python scripts/torch_profile_stages.py --mode prunecheck --window 1024 \\
        --prune-window-blocks 6
    python scripts/torch_profile_stages.py --mode sweep --device cpu \\
        --capacity 4096 --pool-block 512 --pool 3000 --sweep-windows 64 \\
        --sweep-depths 1,2
"""

from __future__ import annotations

import argparse
import os
import statistics
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
    clone_pool,
    device_line,
    no_sync,
    resolve_device,
    same,
)

MODES = ("device", "dispatch", "window", "sweep", "prunecheck", "rescanstall")
#: Steps queued ahead of the timed dispatch.
DEPTHS = (0, 1, 2, 4, 8)


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


def make_engine(args, window, *, pool_block=None, readback_group=1,
                prune_window_blocks=0, prune_chunk=128, band_spec=""):
    """A ``GpuEngine`` on ``args.device`` filled to ``args.pool`` players;
    returns (engine, rng, next id)."""
    from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
    from matchmaking_tpu_torch.engine import interface

    cfg = Config(
        queues=(QueueConfig(rating_threshold=args.threshold),),
        engine=EngineConfig(
            backend="gpu", pool_capacity=args.capacity,
            pool_block=pool_block or args.pool_block,
            batch_buckets=(window,), top_k=8,
            readback_group=readback_group,
            prune_window_blocks=prune_window_blocks, prune_chunk=prune_chunk,
            band_spec=band_spec,
        ),
    )
    engine = interface.make_engine(cfg, cfg.queues[0], device=args.device)
    rng = np.random.default_rng(0)
    next_id = 0
    while engine.pool_size() < args.pool:
        chunk = min(args.pool - engine.pool_size(), 8192)
        engine.restore_columns(make_columns(rng, chunk, next_id, 0.0), 0.0)
        next_id += chunk
    return engine, rng, next_id


def packed_window(engine, rng, next_id, window):
    """One window of fresh requests admitted to the host mirror and packed
    f32[9, B] on the engine's device (its rows rewrite the same slots at
    every step: the step's cost does not depend on the values)."""
    import torch

    from matchmaking_tpu_torch.core.pool import pack_batch

    cols = make_columns(rng, window, next_id, 0.0)
    slots = engine.pool.allocate_columns(cols)
    batch = engine.pool.batch_arrays_cols(cols, slots, window, 0.0)
    return torch.from_numpy(pack_batch(batch, 0.0)).to(engine.device)


def check_window(engine, packed, ks=None) -> "dict | None":
    """Above the largest window a card run has checked, the candidate pass
    against its plain version on the engine's pool (CUDA only)."""
    from matchmaking_tpu_torch.engine.kernels import packed_now, unpack_batch

    if engine.device.type != "cuda" or packed.shape[1] <= CHECKED_WINDOW:
        return None
    batch = unpack_batch(packed)
    rep = check_candidates(ks or engine.kernels, engine.dev_pool, batch,
                           batch["threshold"], packed_now(packed))
    log(f"[check] candidate pass vs plain at B={packed.shape[1]}: slots "
        f"equal, values bit-equal")
    return rep


def timed_replays(torch, replay, iters, device) -> float:
    """ms of one of ``iters`` replays queued back to back (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with no_sync(device):
        start.record()
        for _ in range(iters):
            replay()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def mode_device(args) -> dict:
    """The engine's captured step, replayed back to back: device ms a step,
    for its dense variant and the one without filters."""
    import torch

    engine, rng, next_id = make_engine(args, args.window)
    packed = packed_window(engine, rng, next_id, args.window)
    out = {"check": check_window(engine, packed), "ms": {}}
    for variant in ("dense", "dense_nofilter"):
        if engine._graphs is not None:
            g = engine._step_graph(variant, args.window)
            g.static_in.copy_(packed)
            engine._graphs.replay(g)
            torch.cuda.synchronize(engine.device)

            def step():
                engine._graphs.replay(g)
        else:
            run = engine._step_fn(variant)

            def step():
                run(engine.dev_pool, packed)
        times = []
        for rep in range(args.reps):
            if engine._graphs is not None:
                ms = timed_replays(torch, step, args.iters, engine.device)
            else:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    step()
                ms = (time.perf_counter() - t0) / args.iters * 1e3
            times.append(ms)
            log(f"[device {variant} rep{rep}] {args.iters} chained steps: "
                f"{ms * args.iters:.1f} ms total, {ms:.3f} ms/step "
                f"(B={args.window}, P={engine.kernels.capacity})")
        out["ms"][variant] = times
    engine.close()
    return out


def mode_dispatch(args) -> dict:
    """Host cost of one dispatch with ``depth`` steps queued ahead of it:
    the pinned copy of the packed window into the graph's input, the
    replay, the wait for the device."""
    import torch

    engine, rng, next_id = make_engine(args, args.window)
    packed = packed_window(engine, rng, next_id, args.window)
    check = check_window(engine, packed)
    cuda = engine._graphs is not None
    staging = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=cuda)
    staging.copy_(packed)
    if cuda:
        g = engine._step_graph("dense", args.window)
        dest = g.static_in

        def call():
            engine._graphs.replay(g)
    else:
        dest = torch.empty_like(staging)
        run = engine._step_fn("dense")

        def call():
            run(engine.dev_pool, dest)

    def sync():
        if cuda:
            torch.cuda.synchronize(engine.device)

    dest.copy_(staging, non_blocking=True)
    call()
    sync()
    rows = {}
    for depth in DEPTHS:
        rows[depth] = {"h2d_ms": [], "jit_call_ms": [], "sync_after_ms": []}
        for rep in range(args.reps):
            sync()  # drain
            for _ in range(depth):  # queue ``depth`` steps ahead
                dest.copy_(staging, non_blocking=True)
                call()
            t_h2d0 = time.perf_counter()
            dest.copy_(staging, non_blocking=True)
            t_h2d1 = time.perf_counter()
            call()
            t_disp = time.perf_counter()
            sync()
            t_sync = time.perf_counter()
            row = rows[depth]
            row["h2d_ms"].append(1e3 * (t_h2d1 - t_h2d0))
            row["jit_call_ms"].append(1e3 * (t_disp - t_h2d1))
            row["sync_after_ms"].append(1e3 * (t_sync - t_disp))
            log(f"[dispatch depth={depth} rep{rep}] "
                f"h2d={row['h2d_ms'][-1]:.2f} ms "
                f"jit_call={row['jit_call_ms'][-1]:.2f} ms "
                f"sync_after={row['sync_after_ms'][-1]:.2f} ms")
    engine.close()
    return {"check": check, "depths": rows}


def mode_window(args) -> dict:
    return run_point(args, args.window, args.depth, reps=args.reps,
                     iters=args.iters)


def run_point(args, window, depth, reps, iters) -> dict:
    """Windows of ``window`` fresh requests at pipeline depth ``depth``,
    the pool refilled to ``args.pool`` between them: matches/s and window
    latency p50/p99 a rep, and the median rep."""
    if depth < args.readback_group:
        log(f"[warn] depth {depth} < readback-group {args.readback_group}: "
            f"groups never fill before the depth gate blocks — this point "
            f"measures wait-dominated stale seals")
    engine, rng, next_id = make_engine(args, window,
                                       readback_group=args.readback_group)
    results = []
    for rep in range(reps):
        lats, matches, t0 = [], 0, time.perf_counter()
        submit = {}
        done_t = t0

        def handle(tok, out):
            nonlocal matches, done_t
            lats.append(time.perf_counter() - submit.pop(tok))
            matches += out.n_matches
            done_t = time.perf_counter()

        for _ in range(iters):
            now = time.perf_counter() - t0
            cols = make_columns(rng, window, next_id, now)
            next_id += window
            tok = engine.search_columns_async(cols, now)
            submit[tok] = time.perf_counter()
            for tok2, out in engine.collect_ready():
                handle(tok2, out)
            while engine.inflight() >= depth:
                got = engine.collect_ready()
                if not got:
                    time.sleep(0.0002)
                for tok2, out in got:
                    handle(tok2, out)
            # refill
            deficit = args.pool - engine.pool_size()
            if deficit >= 8192:
                engine.restore_columns(
                    make_columns(rng, deficit, next_id, now), now)
                next_id += deficit
        for tok2, out in engine.flush():
            handle(tok2, out)
        span = done_t - t0
        lat_ms = np.sort(np.array(lats)) * 1e3
        mps = matches / span if span > 0 else 0
        results.append((mps, float(np.percentile(lat_ms, 50)),
                        float(np.percentile(lat_ms, 99))))
        log(f"[B={window} d={depth} rep{rep}] {mps:.0f} m/s "
            f"p50={results[-1][1]:.1f} ms p99={results[-1][2]:.1f} ms")
    reps_out = list(results)
    results.sort()
    med = results[len(results) // 2]
    log(f"[B={window} d={depth} MEDIAN] {med[0]:.0f} m/s "
        f"p50={med[1]:.1f} p99={med[2]:.1f}")
    spans = engine.span_report()
    engine.close()
    return {"window": window, "depth": depth, "reps": reps_out,
            "median": med, "spans": spans}


def mode_sweep(args) -> dict:
    table = {}
    windows = [int(w) for w in args.sweep_windows.split(",")]
    depths = [int(d) for d in args.sweep_depths.split(",")]
    for window in windows:
        for depth in depths:
            table[(window, depth)] = run_point(
                args, window, depth, reps=args.reps,
                iters=args.iters)["median"]
    log("window depth mps p50 p99")
    for (w, d), (mps, p50, p99) in sorted(table.items()):
        log(f"{w:6d} {d:3d} {mps:8.0f} {p50:7.1f} {p99:7.1f}")
    return {"table": [[w, d, *v] for (w, d), v in sorted(table.items())]}


def mode_prunecheck(args) -> dict:
    """Rating-banded pruning against dense from one pool state: the
    outputs and pools of one step through each must be bit-identical
    (else ``AssertionError``), then ms a step for both kernel sets, with
    and without filters (each a captured graph on the card, chained on a
    copy of the pool)."""
    import torch

    from matchmaking_tpu_torch.engine.graphs import StepGraphs
    from matchmaking_tpu_torch.engine.kernels import KernelSet

    w = args.prune_window_blocks or 12
    engine, rng, next_id = make_engine(
        args, args.window, prune_window_blocks=w,
        prune_chunk=args.prune_chunk, band_spec="gaussian:1500:300")
    pruned_k = engine.kernels
    dense_k = KernelSet(
        capacity=pruned_k.capacity, top_k=8, pool_block=pruned_k.pool_block,
        glicko2=pruned_k.glicko2, widen_per_sec=pruned_k.widen_per_sec,
        max_threshold=pruned_k.max_threshold,
        pair_rounds=pruned_k.pair_rounds, exact_block=True)
    packed = packed_window(engine, rng, next_id, args.window)
    check = check_window(engine, packed, dense_k)
    base_pool = engine.dev_pool

    # Exactness: one step through each kernel set from the same state.
    p1, p2 = clone_pool(base_pool), clone_pool(base_pool)
    steps0 = pruned_k.pruned_steps
    o1 = dense_k.search_step_packed(p1, packed)
    o2 = pruned_k.search_step_packed(p2, packed)
    same_out = same(o1, o2)
    same_pool = same(dict(p1), dict(p2))
    span_path = (None if pruned_k.span_steps is None
                 else int(pruned_k.span_steps.sum()))
    # The window's path through the pruned step: its spans, or the dense
    # fallback when some chunk's reach is wider than W blocks.
    path = "span" if span_path else "fallback"
    log(f"[prunecheck] outputs bit-identical: {same_out}, "
        f"pool bit-identical: {same_pool} "
        f"(B={args.window}, P={pruned_k.capacity}, "
        f"blocks={pruned_k.n_blocks}, W={pruned_k.prune_window_blocks}, "
        f"chunk={pruned_k.prune_chunk}, "
        f"matches={int((o1[0] < pruned_k.capacity).sum())}, pruned steps "
        f"{pruned_k.pruned_steps - steps0}, on the span path so far "
        f"{span_path}: the {path} path)")
    if not (same_out and same_pool):
        raise AssertionError("prunecheck: the pruned step differs from the "
                             "dense one")
    del p1, p2

    cuda = engine.device.type == "cuda"
    ms: dict[str, list[float]] = {}
    for name, k in (("dense", dense_k), ("pruned", pruned_k),
                    ("dense/nf", dense_k), ("pruned/nf", pruned_k)):
        nofilter = name.endswith("/nf")
        pool_dev = clone_pool(base_pool)

        def run(pool, _=None, k=k, nofilter=nofilter):
            return k.search_step_packed(pool, packed, skip_filters=nofilter)

        if cuda:
            graphs = StepGraphs(k, engine.device)
            g = graphs.capture(name, args.window, run, pool_dev,
                               torch.zeros(1), clone_pool(base_pool),
                               debug=True)

            def step(graphs=graphs, g=g):
                graphs.replay(g)
        else:
            def step(pool_dev=pool_dev, run=run):
                run(pool_dev)
        step()
        times = []
        for _ in range(args.reps):
            if cuda:
                times.append(timed_replays(torch, step, args.iters,
                                           engine.device))
            else:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    step()
                times.append((time.perf_counter() - t0) / args.iters * 1e3)
        ms[name] = times
        log(f"[prunecheck {name}] ms/step min/med/max: "
            f"{min(times):.3f}/{statistics.median(times):.3f}/"
            f"{max(times):.3f}")
    engine.close()
    if cuda:
        torch.cuda.empty_cache()
    return {"check": check, "bit_identical": True,
            "window_blocks": pruned_k.prune_window_blocks,
            "chunk": pruned_k.prune_chunk, "span_path_steps": span_path,
            "path": path, "ms": ms}


def mode_rescanstall(args) -> dict:
    """Throughput/latency dent of a rescan tick under sustained load:
    pipelined windows (depth ``--depth``) with one rescan every
    ``--rescan-every`` windows, the OVERLAP discipline (the rescan joins
    the stream) against DRAIN (flush the pipeline, rescan, flush again).
    The windows keep matching ~everything, so the pool is held by refill
    and the rescan itself finds little: the scheduling cost alone."""
    out = {}
    for discipline in ("overlap", "drain"):
        engine, rng, next_id = make_engine(
            args, args.window, readback_group=args.readback_group)
        engine.warmup()   # every step variant, the rescan one too: no
        # capture mid-measurement

        def refill(now):
            nonlocal next_id
            while engine.pool_size() < args.pool:
                chunk = min(args.pool - engine.pool_size(), 8192)
                engine.restore_columns(
                    make_columns(rng, chunk, next_id, now), now)
                next_id += chunk

        lat, matches, rescans = [], 0, 0
        submit = {}
        t0 = time.perf_counter()

        def wall():
            return time.perf_counter() - t0

        def drainall():
            for tok, _ in engine.flush():
                if tok in submit:
                    lat.append(time.perf_counter() - submit.pop(tok))
            engine.rescan_tokens.clear()

        n = args.iters * args.reps
        t_start = None
        for i in range(n + 5):
            if i == 5:
                t_start = time.perf_counter()
                matches = 0
            if i % args.rescan_every == 0 and i > 0:
                rescans += 1
                if discipline == "drain":
                    drainall()
                    engine.rescan_async(args.window, wall())
                    drainall()
                else:
                    engine.rescan_async(args.window, wall())
            cols = make_columns(rng, args.window, next_id, wall())
            next_id += args.window
            tok = engine.search_columns_async(cols, wall())
            submit[tok] = time.perf_counter()
            while engine.inflight() >= args.depth:
                got = engine.collect_ready()
                if not got:
                    time.sleep(0.0005)
                for tok2, res in got:
                    if tok2 in submit:
                        lat.append(time.perf_counter() - submit.pop(tok2))
                        matches += getattr(res, "n_matches", 0)
                    engine.rescan_tokens.discard(tok2)
            refill(wall())
        drainall()
        span = time.perf_counter() - t_start
        ls = sorted(lat)
        p99 = ls[max(0, int(len(ls) * 0.99) - 1)]
        out[discipline] = {"matches_per_s": matches / span,
                           "p50_ms": statistics.median(ls) * 1e3,
                           "p99_ms": p99 * 1e3, "windows": n,
                           "rescans": rescans}
        log(f"[rescanstall {discipline}] {matches / span:,.0f} matches/s, "
            f"window p50 {statistics.median(ls) * 1e3:.1f} ms, "
            f"p99 {p99 * 1e3:.1f} ms "
            f"({n} windows, rescan every {args.rescan_every})")
        engine.close()
    return out


def parse_args(argv: "list[str] | None" = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=MODES, default="device")
    p.add_argument("--rescan-every", type=int, default=10,
                   help="rescanstall: windows between rescan ticks")
    p.add_argument("--pool", type=int, default=100_000)
    p.add_argument("--capacity", type=int, default=131_072)
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--sweep-windows", default="256,512,1024,2048")
    p.add_argument("--sweep-depths", default="1,2,3,4")
    p.add_argument("--readback-group", type=int, default=1,
                   help="device-side result grouping for the window, sweep "
                        "and rescanstall modes")
    p.add_argument("--pool-block", type=int, default=8192)
    p.add_argument("--prune-window-blocks", type=int, default=0,
                   help="prunecheck: span width W (0 → 12)")
    p.add_argument("--prune-chunk", type=int, default=128)
    p.add_argument("--threshold", type=float, default=100.0,
                   help="queue rating_threshold; tighter values shrink the "
                        "admissible rating spans prunecheck measures")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p.parse_args(argv)


def run(args) -> dict:
    """The chosen mode on ``args.device`` (a name or a torch device)."""
    args.device = resolve_device(str(args.device))
    log(device_line(args.device))
    return {"device": mode_device, "dispatch": mode_dispatch,
            "window": mode_window, "sweep": mode_sweep,
            "prunecheck": mode_prunecheck,
            "rescanstall": mode_rescanstall}[args.mode](args)


def main(argv: "list[str] | None" = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
