#!/usr/bin/env python3
"""The 1v1 window step run eagerly on one GPU, through this checkout's
``block_best`` operator and through another checkout's wrapper, in turns.

    python3 scripts/torch_eager_ab.py --baseline-tree build/parent \
        [--windows 24] [--shards 4] [--out results.json]

The steps that run without a CUDA graph: a ``ShardedKernelSet`` over a
``PoolMesh`` whose shards lie on several cards (``GpuEngine`` replays a
sharded step from a graph only when every shard shares one card), and
over the ``ProcessMesh`` of a process group. Each is timed here at config
#1's width (P = 131,072 with 100,000 waiting, windows of 1,024): the
dense ``KernelSet`` step; the pool mesh's all-gather and ring steps on
``("cuda:0",) × shards`` (one card standing in for several: the same
Python and launches); the process mesh's all-gather and ring steps over a
NCCL group of one.

Every step takes each window twice, on two copies of its pool: once with
this checkout's ``cuda_kernels.block_best`` and once with the baseline
tree's (``chip_smoke.load_baseline``: its ``engine/cuda_kernels.py``
under its own name), swapped in for the call, the first side alternating
window by window. All else is this checkout's code in one process, so
the difference is the wrapper's. Per step and side: the host ms until
the call returns and the ms until the card has finished it (a
synchronize), medians over the windows; the median of the paired host
ms differences; ``block_best`` launches a window. Every window's result
equals the dense step's on both sides. Prints the card and one JSON
line; exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import socket
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WAITING = 100_000
WARM = 3


def load_smoke():
    """This checkout's chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def run(smoke, baseline_tree: str, windows: int, shards: int) -> dict:
    import numpy as np
    import torch

    from matchmaking_tpu_torch.config import Config
    from matchmaking_tpu_torch.engine import cuda_kernels as ck
    from matchmaking_tpu_torch.engine import distributed, sharded
    from matchmaking_tpu_torch.engine.kernels import (
        KernelSet,
        pool_from_reference,
    )

    base = smoke.load_baseline(baseline_tree)
    wrappers = {"operator": ck.block_best, "baseline": base.block_best}
    P, B = smoke.FULL_P, smoke.FULL_B
    cfg = Config.from_json(os.path.join(ROOT, "configs/elo_1v1.json"),
                           backend="gpu")
    q, ec = cfg.queues[0], cfg.engine
    geo = dict(capacity=P, top_k=ec.top_k, pool_block=ec.pool_block,
               glicko2=False, widen_per_sec=q.widen_per_sec,
               max_threshold=q.max_threshold)
    pool, _, _ = smoke.kernel_inputs(torch, 31, P, WAITING, B, False, "cuda")
    arrays = {k: v.cpu().numpy() for k, v in pool.items()}
    free = np.nonzero(~arrays["active"])[0]
    if (WARM + windows) * B > len(free):
        raise ValueError(f"{windows} windows need more than the pool's "
                         f"{len(free)} free slots")
    rng = np.random.default_rng(31)
    packs = []
    for w in range(WARM + windows):
        packed = np.zeros((9, B), np.float32)
        packed[0] = free[w * B:(w + 1) * B]
        packed[1] = rng.normal(1500, 300, B)
        packed[2] = 350.0
        packed[5] = q.rating_threshold
        packed[7] = 1.0
        packed[8] = 1.0 + w
        packs.append(torch.from_numpy(packed).cuda())

    def launches():
        return ck.LAUNCHES["block_best"] + base.LAUNCHES["block_best"]

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        dense = KernelSet(**geo)
        steps = {"dense": (dense, {side: pool_from_reference(arrays, "cuda")
                                   for side in wrappers})}
        meshes = {"pool_mesh": sharded.pool_mesh(shards, ["cuda:0"] * shards),
                  "process_mesh": distributed.global_pool_mesh("cuda")}
        for name, mesh in meshes.items():
            for ring in (False, True):
                ks = sharded.ShardedKernelSet(mesh=mesh, ring=ring, **geo)
                steps[f"{name}_{'ring' if ring else 'all_gather'}"] = (
                    ks, {side: ks.place_pool(arrays) for side in wrappers})
        times = {name: {side: {"host_ms": [], "wall_ms": [], "launches": []}
                        for side in wrappers} for name in steps}
        for w, pk in enumerate(packs):
            order = list(wrappers) if w % 2 == 0 else list(wrappers)[::-1]
            want = None
            for name, (ks, pools) in steps.items():
                for side in order:
                    ck.block_best = wrappers[side]
                    torch.cuda.synchronize()
                    before = launches()
                    t0 = time.perf_counter()
                    out = ks.search_step_packed(pools[side], pk)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    if want is None:
                        want = out
                    elif not torch.equal(out, want):
                        raise AssertionError(
                            f"{name} ({side}) window {w}: differs from the "
                            f"dense step")
                    if w >= WARM:
                        rec = times[name][side]
                        rec["host_ms"].append((t1 - t0) * 1e3)
                        rec["wall_ms"].append((t2 - t0) * 1e3)
                        rec["launches"].append(launches() - before)
    finally:
        ck.block_best = wrappers["operator"]
        distributed.shutdown_distributed()
    res = {}
    for name, sides in times.items():
        new, old = sides["operator"]["host_ms"], sides["baseline"]["host_ms"]
        res[name] = {
            **{f"{side}_{k}": statistics.median(r[k])
               for side, r in sides.items() for k in ("host_ms", "wall_ms")},
            "host_ms_paired_difference": statistics.median(
                a - b for a, b in zip(new, old)),
            "block_best_a_window": max(sides["operator"]["launches"]),
            "windows": len(new)}
        if sides["operator"]["launches"] != sides["baseline"]["launches"]:
            raise AssertionError(f"{name}: launches differ between sides")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-tree", required=True,
                    help="another checkout of the port")
    ap.add_argument("--windows", type=int, default=24)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--out", help="write the result here (JSON)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    smoke = load_smoke()
    print(smoke.card_line())
    res = run(smoke, args.baseline_tree, args.windows, args.shards)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"steps": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
