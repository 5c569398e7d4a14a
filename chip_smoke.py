#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (matchmaking_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out results.json] [--profile]
                          [--baseline-tree DIR] [--plan-sweep]

Phases, each of which raises (exit code != 0) when it fails:

1. build: compile csrc/block_best.cu with nvcc for sm_90a; print the card
   and its max SM clock; report each kernel instance's registers, shared
   memory and spills (ptxas) and the ELO scorer's inner-loop instructions
   per pair (cuobjdump -sass, where the toolkit has it).
2. kernel: the block_best kernel against its plain PyTorch version on the
   same CUDA tensors, at full pool width (P = 131,072 slots in blocks of
   8,192, 100k active) and every window bucket (B = 16, 64, 256, 1,024),
   for all four instances (Glicko-2 x filters) with widening off and on;
   plus ragged small shapes and a crafted exact tie across the cluster's
   slices. Slots must be equal and values bit-equal. Times the kernel at
   every bucket (CUDA events, median of 30, device time), the wrapper's
   host time per call at every bucket, and the plain version at B = 1,024,
   and computes the bound. ``--baseline-tree DIR`` loads the wrapper of
   another checkout of the port (e.g. the parent commit, unpacked with
   ``git archive`` under a git-ignored directory), which builds that
   tree's kernel source; it is checked the same way and timed in turns
   with this one (old, new, new, old) on the same inputs.
3. engine: the main path. GpuEngine with configs/elo_1v1.json (backend
   overridden to "gpu"), filled to 100k waiting players with restore(),
   then 24 windows of 1,024 requests through search(). Checks that no
   player is in two matches, every pair fits both effective thresholds,
   pool_size accounting holds and block_best launched once per window;
   re-runs the first 3 windows on a CPU engine fed the same inputs (same
   pairs). Then configs #2 (filters) and #4 (Glicko-2 + widening) briefly.
4. service: the in-process service demo on the card (10 players answered).

``--plan-sweep`` times five variants at every bucket under every
(rows per CTA, cluster) plan, to check ``plan_grid``'s choice.

``--profile`` splits the first config #1 window into host phases
(allocate, batch_arrays, the synchronized device step, finalize, GC
pauses), and adds 8 config #1 windows after the main path's count is
read: 4 split the same way and 4 under torch.profiler for the device's
busy share and its kernels.

The last lines of standard output are the max SM clock, the card
(nvidia-smi name and power limit), one JSON line with the kernel's numbers, and one JSON line
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import cProfile
import io
import json
import os
import pstats
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

FULL_P, FULL_BLOCK, FULL_ACTIVE, FULL_B = 131_072, 8_192, 100_000, 1_024


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def card_line(fields="name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---- phase 1: build, and what the compiler made ----------------------------


def ptxas_report(text):
    """{kernel instance: {registers, smem_bytes, spill_bytes}} from the
    ``-Xptxas -v`` output (one instance per (glicko2, filters) pair)."""
    report, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None:
            continue
        inst = re.search(r"(prep_kernel|block_best_kernel)ILb(\d)ELb(\d)E", fn)
        if inst is None:
            continue
        key = f"{inst.group(1)}<glicko2={inst.group(2)},filters={inst.group(3)}>"
        entry = report.setdefault(key, {})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["static_smem_bytes"] = int(m.group(1)) if m else 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return report


def sass_inner_loop(so_path, out_dir):
    """Instructions of the ELO scorer's candidate loops (the innermost loops
    that load a record with LDS.64), from ``cuobjdump -sass``; None
    without cuobjdump. The whole SASS of that instance goes to ``out_dir``
    when given."""
    tool = next((c for c in (os.path.join(os.environ.get("CUDA_HOME", ""),
                                          "bin", "cuobjdump"),
                             "/usr/local/cuda/bin/cuobjdump")
                 if os.path.isfile(c)), None)
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs if re.match(r"\S*block_best_kernelILb0ELb0E", f)),
                None)
    if body is None:
        return None
    if out_dir:
        with open(os.path.join(out_dir, "block_best_elo.sass"), "w") as f:
            f.write(body)
    insts, labels = [], {}
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(insts)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            insts.append((int(m.group(1), 16), m.group(2).strip()))
    addr_index = {a: k for k, (a, _) in enumerate(insts)}
    loops = []
    for k, (addr, text_) in enumerate(insts):
        m = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", text_)
        if not m:
            continue
        start = (labels.get(m.group(1)) if m.group(1)
                 else addr_index.get(int(m.group(2), 16)))
        if start is not None and start <= k:
            loops.append((start, k))
    inner = [(a, b) for a, b in loops  # loops with no loop inside them
             if not any((c, d) != (a, b) and a <= c and d <= b
                        for c, d in loops)]
    found = []
    for a, b in inner:  # the scoring loops: one LDS.64 per candidate
        ops = [t.split()[1] if t.startswith("@") else t.split()[0]
               for _, t in insts[a:b + 1]]
        lds = sum(op == "LDS.64" for op in ops)
        if not lds:
            continue
        hist = {}
        for op in ops:
            hist[op] = hist.get(op, 0) + 1
        pairs = lds * 8  # each candidate feeds the warp's 8 rows
        found.append({"instructions": len(ops), "candidates": lds,
                      "pairs": pairs, "instructions_per_pair": len(ops) / pairs,
                      "opcodes": dict(sorted(hist.items(),
                                             key=lambda kv: -kv[1]))})
    if not found:
        return None
    # The loop without the own-slot test is the one almost every tile runs.
    found.sort(key=lambda f: f["instructions_per_pair"])
    return {"instructions_per_pair": found[0]["instructions_per_pair"],
            "loops": found}


def load_baseline(tree):
    """The ``engine/cuda_kernels`` module of another checkout of the port,
    loaded under its own name. Its ``block_best`` has the same Python
    signature and builds that tree's kernel source into that tree's build
    directory, so any two commits of the port compare through it."""
    import importlib.util

    src = os.path.join(tree, "matchmaking_tpu_torch", "engine", "cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("baseline_cuda_kernels", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- phase 2: kernel vs plain ---------------------------------------------


def kernel_inputs(torch, seed, capacity, active, rows, filters, device):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def normal(n, mean, std):
        return (torch.randn(n, generator=g) * std + mean).to(device)

    def uniform(n, lo, hi):
        return (torch.rand(n, generator=g) * (hi - lo) + lo).to(device)

    def codes(n, k):
        if not filters:
            return torch.zeros(n, dtype=torch.int32, device=device)
        return torch.randint(0, k, (n,), generator=g, dtype=torch.int32).to(device)

    pool = {
        "rating": normal(capacity, 1500.0, 300.0),
        "rd": uniform(capacity, 0.0, 350.0),
        "region": codes(capacity, 4),
        "mode": codes(capacity, 3),
        "threshold": torch.full((capacity,), 100.0, device=device),
        "enqueue_t": uniform(capacity, 0.0, 30.0),
        "active": torch.randperm(capacity, generator=g).to(device) < active,
    }
    start = max(0, active - rows // 2)
    batch = {
        "slot": torch.arange(start, start + rows, dtype=torch.int32,
                             device=device).clamp_max(capacity),
        "rating": normal(rows, 1500.0, 300.0),
        "rd": uniform(rows, 0.0, 350.0),
        "region": codes(rows, 4),
        "mode": codes(rows, 3),
        "valid": torch.ones(rows, dtype=torch.bool, device=device),
    }
    q_thr = torch.full((rows,), 100.0, device=device)
    return pool, batch, q_thr


def time_ms(torch, fn, reps=30):
    """Median of ``reps`` CUDA-event timings of ``fn`` (after 3 warm-ups).
    Each timing starts behind a ~0.5 ms device sleep, so the host has
    queued ``fn``'s launches before the first event fires: the time is the
    device's, not the Python wrapper's (``host_us`` times that)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(torch, fn, reps=100):
    """Host µs per call of ``fn`` (a wrapper that only queues device work):
    the time until ``reps`` calls have returned, with no device wait in
    between, over ``reps``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def compare(torch, got, want, what):
    (kv, ki), (rv, ri) = got, want
    if not torch.equal(ki, ri):
        bad = int((ki != ri).sum())
        raise AssertionError(f"{what}: {bad} candidate slots differ")
    if not torch.equal(kv.view(torch.int32), rv.view(torch.int32)):
        raise AssertionError(f"{what}: values are not bit-equal")
    finite = torch.isfinite(rv)
    if bool(finite.any()):
        return float((kv[finite] - rv[finite]).abs().max())
    return 0.0


#: (glicko2, filters, widen): the four kernel instances, widening off and on.
#: "elo" is the main path's: config #1 windows carry no filters.
VARIANTS = {
    "elo": (False, False, 0.0),
    "elo_widen": (False, False, 5.0),
    "filters": (False, True, 0.0),
    "filters_widen": (False, True, 5.0),
    "glicko2": (True, False, 0.0),
    "glicko2_widen": (True, False, 5.0),
    "glicko2_filters": (True, True, 0.0),
    "all": (True, True, 5.0),
}
BUCKETS = (16, 64, 256, 1024)


def bound(ck, rows, glicko2, filters):
    """Least time for one full-width call: the pairs' operations over the
    FP32 peak, or the bytes (each input read once, each output written
    once) over the memory rate, whichever is larger."""
    ops = rows * FULL_P * ck.ops_per_pair(glicko2=glicko2, filters=filters)
    n_blocks = FULL_P // FULL_BLOCK
    nbytes = (FULL_P * (6 * 4 + 1) + rows * (6 * 4 + 1) + rows * n_blocks * 8)
    ops_ms, bytes_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"pairs": rows * FULL_P, "ops": ops, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def kernel_split(torch, fn, reps=20):
    """Mean device time (µs) per call of each kernel ``fn`` launches, from
    torch.profiler: the record prep and the scorer, without launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for kernel in ("prep_kernel", "block_best_kernel"):
            if kernel in e.key:
                dev = getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
                split[kernel] = split.get(kernel, 0.0) + dev / reps
    return split


def phase_kernel(torch, ck, scoring, device, baseline=None):
    """Every variant at every window bucket at full pool width: bit-equal
    to the plain version, and timed (with ``baseline``, another tree's
    ``cuda_kernels`` module, timed in turns beside it: old, new, new,
    old)."""
    kw = dict(pool_block=FULL_BLOCK, max_threshold=250.0,
              g_coeff=scoring.G_COEFF_F32)
    results, max_err = {}, 0.0
    for vi, (name, (glicko2, filters, widen)) in enumerate(VARIANTS.items()):
        args = dict(kw, glicko2=glicko2, widen_per_sec=widen, filters=filters)
        res = results[name] = {"ms_by_bucket": {}, "host_us_by_bucket": {}}
        if baseline is not None:
            res["baseline_ms_by_bucket"] = {}
            res["baseline_host_us_by_bucket"] = {}
        for b in BUCKETS:
            pool, batch, q_thr = kernel_inputs(torch, 100 + vi, FULL_P,
                                               FULL_ACTIVE, b, filters, device)
            got = ck.block_best(pool, batch, q_thr, 20.0, **args)
            want = ck.block_best_reference(pool, batch, q_thr, 20.0, **args)
            torch.cuda.synchronize()
            max_err = max(max_err, compare(torch, got, want, f"{name} B={b}"))
            new = lambda: ck.block_best(pool, batch, q_thr, 20.0, **args)
            if baseline is None:
                res["ms_by_bucket"][b] = time_ms(torch, new)
                res["host_us_by_bucket"][b] = host_us(torch, new)
            else:
                old = lambda: baseline.block_best(pool, batch, q_thr, 20.0,
                                                  **args)
                compare(torch, old(), want, f"baseline {name} B={b}")
                o1, n1, n2, o2 = (time_ms(torch, f) for f in (old, new, new, old))
                res["ms_by_bucket"][b] = statistics.median([n1, n2])
                res["baseline_ms_by_bucket"][b] = statistics.median([o1, o2])
                o1, n1, n2, o2 = (host_us(torch, f) for f in (old, new, new, old))
                res["host_us_by_bucket"][b] = statistics.median([n1, n2])
                res["baseline_host_us_by_bucket"][b] = statistics.median([o1, o2])
            if name == "elo":
                res.setdefault("kernel_us_by_bucket", {})[b] = kernel_split(
                    torch, new)
            if b == FULL_B:
                res["blocks_with_candidate"] = float(
                    torch.isfinite(got[0]).float().mean())
                res["plain_ms"] = time_ms(torch, lambda: ck.block_best_reference(
                    pool, batch, q_thr, 20.0, **args), reps=20)
                res.update(bound(ck, int(batch["valid"].sum()), glicko2,
                                 filters))
        res["ms"] = res["ms_by_bucket"][FULL_B]
        if "kernel_us_by_bucket" in res:
            log(f"kernel {name}: device µs per call by kernel "
                f"{res['kernel_us_by_bucket']}")
        log(f"kernel {name}: ms by bucket {res['ms_by_bucket']}"
            + (f", baseline {res['baseline_ms_by_bucket']}" if baseline else "")
            + f"; host µs per call {res['host_us_by_bucket']}"
            + (f", baseline {res['baseline_host_us_by_bucket']}" if baseline
               else "")
            + f" (plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms"
            f" at B={FULL_B})")
    # Ragged shapes: B = 16 / P = 256 (blocks of 64), B = 1, B = 33, and
    # blocks of 125 slots (no 16-slot alignment, no cluster split).
    for seed, (cap, blk, rows, filters) in enumerate(
            [(256, 64, 16, True), (256, 64, 1, False), (2048, 512, 33, True),
             (1000, 125, 20, True)]):
        pool, batch, q_thr = kernel_inputs(torch, 200 + seed, cap, cap * 3 // 4,
                                           rows, filters, device)
        args = dict(kw, pool_block=blk, glicko2=bool(seed % 2), widen_per_sec=3.0,
                    filters=filters)
        max_err = max(max_err, compare(
            torch, ck.block_best(pool, batch, q_thr, 20.0, **args),
            ck.block_best_reference(pool, batch, q_thr, 20.0, **args),
            f"ragged B={rows} P={cap}"))
    # Crafted exact tie: 1490 and 1510 around 1500, in both orders, spread
    # over the quarters of each block (so over the cluster's slices); the
    # lowest slot of each block must win.
    pool, batch, q_thr = kernel_inputs(torch, 300, 4096, 0, 40, False, device)
    firsts = []
    for b in range(4):
        base = b * 1024 + 37 * b + 5
        firsts.append(base)
        for j, r in enumerate((1510.0, 1490.0, 1490.0, 1510.0)):
            pool["rating"][base + 256 * j] = r
            pool["active"][base + 256 * j] = True
    batch["rating"].fill_(1500.0)
    batch["slot"].fill_(4096)
    for filters in (True, False):
        args = dict(kw, pool_block=1024, glicko2=False, widen_per_sec=0.0,
                    filters=filters)
        got = ck.block_best(pool, batch, q_thr, 0.0, **args)
        compare(torch, got, ck.block_best_reference(pool, batch, q_thr, 0.0,
                                                    **args), "exact tie")
        expect = torch.tensor(firsts, dtype=torch.int32, device=device)
        if not torch.equal(got[1], expect.expand(40, 4)):
            raise AssertionError("exact tie: the lowest slot did not win")
    torch.cuda.synchronize()
    return results, max_err


def plan_sweep(torch, ck, scoring, device, variants=("elo", "elo_widen",
                                                    "filters", "glicko2",
                                                    "all")):
    """Each variant at every bucket under every (rows per CTA, cluster)
    plan the kernel takes, each launched with that plan (``ck._launch``),
    checked bit-equal and timed: the evidence behind plan_grid's choice."""
    sweep = {}
    n_blocks = FULL_P // FULL_BLOCK
    for name in variants:
        glicko2, filters, widen = VARIANTS[name]
        kw = dict(pool_block=FULL_BLOCK, max_threshold=250.0,
                  glicko2=glicko2, filters=filters, widen_per_sec=widen,
                  g_coeff=scoring.G_COEFF_F32)
        for b in BUCKETS:
            pool, batch, q_thr = kernel_inputs(torch, 100, FULL_P,
                                               FULL_ACTIVE, b, filters, device)
            ck._check(pool, batch, q_thr, FULL_BLOCK)
            want = ck.block_best_reference(pool, batch, q_thr, 20.0, **kw)
            best = ck.plan_grid(b, n_blocks, FULL_BLOCK, ck.sm_count(0))
            row = sweep.setdefault(name, {})[b] = {
                "chosen": f"{best.rows_per_cta}x{best.cluster}"}
            for rows in ck.ROWS_PER_CTA:
                for cluster in (1, 2, 4, 8):
                    plan = ck.GridPlan(rows, cluster,
                                       (n_blocks * cluster, -(-b // rows)))
                    fn = lambda: ck._launch(plan, pool, batch, q_thr, 20.0,
                                            **kw)
                    compare(torch, fn(), want, f"plan {plan} B={b}")
                    row[f"{rows}x{cluster}"] = time_ms(torch, fn)
            log(f"plan sweep {name} B={b}: " + ", ".join(
                f"{k} {v if isinstance(v, str) else round(v * 1e3, 1)}"
                for k, v in row.items()))
    return sweep


# ---- phase 3: the engine main path -----------------------------------------


def make_requests(np, SearchRequest, rng, n, start, now, filters, glicko2):
    regions = np.array(["eu", "na", "apac", "*"])
    modes = np.array(["ranked", "casual", "*"])
    rating = rng.normal(1500.0, 300.0, n)
    rd = rng.uniform(30.0, 350.0, n) if glicko2 else np.full(n, 350.0)
    waited = rng.uniform(0.0, 20.0, n)
    reg = regions[rng.integers(0, 4, n)] if filters else np.full(n, "*")
    mode = modes[rng.integers(0, 3, n)] if filters else np.full(n, "*")
    return [SearchRequest(id=f"p{start + i}", rating=float(rating[i]),
                          rating_deviation=float(rd[i]), region=str(reg[i]),
                          game_mode=str(mode[i]),
                          enqueued_at=now - float(waited[i]))
            for i in range(n)]


def check_window(scoring, eng, reqs, out, now, before, seen, glicko2):
    """The invariants of one window; returns the number of matches."""
    q = eng.queue
    for m in out.matches:
        a, b = m.requests()
        for r in (a, b):
            if r.id in seen:
                raise AssertionError(f"{r.id} is in two matches")
            seen.add(r.id)
        d = scoring.distance(a.rating, b.rating, a.rating_deviation,
                             b.rating_deviation, glicko2=glicko2)
        limit = min(eng.effective_threshold(a, now), eng.effective_threshold(b, now))
        if d > limit + 1e-3:
            raise AssertionError(f"pair {a.id}-{b.id}: d={d} > limit {limit}")
        if not scoring.region_mode_compatible(a.region, a.game_mode,
                                              b.region, b.game_mode):
            raise AssertionError(f"pair {a.id}-{b.id} breaks the filters")
    matched = {r.id for m in out.matches for r in m.requests()}
    admitted = len(reqs) - len(out.rejected)
    if any(r.id not in matched and r.id not in {x.id for x in out.queued}
           for r in reqs):
        raise AssertionError("a request was neither matched nor queued")
    if eng.pool_size() != before + admitted - 2 * len(out.matches):
        raise AssertionError(
            f"pool_size {eng.pool_size()} != {before} + {admitted} - "
            f"2 x {len(out.matches)}")
    return len(out.matches)


def pairs_of(out):
    return {frozenset(r.id for r in m.requests()) for m in out.matches}


class GcClock:
    """Seconds spent in Python's garbage collector while installed."""

    def __init__(self):
        self.total = 0.0
        self._start = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.total += time.perf_counter() - self._start
            self._start = None

    def __enter__(self):
        import gc
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._on_gc)


@contextlib.contextmanager
def split_phases(torch, eng):
    """Seconds spent in each host phase of ``eng.search`` while inside:
    allocate, batch_arrays, the step (with a device sync after it, so it
    holds the device's work), finalize, and GC pauses."""
    per = {"allocate": 0.0, "batch_arrays": 0.0, "step": 0.0,
           "finalize": 0.0, "gc": 0.0}

    def timed(name, fn, sync=False):
        def call(*a, **k):
            t = time.perf_counter()
            r = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            per[name] += time.perf_counter() - t
            return r
        return call

    eng.pool.allocate = timed("allocate", eng.pool.allocate)
    eng.pool.batch_arrays = timed("batch_arrays", eng.pool.batch_arrays)
    eng.kernels.search_step_packed = timed(
        "step", eng.kernels.search_step_packed, sync=True)
    eng._finalize = timed("finalize", eng._finalize)
    try:
        with GcClock() as gc_clock:
            yield per
        per["gc"] = gc_clock.total
    finally:
        for name in ("allocate", "batch_arrays"):
            del eng.pool.__dict__[name]
        del eng.kernels.__dict__["search_step_packed"]
        del eng.__dict__["_finalize"]


def split_ms(per, search_s, windows):
    split = {k: v / windows * 1e3 for k, v in per.items()}
    split["search"] = search_s / windows * 1e3
    split["other"] = split["search"] - sum(
        split[k] for k in ("allocate", "batch_arrays", "step", "finalize"))
    return split


def profile_windows(torch, eng, windows, t_first):
    """Split the step of ``windows`` into host phases (``split_phases``),
    then run the same count of further windows under torch.profiler for
    the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    half = len(windows) // 2
    search_s = 0.0
    with split_phases(torch, eng) as per:
        for w, reqs in enumerate(windows[:half]):
            t = time.perf_counter()
            eng.search(reqs, t_first + w)
            search_s += time.perf_counter() - t
    split = split_ms(per, search_s, half)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for w, reqs in enumerate(windows[half:]):
            eng.search(reqs, t_first + half + w)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            kernels.append((dev, e.count, e.key))
    kernels.sort(reverse=True)
    device_us = sum(k[0] for k in kernels)
    n = len(windows) - half
    return {
        "windows_split": half, "windows_profiled": n,
        "split_ms_per_window": split,
        "profiled_wall_ms_per_window": wall / n * 1e3,
        "device_ms_per_window": device_us / n / 1e3,
        "device_busy_share": device_us / 1e6 / wall if wall else 0.0,
        "top_kernels": [{"name": k[2][:90], "count": k[1],
                         "device_ms_per_window": k[0] / n / 1e3}
                        for k in kernels[:12]],
    }


def run_engine(torch, np, ck, scoring, mods, path, *, waiting, windows,
               cpu_windows, filters, glicko2, seed, profile=0):
    Config, GpuEngine, SearchRequest = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue = cfg.queues[0]
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    fill = make_requests(np, SearchRequest, rng, waiting, 0, t0, filters, glicko2)
    stream = [make_requests(np, SearchRequest, rng, FULL_B,
                            waiting + w * FULL_B, t0 + 1.0 + w, filters, glicko2)
              for w in range(windows)]
    eng = GpuEngine(cfg, queue, device="cuda")
    eng.warmup()
    t = time.perf_counter()
    eng.restore(fill, t0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if eng.pool_size() != waiting:
        raise AssertionError(f"restore left {eng.pool_size()} != {waiting}")
    ck.LAUNCHES["block_best"] = 0  # count the main path's launches only
    seen, outs, step_ms, gc_ms, matches = set(), [], [], [], 0
    first_split = None
    for w, reqs in enumerate(stream):
        now = t0 + 1.0 + w
        before = eng.pool_size()
        # With --profile, the first window is split into its phases too,
        # and its Python calls are counted (cProfile) to find what a first
        # window of the process pays that later ones do not.
        first = profile and w == 0
        phases = split_phases(torch, eng) if first else contextlib.nullcontext()
        calls = cProfile.Profile() if first else None
        with phases as per, GcClock() as gc_clock:
            t = time.perf_counter()
            if calls is not None:
                calls.enable()
            out = eng.search(reqs, now)
            if calls is not None:
                calls.disable()
            step_ms.append((time.perf_counter() - t) * 1e3)
        gc_ms.append(gc_clock.total * 1e3)
        if first:
            first_split = split_ms(per, step_ms[-1] / 1e3, 1)
            stats = pstats.Stats(calls).stats
            first_split["top_calls"] = [
                {"fn": f"{fn[0].rsplit('/', 2)[-1]}:{fn[1]}:{fn[2]}",
                 "calls": st[1], "tottime_ms": st[2] * 1e3,
                 "cumtime_ms": st[3] * 1e3}
                for fn, st in sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]]
            log(f"first window {path} (under cProfile): {first_split}")
        matches += check_window(scoring, eng, reqs, out, now, before, seen,
                                glicko2)
        outs.append(out)
    launches = ck.LAUNCHES["block_best"]
    torch.cuda.synchronize()
    if launches != windows:  # one launch per <= 1024-lane window chunk
        raise AssertionError(f"block_best launched {launches} times for "
                             f"{windows} windows")
    prof = None
    if profile:
        extra = [make_requests(np, SearchRequest, rng, FULL_B,
                               waiting + (windows + w) * FULL_B,
                               t0 + 1.0 + windows + w, filters, glicko2)
                 for w in range(profile)]
        prof = profile_windows(torch, eng, extra, t0 + 1.0 + windows)
        log(f"profile {path}: {prof['split_ms_per_window']}, device busy "
            f"{prof['device_busy_share']:.3f}")
    cpu = GpuEngine(cfg, queue, device="cpu")
    cpu.restore(fill, t0)
    for w in range(cpu_windows):
        if pairs_of(cpu.search(stream[w], t0 + 1.0 + w)) != pairs_of(outs[w]):
            raise AssertionError(f"{path} window {w}: the CPU engine formed "
                                 f"other pairs")
    step_ms_sorted = sorted(step_ms)
    res = {
        "config": path, "waiting": waiting, "windows": windows,
        "window": FULL_B, "matches": matches, "launches": launches,
        "pool_size_end": eng.pool_size(), "restore_s": restore_s,
        "step_ms": step_ms, "gc_ms": gc_ms,
        "step_ms_p50": statistics.median(step_ms),
        "step_ms_p99": step_ms_sorted[min(len(step_ms) - 1,
                                          int(0.99 * len(step_ms)))],
        "cpu_windows_equal": cpu_windows,
        "first_window_split_ms": first_split,
        "profile": prof,
    }
    log(f"engine {path}: {matches} matches in {windows} windows, step p50 "
        f"{res['step_ms_p50']:.2f} ms p99 {res['step_ms_p99']:.2f} ms, "
        f"pool {eng.pool_size()}, launches {launches}")
    return res


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke test needs a GPU")
        return 2
    sys.path.insert(0, HERE)
    try:
        from matchmaking_tpu_torch.config import Config
        from matchmaking_tpu_torch.engine import cuda_kernels as ck
        from matchmaking_tpu_torch.engine import scoring
        from matchmaking_tpu_torch.engine.gpu import GpuEngine
        from matchmaking_tpu_torch.service.app import run_demo
        from matchmaking_tpu_torch.service.contract import SearchRequest
    except ImportError as e:
        log(f"the matchmaking_tpu_torch package is not beside this file: {e}")
        return 3
    out_path = argv[argv.index("--out") + 1] if "--out" in argv else None
    out_dir = os.path.dirname(os.path.abspath(out_path)) if out_path else None
    baseline_tree = (argv[argv.index("--baseline-tree") + 1]
                     if "--baseline-tree" in argv else None)
    profile = 8 if "--profile" in argv else 0
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. build and identify
    t = time.perf_counter()
    ptxas = io.StringIO()
    with contextlib.redirect_stdout(ptxas):
        so = ck.build(verbose=True)
    build_s = time.perf_counter() - t
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    max_sm_clock = card_line("clocks.max.sm")
    resources = ptxas_report(ptxas.getvalue())
    log(f"built block_best in {build_s:.1f} s on {kind} ({card}, max SM "
        f"clock {max_sm_clock})")
    for inst, res in resources.items():
        log(f"ptxas {inst}: {res}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    sass = sass_inner_loop(so, out_dir)
    log(f"SASS, ELO scorer's inner loop: {sass}")
    baseline = load_baseline(baseline_tree) if baseline_tree else None

    # 2. kernel vs plain
    kernel, max_err = phase_kernel(torch, ck, scoring, device, baseline)
    sweep = (plan_sweep(torch, ck, scoring, device) if "--plan-sweep" in argv
             else None)

    # 3. the engine main path, then configs #2 and #4 briefly
    mods = (Config, GpuEngine, SearchRequest)
    engine = [run_engine(torch, np, ck, scoring, mods, "configs/elo_1v1.json",
                         waiting=100_000, windows=24, cpu_windows=3,
                         filters=False, glicko2=False, seed=1,
                         profile=profile)]
    main_launches = engine[0]["launches"]
    engine.append(run_engine(torch, np, ck, scoring, mods,
                             "configs/multiqueue_filters.json",
                             waiting=50_000, windows=5, cpu_windows=1,
                             filters=True, glicko2=False, seed=2))
    engine.append(run_engine(torch, np, ck, scoring, mods,
                             "configs/glicko2.json", waiting=50_000,
                             windows=5, cpu_windows=1, filters=False,
                             glicko2=True, seed=4))

    # 4. service round trip on the card
    answers = asyncio.run(run_demo(device="cuda"))
    by_id = {r.player_id: r for r in answers}
    for r in answers:
        if r.status != "matched":
            raise AssertionError(f"demo: {r.player_id} got {r.status}")
        partner = next(p for p in r.match.players if p != r.player_id)
        if by_id[partner].status != "matched":
            raise AssertionError(f"demo: partner {partner} not matched")
    log(f"service demo: {len(answers)} players answered, all matched")
    torch.cuda.synchronize()

    main_k = kernel["elo"]
    line = {"kernels": [{
        "name": "block_best",
        "route": "cuda",
        "source": "matchmaking_tpu_torch/csrc/block_best.cu",
        "replaces": "matchmaking_tpu/engine/pallas_kernels.py:153",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": main_k["ms"],
        "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"],
        "bound_by": main_k["bound_by"],
        "library_ms": None,
        "ms_by_bucket": main_k["ms_by_bucket"],
        "host_us": main_k["host_us_by_bucket"][FULL_B],
    }]}
    total_s = time.perf_counter() - t_start
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": card, "kind": kind, "build_s": build_s,
                       "max_sm_clock": max_sm_clock, "ptxas": resources,
                       "sass_elo_inner_loop": sass, "plan_sweep": sweep,
                       "kernel": kernel, "max_abs_err": max_err,
                       "engine": engine, "demo_players": len(answers),
                       "total_s": total_s, "kernels_line": line}, f, indent=1)
    print(f"total {total_s:.1f} s")
    print(f"max SM clock: {max_sm_clock}")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
