#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (matchmaking_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out results.json] [--baseline-tree DIR]
                          [--plan-sweep] [--profile-soak]

Phases, each of which raises (exit code != 0) when it fails:

1. build: compile csrc/block_best.cu and csrc/quality_accum.cu with nvcc
   for sm_90a (one nvcc each) and, beside them, the wire codec
   csrc/codec.cc with g++, all started together; print the card and its
   max SM clock; report each kernel instance's registers, shared memory
   and spills (ptxas) and the ELO scorer's inner-loop instructions per pair
   (cuobjdump -sass, where the toolkit has it).
2. kernels: the block_best kernel against its plain PyTorch version on the
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
   with this one (old, new, new, old) on the same inputs. Then block_best's
   span launch (the pruned step's) at full width on a pool laid out by the
   gaussian:1500:300 banded allocator, all four instances, on a window
   whose spans fit W = 6 blocks and on config #1's window, whose do not:
   bit-equal to its plain version with the step's own flag and with the
   flag flipped, and a feasible launch equal to the dense one; span,
   fallback and dense ms at B = 1,024. The same at chunks of 16 rows (the
   bucketed step's, whose spans hold config #1's window): bit-equal to the
   plain version and the dense launch, span and dense ms, the plan and
   the bound. Then quality_accum against its
   plain version at every bucket on step results with real matches
   (histograms and counts equal, sums within 1e-5 relative; every addend
   is >= 0; two launches on the same inputs bit-equal), reading ``now``
   from the packed window's row on the card; timed with its host µs per
   call beside an empty kernel launched the same way (the launch floor),
   at 32 rating and wait edges, and its bound; with ``--baseline-tree``,
   the other tree's quality_accum is checked and timed in turns too.
3. engine: the main path. GpuEngine with configs/elo_1v1.json (backend
   overridden to "gpu"), its warmup() capturing one CUDA graph per (step
   variant, bucket) (capture ms and memory reported; no window may
   capture again): 100k waiting players through restore_columns(),
   then 48 windows of 1,024 through search_columns_async() at the config's
   pipeline depth (2): window N+1 is dispatched before window N is
   collected with collect_ready(), and flush() ends the run. Restores and
   dispatches run under torch.cuda.set_sync_debug_mode("error"). Checks:
   no player in two matches, every pair within both effective thresholds
   (and filters), every request matched, queued or rejected, pool
   accounting, one block_best and one quality_accum launch per window
   chunk, the engine's quality_report() after flush() equal to a host
   recomputation from the outcomes in every rating bucket's count, the
   first 3 windows' pairs equal a CPU columnar engine's, and an object-path
   engine on the card (8 windows, the old path's timing and GC) forms the
   first window's pairs too. Then an expire_deadlines() sweep over the
   5 % of waiting players stamped with a deadline, and 8 more windows
   under torch.profiler for the device's busy share, the launches the host
   queues per window (graph launches and copies) and the kernels the
   device runs per window (at most 401 + 1, the quality state's copies
   aside), among them exactly one prep_kernel, one block_best_kernel and
   one quality_accum_kernel, counted on the device by name. Then every
   window is driven again through an engine that replays its graphs and
   one that runs the same steps eagerly on the card, in lockstep from the
   same pool: each window's pairs, distances (bit for bit) and queued ids,
   and at the end the pools and quality states, must be equal. 3b: the same
   config with BENCH_SWEEP.md §5's pruning (band_spec gaussian:1500:300,
   prune_window_blocks 6, prune_chunk 128): the same 48 windows, checks and
   CPU comparison, and the windows that took the span path rather than the
   dense fallback, counted on the device and read once. 3c: config #1
   bucketed with the JAX bench's geometry (band_spec gaussian:1500:300,
   prune_window_blocks 6, prune_chunk 16): the same 48 windows, checks,
   CPU comparison and lockstep replay (pools, index columns included,
   equal), the span-path count (it fails if no window took the span
   path), formation_report()'s touched fraction and bucket occupancy (equal
   to the device index counts and to a host count of the pool after
   flush()), and one heartbeat() with windows in flight, whose index must
   equal a host rebuild of the pool it read. Configs #2 (filters,
   6 windows) and #4 (Glicko-2 + widening, 24 windows) run the same way,
   and config #4 runs a two-chunk rescan tick between two windows in
   flight, which must form matches, the same as on the CPU and as the
   eager steps on the card (and reconcile its quality samples); one more
   tick runs under torch.profiler (launches queued and kernels run per
   chunk, one of each hand kernel per chunk). 3d: speculation, for
   config #4 (the dense rescan family) and config #1 bucketed (the
   bucketed one): an engine with spec_formation (two passes) and a twin
   take the same restore and 4 windows in lockstep; the engine then
   speculates 30 s later (its live pool must stay bit-equal), validates
   and commits, and its outcome must equal the twin's two cold
   rescan_async ticks at that time, with pools and quality states equal;
   a second speculation, discarded by an admission, leaves the live pool
   as it was. Prints the counters and the device ms of the spare pool's
   copy, a speculation and a commit, with their launches.
4. service: the in-process service on the card: the 10-player demo; a
   soak with 100k restored players and 16,384 requests published in
   bursts (every request answered once from its window, partners agree,
   one publish_batch per window; request latency publish → first answer;
   the quality ledger and the engine's quality state both hold every
   matched player; with the broker's burst consume, every burst decoded
   at consume and no window at the flush), and the same soak with
   consume_batch off (the per-delivery path, the flush decoding each
   window); config #4's service, whose rescan loop must
   publish matches; and config #2's service, both of its queues in one
   app (20k restored and 2,048 requests each): every answer within its
   queue's threshold and filters and from its own queue, one
   publish_batch per window per queue, and a probe pair 100 apart matched
   at casual's threshold 150 and left waiting at ranked's 75. Then config
   #1 bucketed with spec_formation and no rescan loop: two players 400
   apart under fast widening must be matched by the speculation loop
   alone.
5. teams and roles: config #3 (team_5v5.json, P = 65,536) with 50k
   restored solo players and 24 object windows of 1,024 at depth 2, and
   config #5 (role_party.json, P = 16,384) with 12k players (declared
   roles) and 8 windows; every request pins its region and mode, so
   ``team_delegated`` must stay 0. Every match is checked (nobody twice,
   two teams of five, one region and mode, spread within every member's
   effective threshold, team sums within the spread, a perfect role
   assignment per team by brute force), pool accounting is exact, and the
   first 3 windows' raw step results are bit-equal to the same engine's on
   the CPU. Config #3 then runs a rescan tick 30 s later (widened
   thresholds), which must form matches. The engine's quality_report()
   holds one sample per member of every match. Each queue profiles 8 more
   windows (device ms and kernels per window; none of the hand kernels
   may run) and its step alone (kernels,
   device ms, CUDA-event ms, host ms per call: the ``steps`` line; the team
   step must stay within 300 kernels, the role step within 60 more). On a
   200-player role pool a 3-player party hands the queue to the host
   oracle, expires, and after the 5 s quiet period the queue is back on
   the card. The same hand-over through the service: a party with a
   deadline hands the queue to the oracle, the deadline sweep expires it,
   no traffic follows, and the health timer alone brings the queue back
   onto the card within one ``health_interval_s`` of the quiet period's
   end. Config #3's service: 50k restored through the app, 8,192
   requests in bursts of 512, every request answered, every match two
   teams of five, no fault caught.
6. overload control: config #1's service with 100k restored (tiers 0 / 1
   / 2 at 25 / 50 / 25 %) and 16,384 requests of the mixed-tier-peak
   cohorts (ranked tier 0 with a 1.5 s deadline, quick-play tier 1 with
   4 s, bot-fill tier 2 with none) in bursts of 512, unpaced, under
   max_waiting 100,000, max_inflight 8,192, 3 tiers, the "oldest" debt,
   EDF and a 25 ms deadline sweep; then the same soak with no overload
   control. Every request answered once (at most one terminal answer),
   the pool at or under 100,000 after every window, no tier-0 player shed
   while a tier-2 player waits, the shed answers by tier equal to the
   controller's, nobody matched later than its deadline + 25 ms, no
   credit held after the drain. Prints requests/s, latency p50/p99 by
   tier and overall for both soaks, shed and expired by tier, the
   admission cut's host µs and the debt's (pick and eviction) host ms a
   window.
7. the circuit breaker: config #1's service with breaker threshold 2
   (window 30 s, first probe 0.25 s, backoff 2, max 60 s, health timer
   0.05 s) and a chaos script failing device steps 0-1 and the first
   probe; 100k restored, 8 requests: two failed windows trip the breaker
   and the host oracle, with the whole pool, answers them; probe 1 fails,
   probe 2 captures and replays the base step's graph (block_best and
   quality_accum each launched by the replay and by the eager run before
   the capture) and the pool moves onto a fresh engine; 1,024
   more requests in 8 windows answered on the card. The counters must be
   the script's (crashes 2, trips 1, probes 2, probe failures 1, closes
   1), every player answered once, the moved pool the oracle's, the
   quality counts monotone, and the allocated device memory back within
   5 % of one engine's share after the demotion and within 5 % of that
   share after the re-promotion. Prints the ms from the trip to the first
   degraded answer, the probe's build, probe (capture and replay) and
   move ms, and the first 8 windows' dispatch ms after it.

8. durability, the drain and auth: config #1's service at full width
   with 100k restored. 8a: 16,384 requests in bursts of 512 with
   durability off, then with the write-ahead journal on (fsync "window"),
   after a compaction that anchors the 100k (timed, with the snapshot's
   bytes): requests/s and latency p50/p99 for both, the journal's host ms
   a window (ADMIT rows, their append and write, the terminals' append,
   the commit on its thread and the loop's wait for it); every request
   answered once, the segment's ADMIT records equal to the windows
   dispatched. 8b: a second stream crashed (``crash()``) right after its
   4th window is dispatched and journaled, in flight; a successor on the
   same directory recovers on the card (rto_ms
   and its split: attach, snapshot load, removes, tail, heartbeat, the
   re-anchoring compaction; and the device's drain after it): its waiting
   set equal to a host recomputation from the files (read_segment and the
   snapshot), every player answered ``matched`` before the crash absent
   from it and its redelivery replaying that body byte for byte, every
   admitted player without a terminal waiting once; 1,024 new requests
   whose first window's pairs equal those of a port app on the CPU
   recovered from a copy of the directory, then the redeliveries and
   6,144 more; both hand kernels launched, nobody in two matches across
   both apps, the first 8 windows' dispatch ms. 8c: phase 6's overload settings, 100k
   tiered waiting, 1,024 requests answered, then ``drain(dir)`` with 512
   requests reaching the broker after the consumer is cancelled (the
   backlog); a successor's ``restore_checkpoint(dir)``: the pool's columns
   equal after the round trip, the backlog re-published and answered on
   the card, no credit held; save and restore ms and bytes. 8d: auth
   ``rpc`` (an in-process responder, a 5 s timeout), ``static`` and
   ``none``, 1,024
   requests each (one in 8 with a bad token, answered ``unauthorized``),
   requests/s for each. 8b's successor logs the recovery's events the
   CPU app recovering the same files logs.
9. tracing: config #1's service at full width, 100k restored and 16,384
   requests in bursts of 512, three times in this process: tracing off,
   on, and sampled (``trace_sample_n`` 16). Each prints requests/s,
   latency p50/p99, GC ms, the flight recorder's and the attribution's
   host ms (over the soak and a window) and the traces settled, which
   must be the requests answered (on), 1 in 16 of them (sampled), none
   (off). Every window's merged marks must be dispatch, (h2d,
   device_step)+, readback_seal, collect; work + wait must equal the span
   of every trace; each request's own answer quotes its trace id exactly
   when it was traced. Phase 7's event kinds must be the CPU run's
   (``BREAKER_EVENTS``).
10. observability: config #1's service at full width, 100k restored and
   16,384 requests in bursts of 512, twice in this process: (a) the
   telemetry sampler off and no HTTP server; (b) the defaults (sampler at
   1 s, tracing, incident capture) with ``metrics_port`` on a free port
   and an SLO target of 100 ms (windows of 1 and 3 s). During (b) a
   client on the same loop fetches ``/metrics?format=prom`` and
   ``/healthz`` every 100 ms and ``/debug/profile?secs=1`` once after the
   first 4 windows, then every route once. Checks: every request answered
   once; every Prometheus text valid (one TYPE line per family, no
   duplicate series, every value a number); the pool gauge is the
   waiting count; every route's status that of the same configuration on
   the CPU; the queue burns (a /healthz lists it; a ``slo_burn`` bundle
   passes ``validate_bundle``); the profile's Chrome trace names
   prep_kernel, block_best_kernel and quality_accum_kernel, counted
   against the launches its capture saw. Prints requests/s and latency
   of (a) and (b), the scrape's host ms (``build_report`` and
   ``_flatten_prom``), the Prometheus bytes, the telemetry tick's and the
   incident capture's host ms and the profile's ms. Phases 7 and 8b hold
   one valid ``breaker_trip`` and one valid ``crash_recovery`` bundle.

``--plan-sweep`` times five variants at every bucket under every
(rows per CTA, cluster) plan, to check ``plan_grid``'s choice.
``--profile-soak`` (with ``--out``) writes cProfile's functions by own
time over each of phase 4's two soaks and phase 9's three beside the
output file.

11. resilience: config #1's service at full width with 100k restored.
   11a: 16,384 requests in bursts of 512 under seeded broker chaos on the
   request queue (1 % drops and duplicates, seq 0's first attempt
   dropped, seq 1 delivered 9 times, a partition from publish seq 4,096
   to 4,608) with ``debug_invariants``, twice, then without chaos on the
   burst path and with ``consume_batch`` off (the per-delivery path that
   consume faults force): the two chaos runs' fault stats and fault
   events equal, no invariant violated, every request answered, nothing
   dead-lettered; requests/s and latency p50/p99 of each. 11b: the
   journal on (fsync "none"), the 100k recovered from a journal at each
   start; replication off and on in turns, two rounds each (an
   in-process hub, a standby pumped every 20 ms): requests/s, latency,
   the lag in records (p50/p99 over the pumps), the tap's host µs a
   record, a pump's host ms, the baseline's bytes and host ms at 100k
   waiting; the shadow equals the pool, and no tap, send or pump failed.
   11c: a second stream crashed after its 4th window; the standby takes
   over at a scripted time (epoch 2); a successor on the card adopts the
   shadow (RTO and its split: restore, heartbeat, compaction), which is
   the primary's mirror at the crash; the fenced ex-primary's append
   raises and its publish is refused and counted; 512 matched players'
   redeliveries replay their bodies; 1,024 new requests under
   torch.profiler launch block_best and quality_accum, as often as the
   device ran them; nobody matched by both apps; a valid ``failover``
   bundle. 11d: 8,192 requests with a scripted drop, duplicate, delay and
   partition on the replication link: the lag during the partition, the
   peak ``unacked_admit_players`` (the loss bound), and the shadow equal
   to the pool after the heal.

12. network: config #1's service at full width with the journal on
   (fsync "none"), the 100k recovered from a journal at each start, its
   lease at a ``python -m matchmaking_tpu_torch.net.failover_proc lease``
   child and its standby a ``failover_proc host`` child on the card, over
   UDS sockets with 32 MiB frame and send buffer limits on both sides.
   12a: replication off and over the socket in turns, two rounds each:
   requests/s, latency, the lag in records, the tap's µs a record, the IO
   thread's ms and bytes of the 100k baseline frame, send → the child's
   applied baseline, the link's frames, reconnects, drops and liveness
   losses, the loop's longest stall after the start; the child's shadow
   equals the pool, and no send, frame, liveness, lease-request or fence
   error. 12b: the
   JAX soak's cycle-0 script on the fwd flow (a drop, a duplicate, a
   delay, a reset, relative to the baseline's seq): one reconnect, the
   baseline re-sent, every record applied once, the shadow the pool; then
   a crash after the 4th window of a second stream, the child's takeover
   after the real lease expiry, both fences of the ex-primary refused,
   the child serving config #1 on the card adopting its shadow (RTO and
   split, the takeover's epoch), 1,024 requests through the child
   launching block_best and quality_accum there (counted by the child),
   both kernels against their plain versions on the child's pool, nobody
   matched by both. 12c: ``failover_proc.soak`` at JAX's geometry with
   its hosts on the card, ``NET_SOAK_RUNS`` times: no double match, loss
   within the unacked-tail bound, both fences refused after the
   asymmetric partition, reconnects, no heartbeat false positive, equal
   takeover-transcript digests.

Each phase's seconds are logged. The last lines of standard output are a
JSON summary of phases 3-12, the
max SM clock, the ``steps`` line (the team and role steps: plain PyTorch),
the card (nvidia-smi name and power limit), one JSON line with the
kernels' numbers (block_best, its span launch inside its entry, and
quality_accum), and one JSON line ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import functools
import json
import os
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
    ``-Xptxas -v`` output (block_best: one instance per (glicko2, filters)
    pair; quality_accum: one CTA and a cluster of 8)."""
    report, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None:
            continue
        inst = re.search(r"(prep_kernel|block_best_kernel)ILb(\d)ELb(\d)E", fn)
        if inst is not None:
            key = (f"{inst.group(1)}<glicko2={inst.group(2)},"
                   f"filters={inst.group(3)}>")
        elif (m := re.search(r"quality_accum_kernelILi(\d)E", fn)):
            key = f"quality_accum_kernel<cluster={m.group(1)}>"
        else:
            continue
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


def now_arg(mod, t, value):
    """``now`` as ``mod``'s ``block_best`` takes it: the one-element f32
    tensor ``t`` on the card (the packed window's now row), or the host
    float ``value`` for a tree whose kernel still took the time as a
    float (the parent of the device-read ``now``)."""
    import inspect

    ann = inspect.signature(mod.block_best).parameters["now"].annotation
    return value if ann in ("float", float) else t


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


def bound(ck, rows, glicko2, filters, *, pairs=None, pool_slots=FULL_P):
    """Least time for one full-width call: the pairs' operations over the
    FP32 peak, or the bytes (each input read once, each output written
    once) over the memory rate, whichever is larger. The span launch
    passes the pairs its spans hold and the pool slots they cover."""
    pairs = rows * FULL_P if pairs is None else pairs
    ops = pairs * ck.ops_per_pair(glicko2=glicko2, filters=filters)
    n_blocks = FULL_P // FULL_BLOCK
    nbytes = (pool_slots * (6 * 4 + 1) + rows * (6 * 4 + 1)
              + rows * n_blocks * 8)
    return roofline({"pairs": pairs}, ops, nbytes)


def roofline(res, ops, nbytes):
    ops_ms, bytes_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(res, ops=ops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


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
    now = torch.tensor([20.0], device=device)
    old_now = now_arg(baseline, now, 20.0) if baseline is not None else None
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
            got = ck.block_best(pool, batch, q_thr, now, **args)
            want = ck.block_best_reference(pool, batch, q_thr, now, **args)
            torch.cuda.synchronize()
            max_err = max(max_err, compare(torch, got, want, f"{name} B={b}"))
            new = lambda: ck.block_best(pool, batch, q_thr, now, **args)
            if baseline is None:
                res["ms_by_bucket"][b] = time_ms(torch, new)
                res["host_us_by_bucket"][b] = host_us(torch, new)
            else:
                old = lambda: baseline.block_best(pool, batch, q_thr,
                                                  old_now, **args)
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
                    pool, batch, q_thr, now, **args), reps=20)
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
            torch, ck.block_best(pool, batch, q_thr, now, **args),
            ck.block_best_reference(pool, batch, q_thr, now, **args),
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
        zero = torch.zeros(1, device=device)
        got = ck.block_best(pool, batch, q_thr, zero, **args)
        compare(torch, got, ck.block_best_reference(pool, batch, q_thr, zero,
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
            now = torch.tensor([20.0], device=device)
            ck._check(pool, batch, q_thr, now, FULL_BLOCK)
            want = ck.block_best_reference(pool, batch, q_thr, now, **kw)
            best = ck.plan_grid(b, n_blocks, FULL_BLOCK, ck.sm_count(0))
            row = sweep.setdefault(name, {})[b] = {
                "chosen": f"{best.rows_per_cta}x{best.cluster}"}
            for rows in ck.ROWS_PER_CTA:
                for cluster in (1, 2, 4, 8):
                    plan = ck.GridPlan(rows, cluster,
                                       (n_blocks * cluster, -(-b // rows)))
                    fn = lambda: ck._launch(plan, pool, batch, q_thr, now,
                                            **kw)
                    compare(torch, fn(), want, f"plan {plan} B={b}")
                    row[f"{rows}x{cluster}"] = time_ms(torch, fn)
            log(f"plan sweep {name} B={b}: " + ", ".join(
                f"{k} {v if isinstance(v, str) else round(v * 1e3, 1)}"
                for k, v in row.items()))
    return sweep


#: Float operations per quality sample in the plain formulas: the widened
#: threshold (5), the pair's limit, quality (division, subtraction, two
#: clips, the bucket's multiply: 5), the wait (2), three sums, and a binary
#: search over each axis's edges (3 + 5 compares at the default edges).
QUALITY_OPS_PER_SAMPLE = 24


def step_windows(torch, np, kernels, device, buckets=BUCKETS):
    """Config #1-like step results that form real matches, one per bucket:
    a seeded pool (P = 131,072, 100k active, thresholds 100, widening 5/s
    to 250), a window of arrivals, and config #1's dense step on a copy of
    the pool. Returns {B: (pool after the step, f32[3, B] result, now, the
    packed window on the card)}."""
    rng = np.random.default_rng(12)
    active = np.zeros(FULL_P, bool)
    active[rng.permutation(FULL_P)[:FULL_ACTIVE]] = True
    arrays = {"rating": rng.normal(1500, 300, FULL_P).astype(np.float32),
              "rd": np.full(FULL_P, 350.0, np.float32),
              "region": np.zeros(FULL_P, np.int32),
              "mode": np.zeros(FULL_P, np.int32),
              "threshold": np.full(FULL_P, 100.0, np.float32),
              "enqueue_t": rng.uniform(0, 30, FULL_P).astype(np.float32),
              "active": active}
    ks = kernels.KernelSet(capacity=FULL_P, top_k=8, pool_block=FULL_BLOCK,
                           glicko2=False, widen_per_sec=5.0,
                           max_threshold=250.0)
    free = np.nonzero(~active)[0]
    out = {}
    for b in buckets:
        packed = np.zeros((9, b), np.float32)
        packed[0] = free[:b]
        packed[1] = rng.normal(1500, 300, b)
        packed[2] = 350.0
        packed[5] = 100.0
        packed[6] = rng.uniform(10, 30, b)
        packed[7] = 1.0
        packed[8] = 30.0
        pool = kernels.pool_from_reference(arrays, device)
        packed_dev = torch.from_numpy(packed).to(device)
        res = ks.search_step_packed(pool, packed_dev, skip_filters=True)
        out[b] = (pool, res, 30.0, packed_dev)
    torch.cuda.synchronize()
    return out


def quality_state_check(torch, got, want, what):
    """Histograms and counts equal, sums within 1e-5 of the plain
    version's (every addend is >= 0, so of the sum of their magnitudes);
    returns the largest sum error."""
    for name in ("q_hist", "w_hist", "count"):
        if not torch.equal(got[name], want[name]):
            raise AssertionError(f"{what}: {name} differs")
    max_err = 0.0
    for name in ("q_sum", "w_sum", "d_sum"):
        err = (got[name] - want[name]).abs()
        if bool((err > 1e-5 * want[name].abs()).any()):
            raise AssertionError(f"{what}: {name} off by {float(err.max())}")
        max_err = max(max_err, float(err.max()))
    return max_err


def phase_quality(torch, np, ck, kernels, spec, device, baseline=None):
    """``quality_accum`` against its plain version on the same CUDA
    tensors, at every bucket, on step results with real matches: histograms
    and counts equal, sums within 1e-5 of the sum of their addends (all
    >= 0, so of the sums themselves); two launches on the same inputs end
    bit-equal. The kernel reads ``now`` from the packed window's row on the
    device. Times the kernel at every bucket (device ms, host µs per call),
    beside an empty kernel launched the same way (the launch floor), at 32
    rating and 32 wait edges, the plain version at B = 1,024, and the bound
    from the bytes the call must move. With ``baseline`` (another tree's
    ``cuda_kernels``), its ``QualityAccum`` is checked too and timed in
    turns with this one: old, new, new, old."""
    acc = kernels.QualityAccumKernel(
        capacity=FULL_P, widen_per_sec=5.0, max_threshold=250.0,
        rating_edges=spec.rating_edges, n_quality=spec.n_quality,
        wait_edges=spec.wait_edges)
    kw = dict(widen_per_sec=5.0, max_threshold=250.0,
              rating_edges=acc.rating_edges, n_quality=acc.n_quality,
              wait_edges=acc.wait_edges)
    res = {"ms_by_bucket": {}, "host_us_by_bucket": {},
           "empty_ms_by_bucket": {}, "empty_host_us_by_bucket": {},
           "matches_by_bucket": {}}
    if baseline is not None:
        res["baseline_ms_by_bucket"] = {}
        res["baseline_host_us_by_bucket"] = {}
    max_err = 0.0
    for b, (pool, out, now, packed) in step_windows(torch, np, kernels,
                                                    device).items():
        now_row = packed[-1]  # the packed window's now row, on the card
        plain = lambda state: ck.quality_accum_reference(
            state, pool["rating"], pool["enqueue_t"], pool["threshold"], out,
            now, **kw)
        got, again, want = (acc.init_state(device) for _ in range(3))
        acc.accum(got, pool, out, now_row)
        acc.accum(again, pool, out, now_row)
        plain(want)
        torch.cuda.synchronize()
        matches = int((out[0] < FULL_P).sum())
        if int(got["count"].sum()) != 2 * matches or matches == 0:
            raise AssertionError(f"quality_accum B={b}: {got['count'].sum()} "
                                 f"samples for {matches} matches")
        max_err = max(max_err, quality_state_check(torch, got, want,
                                                   f"quality_accum B={b}"))
        if not torch.equal(got.flat, again.flat):
            raise AssertionError(f"quality_accum B={b}: two launches on the "
                                 f"same inputs differ")
        scratch = acc.init_state(device)
        new = lambda: acc.accum(scratch, pool, out, now_row)
        empty = lambda: acc._bound.launch_empty(out, now_row)
        if baseline is None:
            res["ms_by_bucket"][b] = time_ms(torch, new)
            res["host_us_by_bucket"][b] = host_us(torch, new)
        else:
            cols = (pool["rating"], pool["enqueue_t"], pool["threshold"])
            old = functools.partial(baseline.QualityAccum(
                acc.init_state(device), *cols, capacity=FULL_P, **kw),
                out, now_row)
            check = acc.init_state(device)
            baseline.QualityAccum(check, *cols, capacity=FULL_P, **kw)(
                out, now_row)
            torch.cuda.synchronize()
            quality_state_check(torch, check, want,
                                f"baseline quality_accum B={b}")
            o1, n1, n2, o2 = (time_ms(torch, f) for f in (old, new, new, old))
            res["ms_by_bucket"][b] = statistics.median([n1, n2])
            res["baseline_ms_by_bucket"][b] = statistics.median([o1, o2])
            o1, n1, n2, o2 = (host_us(torch, f) for f in (old, new, new, old))
            res["host_us_by_bucket"][b] = statistics.median([n1, n2])
            res["baseline_host_us_by_bucket"][b] = statistics.median([o1, o2])
        res["empty_ms_by_bucket"][b] = time_ms(torch, empty)
        res["empty_host_us_by_bucket"][b] = host_us(torch, empty)
        res["matches_by_bucket"][b] = matches
        if b == FULL_B:
            res["plain_ms"] = time_ms(torch, lambda: plain(scratch), reps=20)
            # Bytes: the result read once, three gathered columns at both
            # sides' slots of every match, the state read and written.
            nbytes = 3 * b * 4 + 2 * matches * 3 * 4 + 2 * acc.size * 4
            res.update(roofline({"samples": 2 * matches},
                                2 * matches * QUALITY_OPS_PER_SAMPLE, nbytes))
            # The most edges the kernel takes: 32 rating and 32 wait edges
            # (the default spec has 7 and 22).
            wide = kernels.QualityAccumKernel(
                capacity=FULL_P, widen_per_sec=5.0, max_threshold=250.0,
                rating_edges=np.linspace(600.0, 2400.0, 32),
                n_quality=spec.n_quality,
                wait_edges=np.geomspace(1e-3, 60.0, 32))
            w_got, w_want = wide.init_state(device), wide.init_state(device)
            wide.accum(w_got, pool, out, now_row)
            ck.quality_accum_reference(
                w_want, pool["rating"], pool["enqueue_t"], pool["threshold"],
                out, now, **dict(kw, rating_edges=wide.rating_edges,
                                 wait_edges=wide.wait_edges))
            torch.cuda.synchronize()
            max_err = max(max_err, quality_state_check(
                torch, w_got, w_want, "quality_accum, 32 edges"))
            res["ms_32_edges"] = time_ms(
                torch, lambda: wide.accum(w_got, pool, out, now_row))
    res["ms"] = res["ms_by_bucket"][FULL_B]
    res["host_us"] = res["host_us_by_bucket"][FULL_B]
    res["empty_ms"] = res["empty_ms_by_bucket"][FULL_B]
    log(f"quality_accum: ms by bucket {res['ms_by_bucket']}"
        + (f", baseline {res['baseline_ms_by_bucket']}" if baseline else "")
        + f"; host µs per call {res['host_us_by_bucket']}"
        + (f", baseline {res['baseline_host_us_by_bucket']}" if baseline
           else "")
        + f"; empty launch ms {res['empty_ms_by_bucket']}, host µs "
        f"{res['empty_host_us_by_bucket']}; 32 edges {res['ms_32_edges']:.5f}"
        f" ms (plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.7f} ms"
        f" by {res['bound_by']} at B={FULL_B}); matches "
        f"{res['matches_by_bucket']}; max sum error {max_err}")
    return res, max_err


#: The pruned main path's setting (the JAX package's BENCH_SWEEP.md §5):
#: W = 6 of 16 blocks, chunks of 128, gaussian:1500:300 bands.
PRUNE = {"prune_window_blocks": 6, "prune_chunk": 128,
         "band_spec": "gaussian:1500:300"}
#: Config #1 bucketed, with the JAX bench's bucketed geometry
#: (bench.py ``_bucketed_geometry``: W = ceil(16 · 33 / 100) = 6 blocks,
#: chunks of max(8, min(128, 1024 // 64)) = 16 rows).
BUCKETED = {"bucketed": True, "prune_window_blocks": 6, "prune_chunk": 16,
            "band_spec": "gaussian:1500:300"}


def span_inputs(torch, np, kernels, device, *, glicko2, filters, thr,
                window_std, seed, chunk=PRUNE["prune_chunk"], widen=2.0):
    """A pool laid out by the banded allocator (gaussian:1500:300, one band
    per block; 100k players of N(1500, 300)), a window of 1,024 arrivals
    placed by it too and sorted by rating as the pruned step sorts it, and
    the step's own span starts and feasibility for it."""
    from matchmaking_tpu_torch.core.pool import PlayerPool, band_edges_from_spec
    from matchmaking_tpu_torch.engine.cuda_kernels import effective_threshold
    from matchmaking_tpu_torch.service.contract import RequestColumns

    rng = np.random.default_rng(seed)
    n_blocks = FULL_P // FULL_BLOCK
    pp = PlayerPool(FULL_P, thr, band_edges=band_edges_from_spec(
        PRUNE["band_spec"], n_blocks))

    def cols(prefix, ratings):
        n = ratings.size
        z = np.zeros(n, np.int32)
        return RequestColumns(
            ids=np.char.add(prefix, np.arange(n).astype(str)).astype(object),
            rating=ratings, rd=np.zeros(n, np.float32), region=z, mode=z,
            threshold=np.full(n, np.nan, np.float32),
            enqueued_at=np.zeros(n))

    pp.allocate_columns(cols("p", rng.normal(1500, 300, FULL_ACTIVE)
                             .astype(np.float32)))
    w_rating = np.sort(rng.normal(1500, window_std, FULL_B)).astype(np.float32)
    w_slots = pp.allocate_columns(cols("w", w_rating))
    active = np.zeros(FULL_P, bool)
    active[pp.waiting_slots()] = True
    active[w_slots] = False  # the window's own slots: admitted by the step
    codes = lambda n, k: (rng.integers(0, k, n) if filters
                          else np.zeros(n)).astype(np.int32)
    pool = kernels.pool_from_reference({
        "rating": pp.m_rating.copy(),
        "rd": rng.uniform(0, 350, FULL_P).astype(np.float32),
        "region": codes(FULL_P, 4), "mode": codes(FULL_P, 3),
        "threshold": np.full(FULL_P, thr, np.float32),
        "enqueue_t": rng.uniform(0, 20, FULL_P).astype(np.float32),
        "active": active}, device)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    batch = {"slot": to(w_slots.astype(np.int32)), "rating": to(w_rating),
             "rd": to(rng.uniform(0, 350, FULL_B).astype(np.float32)),
             "region": to(codes(FULL_B, 4)), "mode": to(codes(FULL_B, 3)),
             "threshold": to(np.full(FULL_B, thr, np.float32)),
             "enqueue_t": to(rng.uniform(0, 20, FULL_B).astype(np.float32)),
             "valid": to(np.ones(FULL_B, bool))}
    ks = kernels.KernelSet(capacity=FULL_P, top_k=8, pool_block=FULL_BLOCK,
                           glicko2=glicko2, widen_per_sec=widen,
                           max_threshold=250.0,
                           prune_window_blocks=PRUNE["prune_window_blocks"],
                           prune_chunk=chunk)
    kernels.admit(pool, batch)
    q_thr = effective_threshold(batch["threshold"], batch["enqueue_t"],
                                torch.tensor([20.0], device=device), widen,
                                250.0)
    start, feasible = ks._chunk_windows(batch, q_thr, *ks._live_stats(pool))
    return ks, pool, batch, q_thr, start, feasible


def phase_span(torch, np, ck, kernels, scoring, device, sweep=False):
    """The span launch of block_best at full width on a banded pool, for
    all four instances: a narrow window (thresholds 30, ratings N(1500,
    60)) whose spans fit W = 6 blocks, and config #1's window (thresholds
    100, N(1500, 300)) whose tail chunks do not. Each is bit-equal to the
    plain version with the step's own flag and with the flag flipped, and
    a feasible launch equals the dense launch (its spans hold every
    candidate). At B = 1,024, ELO, on the feasible window: span, fallback
    (the flag unset) and dense device ms on the same inputs, and the span
    launch's bound over its spans' pairs."""
    w = PRUNE["prune_window_blocks"]
    chunk = PRUNE["prune_chunk"]
    res, feasible_seen = {}, set()
    for vi, (glicko2, filters) in enumerate(((False, False), (False, True),
                                             (True, False), (True, True))):
        for thr, std in ((30.0, 60.0), (100.0, 300.0)):
            ks, pool, batch, q_thr, start, feasible = span_inputs(
                torch, np, kernels, device, glicko2=glicko2, filters=filters,
                thr=thr, window_std=std, seed=20 + vi)
            kw = dict(pool_block=FULL_BLOCK, glicko2=glicko2, filters=filters,
                      widen_per_sec=2.0, max_threshold=250.0,
                      g_coeff=scoring.G_COEFF_F32)
            now = torch.tensor([20.0], device=device)
            dense = ck.block_best(pool, batch, q_thr, now, **kw)
            feasible_seen.add(bool(feasible))
            what = f"span glicko2={glicko2} filters={filters} thr={thr}"
            spans = {}
            for flag in (feasible, ~feasible):
                span = ck.Span(start, chunk, w, flag.reshape(1))
                got = ck.block_best(pool, batch, q_thr, now, span=span, **kw)
                compare(torch, got, ck.block_best_span_reference(
                    pool, batch, q_thr, now, span, **kw), what)
                spans[bool(flag)] = span
            if bool(feasible):
                compare(torch, ck.block_best(pool, batch, q_thr, now,
                                             span=spans[True], **kw),
                        dense, f"{what}: span against dense")
            if (glicko2, filters) == (False, False):
                res[f"span_starts_thr{thr:g}"] = start.tolist()
            if (glicko2, filters) == (False, False) and bool(feasible):
                r = res
                for name, fn in (
                        ("span_ms", lambda: ck.block_best(
                            pool, batch, q_thr, now, span=spans[True], **kw)),
                        ("fallback_ms", lambda: ck.block_best(
                            pool, batch, q_thr, now, span=spans[False], **kw)),
                        ("dense_ms", lambda: ck.block_best(
                            pool, batch, q_thr, now, **kw))):
                    r[name] = time_ms(torch, fn)
                starts = start.tolist()
                blocks = {s_ + j for s_ in starts for j in range(w)}
                rows = int(batch["valid"].sum())
                r["span_starts"] = starts
                r["blocks_with_candidate"] = float(
                    torch.isfinite(dense[0]).float().mean())
                r.update(bound(ck, rows, False, False,
                               pairs=rows * w * FULL_BLOCK,
                               pool_slots=len(blocks) * FULL_BLOCK))
                r["plain_ms"] = time_ms(torch, lambda: (
                    ck.block_best_span_reference(pool, batch, q_thr, now,
                                                 spans[True], **kw)), reps=10)
                log(f"span launch, feasible window (thr {thr}): span "
                    f"{r['span_ms']:.4f} ms, fallback {r['fallback_ms']:.4f} "
                    f"ms, dense {r['dense_ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                    f"(span starts {starts})")
    if feasible_seen != {True, False}:
        raise AssertionError(f"span phase: feasibility {feasible_seen}, "
                             f"wanted both")
    res["chunk16"] = span_chunk16(torch, np, ck, kernels, scoring, device,
                                  sweep)
    torch.cuda.synchronize()
    return res


def span_chunk16(torch, np, ck, kernels, scoring, device, sweep=False):
    """The bucketed step's span launch: config #1's window (thresholds 100,
    no widening, N(1500, 300)) cut into chunks of 16 rows, whose spans fit
    W = 6 blocks (chunks of 128 do not; nor do chunks of 16 once 20 s of
    widening at 2/s reach 140), for the ELO instance, and the Glicko-2 +
    filters instance on the same window (its spans, widened by rating
    deviations up to 350, do not fit): bit-equal to the plain version with
    the flag set and flipped, and to the dense launch where the flag is
    the step's own. ELO: span and dense device ms on the
    same inputs, the plan (``plan_grid`` takes 16 rows a CTA so that a
    CTA's rows share one span), the plain version's ms and the bound over
    the spans' pairs. With ``sweep``, every plan with 8 or 16 rows a CTA,
    each checked and timed."""
    w, chunk = BUCKETED["prune_window_blocks"], BUCKETED["prune_chunk"]
    out = {}
    for vi, (glicko2, filters) in enumerate(((False, False), (True, True))):
        ks, pool, batch, q_thr, start, feasible = span_inputs(
            torch, np, kernels, device, glicko2=glicko2, filters=filters,
            thr=100.0, window_std=300.0, seed=30 + vi, chunk=chunk, widen=0.0)
        what = f"span chunk 16 glicko2={glicko2} filters={filters}"
        if bool(feasible) == glicko2:
            raise AssertionError(f"{what}: feasibility {bool(feasible)}")
        kw = dict(pool_block=FULL_BLOCK, glicko2=glicko2, filters=filters,
                  widen_per_sec=0.0, max_threshold=250.0,
                  g_coeff=scoring.G_COEFF_F32)
        now = torch.tensor([20.0], device=device)
        dense = ck.block_best(pool, batch, q_thr, now, **kw)
        spans = {}
        for flag in (True, False):
            span = ck.Span(start, chunk, w, torch.tensor([flag], device=device))
            got = ck.block_best(pool, batch, q_thr, now, span=span, **kw)
            compare(torch, got, ck.block_best_span_reference(
                pool, batch, q_thr, now, span, **kw), what)
            if not flag or bool(feasible):
                compare(torch, got, dense, f"{what}: against dense")
            spans[flag] = span
        if glicko2:
            continue
        plan = ck.plan_grid(FULL_B, FULL_P // FULL_BLOCK, FULL_BLOCK,
                            ck.sm_count(0), chunk)
        starts = start.tolist()
        blocks = {s_ + j for s_ in starts for j in range(w)}
        rows = int(batch["valid"].sum())
        out = {"plan": f"{plan.rows_per_cta}x{plan.cluster}",
               "span_starts": starts,
               "span_ms": time_ms(torch, lambda: ck.block_best(
                   pool, batch, q_thr, now, span=spans[True], **kw)),
               "dense_ms": time_ms(torch, lambda: ck.block_best(
                   pool, batch, q_thr, now, **kw)),
               "plain_ms": time_ms(torch, lambda: ck.block_best_span_reference(
                   pool, batch, q_thr, now, spans[True], **kw), reps=5)}
        out.update(bound(ck, rows, False, False, pairs=rows * w * FULL_BLOCK,
                         pool_slots=len(blocks) * FULL_BLOCK))
        if sweep:
            n_blocks = FULL_P // FULL_BLOCK
            out["plans"] = {}
            for rows_cta in (8, 16):
                for cluster in (1, 2, 4, 8):
                    gp = ck.GridPlan(rows_cta, cluster, (n_blocks * cluster,
                                                         -(-FULL_B // rows_cta)))
                    fn = lambda: ck._launch(gp, pool, batch, q_thr, now,
                                            span=spans[True], **kw)
                    compare(torch, fn(), dense, f"{what} plan {gp}")
                    out["plans"][f"{rows_cta}x{cluster}"] = time_ms(torch, fn)
        log(f"span launch, chunks of 16 (config #1's window, W = {w}, plan "
            f"{out['plan']}): span {out['span_ms']:.5f} ms, dense "
            f"{out['dense_ms']:.5f} ms, plain {out['plain_ms']:.3f} ms, bound "
            f"{out['bound_ms']:.5f} ms; {len(blocks)} blocks in some span"
            + (f"; plans {out['plans']}" if sweep else ""))
    return out


# ---- phase 3: the engine main path (columnar, pipelined) -------------------


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
def no_sync(torch):
    """Any device→host synchronisation inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


class Population:
    """Seeded players, row k = player ``p<k>``: the columns the engines
    get, and the host copy the checks read."""

    REGIONS = ("eu", "na", "apac", "*")
    MODES = ("ranked", "casual", "*")

    def __init__(self, np, rng, n, t0, *, filters, glicko2, deadline_frac=0.0):
        self.np = np
        self.rating = rng.normal(1500.0, 300.0, n).astype(np.float32)
        self.rd = (rng.uniform(30.0, 350.0, n) if glicko2
                   else np.full(n, 350.0)).astype(np.float32)
        self.waited = rng.uniform(0.0, 20.0, n)
        pick = lambda names: (np.array(names, object)[rng.integers(0, len(names), n)]
                              if filters else np.full(n, "*", object))
        self.region, self.mode = pick(self.REGIONS), pick(self.MODES)
        self.deadline = np.where(rng.random(n) < deadline_frac, t0 + 50.0, 0.0)
        self.ids = np.char.add("p", np.arange(n).astype(str)).astype(object)

    def columns(self, RequestColumns, eng, lo, hi, now, reply="replies"):
        """Rows [lo, hi) enqueued at ``now`` minus their wait, interned by
        ``eng``."""
        np = self.np
        sl = slice(lo, hi)
        region, mode = eng.intern_columns(self.region[sl].tolist(),
                                          self.mode[sl].tolist())
        return RequestColumns(
            ids=self.ids[sl].copy(), rating=self.rating[sl], rd=self.rd[sl],
            region=region, mode=mode,
            threshold=np.full(hi - lo, np.nan, np.float32),
            enqueued_at=now - self.waited[sl],
            reply_to=np.full(hi - lo, reply, object),
            correlation_id=self.ids[sl].copy(), deadline=self.deadline[sl])

    def rows(self, ids):
        return self.np.array([int(p[1:]) for p in ids.tolist()], self.np.int64)


def check_columnar(np, scoring, eng, pop, out, now, enq, seen, glicko2,
                   window_ids=None):
    """The invariants of one collected ColumnarOutcome: nobody in two
    matches, every pair within both effective thresholds and filters, the
    reported distance the pair's, and (traffic windows) every request
    matched, queued or rejected. ``enq`` maps a row to its enqueue time."""
    q = eng.queue
    a, b = pop.rows(out.m_id_a), pop.rows(out.m_id_b)
    for pid in out.m_id_a.tolist() + out.m_id_b.tolist():
        if pid in seen:
            raise AssertionError(f"{pid} is in two matches")
        seen.add(pid)
    for j in range(out.n_matches):
        ra, rb = a[j], b[j]
        d = scoring.distance(float(pop.rating[ra]), float(pop.rating[rb]),
                             float(pop.rd[ra]), float(pop.rd[rb]),
                             glicko2=glicko2)
        eff = [min(q.max_threshold, q.rating_threshold + q.widen_per_sec
                   * max(0.0, now - enq[r])) if q.widen_per_sec > 0
               else q.rating_threshold for r in (ra, rb)]
        if d > min(eff) + 1e-3:
            raise AssertionError(f"pair p{ra}-p{rb}: d={d} > limit {min(eff)}")
        if abs(d - float(out.m_dist[j])) > 1e-3 * max(1.0, d):
            raise AssertionError(f"pair p{ra}-p{rb}: reported {out.m_dist[j]}, "
                                 f"recomputed {d}")
        if not scoring.region_mode_compatible(pop.region[ra], pop.mode[ra],
                                              pop.region[rb], pop.mode[rb]):
            raise AssertionError(f"pair p{ra}-p{rb} breaks the filters")
    if window_ids is not None:
        done = set(out.q_ids.tolist()) | seen | {p for p, _ in out.rejected}
        if any(p not in done for p in window_ids.tolist()):
            raise AssertionError("a request was neither matched, queued "
                                 "nor rejected")
    return out.n_matches


def pair_set(out):
    return {frozenset(p) for p in zip(out.m_id_a.tolist(), out.m_id_b.tolist())}


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def device_busy(torch, run):
    """torch.profiler over ``run()``: the device's busy share of the wall
    time, its top kernels, and the host operators that took the most host
    time of their own (queueing the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels, host_ops = [], []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            kernels.append((dev, e.count, e.key))
        elif e.key.startswith("aten::") or e.key.startswith("cuda"):
            host_ops.append((e.self_cpu_time_total, e.count, e.key))
    kernels.sort(reverse=True)
    host_ops.sort(reverse=True)
    device_us = sum(k[0] for k in kernels)
    calls = {k: c for _, c, k in host_ops}
    # The hand kernels the device ran, by name, as the profiler saw them
    # (inside the graphs' replays too): what backs the LAUNCHES counts,
    # which a replay adds on the host.
    own = {name: sum(k[1] for k in kernels if name in k[2])
           for name in OWN_KERNELS}
    own_ms = {name: sum(k[0] for k in kernels if name in k[2]) / n / 1e3
              for name in OWN_KERNELS}
    return {"windows": n, "wall_ms_per_window": wall / n * 1e3,
            "own_kernels": own, "own_kernel_ms_per_window": own_ms,
            "kernels_per_window": sum(k[1] for k in kernels) / n,
            # What the host queued: kernel launches, graph launches and
            # copies (runtime API calls the profiler saw).
            "queued_per_window": sum(calls.get(k, 0)
                                     for k in LAUNCH_CALLS) / n,
            "graph_launches_per_window": calls.get("cudaGraphLaunch", 0) / n,
            "device_ms_per_window": device_us / n / 1e3,
            "device_busy_share": device_us / 1e6 / wall,
            "device_idle_share": 1.0 - device_us / 1e6 / wall,
            "top_kernels": [{"name": k[2][:90], "count": k[1],
                             "device_ms_per_window": k[0] / n / 1e3}
                            for k in kernels[:10]],
            "top_host_ops": [{"name": k[2], "count": k[1],
                              "host_ms_per_window": k[0] / n / 1e3}
                             for k in host_ops[:12]]}


#: The device kernels of csrc/: block_best.cu's two, quality_accum.cu's.
OWN_KERNELS = ("prep_kernel", "block_best_kernel", "quality_accum_kernel")


def check_own_kernels(prof, want, what):
    """The profiled run's hand kernels, counted on the device, must be
    ``want`` of each (one per window chunk on a 1v1 path, none on a team
    or role path)."""
    if prof["own_kernels"] != {name: want for name in OWN_KERNELS}:
        raise AssertionError(f"{what}: the device ran {prof['own_kernels']} "
                             f"of the hand kernels, expected {want} of each")


#: Runtime API calls that queue work on the card: kernel launches, graph
#: launches, copies and fills.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def graph_summary(rep):
    """An engine's ``graph_report()`` in brief: captures, capture and
    warm-up host ms (sum and largest), private memory (sum and by graph)."""
    graphs = rep["graphs"].values()
    return {"captures": rep["captures"],
            "capture_ms_total": sum(g["capture_ms"] for g in graphs),
            "capture_ms_max": max(g["capture_ms"] for g in graphs),
            "warm_ms_total": sum(g["warm_ms"] for g in graphs),
            "memory_bytes_total": sum(g["memory_bytes"] for g in graphs),
            "by_graph": {k: {"capture_ms": round(g["capture_ms"], 3),
                             "memory_bytes": g["memory_bytes"]}
                         for k, g in rep["graphs"].items()}}


def replay_equals_eager(torch, np, mods, cfg, pop, *, waiting, t0, windows,
                        now_of, label):
    """Each window of the main path through an engine that replays its
    captured steps and through one that runs the same steps eagerly on the
    card (its graph set taken away), dispatched and flushed in lockstep
    from the same restored pool: every window's pairs, distances (bit for
    bit) and queued ids equal, and at the end the pools, the quality
    states and the pruned step's counts equal."""
    _, GpuEngine, RequestColumns, _ = mods
    queue = cfg.queues[0]
    graphed, eager = (GpuEngine(cfg, queue, device="cuda") for _ in range(2))
    eager._graphs = None
    for e in (graphed, eager):
        e.warmup()
        e.restore_columns(pop.columns(RequestColumns, e, 0, waiting, t0), t0)
    for w in range(windows):
        outs = []
        for e in (graphed, eager):
            e.search_columns_async(pop.columns(
                RequestColumns, e, waiting + w * FULL_B,
                waiting + (w + 1) * FULL_B, now_of[w]), now_of[w])
            (_, out), = e.flush()
            outs.append(out)
        a, b = outs
        if (a.m_id_a.tolist() != b.m_id_a.tolist()
                or a.m_id_b.tolist() != b.m_id_b.tolist()
                or a.q_ids.tolist() != b.q_ids.tolist()
                or not np.array_equal(a.m_dist.view(np.int32),
                                      b.m_dist.view(np.int32))):
            raise AssertionError(f"{label} window {w}: the replayed step "
                                 f"differs from the eager one")
    torch.cuda.synchronize()
    for name, col in eager.dev_pool.full.items():
        if not torch.equal(graphed.dev_pool.full[name], col):
            raise AssertionError(f"{label}: pool column {name} differs after "
                                 f"{windows} replayed and eager windows")
    if not torch.equal(graphed._q_dev.flat, eager._q_dev.flat):
        raise AssertionError(f"{label}: the quality states differ")
    if graphed.prune_report() != eager.prune_report():
        raise AssertionError(f"{label}: pruned counts {graphed.prune_report()}"
                             f" != {eager.prune_report()}")
    if graphed.formation_report() != eager.formation_report():
        raise AssertionError(f"{label}: formation reports differ")
    return windows


def exact_index(np, active, rating, rd, n_blocks):
    """The bucket index of a pool from its columns, on the host: per block
    the active count, the live rating bounds (+inf / -inf when empty) and
    the largest live rating deviation (0 when empty)."""
    act = active.reshape(n_blocks, -1)
    r = rating.reshape(n_blocks, -1)
    return {"bidx_count": act.sum(1).astype(np.int32),
            "bidx_min": np.where(act, r, np.inf).min(1).astype(np.float32),
            "bidx_max": np.where(act, r, -np.inf).max(1).astype(np.float32),
            "bidx_rd": np.where(act, rd.reshape(n_blocks, -1),
                                0.0).max(1).astype(np.float32)}


def check_bucketed(torch, np, eng, at_heartbeat, windows, label):
    """A bucketed run's index, after ``flush()``: the mid-stream heartbeat's
    rebuild equal to a host rebuild of the pool it read; the device counts
    equal to the mirror's bucket occupancy (``formation_report``) and to a
    host count of the pool, its bounds holding the live bounds; every
    window in the touched count. Returns the formation report's numbers."""
    nb = eng.kernels.n_blocks
    host = {k: v.cpu().numpy() for k, v in at_heartbeat.items()}
    want = exact_index(np, host["active"], host["rating"], host["rd"], nb)
    for k, v in want.items():
        if not np.array_equal(host[k].view(np.int32), v.view(np.int32)):
            raise AssertionError(f"{label}: the heartbeat's {k} "
                                 f"{host[k].tolist()} != {v.tolist()}")
    pool = {k: eng.dev_pool[k].cpu().numpy() for k in (
        "active", "rating", "rd", "bidx_count", "bidx_min", "bidx_max")}
    exact = exact_index(np, pool["active"], pool["rating"], pool["rd"], nb)
    rep = eng.formation_report()
    if (pool["bidx_count"].tolist() != rep["bucket_occupancy"]
            or pool["bidx_count"].tolist() != exact["bidx_count"].tolist()):
        raise AssertionError(f"{label}: index counts {pool['bidx_count']} "
                             f"!= occupancy {rep['bucket_occupancy']} or "
                             f"the pool's {exact['bidx_count']}")
    if ((pool["bidx_min"] > exact["bidx_min"]).any()
            or (pool["bidx_max"] < exact["bidx_max"]).any()):
        raise AssertionError(f"{label}: index bounds narrower than the pool's")
    if rep["windows"] != windows:
        raise AssertionError(f"{label}: formation counted {rep['windows']} "
                             f"of {windows} windows")
    return {k: rep[k] for k in ("windows", "touched_slots", "total_slots",
                                "formation_touched_frac", "bucket_occupancy",
                                "peak_bucket_occupancy")}


def greedy_pair_kernels(torch, kernels, capacity, rows, n_blocks, rounds):
    """Device kernels one ``greedy_pair`` call launches (torch.profiler
    over one call on window-shaped inputs, after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cpu").manual_seed(0)
    vals = -torch.rand(rows, n_blocks, generator=g).cuda() * 100.0
    idxs = torch.randint(0, capacity, (rows, n_blocks), generator=g,
                         dtype=torch.int32).cuda()
    slot = torch.arange(rows, dtype=torch.int32).cuda()
    kernels.greedy_pair(vals, idxs, slot, capacity, rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernels.greedy_pair(vals, idxs, slot, capacity, rounds)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA"))


def reset_counts(ck):
    """Every kernel's launch count to 0, just before a path is driven."""
    for name in ck.LAUNCHES:
        ck.LAUNCHES[name] = 0


def quality_reconciles(np, eng, pop, outs, what):
    """The engine's quality report, read after ``flush()``, against a host
    recomputation from the returned outcomes (engine/quality's host
    accumulator over both sides of every match): the same samples, per
    rating bucket. Returns the report's sample count."""
    from matchmaking_tpu_torch.engine.quality import HostQualityAccum

    host = HostQualityAccum(eng._q_spec)
    for out in outs:
        if out.n_matches:
            host.observe(
                rating=np.concatenate([pop.rating[pop.rows(out.m_id_a)],
                                       pop.rating[pop.rows(out.m_id_b)]]),
                quality=np.concatenate([out.m_quality, out.m_quality]),
                wait_s=np.concatenate([out.m_wait_a, out.m_wait_b]),
                spread=np.concatenate([out.m_dist, out.m_dist]))
    rep = eng.quality_report()
    got = [b["count"] for b in rep["buckets"]]
    want = host.arrays["count"].tolist()
    if got != want:
        raise AssertionError(f"{what}: quality report counts {got} != the "
                             f"outcomes' {want}")
    return rep["samples"]


def run_columnar(torch, np, ck, scoring, mods, path, *, waiting, windows,
                 glicko2, filters, seed, cpu_windows, object_windows,
                 profile_windows, engine_over=None, heartbeat_at=None):
    """The main path: ``restore_columns`` fills the pool, then ``windows``
    windows of 1,024 go through ``search_columns_async`` at the config's
    pipeline depth, each collected with ``collect_ready`` only after the
    next is dispatched, and ``flush`` ends the run. ``engine_over``
    replaces engine keys of the file (the pruned or bucketed path's
    knobs). A bucketed run calls ``heartbeat`` right after window
    ``heartbeat_at`` is dispatched (windows in flight) and holds the index
    it rebuilt to an exact rebuild of the pool at that point."""
    import dataclasses

    Config, GpuEngine, RequestColumns, SearchRequest = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    if engine_over:
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, **engine_over))
    bucketed = bool(cfg.engine.bucketed)
    label = path + (" (bucketed)" if bucketed
                    else " (pruned)" if engine_over else "")
    queue, depth = cfg.queues[0], cfg.engine.pipeline_depth
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    n_all = waiting + (windows + profile_windows) * FULL_B
    pop = Population(np, rng, n_all, t0, filters=filters, glicko2=glicko2,
                     deadline_frac=0.05)
    enq = np.empty(n_all)
    now_of = [t0 + 1.0 + 0.05 * w for w in range(windows + profile_windows)]
    enq[:waiting] = t0 - pop.waited[:waiting]
    for w, now in enumerate(now_of):
        lo = waiting + w * FULL_B
        enq[lo:lo + FULL_B] = now - pop.waited[lo:lo + FULL_B]
    eng = GpuEngine(cfg, queue, device="cuda")
    t = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t
    graphs = graph_summary(eng.graph_report())
    fill = pop.columns(RequestColumns, eng, 0, waiting, t0)
    stream = [pop.columns(RequestColumns, eng, waiting + w * FULL_B,
                          waiting + (w + 1) * FULL_B, now_of[w])
              for w in range(windows + profile_windows)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_sync(torch):
        eng.restore_columns(fill, t0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if eng.pool_size() != waiting:
        raise AssertionError(f"restore left {eng.pool_size()} != {waiting}")
    deadlines_waiting = eng.deadline_count()
    util0 = eng.util_report()
    spans0 = dict(eng.spans)
    prune0 = eng.prune_report()  # one read of the span counter, before
    samples0 = eng.quality_report()["samples"]
    reset_counts(ck)  # count the main path's launches only
    dispatch_ms, turnaround_ms, gc_ms = [], [], []
    outs, t_disp, token_window = {}, {}, {}
    at_heartbeat = None
    with GcClock() as gc_clock:
        t_run = time.perf_counter()
        for w in range(windows):
            gc_before = gc_clock.total
            t = time.perf_counter()
            with no_sync(torch):
                tok = eng.search_columns_async(stream[w], now_of[w])
            dispatch_ms.append((time.perf_counter() - t) * 1e3)
            t_disp[tok], token_window[tok] = t, w
            if bucketed and w == heartbeat_at:
                # The rebuild queues behind the windows in flight; so do
                # these copies of its index and of the pool it read.
                with no_sync(torch):
                    eng.heartbeat(now_of[w])
                    at_heartbeat = {k: eng.dev_pool[k].clone() for k in (
                        "active", "rating", "rd", "bidx_count", "bidx_min",
                        "bidx_max", "bidx_rd")}
            if w == 1:
                # Collect windows 0 and 1 together, so the CPU replay of the
                # first three windows sees the same pool at each dispatch.
                torch.cuda.synchronize()
            while eng.inflight() >= depth:
                for tok_c, out in eng.collect_ready():
                    turnaround_ms.append((time.perf_counter() - t_disp[tok_c]) * 1e3)
                    outs[token_window[tok_c]] = out
            gc_ms.append((gc_clock.total - gc_before) * 1e3)
        for tok_c, out in eng.flush():
            turnaround_ms.append((time.perf_counter() - t_disp[tok_c]) * 1e3)
            outs[token_window[tok_c]] = out
        run_s = time.perf_counter() - t_run
    launches = ck.LAUNCHES["block_best"]
    q_launches = ck.LAUNCHES["quality_accum"]
    prune = eng.prune_report()  # and once after flush()
    if prune is not None:
        prune = {k: prune[k] - prune0[k] for k in prune}
    util = eng.util_report()
    spans = {k: (v - spans0[k]) for k, v in eng.spans.items()}
    split = {k[:-2] + "_ms": v / windows * 1e3 for k, v in spans.items()
             if k.endswith("_s")}
    idle = util["device_idle_s"] - util0["device_idle_s"]
    busy = util["device_busy_s"] - util0["device_busy_s"]
    # -- checks, after the timed loop (they build Python objects) --
    if launches != windows or q_launches != windows:
        # one launch of each per <= 1,024-lane window chunk
        raise AssertionError(f"block_best launched {launches} times and "
                             f"quality_accum {q_launches} for {windows} "
                             f"window chunks")
    if prune is not None and prune["windows"] != windows:
        raise AssertionError(f"pruned steps {prune} for {windows} windows")
    formation = (check_bucketed(torch, np, eng, at_heartbeat, windows, label)
                 if bucketed else None)
    if bucketed and prune["span_windows"] == 0:
        raise AssertionError(f"{label}: no window took the span path "
                             f"({prune})")
    seen, matches, admitted = set(), 0, 0
    for w in range(windows):
        out = outs[w]
        matches += check_columnar(np, scoring, eng, pop, out, now_of[w], enq,
                                  seen, glicko2, window_ids=stream[w].ids)
        admitted += len(stream[w]) - len(out.rejected)
    if eng.pool_size() != waiting + admitted - 2 * matches:
        raise AssertionError(f"pool_size {eng.pool_size()} != {waiting} + "
                             f"{admitted} - 2 x {matches}")
    samples = quality_reconciles(np, eng, pop, [outs[w] for w in range(windows)],
                                 label)
    if samples - samples0 != 2 * matches or samples0:
        raise AssertionError(f"{label}: {samples} quality samples for "
                             f"{matches} matches")
    # The deadline sweep: every stamped player still waiting expires (5 %
    # of the rows carry a deadline, arrivals included).
    n_in = waiting + windows * FULL_B
    stamped = pop.deadline[:n_in] != 0.0
    left = sum(1 for p in pop.ids[:n_in][stamped].tolist() if p not in seen)
    if eng.deadline_count() != left or left == 0:
        raise AssertionError(f"deadline_count {eng.deadline_count()} != {left}")
    t = time.perf_counter()
    expired = eng.expire_deadlines(t0 + 50.0)
    sweep_ms = (time.perf_counter() - t) * 1e3
    if len(expired) != left or eng.deadline_count() != 0:
        raise AssertionError(f"expire_deadlines took {len(expired)} of {left}")
    if any(r.id in eng.pool for r in expired):
        raise AssertionError("an expired player is still waiting")
    if eng.graph_report()["captures"] != graphs["captures"]:
        raise AssertionError(f"{label}: a window captured a graph again")
    log(f"columnar {label}: {matches} matches in {windows} windows, "
        f"dispatch p50 {statistics.median(dispatch_ms):.3f} ms p99 "
        f"{pct(dispatch_ms, 0.99):.3f} ms, turnaround "
        f"p50 {statistics.median(turnaround_ms):.2f} ms, "
        f"{windows * FULL_B / run_s:.0f} requests/s, launches {launches} "
        f"block_best + {q_launches} quality_accum, {samples} quality samples "
        f"reconciled, pruned {prune}, formation {formation}, "
        f"deadline sweep {len(expired)} players in {sweep_ms:.2f} ms; "
        f"warmup {warmup_s:.2f} s: {graphs['captures']} graphs captured in "
        f"{graphs['capture_ms_total']:.1f} ms (largest "
        f"{graphs['capture_ms_max']:.1f}), {graphs['memory_bytes_total']} "
        f"bytes of graph memory")
    # The device's busy share over further windows, under torch.profiler.
    prof = None
    if profile_windows:
        def run():
            for w in range(windows, windows + profile_windows):
                eng.search_columns_async(stream[w], now_of[w])
                while eng.inflight() >= depth:
                    eng.collect_ready()
            eng.flush()
            return profile_windows
        prof = device_busy(torch, run)
        check_own_kernels(prof, profile_windows, f"profile {label}")
        from matchmaking_tpu_torch.engine import kernels
        prof["greedy_pair_kernels_per_call"] = greedy_pair_kernels(
            torch, kernels, eng.kernels.capacity, FULL_B, eng.kernels.n_blocks,
            eng.kernels.pair_rounds)
        # The quality state's copies to the host in the profiled run (the
        # flush's, and every quality_report_every windows): memcpys, not
        # step kernels.
        prof["quality_copies"] = 1 + profile_windows // max(
            1, cfg.observability.quality_report_every)
        prof["step_kernels_per_window"] = (prof["kernels_per_window"]
                                           - prof["quality_copies"]
                                           / profile_windows)
        log(f"profile {label}: device busy {prof['device_busy_share']:.3f}, "
            f"{prof['device_ms_per_window']:.3f} device ms, "
            f"{prof['queued_per_window']:.2f} launches queued by the host "
            f"({prof['graph_launches_per_window']:.2f} graph launches) and "
            f"{prof['kernels_per_window']:.2f} kernels per window "
            f"({prof['step_kernels_per_window']:.2f} without the quality "
            f"state's copies), {prof['greedy_pair_kernels_per_call']} in "
            f"greedy_pair; top {prof['top_kernels'][:4]}")
    # The same first windows on a CPU columnar engine (windows 0 and 1
    # dispatched before any collection, as on the card).
    cpu = GpuEngine(cfg, queue, device="cpu")
    cpu.restore_columns(pop.columns(RequestColumns, cpu, 0, waiting, t0), t0)
    cpu_outs = []
    for w in range(cpu_windows):
        cpu.search_columns_async(pop.columns(
            RequestColumns, cpu, waiting + w * FULL_B,
            waiting + (w + 1) * FULL_B, now_of[w]), now_of[w])
        if w >= 1 or w == cpu_windows - 1:
            cpu_outs += [o for _, o in cpu.flush()]
    for w in range(cpu_windows):
        if pair_set(cpu_outs[w]) != pair_set(outs[w]):
            raise AssertionError(f"{label} window {w}: the CPU engine formed "
                                 f"other pairs")
    # Every window replayed against the same step run eagerly on the card.
    eager_windows = replay_equals_eager(
        torch, np, mods, cfg, pop, waiting=waiting, t0=t0, windows=windows,
        now_of=now_of, label=label)
    log(f"columnar {label}: {eager_windows} windows replayed bit-equal to "
        f"the eager step")
    # The object path on the card, from the same pool: the same first
    # window, then its own windows (its slot layout parts from the
    # columnar one after a window: see PERF.md).
    obj = None
    if object_windows:
        o_eng = GpuEngine(cfg, queue, device="cuda")
        o_eng.warmup()
        o_eng.restore_columns(pop.columns(RequestColumns, o_eng, 0, waiting, t0), t0)
        torch.cuda.synchronize()
        reset_counts(ck)
        step_ms, o_gc, o_seen, o_matches = [], [], set(), 0
        for w in range(object_windows):
            c = stream[w]
            reqs = [SearchRequest(id=c.ids[i], rating=float(c.rating[i]),
                           rating_deviation=float(c.rd[i]),
                           region=pop.region[waiting + w * FULL_B + i],
                           game_mode=pop.mode[waiting + w * FULL_B + i],
                           enqueued_at=float(c.enqueued_at[i]))
                    for i in range(len(c))]
            with GcClock() as g:
                t = time.perf_counter()
                out = o_eng.search(reqs, now_of[w])
                step_ms.append((time.perf_counter() - t) * 1e3)
            o_gc.append(g.total * 1e3)
            ids = {r.id for m in out.matches for r in m.requests()}
            if ids & o_seen:
                raise AssertionError("object path: a player in two matches")
            o_seen |= ids
            o_matches += len(out.matches)
            if w == 0 and ({frozenset(r.id for r in m.requests())
                            for m in out.matches} != pair_set(outs[0])):
                raise AssertionError("object path: window 0 pairs differ "
                                     "from the columnar path's")
        o_launches = ck.LAUNCHES["block_best"]
        if (o_launches != object_windows
                or ck.LAUNCHES["quality_accum"] != object_windows):
            raise AssertionError(f"object path: {ck.LAUNCHES} launches for "
                                 f"{object_windows} windows")
        o_eng.flush()
        if o_eng.quality_report()["samples"] != 2 * o_matches:
            raise AssertionError("object path: quality samples != 2 x "
                                 "matches")
        obj = {"windows": object_windows, "matches": o_matches,
               "launches": o_launches, "step_ms": step_ms, "gc_ms": o_gc,
               "step_ms_p50": statistics.median(step_ms),
               "step_ms_max": max(step_ms)}
        log(f"object {path}: step p50 {obj['step_ms_p50']:.2f} ms, max "
            f"{obj['step_ms_max']:.2f} ms, GC max {max(o_gc):.2f} ms")
    return {
        "config": path, "engine_over": engine_over, "waiting": waiting,
        "windows": windows, "window": FULL_B, "pipeline_depth": depth,
        "matches": matches, "launches": launches,
        "quality_launches": q_launches, "quality_samples": samples,
        "prune": prune, "formation": formation,
        "pool_size_end": eng.pool_size(),
        "restore_s": restore_s,
        "dispatch_ms": dispatch_ms, "turnaround_ms": turnaround_ms,
        "dispatch_ms_p50": statistics.median(dispatch_ms),
        "dispatch_ms_p99": pct(dispatch_ms, 0.99),
        "turnaround_ms_p50": statistics.median(turnaround_ms),
        "turnaround_ms_p99": pct(turnaround_ms, 0.99),
        "requests_per_s": windows * FULL_B / run_s, "run_s": run_s,
        "gc_ms": gc_ms, "gc_ms_total": sum(gc_ms), "gc_ms_max": max(gc_ms),
        "idle_fraction": idle / max(1e-9, idle + busy),
        "util_report": util, "split_ms_per_window": split,
        "deadlines_waiting_at_start": deadlines_waiting,
        "deadline_sweep": {"expired": len(expired), "ms": sweep_ms},
        "cpu_windows_equal": cpu_windows, "profile": prof, "object": obj,
        "eager_windows_equal": eager_windows, "warmup_s": warmup_s,
        "graphs": graphs,
    }


def run_rescan(torch, np, ck, scoring, mods, path, *, waiting, seed):
    """Config #4 (Glicko-2, widening 5/s): a rescan tick dispatched between
    two traffic windows in flight (windows and tick are collected
    together at the end). The tick must form matches the arrivals did
    not, and a CPU engine driven the same way must form the same pairs."""
    Config, GpuEngine, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue = cfg.queues[0]
    chunks = 2  # a tick of two chunks of the largest bucket (the depth-2 cap)
    tick = chunks * max(cfg.engine.batch_buckets)
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    pop = Population(np, rng, waiting + 2 * FULL_B, t0, filters=False,
                     glicko2=True)
    nows = (t0 + 1.0, t0 + 30.0, t0 + 30.5)
    enq = np.concatenate([t0 - pop.waited[:waiting],
                          nows[0] - pop.waited[waiting:waiting + FULL_B],
                          nows[2] - pop.waited[waiting + FULL_B:]])

    def drive(device, eager=False):
        eng = GpuEngine(cfg, queue, device=device)
        if eager:
            eng._graphs = None  # the same steps, eagerly on the card
        eng.warmup()
        eng.restore_columns(pop.columns(RequestColumns, eng, 0, waiting, t0), t0)
        a = pop.columns(RequestColumns, eng, waiting, waiting + FULL_B, nows[0])
        b = pop.columns(RequestColumns, eng, waiting + FULL_B,
                        waiting + 2 * FULL_B, nows[2])
        if device != "cpu":
            torch.cuda.synchronize()
            reset_counts(ck)
        with (no_sync(torch) if device != "cpu" else contextlib.nullcontext()):
            ta = eng.search_columns_async(a, nows[0])
            before = dict(ck.LAUNCHES)
            tr = eng.rescan_async(tick, nows[1])
            tick_launches = {k: v - before[k] for k, v in ck.LAUNCHES.items()}
            tb = eng.search_columns_async(b, nows[2])
        outs = dict(eng.flush())
        return eng, (outs[ta], outs[tr], outs[tb]), tick_launches

    eng, outs, tick_counts = drive("cuda")
    launches = dict(ck.LAUNCHES)
    tick_launches = tick_counts["block_best"]
    if (tick_counts != {"block_best": chunks, "quality_accum": chunks}
            or launches != {"block_best": 2 + chunks,
                            "quality_accum": 2 + chunks}):
        raise AssertionError(f"rescan run: {tick_counts} launches for the "
                             f"tick's {chunks} chunks, {launches} in all for "
                             f"{2 + chunks} chunks")
    launches = launches["block_best"]
    seen = set()
    for out, now in zip(outs, nows):
        check_columnar(np, scoring, eng, pop, out, now, enq, seen, True)
    if outs[1].n_matches == 0:
        raise AssertionError("the rescan tick formed no match")
    samples = quality_reconciles(np, eng, pop, outs, "rescan run")
    if samples != 2 * sum(o.n_matches for o in outs):
        raise AssertionError("rescan run: quality samples != 2 x matches")
    _, cpu_outs, _ = drive("cpu")
    for k, (got, want) in enumerate(zip(outs, cpu_outs)):
        if pair_set(got) != pair_set(want):
            raise AssertionError(f"rescan run, outcome {k}: the CPU engine "
                                 f"formed other pairs")
    # The tick's two chunks replay one graph before the tick's readbacks:
    # each reads back its own result, the eager step's.
    _, eager_outs, _ = drive("cuda", eager=True)
    for k, (got, want) in enumerate(zip(outs, eager_outs)):
        if (got.m_id_a.tolist() != want.m_id_a.tolist()
                or not np.array_equal(got.m_dist.view(np.int32),
                                      want.m_dist.view(np.int32))):
            raise AssertionError(f"rescan run, outcome {k}: the replayed "
                                 f"steps differ from the eager ones")
    # One more tick under torch.profiler: what the host queues and the
    # device runs per chunk (each chunk one graph replay).
    def run():
        eng.rescan_async(tick, nows[2] + 1.0)
        eng.flush()
        return chunks
    prof = device_busy(torch, run)
    check_own_kernels(prof, chunks, "rescan tick profile")
    log(f"rescan tick profile: {prof['queued_per_window']:.2f} launches "
        f"queued by the host ({prof['graph_launches_per_window']:.2f} graph "
        f"launches) and {prof['kernels_per_window']:.2f} kernels per chunk, "
        f"{prof['device_ms_per_window']:.3f} device ms a chunk")
    log(f"rescan {path}: tick of {chunks} chunks formed "
        f"{outs[1].n_matches} matches between waiting players "
        f"(arrivals {outs[0].n_matches} + {outs[2].n_matches}); same pairs "
        f"on the CPU and eagerly on the card; launches {tick_launches} in "
        f"the tick, "
        f"{launches - tick_launches} in the arrival windows")
    return {"config": path, "waiting": waiting, "rescan_chunks": chunks,
            "rescan_matches": outs[1].n_matches,
            "arrival_matches": outs[0].n_matches + outs[2].n_matches,
            "launches": launches, "tick_launches": tick_launches,
            "arrival_launches": launches - tick_launches,
            "tick_profile": prof}


def same_outcomes(np, got, want, what):
    """Two columnar outcomes (or lists of them, concatenated) with the same
    pairs in the same order, distances bit for bit, and queued ids."""
    cat = lambda outs, name: [x for o in outs for x in getattr(o, name).tolist()]
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    for name in ("m_id_a", "m_id_b", "q_ids"):
        if cat(got, name) != cat(want, name):
            raise AssertionError(f"{what}: {name} differ")
    gd = np.concatenate([o.m_dist for o in got]).view(np.int32)
    wd = np.concatenate([o.m_dist for o in want]).view(np.int32)
    if not np.array_equal(gd, wd):
        raise AssertionError(f"{what}: distances differ")
    return sum(o.n_matches for o in got)


def same_pools(torch, a, b, what):
    """Two engines' device pools (index columns included) and quality
    states bit-equal."""
    torch.cuda.synchronize()
    for name, col in a.dev_pool.full.items():
        if not torch.equal(col, b.dev_pool.full[name]):
            raise AssertionError(f"{what}: pool column {name} differs")
    if not torch.equal(a._q_dev.flat, b._q_dev.flat):
        raise AssertionError(f"{what}: the quality states differ")


def event_ms(torch, fn):
    """Device ms from a CUDA event before ``fn()`` to one after it (what
    ``fn`` queued on the stream), and ``fn``'s result."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def run_speculation(torch, np, ck, mods, path, *, engine_over, waiting,
                    windows, seed):
    """Phase 3d: speculation on the card. An engine with ``spec_formation``
    (two passes) and a twin without a held speculation take the same
    restore and ``windows`` traffic windows in lockstep (equal outcomes).
    Then the engine speculates 30 s after the stream (widened thresholds
    where the queue widens): its live pool stays bit-equal through it, and
    the commit's outcome equals the twin's two cold ``rescan_async`` ticks
    at the same time (queued back to back, so both pick the same players,
    as the two passes do), pair for pair, distances bit for bit, with equal
    pools (index columns included) and quality states after. A second
    speculation, invalidated by a traffic window, leaves the live pool
    bit-equal to before it, and the next window's outcome and the pools
    again equal the twin's. Times: the spare pool's copy (device ms,
    median of 10), a speculation (device ms from an event before to one
    after: the copy, 2 passes of the rescan graph per chunk, the result
    copies) and a commit (the copy back and one quality fold a chunk),
    with their host ms; the launches of each; the counters."""
    import dataclasses

    Config, GpuEngine, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, spec_formation=True, spec_max_steps=2, **engine_over))
    label = f"speculation {path}" + (" (bucketed)" if cfg.engine.bucketed
                                     else "")
    queue = cfg.queues[0]
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    pop = Population(np, rng, waiting + (windows + 1) * FULL_B, t0,
                     filters=False, glicko2=queue.glicko2)
    now_of = [t0 + 1.0 + 0.05 * w for w in range(windows + 1)]
    eng, twin = (GpuEngine(cfg, queue, device="cuda") for _ in range(2))
    for e in (eng, twin):
        e.warmup()
        e.restore_columns(pop.columns(RequestColumns, e, 0, waiting, t0), t0)

    def window(w):
        outs = []
        for e in (eng, twin):
            e.search_columns_async(pop.columns(
                RequestColumns, e, waiting + w * FULL_B,
                waiting + (w + 1) * FULL_B, now_of[w]), now_of[w])
            (_, out), = e.flush()
            outs.append(out)
        same_outcomes(np, *outs, f"{label} window {w}")

    for w in range(windows):
        window(w)
    same_pools(torch, eng, twin, f"{label} after the stream")
    t_spec = now_of[windows - 1] + 30.0
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in eng.dev_pool.full.items()}
    reset_counts(ck)
    h = time.perf_counter()
    spec_ms, held = event_ms(torch, lambda: eng.speculate(t_spec))
    spec_host_ms = (time.perf_counter() - h) * 1e3
    spec_launches = dict(ck.LAUNCHES)
    if not held:
        raise AssertionError(f"{label}: no speculation held")
    for k, v in before.items():
        if not torch.equal(eng.dev_pool.full[k], v):
            raise AssertionError(f"{label}: the speculation wrote the live "
                                 f"pool's {k}")
    reset_counts(ck)
    tok = eng.spec_validate(t_spec)
    h = time.perf_counter()
    commit_ms, _ = event_ms(torch, lambda: eng.spec_commit(tok, t_spec))
    commit_host_ms = (time.perf_counter() - h) * 1e3
    commit_launches = dict(ck.LAUNCHES)
    (_, got), = eng.flush()
    # Two ticks queued back to back: the second picks the first's players
    # again (the mirror lags until the flush), as the second pass does.
    for _ in range(2):
        twin.rescan_async(2 * FULL_B, t_spec)
    cold = [o for _, o in twin.flush()]
    matches = same_outcomes(np, got, cold, f"{label}: commit against the "
                            f"cold rescans")
    same_pools(torch, eng, twin, f"{label} after the commit")
    steps = eng.spec_report()["spec_committed_steps"]
    if (matches == 0 or spec_launches["block_best"] != steps
            or spec_launches["quality_accum"] != 0
            or commit_launches != {"block_best": 0, "quality_accum": steps}):
        raise AssertionError(f"{label}: {matches} matches; launches "
                             f"{spec_launches} speculating, "
                             f"{commit_launches} committing, {steps} passes")
    # A speculation discarded by an admission.
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in eng.dev_pool.full.items()}
    if not eng.speculate(t_spec + 1.0):
        raise AssertionError(f"{label}: no second speculation")
    torch.cuda.synchronize()
    for k, v in before.items():
        if not torch.equal(eng.dev_pool.full[k], v):
            raise AssertionError(f"{label}: the discarded speculation wrote "
                                 f"the live pool's {k}")
    now_of[windows] = t_spec + 2.0
    window(windows)
    if eng.spec_validate(t_spec + 2.0) is not None:
        raise AssertionError(f"{label}: an admission left the speculation")
    same_pools(torch, eng, twin, f"{label} after the discarded speculation")
    report = eng.spec_report()
    if report["spec_hit"] != 1 or report["spec_wasted"] != 1:
        raise AssertionError(f"{label}: counters {report}")
    spare = eng._spec_device_pool()
    copy_ms = statistics.median(event_ms(torch, lambda: eng._copy_pool(
        spare, eng.dev_pool))[0] for _ in range(10))
    # The host's pick of the players (a rescan tick's): what most of a
    # speculation's host time goes to at this pool size.
    h = time.perf_counter()
    eng._rescan_chunks(2 * FULL_B, t_spec)
    pick_host_ms = (time.perf_counter() - h) * 1e3
    # One more speculation and its commit under torch.profiler: the device
    # time of what each queued (kernels and copies), apart from the host's.
    t_prof = t_spec + 3.0
    prof_spec = device_busy(torch, lambda: eng.speculate(t_prof) and 1)
    prof_commit = device_busy(torch, lambda: eng.spec_commit(
        eng.spec_validate(t_prof), t_prof) is not None and 1)
    eng.flush()
    out = {"config": path, "engine_over": engine_over, "waiting": waiting,
           "windows": windows, "commit_matches": matches, "passes": steps,
           "copy_ms": copy_ms, "speculate_ms": spec_ms,
           "speculate_host_ms": spec_host_ms, "pick_host_ms": pick_host_ms,
           "commit_ms": commit_ms,
           "commit_host_ms": commit_host_ms,
           "speculate_device_ms": prof_spec["device_ms_per_window"],
           "speculate_wall_ms": prof_spec["wall_ms_per_window"],
           "speculate_kernels": prof_spec["kernels_per_window"],
           "commit_device_ms": prof_commit["device_ms_per_window"],
           "commit_wall_ms": prof_commit["wall_ms_per_window"],
           "commit_kernels": prof_commit["kernels_per_window"],
           "speculate_launches": spec_launches["block_best"],
           "commit_launches": commit_launches["quality_accum"],
           "counters": report}
    log(f"{label}: commit of {steps} passes formed {matches} matches, equal "
        f"to the twin's cold rescans; pools equal; counters {report}; spare "
        f"pool copy {copy_ms:.4f} ms (events); speculate {spec_ms:.4f} ms "
        f"between events ({spec_host_ms:.3f} host, {pick_host_ms:.3f} of "
        f"it the players' pick), profiled: "
        f"{out['speculate_device_ms']:.4f} device ms in "
        f"{out['speculate_kernels']:.0f} kernels and copies, "
        f"{out['speculate_wall_ms']:.3f} wall; commit {commit_ms:.4f} ms "
        f"between events ({commit_host_ms:.3f} host), profiled "
        f"{out['commit_device_ms']:.4f} device ms in "
        f"{out['commit_kernels']:.0f}, {out['commit_wall_ms']:.3f} wall")
    return out


def check_faults(app, what):
    """The service nacks and revives after a failed window, and retries a
    failed tick, so its answers can all be right after a failure on the
    card: a service run passes only if it caught none."""
    if app.faults():
        raise AssertionError(f"{what}: the service caught failures: "
                             f"{app.faults()}")


# ---- phase 4: the service ---------------------------------------------------


async def service_soak(np, ck, mods, path, *, waiting, requests, burst,
                       seed, consume_batch=True, profile_to=None,
                       observability=None):
    """The service at full width: ``waiting`` players restored, then
    ``requests`` published in bursts of ``burst``. Every request is
    answered from its window once (queued or matched) and matched at most
    once, partners agree, one publish_batch per answered window, one
    block_best launch per window (each fits one chunk), and the service
    caught no failure. ``consume_batch`` (the broker's burst consume, on
    by default) off runs the per-delivery path; the codec's decode calls
    are counted: with it on, the bursts are decoded at consume and no
    window at the flush. ``profile_to``: a file that gets cProfile's
    functions by own time over the soak (the event loop's thread, which
    runs every part of the service). ``observability``: fields of the
    config's ``ObservabilityConfig`` to replace (e.g. tracing off)."""
    import dataclasses

    from matchmaking_tpu_torch.native import codec
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        broker=dataclasses.replace(cfg.broker, consume_batch=consume_batch))
    if observability:
        cfg = dataclasses.replace(cfg, observability=dataclasses.replace(
            cfg.observability, **observability))
    decodes = {"consume": 0, "flush": 0}
    real_decode = {"consume": codec.decode_batch_concat,
                   "flush": codec.decode_batch}

    def counted(where):
        def call(*a, **k):
            decodes[where] += 1
            return real_decode[where](*a, **k)
        return call
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=cfg.queues[0].glicko2)
    if cfg.batcher.max_batch > max(cfg.engine.batch_buckets):
        raise AssertionError("soak: a window would take several chunks")
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()  # warm_start: every (variant, bucket) graph captured
    codec.decode_batch_concat = counted("consume")
    codec.decode_batch = counted("flush")
    try:
        reply = "soak.replies"
        app.broker.declare_queue(reply)
        fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply)
        app.restore_columns(fill, pop.region[:waiting],
                                  pop.mode[:waiting], t0)
        reset_counts(ck)  # count the soak's own windows only
        # Latency is publish → the service's response publish (the time a
        # reply is handed to the broker), recorded in the broker's
        # publish_batch, so reading the replies does not time the reader.
        calls, t_pub, first = [], {}, {}
        real = app.broker.publish_batch

        def publish_batch(items):
            calls.append(len(items))
            t = time.perf_counter()
            for _, _, props in items:
                cid = props.correlation_id
                if cid in t_pub and cid not in first:
                    first[cid] = t - t_pub[cid]
            real(items)

        app.broker.publish_batch = publish_batch
        bodies = [json.dumps({"id": pop.ids[k], "rating": float(pop.rating[k]),
                              "rating_deviation": float(pop.rd[k])}).encode()
                  for k in range(waiting, waiting + requests)]
        prof = None
        if profile_to:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        gc_clock = GcClock().__enter__()
        t_soak = time.perf_counter()
        for b in range(0, requests, burst):
            for k in range(b, min(b + burst, requests)):
                pid = pop.ids[waiting + k]
                t_pub[pid] = time.perf_counter()
                app.broker.publish(app.queue_cfg.name, bodies[k],
                                   Properties(reply_to=reply,
                                              correlation_id=pid))
            await asyncio.sleep(0.005)
        deadline = time.monotonic() + 120.0
        while len(first) < requests and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        soak_s = time.perf_counter() - t_soak
        gc_clock.__exit__()
        if prof is not None:
            import io
            import pstats

            prof.disable()
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(40)
            with open(profile_to, "w") as f:
                f.write(text.getvalue())
        while app.engine.inflight() and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        if len(first) != requests:
            raise AssertionError(f"soak: {requests - len(first)} requests "
                                 f"never answered")
        spans, util = app.engine.span_report(), app.engine.util_report()
    finally:
        await app.stop()
        codec.decode_batch_concat = real_decode["consume"]
        codec.decode_batch = real_decode["flush"]
    launches = ck.LAUNCHES["block_best"]
    check_faults(app, "soak")
    if (consume_batch and (decodes["flush"] or not decodes["consume"])) or (
            not consume_batch and decodes["consume"]):
        raise AssertionError(f"soak, consume_batch {consume_batch}: decode "
                             f"calls {decodes}")
    windows = app.counters["windows"]
    if launches != windows or ck.LAUNCHES["quality_accum"] != windows:
        raise AssertionError(f"soak: {ck.LAUNCHES} launches for {windows} "
                             f"windows")
    from matchmaking_tpu_torch.service.contract import decode_response
    seqs, matched = {}, {}
    while True:
        d = await app.broker.get(reply, timeout=0.2)
        if d is None:
            break
        pid = d.properties.correlation_id
        r = decode_response(d.body)
        if r.player_id != pid:
            raise AssertionError(f"soak: answer for {r.player_id} on {pid}")
        seqs.setdefault(pid, []).append(r.status)
        if r.status == "matched":
            if pid in matched:
                raise AssertionError(f"soak: {pid} matched twice")
            matched[pid] = r.match
    for pid in t_pub:
        if seqs.get(pid) not in (["matched"], ["queued"],
                                 ["queued", "matched"]):
            raise AssertionError(f"soak: {pid} answered {seqs.get(pid)}")
    for pid, m in matched.items():
        other = next(p for p in m.players if p != pid)
        if other not in matched or matched[other].match_id != m.match_id:
            raise AssertionError(f"soak: {pid}'s partner disagrees")
    if len(calls) != windows:
        raise AssertionError(f"soak: {len(calls)} publish_batch calls for "
                             f"{windows} windows")
    # The quality ledger got both players of every published match, and
    # the engine's device accumulator (read back at once) agrees.
    ledger = app.quality.snapshot()["queues"][app.queue_cfg.name]
    engine_samples = int(app.engine.quality_checkpoint()["count"].sum())
    if not (ledger["matched_players"] == len(matched) == engine_samples
            == app.counters["players_matched"]) or not matched:
        raise AssertionError(f"soak: ledger {ledger['matched_players']}, "
                             f"engine {engine_samples} quality samples for "
                             f"{len(matched)} matched players")
    lat = [v * 1e3 for v in first.values()]
    res = {"config": path, "waiting": waiting, "requests": requests,
           "burst": burst, "consume_batch": consume_batch,
           "gc_ms": gc_clock.total * 1e3,
           "decode_calls": decodes, "windows": windows, "launches": launches,
           "soak_s": soak_s,
           "requests_per_s": requests / soak_s,
           "players_matched": len(matched), "publish_batches": len(calls),
           "latency_ms_p50": statistics.median(lat),
           "latency_ms_p99": pct(lat, 0.99), "latency_ms_max": max(lat),
           "counters": dict(app.counters), "span_report": spans,
           "util_report": util, "quality_samples": engine_samples,
           "ledger": {k: ledger[k] for k in ("matched_players",)}}
    log(f"service soak {path} (consume_batch {consume_batch}): {requests} "
        f"requests over {waiting} waiting, {windows} windows, decode calls "
        f"{decodes}, GC {res['gc_ms']:.1f} ms, "
        f"{res['requests_per_s']:.0f} requests/s, "
        f"latency p50 {res['latency_ms_p50']:.2f} ms p99 "
        f"{res['latency_ms_p99']:.2f} ms")
    return res


async def service_rescan(np, ck, mods, path, *, waiting, seed):
    """Config #4's service: its rescan loop (the file's interval) must
    publish matches between players restored into the pool, every match
    must reach both players, and the service must catch no failure."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, warm_start=True))
    interval = cfg.queues[0].rescan_interval_s
    if interval <= 0:
        raise AssertionError(f"{path} configures no rescan")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting, t0, filters=False, glicko2=True)
    app = MatchmakingApp(cfg, device="cuda")
    reply = "rescan.replies"
    await app.start()
    try:
        app.broker.declare_queue(reply)
        app.restore_columns(
            pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply),
            pop.region, pop.mode, t0)
        reset_counts(ck)  # the rescan ticks' chunks only
        deadline = time.monotonic() + 3 * interval + 10.0
        while (app.counters["rescan_matches"] == 0
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
    finally:
        await app.stop()
    launches = ck.LAUNCHES["block_best"]
    check_faults(app, "service rescan")
    n = 0
    while await app.broker.get(reply, timeout=0.2) is not None:
        n += 1
    m = app.counters["rescan_matches"]
    if (m == 0 or n != 2 * m or launches == 0
            or ck.LAUNCHES["quality_accum"] != launches):
        raise AssertionError(f"service rescan: {m} matches, {n} answers, "
                             f"{launches} launches")
    log(f"service rescan {path}: {m} matches published by the rescan loop, "
        f"{launches} block_best launches")
    return {"config": path, "waiting": waiting, "rescan_interval_s": interval,
            "rescan_matches": m, "answers": n, "launches": launches}


async def service_spec(ck, mods, path):
    """Config #1 bucketed (the JAX bench's geometry) with speculation on
    and no rescan loop: two players far apart (1500 and 1900) under fast
    widening (threshold 50, 400/s, capped at 2000), the geometry of the
    JAX package's own test. Only the speculation loop can match them; both
    must be answered matched by one match, and the service must catch no
    failure."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.client import MatchmakingClient

    Config = mods[0]
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(
            cfg.engine, warm_start=True, spec_formation=True,
            spec_interval_ms=10.0, spec_max_steps=2, spec_staleness_ms=500.0,
            **BUCKETED),
        queues=(dataclasses.replace(cfg.queues[0], rating_threshold=50.0,
                                    widen_per_sec=400.0, max_threshold=2000.0,
                                    rescan_interval_s=0.0),))
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    try:
        reset_counts(ck)
        t = time.perf_counter()
        client = MatchmakingClient(app.broker, cfg.queues[0].name)
        a = client.submit({"id": "alice", "rating": 1500})
        b = client.submit({"id": "bob", "rating": 1900})
        first = [(await client.next_response(h, timeout=30.0)).status
                 for h in (a, b)]
        second = [await client.next_response(h, timeout=30.0) for h in (a, b)]
        wait_s = time.perf_counter() - t
        report = app.engine.spec_report()
        counters = dict(app.counters)
    finally:
        await app.stop()
    check_faults(app, "service speculation")
    if (first != ["queued", "queued"]
            or [r.status for r in second] != ["matched", "matched"]
            or second[0].match.match_id != second[1].match.match_id
            or counters["rescan_matches"] != 1 or counters["spec_commits"] == 0
            or report["spec_hit"] == 0):
        raise AssertionError(f"service speculation: {first}, "
                             f"{[r.status for r in second]}, {counters}, "
                             f"{report}")
    launches = dict(ck.LAUNCHES)
    if launches["block_best"] == 0 or launches["quality_accum"] == 0:
        raise AssertionError(f"service speculation: launches {launches}")
    log(f"service speculation {path} (bucketed): both players matched by the "
        f"speculation loop alone in {wait_s:.3f} s; {counters['spec_commits']} "
        f"commits, counters {report}, launches {launches}")
    return {"config": path, "engine_over": BUCKETED, "matched_after_s": wait_s,
            "spec_commits": counters["spec_commits"], "counters": report,
            "launches": launches["block_best"],
            "quality_launches": launches["quality_accum"]}


# ---- phase 5: team and role queues (configs #3 and #5) ------------------------


#: Region and mode values of the team phases: every request pins both (a
#: wildcard would hand the queue to the host oracle).
TEAM_REGIONS = ("eu", "na", "apac")
TEAM_MODES = ("ranked", "casual")
ROLE_NAMES = ("tank", "healer", "dps")


class TeamPopulation:
    """Seeded solo players, row k = player ``t<k>``: ratings N(1500, 300),
    waits U(0, 20) s, region from 3 values and mode from 2, all pinned;
    with ``roles``, 70 % one role (tank 20 %, healer 20 %, dps 60 %), 20 %
    two roles, 10 % none (eligible for every slot)."""

    def __init__(self, np, rng, n, *, roles, prefix="t"):
        self.rating = rng.normal(1500.0, 300.0, n).astype(np.float32)
        self.waited = rng.uniform(0.0, 20.0, n)
        self.region = np.array(TEAM_REGIONS, object)[rng.integers(0, 3, n)]
        self.mode = np.array(TEAM_MODES, object)[rng.integers(0, 2, n)]
        self.roles = [()] * n
        if roles:
            kind = rng.random(n)
            one = rng.choice(3, n, p=[0.2, 0.2, 0.6])
            two = rng.integers(0, 3, n)
            for k in range(n):
                if kind[k] < 0.7:
                    self.roles[k] = (ROLE_NAMES[one[k]],)
                elif kind[k] < 0.9:
                    self.roles[k] = tuple(r for j, r in enumerate(ROLE_NAMES)
                                          if j != two[k])
        self.ids = [f"{prefix}{k}" for k in range(n)]
        self.row = {pid: k for k, pid in enumerate(self.ids)}

    def requests(self, SearchRequest, lo, hi, now, reply=""):
        return [SearchRequest(id=self.ids[k], rating=float(self.rating[k]),
                              region=self.region[k], game_mode=self.mode[k],
                              roles=self.roles[k], reply_to=reply,
                              correlation_id=self.ids[k],
                              enqueued_at=now - float(self.waited[k]))
                for k in range(lo, hi)]


def _perfect_assignment(itertools, team, slots):
    """Brute force: some member → slot bijection where every member may
    play its slot (no declared roles: any slot)."""
    return any(all(not m.roles or slots[s] in m.roles
                   for m, s in zip(team, perm))
               for perm in itertools.permutations(range(len(slots))))


def check_team_outcome(np, queue, out, now, seen, window=None):
    """The invariants of one collected team/role SearchOutcome: nobody in
    two matches, two teams of ``team_size``, one (region, mode) per match,
    spread ≤ every member's effective threshold, |sum_A − sum_B| ≤ spread,
    quality in [0, 1], a perfect role assignment per team (role queues),
    and (traffic windows) every request matched, queued or rejected."""
    import itertools

    k = queue.team_size
    for m in out.matches:
        members = m.requests()
        ids = [r.id for r in members]
        if len(set(ids)) != 2 * k or any(p in seen for p in ids):
            raise AssertionError(f"match {m.match_id}: a player twice")
        seen.update(ids)
        if [len(t) for t in m.teams] != [k, k]:
            raise AssertionError(f"match {m.match_id}: teams {m.teams}")
        if len({(r.region, r.game_mode) for r in members}) != 1:
            raise AssertionError(f"match {m.match_id}: mixed region/mode")
        ratings = [np.float32(r.rating) for r in members]
        spread = float(max(ratings) - min(ratings))
        for r in members:
            base = (r.rating_threshold if r.rating_threshold is not None
                    else queue.rating_threshold)
            eff = (min(queue.max_threshold, base + queue.widen_per_sec
                       * max(0.0, now - r.enqueued_at))
                   if queue.widen_per_sec > 0 else base)
            if spread > eff + 1e-3:
                raise AssertionError(f"match {m.match_id}: spread {spread} "
                                     f"> {r.id}'s threshold {eff}")
        diff = abs(sum(r.rating for r in m.teams[0])
                   - sum(r.rating for r in m.teams[1]))
        if not queue.role_slots and diff > spread + 1e-3:
            raise AssertionError(f"match {m.match_id}: team sums differ by "
                                 f"{diff} > spread {spread}")
        if not 0.0 <= m.quality <= 1.0:
            raise AssertionError(f"match {m.match_id}: quality {m.quality}")
        if queue.role_slots:
            for team in m.teams:
                if not _perfect_assignment(itertools, team, queue.role_slots):
                    raise AssertionError(f"match {m.match_id}: a team "
                                         f"cannot fill its role slots")
    if window is not None:
        done = ({r.id for r in out.queued} | seen
                | {r.id for r, _ in out.rejected})
        if any(r.id not in done for r in window):
            raise AssertionError("a request was neither matched, queued "
                                 "nor rejected")
    return len(out.matches)


def record_raw(eng):
    """Keep a copy of each finalized window's raw step results (slots,
    spread, limit, split) on the engine instance: the CPU comparison reads
    them. No device work."""
    raws = []
    finalize = eng._finalize_team

    def recording(pending):
        raws.append([r.copy() for r in pending.raw or ()])
        finalize(pending)

    eng._finalize_team = recording
    return raws


def step_bound(np, ks, batch, out_elems):
    """Least time for one team/role step call: the bytes it must move (the
    pool's columns read once, the packed window read once, the admitted
    lanes' columns and the matched slots' ``active`` written once, the
    result f32[rows, max_matches] written once) over the memory rate, or
    its operations (the two stable sorts' P·log2(P) compares each and one
    compare-select per slot per selection round) over the FP32 peak."""
    slot_bytes = 25 + 4 * len(ks.extra_pool_fields)  # 6 x 4-byte + bool
    nbytes = (ks.capacity * slot_bytes + ks.pack_rows * batch * 4
              + batch * slot_bytes + ks.need * ks.max_matches
              + out_elems * 4)
    p = ks.capacity
    ops = 2 * p * int(np.log2(p)) + ks.rounds * p
    return roofline({}, ops, nbytes)


def step_profile(torch, np, ks, src_pool, batch, now, reps=10):
    """The team/role step alone at full width, on fresh copies of
    ``src_pool`` and one window of ``batch`` arrivals into free slots:
    kernels and device ms per call (torch.profiler), CUDA-event ms (median
    of ``reps``), host ms per call, and the bound (``step_bound``)."""
    from torch.profiler import ProfilerActivity, profile

    from matchmaking_tpu_torch.engine.kernels import DevicePool

    active = src_pool["active"].cpu().numpy()
    free = np.nonzero(~active)[0]
    rng = np.random.default_rng(0)
    n = min(batch, free.size)
    packed = np.zeros((ks.pack_rows, batch), np.float32)
    packed[0] = ks.capacity
    packed[0, :n] = free[:n]
    packed[1, :n] = rng.normal(1500.0, 300.0, n)
    packed[3, :n] = rng.integers(1, 4, n)
    packed[4, :n] = rng.integers(1, 3, n)
    packed[5, :n] = 120.0
    packed[6, :n] = now
    packed[7, :n] = 1.0
    if ks.is_role:
        packed[8, :n] = rng.integers(1, 8, n)
    packed[-1] = now
    packed = torch.from_numpy(packed).cuda()
    copies = [DevicePool({k: t.clone() for k, t in src_pool.full.items()})
              for _ in range(3 * reps + 6)]
    torch.cuda.synchronize()
    step = lambda: ks.search_step_packed(copies.pop(), packed)
    out_elems = step().numel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = device_us = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels += e.count
            device_us += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    ms = time_ms(torch, step, reps=reps - 3)
    t = time.perf_counter()
    for _ in range(3):
        step()
    host_ms = (time.perf_counter() - t) / 3 * 1e3
    torch.cuda.synchronize()
    return {"launches": kernels / reps, "device_ms": device_us / reps / 1e3,
            "ms": ms, "host_ms": host_ms, "pool": int(active.sum()),
            "batch": batch, **step_bound(np, ks, batch, out_elems)}


def run_team(torch, np, mods, path, *, waiting, windows, profile_windows,
             cpu_windows, seed, roles):
    """A team (config #3) or role (config #5) queue at full width on the
    card: ``waiting`` solo players restored, then ``windows`` object windows
    of 1,024 through ``search_async`` at the config's pipeline depth
    (dispatches under set_sync_debug_mode("error")), collected with
    ``collect_ready`` and ``flush``; every match checked; the first
    ``cpu_windows`` windows' raw step results (slots, spread, limit, split)
    bit-equal to the same engine's on the CPU; ``profile_windows`` more
    under torch.profiler; the step alone profiled and timed."""
    Config, GpuEngine, _, SearchRequest = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue, depth = cfg.queues[0], cfg.engine.pipeline_depth
    n_all = waiting + (windows + profile_windows) * FULL_B
    pop = TeamPopulation(np, np.random.default_rng(seed), n_all, roles=roles)
    t0 = 1_700_000_000.0
    now_of = [t0 + 1.0 + 0.05 * w for w in range(windows + profile_windows)]
    stream = [pop.requests(SearchRequest, waiting + w * FULL_B,
                           waiting + (w + 1) * FULL_B, now_of[w])
              for w in range(windows + profile_windows)]
    fill = pop.requests(SearchRequest, 0, waiting, t0)
    eng = GpuEngine(cfg, queue, device="cuda")
    eng.warmup()
    graphs = graph_summary(eng.graph_report())
    raws = record_raw(eng)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_sync(torch):
        eng.restore(fill, t0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if eng.pool_size() != waiting:
        raise AssertionError(f"restore left {eng.pool_size()} != {waiting}")
    steps = step_profile(torch, np, eng.kernels, eng.dev_pool, FULL_B, 1.0)
    spans0 = dict(eng.spans)
    dispatch_ms, turnaround_ms, matches_per_window = [], [], []
    outs, t_disp, token_window = {}, {}, {}
    t_run = time.perf_counter()
    for w in range(windows):
        t = time.perf_counter()
        with no_sync(torch):
            tok, _ = eng.search_async(stream[w], now_of[w])
        dispatch_ms.append((time.perf_counter() - t) * 1e3)
        t_disp[tok], token_window[tok] = t, w
        if w == 1:
            # Windows 0 and 1 are collected together, so the CPU engine
            # below sees the same pool (and free list) at each dispatch.
            torch.cuda.synchronize()
        while eng.inflight() >= depth:
            for tok_c, out in eng.collect_ready():
                turnaround_ms.append((time.perf_counter() - t_disp[tok_c]) * 1e3)
                outs[token_window[tok_c]] = out
    for tok_c, out in eng.flush():
        turnaround_ms.append((time.perf_counter() - t_disp[tok_c]) * 1e3)
        outs[token_window[tok_c]] = out
    run_s = time.perf_counter() - t_run
    spans = {k: (v - spans0[k]) for k, v in eng.spans.items()}
    seen, matches, admitted = set(), 0, 0
    for w in range(windows):
        n = check_team_outcome(np, queue, outs[w], now_of[w], seen,
                               window=stream[w])
        matches_per_window.append(n)
        matches += n
        admitted += len(stream[w]) - len(outs[w].rejected)
    if eng.pool_size() != waiting + admitted - 2 * queue.team_size * matches:
        raise AssertionError(f"pool_size {eng.pool_size()} != {waiting} + "
                             f"{admitted} - {2 * queue.team_size} x {matches}")
    if eng.counters.get("team_delegated", 0) != 0:
        raise AssertionError(f"a device phase delegated: {eng.counters}")
    # The rescan tick after widening (config #3 widens 2/s): formation
    # over the waiting pool alone, with thresholds 30 s wider.
    rescan = None
    if queue.widen_per_sec > 0:
        left = eng.pool_size()
        now_r = now_of[windows - 1] + 30.0
        tok = eng.rescan_async(FULL_B, now_r)
        (tok_r, out_r), = eng.flush()
        if tok_r != tok or tok not in eng.rescan_tokens:
            raise AssertionError("rescan: token mismatch")
        eng.rescan_tokens.discard(tok)
        n_r = check_team_outcome(np, queue, out_r, now_r, seen)
        if n_r == 0:
            raise AssertionError("the team rescan tick formed no match")
        if eng.pool_size() != left - 2 * queue.team_size * n_r:
            raise AssertionError("rescan: pool accounting")
        rescan = {"waiting_before": left, "matches": n_r,
                  "waiting_after": eng.pool_size()}
    # Quality: no device accumulator on the team steps; each finalized match
    # adds one host sample per member.
    need = 2 * queue.team_size
    formed = matches + (rescan["matches"] if rescan else 0)
    samples = eng.quality_report()["samples"]
    if samples != need * formed or eng._quality is not None:
        raise AssertionError(f"{path}: {samples} quality samples for "
                             f"{formed} matches of {need}")
    # The same first windows on the CPU (windows 0 and 1 dispatched before
    # any collection, as on the card): raw results bit-equal.
    cpu = GpuEngine(cfg, queue, device="cpu")
    cpu_raws = record_raw(cpu)
    cpu.restore(pop.requests(SearchRequest, 0, waiting, t0), t0)
    for w in range(cpu_windows):
        cpu.search_async(pop.requests(SearchRequest, waiting + w * FULL_B,
                                      waiting + (w + 1) * FULL_B, now_of[w]),
                         now_of[w])
        if w >= 1:
            cpu.flush()
    for w in range(cpu_windows):
        for got, want in zip(raws[w], cpu_raws[w]):
            if not np.array_equal(got.view(np.int32), want.view(np.int32)):
                raise AssertionError(f"{path} window {w}: the CPU step's "
                                     f"slots/spread/limit differ")
    # Device time and kernels per window over further windows.
    def run():
        for w in range(windows, windows + profile_windows):
            eng.search_async(stream[w], now_of[w])
            while eng.inflight() >= depth:
                eng.collect_ready()
        eng.flush()
        return profile_windows
    prof = device_busy(torch, run)
    check_own_kernels(prof, 0, f"{path} profile")
    res = {
        "config": path, "waiting": waiting, "windows": windows,
        "window": FULL_B, "pipeline_depth": depth, "matches": matches,
        "matches_per_window": matches_per_window,
        "team_delegated": eng.counters.get("team_delegated", 0),
        "pool_size_end": eng.pool_size(), "restore_s": restore_s,
        "dispatch_ms_p50": statistics.median(dispatch_ms),
        "dispatch_ms_p99": pct(dispatch_ms, 0.99),
        "turnaround_ms_p50": statistics.median(turnaround_ms),
        "turnaround_ms_p99": pct(turnaround_ms, 0.99),
        "requests_per_s": windows * FULL_B / run_s, "run_s": run_s,
        "finalize_ms_per_window": spans["finalize_s"] / windows * 1e3,
        "step_queue_ms_per_window": spans["step_s"] / windows * 1e3,
        "split_ms_per_window": {k[:-2] + "_ms": v / windows * 1e3
                                for k, v in spans.items() if k.endswith("_s")},
        "cpu_windows_equal": cpu_windows, "rescan": rescan,
        "profile": prof, "step": steps, "quality_samples": samples,
        "graphs": graphs,
    }
    if eng.graph_report()["captures"] != graphs["captures"]:
        raise AssertionError(f"{path}: a window captured a graph again")
    log(f"team {path}: {matches} matches in {windows} windows "
        f"(per window {matches_per_window}), dispatch p50/p99 "
        f"{res['dispatch_ms_p50']:.2f}/{res['dispatch_ms_p99']:.2f} ms, "
        f"turnaround p50/p99 {res['turnaround_ms_p50']:.2f}/"
        f"{res['turnaround_ms_p99']:.2f} ms, {res['requests_per_s']:.0f} "
        f"requests/s, finalize {res['finalize_ms_per_window']:.2f} ms a "
        f"window, team_delegated 0; profile: {prof['kernels_per_window']:.0f} "
        f"kernels ({prof['queued_per_window']:.1f} launches queued) and "
        f"{prof['device_ms_per_window']:.3f} device ms a window, "
        f"busy {prof['device_busy_share']:.3f}; step alone: {steps}; rescan "
        f"{rescan}; {samples} quality samples; graphs {graphs}")
    return res


def role_delegation(torch, np, mods, path, *, waiting, seed):
    """Config #5's hand-over on a small pool: ``waiting`` solo players on
    the card, then a 3-player party arrives: the queue moves to the host
    oracle, which serves the party; the party expires (its deadline), the
    5 s quiet period passes, and the queue moves back onto the card, whose
    next window runs the device step."""
    Config, GpuEngine, _, SearchRequest = mods
    from matchmaking_tpu_torch.service.contract import PartyMember

    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    queue = cfg.queues[0]
    pop = TeamPopulation(np, np.random.default_rng(seed), waiting + 64,
                         roles=True, prefix="d")
    t0 = 1_700_000_000.0
    eng = GpuEngine(cfg, queue, device="cuda")
    eng.warmup()
    eng.restore(pop.requests(SearchRequest, 0, waiting, t0), t0)
    party = SearchRequest(
        id="party", rating=-4000.0, region="eu", game_mode="ranked",
        roles=("tank",), enqueued_at=t0 + 1.0, deadline_at=t0 + 3.0,
        party=(PartyMember("party2", -4000.0, roles=("healer",)),
               PartyMember("party3", -4000.0, roles=("dps",))))
    t = time.perf_counter()
    out = eng.search([party], t0 + 1.0)
    oracle_ms = (time.perf_counter() - t) * 1e3
    if eng.counters != {"team_delegated": 1} or eng.dev_pool is not None:
        raise AssertionError(f"the party did not hand the queue over: "
                             f"{eng.counters}")
    if [r.id for r in out.queued] != ["party"]:
        raise AssertionError("the oracle did not serve the party")
    # After a restore the oracle scans the whole pool: it may match
    # restored players in the same window.
    check_team_outcome(np, queue, out, t0 + 1.0, set())
    oracle_matches = len(out.matches)
    if eng.pool_size() != waiting + 1 - 2 * queue.team_size * oracle_matches:
        raise AssertionError("delegation lost waiting players")
    left = eng.pool_size() - 1
    expired = eng.expire_deadlines(t0 + 7.0)  # past the deadline and quiet
    if [r.id for r in expired] != ["party"]:
        raise AssertionError(f"the party did not expire: {expired}")
    if eng.counters != {"team_delegated": 1, "team_repromoted": 1}:
        raise AssertionError(f"not back on the card: {eng.counters}")
    if eng.dev_pool is None or eng.pool_size() != left:
        raise AssertionError("re-promotion lost waiting players")
    torch.cuda.synchronize()
    with no_sync(torch):
        tok, _ = eng.search_async(pop.requests(
            SearchRequest, waiting, waiting + 64, t0 + 8.0), t0 + 8.0)
    (tok_o, out), = eng.flush()
    check_team_outcome(np, queue, out, t0 + 8.0, set())
    res = {"waiting": waiting, "counters": dict(eng.counters),
           "oracle_window_ms": oracle_ms, "oracle_matches": oracle_matches,
           "device_window_after": {"matches": len(out.matches),
                                   "queued": len(out.queued)}}
    log(f"role delegation {path}: {res}")
    return res


async def service_role_health(np, mods, path, *, waiting, seed):
    """Config #5's hand-over through the service, on the card: ``waiting``
    players restored, then a 2-player party with an ``x-deadline`` 0.5 s
    out hands the queue to the host oracle; the deadline sweep answers it
    ``timeout``, after which no traffic is sent, so only the health timer
    (the file's ``health_interval_s``, the default 1 s) can move the queue
    back onto the card once the quiet period (cut from 5 s to 1 s on this
    engine, to keep the smoke short) has passed. Then 64 pinned arrivals
    are answered by the device step."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.contract import decode_response

    Config, _, _, SearchRequest = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        overload=dataclasses.replace(cfg.overload, deadline_sweep_ms=20.0))
    interval, quiet = cfg.engine.health_interval_s, 1.0
    if interval <= 0 or cfg.queues[0].rescan_interval_s > 0:
        raise AssertionError(f"{path}: the health timer must be the only "
                             f"ticker")
    pop = TeamPopulation(np, np.random.default_rng(seed), waiting + 64,
                         roles=True, prefix="h")
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    reply = "health.replies"
    try:
        app.broker.declare_queue(reply)
        eng = app.engine
        eng.TEAM_REPROMOTE_QUIET_S = quiet
        t0 = time.time()
        app.restore(pop.requests(SearchRequest, 0, waiting, t0, reply), t0)
        t_arrival = time.time()
        app.broker.publish(app.queue_cfg.name, json.dumps({
            "id": "party", "rating": -4000.0, "region": "eu",
            "game_mode": "ranked", "roles": ["tank"],
            "party": [{"id": "party2", "rating": -4000.0,
                       "roles": ["healer"]}]}).encode(),
            Properties(reply_to=reply, correlation_id="party",
                       headers={"x-deadline": repr(t_arrival + 0.5)}))
        statuses = []
        deadline = time.monotonic() + 30.0
        while "timeout" not in statuses and time.monotonic() < deadline:
            d = await app.broker.get(reply, timeout=0.05)
            if d is not None and d.properties.correlation_id == "party":
                statuses.append(decode_response(d.body).status)
        if statuses != ["queued", "timeout"] or eng.dev_pool is not None:
            raise AssertionError(f"role health: the party got {statuses}, "
                                 f"engine counters {eng.counters}")
        while (not eng.counters.get("team_repromoted")
               and time.monotonic() < deadline):
            await asyncio.sleep(0.005)
        t_back = time.time()
        if (eng.counters != {"team_delegated": 1, "team_repromoted": 1}
                or app.counters["health_repromotions"] < 1
                or eng.dev_pool is None):
            raise AssertionError(f"role health: not back on the card by the "
                                 f"health timer: {eng.counters}, "
                                 f"{app.counters}")
        late_s = t_back - (t_arrival + quiet)
        if late_s > interval + 0.5:
            raise AssertionError(f"role health: back {late_s:.3f} s after "
                                 f"the quiet period, interval {interval} s")
        left = eng.pool_size()
        ids = pop.ids[waiting:]
        for k in range(waiting, waiting + 64):
            app.broker.publish(app.queue_cfg.name, json.dumps({
                "id": pop.ids[k], "rating": float(pop.rating[k]),
                "region": pop.region[k], "game_mode": pop.mode[k],
                "roles": list(pop.roles[k])}).encode(),
                Properties(reply_to=reply, correlation_id=pop.ids[k]))
        got = {}
        while len(got) < 64 and time.monotonic() < deadline:
            d = await app.broker.get(reply, timeout=0.05)
            if d is not None and d.properties.correlation_id in ids:
                got.setdefault(d.properties.correlation_id, decode_response(
                    d.body).status)
        while app.engine.inflight() and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        if len(got) != 64 or eng.counters["team_delegated"] != 1:
            raise AssertionError(f"role health: {len(got)} of 64 arrivals "
                                 f"answered, counters {eng.counters}")
    finally:
        await app.stop()
    check_faults(app, "role health")
    res = {"config": path, "waiting": waiting, "health_interval_s": interval,
           "quiet_s": quiet, "repromoted_after_quiet_s": late_s,
           "pool_after": left, "counters": dict(eng.counters),
           "health_repromotions": app.counters["health_repromotions"],
           "arrivals_after": {s: list(got.values()).count(s)
                              for s in set(got.values())}}
    log(f"role health {path}: {res}")
    return res


async def service_multiqueue(np, ck, mods, path, *, waiting, requests, burst,
                             seed):
    """Config #2's service on the card: both queues (ranked at threshold
    75, casual at 150) served by one app, each with ``waiting`` players
    restored and ``requests`` published in bursts of ``burst`` (regions and
    modes drawn with wildcards). Every request is answered from its window
    once (queued or matched) and matched at most once, within its queue's
    threshold and filters, by a partner from its own queue; each queue gets
    one publish_batch per window; one block_best and one quality_accum
    launch per window. A probe pair 100 apart, far from everyone, is
    matched on casual and left waiting on ranked; a ranked and a casual
    player 10 apart are both left waiting."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.contract import decode_response

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, warm_start=True))
    names = [q.name for q in cfg.queues]
    thr = {q.name: q.rating_threshold for q in cfg.queues}
    if len(names) != 2 or thr[names[0]] == thr[names[1]]:
        raise AssertionError(f"{path}: expected two queues, two thresholds")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pops, reply = {}, {}
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    try:
        for name, prefix in zip(names, "rc"):
            pop = pops[name] = Population(np, rng, waiting + requests, t0,
                                          filters=True, glicko2=False)
            pop.ids = np.char.add(prefix, np.arange(waiting + requests)
                                  .astype(str)).astype(object)
            reply[name] = f"mq.{prefix}.replies"
            app.broker.declare_queue(reply[name])
            eng = app.runtime(name).engine
            app.restore_columns(pop.columns(RequestColumns, eng, 0, waiting, t0,
                                            reply[name]),
                                pop.region[:waiting], pop.mode[:waiting], t0,
                                queue=name)
        reset_counts(ck)  # the service's own windows only
        calls = {name: 0 for name in names}
        queue_of_reply = {v: k for k, v in reply.items()}
        real = app.broker.publish_batch

        def publish_batch(items):
            # Every row of a runtime's batch goes to its queue's replies.
            calls[queue_of_reply[items[0][0]]] += 1
            if len({r for r, _, _ in items}) != 1:
                raise AssertionError("a publish_batch mixed the queues")
            real(items)

        app.broker.publish_batch = publish_batch
        low, high = min(names, key=thr.get), max(names, key=thr.get)
        probes = {(low, "lowA", 6000.0), (high, "highA", 6000.0),
                  (low, "crossA", 8000.0)}
        probes_late = {(low, "lowB", 6100.0), (high, "highB", 6100.0),
                       (high, "crossB", 8010.0)}

        def publish(name, pid, body):
            app.broker.publish(name, json.dumps(body).encode(),
                               Properties(reply_to=reply[name],
                                          correlation_id=pid))

        for name, pid, r in sorted(probes):
            publish(name, pid, {"id": pid, "rating": r})
        t_soak = time.perf_counter()
        for b in range(0, requests, burst):
            for name in names:
                pop = pops[name]
                for k in range(waiting + b, waiting + min(b + burst, requests)):
                    body = {"id": pop.ids[k], "rating": float(pop.rating[k])}
                    if pop.region[k] != "*":
                        body["region"] = pop.region[k]
                    if pop.mode[k] != "*":
                        body["game_mode"] = pop.mode[k]
                    publish(name, pop.ids[k], body)
            await asyncio.sleep(0.005)
        for name, pid, r in sorted(probes_late):
            publish(name, pid, {"id": pid, "rating": r})
        answers = {name: {} for name in names}
        want = {name: set(pops[name].ids[waiting:].tolist())
                | {pid for n, pid, _ in probes | probes_late if n == name}
                for name in names}
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            busy = False
            for name in names:
                d = await app.broker.get(reply[name], timeout=0.01)
                if d is not None:
                    busy = True
                    answers[name].setdefault(d.properties.correlation_id,
                                             []).append(decode_response(d.body))
            if (not busy and all(want[n] <= answers[n].keys() for n in names)
                    and not any(app.runtime(n).engine.inflight()
                                for n in names)):
                break
        soak_s = time.perf_counter() - t_soak
        while True:  # late matches of queued players
            got_any = False
            for name in names:
                d = await app.broker.get(reply[name], timeout=0.2)
                if d is not None:
                    got_any = True
                    answers[name].setdefault(d.properties.correlation_id,
                                             []).append(decode_response(d.body))
            if not got_any:
                break
    finally:
        await app.stop()
    check_faults(app, "multiqueue service")
    windows = {n: app.runtime(n).counters["windows"] for n in names}
    total = sum(windows.values())
    if (ck.LAUNCHES["block_best"] != total
            or ck.LAUNCHES["quality_accum"] != total):
        raise AssertionError(f"multiqueue service: {ck.LAUNCHES} launches for "
                             f"{total} windows")
    if calls != windows:
        raise AssertionError(f"multiqueue service: publish_batch calls "
                             f"{calls} for windows {windows}")
    res = {"config": path, "waiting": waiting, "requests": requests,
           "burst": burst, "windows": windows, "launches": total,
           "soak_s": soak_s, "requests_per_s": 2 * requests / soak_s,
           "players_matched": {}}
    for name in names:
        pop, got = pops[name], answers[name]
        row = {pid: k for k, pid in enumerate(pop.ids.tolist())}
        rating = {pid: float(pop.rating[k]) for pid, k in row.items()}
        rating.update({pid: r for n, pid, r in probes | probes_late
                       if n == name})
        published = set(pop.ids[waiting:].tolist()) | {
            pid for n, pid, _ in probes | probes_late if n == name}
        matched = {}
        for pid, rs in got.items():
            seq = [r.status for r in rs]
            # A restored player gets its match only; a published one its
            # window's answer first.
            if seq not in ((["matched"], ["queued"], ["queued", "matched"])
                           if pid in published else (["matched"],)):
                raise AssertionError(f"{name}: {pid} answered {seq}")
            if seq[-1] == "matched":
                matched[pid] = rs[-1].match
        if len(published & set(got)) != requests + 3:
            raise AssertionError(f"{name}: {len(published & set(got))} of "
                                 f"{requests + 3} requests answered")
        for pid, m in matched.items():
            other = next(p for p in m.players if p != pid)
            if other not in rating:
                raise AssertionError(f"{name}: {pid} matched {other}, who is "
                                     f"not on this queue")
            if abs(rating[pid] - rating[other]) > thr[name]:
                raise AssertionError(f"{name}: {pid} and {other} are "
                                     f"{abs(rating[pid] - rating[other])} "
                                     f"apart, threshold {thr[name]}")
            if pid in row and other in row:
                a, b = row[pid], row[other]
                for col in (pop.region, pop.mode):
                    if "*" not in (col[a], col[b]) and col[a] != col[b]:
                        raise AssertionError(f"{name}: {pid} and {other} "
                                             f"fail a filter")
            if other in matched and matched[other].match_id != m.match_id:
                raise AssertionError(f"{name}: {pid}'s partner disagrees")
        res["players_matched"][name] = len(matched)
        probe_status = {pid: got[pid][-1].status
                        for n, pid, _ in probes | probes_late if n == name}
        res.setdefault("probes", {}).update(probe_status)
    want_probes = {"lowA": "queued", "lowB": "queued", "highA": "matched",
                   "highB": "matched", "crossA": "queued", "crossB": "queued"}
    if res["probes"] != want_probes:
        raise AssertionError(f"multiqueue service: probes {res['probes']}, "
                             f"expected {want_probes}")
    log(f"multiqueue service {path}: {res}")
    return res


async def service_team(np, mods, path, *, waiting, requests, burst, seed,
                       interval_s=0.0):
    """Config #3's service on the card: ``waiting`` players restored
    through the app, then ``requests`` published in bursts of ``burst``,
    5 ms apart, or with ``interval_s`` burst k at k x ``interval_s`` after
    the first (a fixed offered load; scripts/torch_service_ab.py). Every request is
    answered from its window (queued, then at most one matched; or
    matched), every matched answer carries two teams of five whose members
    agree on the match, and the service caught no failure. Unpaced, the
    publisher shares the event loop with the service, so the load offered
    (``offered_per_s``) grows as the service frees the loop sooner."""
    import dataclasses

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.contract import decode_response

    Config, _, _, SearchRequest = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, warm_start=True))
    k = cfg.queues[0].team_size
    pop = TeamPopulation(np, np.random.default_rng(seed), waiting + requests,
                         roles=False, prefix="s")
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    reply = "team.replies"
    try:
        app.broker.declare_queue(reply)
        t0 = time.time()
        app.restore(pop.requests(SearchRequest, 0, waiting, t0, reply), t0)
        calls, t_pub, first = [], {}, {}
        real = app.broker.publish_batch

        def publish_batch(items):
            calls.append(len(items))
            t = time.perf_counter()
            for _, _, props in items:
                cid = props.correlation_id
                if cid in t_pub and cid not in first:
                    first[cid] = t - t_pub[cid]
            real(items)

        app.broker.publish_batch = publish_batch
        bodies = [json.dumps({"id": pop.ids[j], "rating": float(pop.rating[j]),
                              "region": pop.region[j],
                              "game_mode": pop.mode[j]}).encode()
                  for j in range(waiting, waiting + requests)]
        gc_clock = GcClock().__enter__()
        t_soak = time.perf_counter()
        for n, b in enumerate(range(0, requests, burst)):
            if n:
                await asyncio.sleep(max(0.0, t_soak + n * interval_s
                                        - time.perf_counter())
                                    if interval_s else 0.005)
            for j in range(b, min(b + burst, requests)):
                pid = pop.ids[waiting + j]
                t_pub[pid] = time.perf_counter()
                app.broker.publish(app.queue_cfg.name, bodies[j],
                                   Properties(reply_to=reply,
                                              correlation_id=pid))
        publish_s = time.perf_counter() - t_soak
        deadline = time.monotonic() + 120.0
        while len(first) < requests and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        soak_s = time.perf_counter() - t_soak
        gc_clock.__exit__()
        while app.engine.inflight() and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        if len(first) != requests:
            raise AssertionError(f"team service: {requests - len(first)} "
                                 f"requests never answered")
        counters = dict(app.engine.counters)
        spans = app.engine.span_report()
    finally:
        await app.stop()
    check_faults(app, "team service")
    if counters.get("team_delegated", 0):
        raise AssertionError(f"team service delegated: {counters}")
    seqs, matched = {}, {}
    while True:
        d = await app.broker.get(reply, timeout=0.2)
        if d is None:
            break
        pid = d.properties.correlation_id
        r = decode_response(d.body)
        if r.player_id != pid:
            raise AssertionError(f"team service: answer for {r.player_id} "
                                 f"on {pid}")
        seqs.setdefault(pid, []).append(r.status)
        if r.status == "matched":
            if pid in matched:
                raise AssertionError(f"team service: {pid} matched twice")
            if [len(t) for t in r.match.teams] != [k, k]:
                raise AssertionError(f"team service: teams {r.match.teams}")
            matched[pid] = r.match
    for pid in t_pub:
        if seqs.get(pid) not in (["matched"], ["queued"],
                                 ["queued", "matched"]):
            raise AssertionError(f"team service: {pid} answered "
                                 f"{seqs.get(pid)}")
    for pid, m in matched.items():
        for other in m.players:
            if other in matched and matched[other].match_id != m.match_id:
                raise AssertionError(f"team service: {pid} and {other} "
                                     f"disagree on their match")
    lat = [v * 1e3 for v in first.values()]
    res = {"config": path, "waiting": waiting, "requests": requests,
           "burst": burst,
           "gc_ms": gc_clock.total * 1e3, "windows": app.counters["windows"],
           "publish_batches": len(calls), "soak_s": soak_s,
           "interval_s": interval_s, "publish_s": publish_s,
           "offered_per_s": requests / publish_s,
           "requests_per_s": requests / soak_s,
           "players_matched": app.counters["players_matched"],
           "latency_ms_p50": statistics.median(lat),
           "latency_ms_p99": pct(lat, 0.99), "latency_ms_max": max(lat),
           "span_report": spans}
    log(f"team service {path}: {requests} requests over {waiting} waiting, "
        f"{res['windows']} windows, offered {res['offered_per_s']:.0f} and "
        f"served {res['requests_per_s']:.0f} requests/s, "
        f"latency p50 {res['latency_ms_p50']:.2f} ms p99 "
        f"{res['latency_ms_p99']:.2f} ms, {res['players_matched']} players "
        f"matched, GC {res['gc_ms']:.1f} ms")
    return res


# ---- phase 6: overload control -------------------------------------------


#: configs/scenarios/mixed-tier-peak.json's cohorts: (name, share, tier,
#: rating mean, rating sigma, deadline in s or None).
COHORTS = (("ranked", 0.25, 0, 1600.0, 150.0, 1.5),
           ("quickplay", 0.50, 1, 1480.0, 300.0, 4.0),
           ("botfill", 0.25, 2, 1400.0, 350.0, None))

#: Phase 6's overload settings (the JAX bench's scenario matrix and its
#: placement soak's credit cap, 8 x window).
OVERLOAD = dict(max_waiting=100_000, max_inflight=8_192, tiers=3,
                shed_policy="oldest", edf=True, deadline_sweep_ms=25.0,
                batch_admission=True)

#: The statuses a request may get, in order: at most one terminal answer.
ANSWER_SEQS = (["queued"], ["matched"], ["queued", "matched"], ["shed"],
               ["queued", "shed"], ["timeout"], ["queued", "timeout"])


class AnswerLog:
    """Every answer the service publishes to ``reply``, with the host
    time of its publish (the broker's ``publish`` and ``publish_batch``
    are wrapped, so reading the replies times nothing)."""

    def __init__(self, app, reply):
        self.times: dict[str, list[float]] = {}
        self.wall: dict[str, list[float]] = {}
        real_one, real_batch = app.broker.publish, app.broker.publish_batch
        in_batch = [False]  # the broker's publish_batch calls publish

        def note(queue, props):
            if queue == reply and props is not None:
                cid = props.correlation_id
                self.times.setdefault(cid, []).append(time.perf_counter())
                self.wall.setdefault(cid, []).append(time.time())

        def publish(queue, body, props=None):
            if not in_batch[0]:
                note(queue, props)
            real_one(queue, body, props)

        def publish_batch(items):
            for queue, _, props in items:
                note(queue, props)
            in_batch[0] = True
            try:
                real_batch(items)
            finally:
                in_batch[0] = False

        app.broker.publish, app.broker.publish_batch = publish, publish_batch
        self.app, self.reply = app, reply

    async def read(self):
        """Every answer on the reply queue: cid → [decoded responses]."""
        from matchmaking_tpu_torch.service.contract import decode_response

        out = {}
        while (d := await self.app.broker.get(self.reply,
                                              timeout=0.2)) is not None:
            out.setdefault(d.properties.correlation_id, []).append(
                decode_response(d.body))
        return out


def cohort_requests(np, rng, n, start):
    """``n`` requests of the mixed-tier-peak cohorts: (id, body, tier,
    deadline budget in s or None), seeded."""
    pick = rng.choice(len(COHORTS), size=n, p=[c[1] for c in COHORTS])
    out = []
    for j, c in enumerate(pick.tolist()):
        _, _, tier, mean, sigma, budget = COHORTS[c]
        pid = f"r{start + j}"
        body = json.dumps({"id": pid, "rating": round(
            float(rng.normal(mean, sigma)), 3)}).encode()
        out.append((pid, body, tier, budget))
    return out


def timed(obj, name, spans):
    """Wrap ``obj.name`` to append each call's host seconds to
    ``spans``."""
    real = getattr(obj, name)

    def call(*a, **k):
        t = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            spans.append(time.perf_counter() - t)
    setattr(obj, name, call)


def watch_tier0(rt, tier_of, violations):
    """Record in ``violations`` every shed of a tier-0 player (refused at
    the cut, or picked by the debt) made while a tier-2 player waited in
    the pool (or, for the debt, entered with the window)."""
    real_shed, real_pick = rt._shed_deliveries, rt._pick_victims

    def tier2_waits():
        return rt.engine.pool_tier_counts(3)[2] > 0

    def shed(deliveries):
        if any(d.tier == 0 for d in deliveries) and tier2_waits():
            violations.append(("cut", len(deliveries)))
        real_shed(deliveries)

    def pick(k, entering=()):
        pool_ids, victims = real_pick(k, entering)
        tiers = [tier_of[p] for p in pool_ids] + [v[1] for v in victims]
        if 0 in tiers and (tier2_waits()
                           or any(e[1] == 2 for e in entering)):
            violations.append(("debt", tiers.count(0)))
        return pool_ids, victims

    rt._shed_deliveries, rt._pick_victims = shed, pick


async def service_overload(np, ck, mods, path, *, waiting, requests, burst,
                           seed, overload_on):
    """Config #1's service at full width with 100k waiting (tiered 25 / 50
    / 25 %) and ``requests`` of the mixed-tier-peak cohorts published in
    bursts of ``burst``, unpaced, each with its ``x-tier`` and (ranked,
    quickplay) ``x-deadline``; with ``overload_on`` under OVERLOAD, else
    with no overload control. Checks: every request answered once (at most
    one terminal answer); with overload control, the pool at or under
    max_waiting after every window, no tier-0 player shed while a tier-2
    player waits, the shed answers by tier equal to the controller's
    ``shed_by_tier``, nobody matched later than its deadline plus one
    sweep interval, no credit held after the drain, and the service
    caught no failure. Times the admission cut and the debt's pick and
    eviction per window."""
    import dataclasses

    from matchmaking_tpu_torch.config import OverloadConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        overload=OverloadConfig(**OVERLOAD) if overload_on
        else OverloadConfig())
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting, t0, filters=False, glicko2=False)
    pool_tier = rng.choice(3, size=waiting, p=[0.25, 0.5, 0.25]).astype(
        np.int32)
    traffic = cohort_requests(np, rng, requests, 0)
    tier_of = {pid: tier for pid, _, tier, _ in traffic}
    tier_of.update(zip(pop.ids.tolist(), pool_tier.tolist()))
    violations: list = []
    app = MatchmakingApp(cfg, device="cuda")
    reply = "overload.replies"
    await app.start()
    rt = app.runtime(cfg.queues[0].name)
    spans = {"cut": [], "pick": [], "debt": []}
    pool_after: list[int] = []
    backlog: list[int] = []
    try:
        app.broker.declare_queue(reply)
        fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply)
        app.restore_columns(dataclasses.replace(fill, tier=pool_tier),
                            pop.region, pop.mode, t0)
        log_ = AnswerLog(app, reply)
        if overload_on:
            timed(rt, "_admission_cut", spans["cut"])
            timed(rt, "_pick_victims", spans["pick"])
            timed(rt, "_pay_debt", spans["debt"])
            watch_tier0(rt, tier_of, violations)
        real_handle, real_cut = rt._handle_columnar_out, rt._batcher._cut

        def handle(*a, **k):
            real_handle(*a, **k)
            pool_after.append(rt.engine.pool_size())

        def cut():  # the backlog EDF can reorder at each cut
            backlog.append(rt._batcher.depth)
            return real_cut()
        rt._handle_columnar_out, rt._batcher._cut = handle, cut
        reset_counts(ck)  # this soak's windows only
        t_pub, deadline_of = {}, {}
        t_soak = time.perf_counter()
        for b in range(0, requests, burst):
            for pid, body, tier, budget in traffic[b:b + burst]:
                headers = {"x-tier": str(tier)}
                if budget is not None:
                    deadline_of[pid] = time.time() + budget
                    headers["x-deadline"] = repr(deadline_of[pid])
                t_pub[pid] = time.perf_counter()
                app.broker.publish(cfg.queues[0].name, body, Properties(
                    reply_to=reply, correlation_id=pid, headers=headers))
            await asyncio.sleep(0.005)
        end = time.monotonic() + 120.0
        while (not all(p in log_.times for p in t_pub)
               and time.monotonic() < end):
            await asyncio.sleep(0.01)
        soak_s = time.perf_counter() - t_soak
        while app.engine.inflight() and time.monotonic() < end:
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.1)  # the last sweep's expiries
        unanswered = [p for p in t_pub if p not in log_.times]
        if unanswered:
            raise AssertionError(f"overload soak: {len(unanswered)} requests "
                                 f"never answered")
        counters = dict(rt.counters)
        shed_by_tier = list(rt.admission.shed_by_tier) if rt.admission else []
        expired_by_tier = (list(rt.admission.expired_by_tier)
                           if rt.admission else [])
    finally:
        await app.stop()
    check_faults(app, "overload soak")
    if overload_on and rt.admission.inflight() != 0:
        raise AssertionError(f"overload soak: {rt.admission.inflight()} "
                             f"credits held after the drain")
    launches = dict(ck.LAUNCHES)
    windows = counters["windows"]
    if launches["block_best"] != windows or launches["quality_accum"] != windows:
        raise AssertionError(f"overload soak: {launches} for {windows} "
                             f"windows")
    answers = await log_.read()
    sweep_s = OVERLOAD["deadline_sweep_ms"] / 1e3
    shed_seen = [0, 0, 0]
    late = 0
    for pid, resps in answers.items():
        seq = [r.status for r in resps]
        if seq not in ANSWER_SEQS:
            raise AssertionError(f"overload soak: {pid} answered {seq}")
        for r, t_wall in zip(resps, log_.wall[pid]):
            if r.status == "shed":
                tier = r.tier if r.tier is not None else tier_of[pid]
                shed_seen[tier] += 1
            if (r.status == "matched" and pid in deadline_of
                    and t_wall > deadline_of[pid] + sweep_s):
                late += 1
    if overload_on:
        if max(pool_after) > OVERLOAD["max_waiting"]:
            raise AssertionError(f"overload soak: the pool reached "
                                 f"{max(pool_after)} after a window")
        if shed_seen != shed_by_tier:
            raise AssertionError(f"overload soak: shed answers by tier "
                                 f"{shed_seen}, shed_by_tier {shed_by_tier}")
        if late:
            raise AssertionError(f"overload soak: {late} players matched "
                                 f"after their deadline + {sweep_s} s")
        if violations:
            raise AssertionError(f"overload soak: tier-0 players shed while "
                                 f"tier 2 waited: {violations[:5]}")
    lat = {t: [] for t in range(3)}
    for pid, t in t_pub.items():
        lat[tier_of[pid]].append((log_.times[pid][0] - t) * 1e3)
    every = [x for xs in lat.values() for x in xs]
    status_by_tier = {t: {} for t in range(3)}
    for pid, _, tier, _ in traffic:
        last = answers[pid][-1].status
        status_by_tier[tier][last] = status_by_tier[tier].get(last, 0) + 1
    res = {"overload": overload_on, "waiting": waiting, "requests": requests,
           "burst": burst, "soak_s": soak_s, "requests_per_s": requests / soak_s,
           "windows": windows, "launches": launches["block_best"],
           "latency_ms_p50": statistics.median(every),
           "latency_ms_p99": pct(every, 0.99),
           "latency_ms_by_tier": {t: {"p50": statistics.median(v),
                                      "p99": pct(v, 0.99)}
                                  for t, v in lat.items()},
           "final_status_by_tier": status_by_tier,
           "shed_by_tier": shed_by_tier, "expired_by_tier": expired_by_tier,
           "backlog_at_cut": {"p50": statistics.median(backlog),
                              "max": max(backlog)},
           "pool_max_after_window": max(pool_after),
           "pool_min_after_window": min(pool_after),
           "matched_late": late,
           "admission_cut_us_per_window": (
               statistics.mean(spans["cut"]) * 1e6 if spans["cut"] else None),
           "debt_windows": len(spans["debt"]),
           "debt_ms_per_window": (statistics.mean(spans["debt"]) * 1e3
                                  if spans["debt"] else None),
           "debt_pick_ms_per_window": (statistics.mean(spans["pick"]) * 1e3
                                       if spans["pick"] else None),
           "counters": {k: v for k, v in counters.items() if v}}
    log(f"overload soak (overload {'on' if overload_on else 'off'}): "
        f"{requests} requests over {waiting} waiting, {windows} windows, "
        f"{res['requests_per_s']:.0f} requests/s, latency p50 "
        f"{res['latency_ms_p50']:.2f} ms p99 {res['latency_ms_p99']:.2f} ms, "
        f"by tier {res['latency_ms_by_tier']}, shed {shed_by_tier}, expired "
        f"{expired_by_tier}, batcher backlog at a cut "
        f"{res['backlog_at_cut']}, pool after a window "
        f"{res['pool_min_after_window']}-{res['pool_max_after_window']}, "
        f"admission cut {res['admission_cut_us_per_window']} us, debt "
        f"{res['debt_ms_per_window']} ms (pick "
        f"{res['debt_pick_ms_per_window']} ms) over {len(spans['debt'])} "
        f"windows")
    return res


# ---- phase 7: the circuit breaker ------------------------------------------


async def service_breaker(np, ck, mods, path, *, waiting, seed):
    """Config #1's service at full width with its breaker on (threshold 2,
    window 30 s, probes 0.25 s, backoff 2, max 60 s, health timer 0.05 s)
    and a chaos script failing device steps 0-1 and the first probe:
    100k restored; 8 requests, whose two failed windows trip the breaker,
    answered by the host oracle with the whole pool; probe 1 fails, probe
    2 captures and replays the base step's graph (each kernel launched by
    the replay and by the eager run before the capture) and the pool
    moves onto a fresh engine; 1,024 more requests
    in 8 windows answered on the card. Checks the counters (crashes 2,
    trips 1, probes 2, probe failures 1, closes 1), every player answered
    once, the waiting ids after the move equal the oracle's, the quality
    counters never decrease, and ``torch.cuda.memory_allocated()`` back
    within 5 % of one engine's share after the demotion and within 5 % of
    it after the re-promotion."""
    import dataclasses
    import gc

    import torch

    from matchmaking_tpu_torch.config import ChaosConfig
    from matchmaking_tpu_torch.engine.cpu import CpuEngine
    from matchmaking_tpu_torch.engine.gpu import GpuEngine
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(
            cfg.engine, breaker_threshold=2, breaker_window_s=30.0,
            breaker_probe_initial_s=0.25, breaker_probe_backoff=2.0,
            breaker_probe_max_s=60.0, health_interval_s=0.05),
        chaos=ChaosConfig(fail_step_ranges=((0, 2),), fail_probes=1))
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting, t0, filters=False, glicko2=False)
    queue = cfg.queues[0].name

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    mem0 = allocated()
    app = MatchmakingApp(cfg, device="cuda")
    reply = "breaker.replies"
    await app.start()
    rt = app.runtime(queue)
    quality = []

    def quality_count():
        quality.append(int(rt.engine.quality_checkpoint()["count"].sum()))

    async def until(pred, what, timeout=60.0):
        end = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > end:
                raise AssertionError(f"breaker phase: timed out on {what}")
            await asyncio.sleep(0.005)

    def publish(lo, hi):
        for k in range(lo, hi):
            pid = f"b{k}"
            app.broker.publish(queue, json.dumps(
                {"id": pid, "rating": round(float(rng.normal(1500, 300)), 3)}
            ).encode(), Properties(reply_to=reply, correlation_id=pid))

    try:
        app.broker.declare_queue(reply)
        app.restore_columns(
            pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply),
            pop.region, pop.mode, t0)
        engine_share = allocated() - mem0
        quality_count()
        log_ = AnswerLog(app, reply)
        t_demote = time.perf_counter()
        publish(0, 8)
        await until(lambda: all(f"b{k}" in log_.times for k in range(8)),
                    "the degraded answers")
        if not isinstance(rt.engine, CpuEngine):
            raise AssertionError("breaker phase: not demoted to the oracle")
        oracle_s = time.perf_counter() - t_demote
        opened_wall = rt.breaker.opened_at
        first_degraded = min(min(log_.wall[f"b{k}"]) for k in range(8))
        mem_demoted = allocated() - mem0
        quality_count()
        oracle_ids = [r.id for r in rt.engine.waiting()]
        reset_counts(ck)  # the probes' launches only
        await until(lambda: rt.counters["breaker_closes"] == 1,
                    "the re-promotion")
        probe_launches = dict(ck.LAUNCHES)
        if not isinstance(rt.engine, GpuEngine):
            raise AssertionError("breaker phase: not back on the card")
        moved_ids = [r.id for r in rt.engine.waiting()]
        mem_promoted = allocated() - mem0
        quality_count()
        probe = dict(rt.last_probe)
        graphs = rt.engine.graph_report()
        probe["captures"] = graphs["captures"]
        probe["capture_ms"] = sum(g["capture_ms"]
                                  for g in graphs["graphs"].values())
        # 1,024 more requests in 8 windows of 128, each answered before
        # the next: the first windows capture their graphs.
        dispatch_ms = []
        timed(rt.engine, "search_columns_async", dispatch_ms)
        reset_counts(ck)  # the windows after the re-promotion only
        for w in range(8):
            publish(8 + 128 * w, 8 + 128 * (w + 1))
            await until(lambda: all(
                f"b{k}" in log_.times
                for k in range(8 + 128 * w, 8 + 128 * (w + 1))),
                f"window {w} after the re-promotion")
        await until(lambda: rt.engine.inflight() == 0, "the last window")
        after_launches = dict(ck.LAUNCHES)
        quality_count()
        counters = dict(rt.counters)
        hook_steps = app.chaos.engine_hook(queue).steps
    finally:
        await app.stop()
    faults = app.faults()
    events = [k for _, k, _, _ in event_rows(app)]
    if events != BREAKER_EVENTS:
        raise AssertionError(f"breaker phase: events {events}, the CPU "
                             f"run's {BREAKER_EVENTS}")
    want = {"engine_crashes": 2, "breaker_trips": 1, "breaker_probes": 2,
            "breaker_probe_failures": 1, "breaker_closes": 1}
    got = {k: counters[k] for k in want}
    if got != want or faults != {"engine_failures": 2, "revives": 2}:
        raise AssertionError(f"breaker phase: counters {got}, faults "
                             f"{faults}")
    if moved_ids != oracle_ids:
        raise AssertionError("breaker phase: the moved pool differs from "
                             "the oracle's")
    if any(b < a for a, b in zip(quality, quality[1:])):
        raise AssertionError(f"breaker phase: quality counts {quality}")
    # The passing probe replays one graph, captured first: its eager run
    # before the capture launches each kernel once more.
    runs = 1 + probe["captures"]
    if probe_launches != {"block_best": runs, "quality_accum": runs}:
        raise AssertionError(f"breaker phase: the probes launched "
                             f"{probe_launches} (graphs captured: "
                             f"{probe['captures']})")
    windows = counters["windows"]
    if (after_launches["block_best"] < 8
            or after_launches["quality_accum"] != after_launches["block_best"]):
        raise AssertionError(f"breaker phase: {after_launches} launches "
                             f"after the re-promotion")
    if abs(mem_demoted) > 0.05 * engine_share or abs(
            mem_promoted - engine_share) > 0.05 * engine_share:
        raise AssertionError(
            f"breaker phase: memory allocated {mem_demoted} B after the "
            f"demotion, {mem_promoted} B after the re-promotion, one engine "
            f"{engine_share} B")
    # The trip froze one incident bundle (the JAX app's breaker_trip
    # trigger), valid by the schema.
    (bundle,) = check_bundles(app, "breaker_trip", "breaker phase")
    answers = await log_.read()
    for pid, resps in answers.items():
        seq = [r.status for r in resps]
        if seq not in ANSWER_SEQS:
            raise AssertionError(f"breaker phase: {pid} answered {seq}")
    if not all(f"b{k}" in answers for k in range(8 + 1024)):
        raise AssertionError("breaker phase: a request was not answered")
    res = {"waiting": waiting, "counters": got, "faults": faults,
           "chaos_steps": hook_steps, "oracle_share_s": oracle_s,
           "trip_to_first_degraded_answer_ms":
               (first_degraded - opened_wall) * 1e3,
           "probe": probe, "moved": len(moved_ids),
           "first_8_windows_dispatch_ms": [x * 1e3 for x in dispatch_ms],
           "events": events, "incident_capture_ms": bundle["capture_ms"],
           "windows": windows, "probe_launches": probe_launches,
           "launches_after": after_launches["block_best"],
           "quality_counts": quality,
           "memory_bytes": {"one_engine": engine_share,
                            "after_demotion": mem_demoted,
                            "after_repromotion": mem_promoted}}
    log(f"breaker phase: {waiting} waiting; the oracle answered 8 in "
        f"{oracle_s:.2f} s ({res['trip_to_first_degraded_answer_ms']:.1f} ms "
        f"from the trip to its first answer); probe {probe}; "
        f"{len(moved_ids)} moved; first 8 windows' dispatch ms "
        f"{[round(x, 3) for x in res['first_8_windows_dispatch_ms']]}; "
        f"memory {res['memory_bytes']}")
    return res


# ---- phase 8: durability, the drain, auth -----------------------------------


class Crashed(BaseException):
    """Unwinds the task a simulated hard crash stopped (not an Exception:
    no handler of the service may catch it and go on)."""


class Replies:
    """Every answer the service publishes to ``reply``: correlation id →
    [(host time of its publish, body)] (the broker's ``publish`` and
    ``publish_batch`` are wrapped, so reading the replies times
    nothing)."""

    def __init__(self, app, reply):
        self.got: dict[str, list[tuple[float, bytes]]] = {}
        real_one, real_batch = app.broker.publish, app.broker.publish_batch
        in_batch = [False]  # the broker's publish_batch calls publish

        def publish(queue, body, props=None):
            if queue == reply and props is not None and not in_batch[0]:
                self.got.setdefault(props.correlation_id, []).append(
                    (time.perf_counter(), bytes(body)))
            real_one(queue, body, props)

        def publish_batch(items):
            t = time.perf_counter()
            for queue, body, props in items:
                if queue == reply and props is not None:
                    self.got.setdefault(props.correlation_id, []).append(
                        (t, bytes(body)))
            in_batch[0] = True
            try:
                real_batch(items)
            finally:
                in_batch[0] = False

        app.broker.publish, app.broker.publish_batch = publish, publish_batch
        app.broker.declare_queue(reply)

    def statuses(self, pid):
        return [json.loads(b)["status"] for _, b in self.got.get(pid, ())]

    def matched(self):
        """player id → match id of every matched answer."""
        out = {}
        for pid, answers in self.got.items():
            for _, b in answers:
                d = json.loads(b)
                if d["status"] == "matched":
                    out.setdefault(pid, set()).add(d["match"]["match_id"])
        return out


def durable_cfg(Config, path, *, journal_dir, fsync="window", overload=None,
                auth=None, warm=True, compact_interval_s=0.0):
    import dataclasses

    from matchmaking_tpu_torch.config import (
        AuthConfig,
        DurabilityConfig,
        OverloadConfig,
    )

    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=warm),
        durability=DurabilityConfig(journal_dir=journal_dir or "",
                                    fsync=fsync,
                                    compact_interval_s=compact_interval_s),
        overload=OverloadConfig(**overload) if overload else OverloadConfig(),
        auth=AuthConfig(**auth) if auth else AuthConfig())


def request_bodies(pop, lo, hi):
    return [(pop.ids[k], json.dumps({"id": pop.ids[k],
                                     "rating": float(pop.rating[k])}).encode())
            for k in range(lo, hi)]


async def publish_and_wait(app, rows, burst, reply, replies, *, headers=None,
                           timeout=120.0):
    """Publish ``rows`` ((id, body)) in bursts of ``burst`` (5 ms apart),
    then wait until each has an answer. Returns (seconds, publish times)."""
    from matchmaking_tpu_torch.service.broker import Properties

    t_pub = {}
    t0 = time.perf_counter()
    for b in range(0, len(rows), burst):
        for pid, body in rows[b:b + burst]:
            t_pub[pid] = time.perf_counter()
            app.broker.publish(app.queue_cfg.name, body, Properties(
                reply_to=reply, correlation_id=pid,
                headers=dict(headers(pid)) if headers else {}))
        await asyncio.sleep(0.005)
    end = time.monotonic() + timeout
    while (not all(p in replies.got for p in t_pub)
           and time.monotonic() < end):
        await asyncio.sleep(0.01)
    soak_s = time.perf_counter() - t0
    missing = [p for p in t_pub if p not in replies.got]
    if missing:
        raise AssertionError(f"{len(missing)} requests never answered")
    return soak_s, t_pub


async def settle(app, timeout=60.0):
    """Until no window is in flight and no answer waits for its commit."""
    rt = app.runtime(app.queue_cfg.name)
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if (app.engine.inflight() == 0 and rt._settler is None
                and rt._batcher.depth == 0
                and app.broker.queue_depth(app.queue_cfg.name) == 0):
            return
        await asyncio.sleep(0.01)
    raise AssertionError("the service did not settle")


def latency_ms(replies, t_pub):
    lat = [(replies.got[p][0][0] - t) * 1e3 for p, t in t_pub.items()]
    return statistics.median(lat), pct(lat, 0.99)


def journal_account(np, directory, queue):
    """A host recomputation of the waiting set from the files alone: the
    newest snapshot's ids, then every record after its anchor in seq
    order (ADMIT adds its rows, TERMINAL/TERMINALS remove), over the
    retained segments. Returns (waiting set, admitted-and-not-terminal
    set, anchor, records by type)."""
    from matchmaking_tpu_torch.utils import journal as jr

    snaps = jr.list_snapshots(directory, queue)
    anchor, snap = snaps[0]
    with np.load(snap, allow_pickle=False) as z:
        waiting = set(z["ids"].tolist())
    records = []
    live = jr.journal_path(directory, queue)
    for path in (live + ".prev", live):
        if os.path.exists(path):
            _, recs, _, _ = jr.read_segment(path)
            records += recs
    records.sort(key=lambda r: r[0])
    admitted = set()
    kinds: dict[int, int] = {}
    for seq, rtype, payload in records:
        kinds[rtype] = kinds.get(rtype, 0) + 1
        if seq <= anchor:
            continue
        d = json.loads(payload)
        if rtype == jr.RT_ADMIT:
            for row in d["rows"]:
                waiting.add(row[0])
                admitted.add(row[0])
        elif rtype == jr.RT_TERMINALS:
            for pid, _, _ in d["t"]:
                waiting.discard(pid)
                admitted.discard(pid)
        elif rtype == jr.RT_TERMINAL:
            waiting.discard(d["id"])
            admitted.discard(d["id"])
    return waiting, admitted, anchor, kinds


def window_pairs(replies, pids):
    """The pairs among the answers to ``pids``."""
    out = set()
    for pid in pids:
        for _, b in replies.got.get(pid, ()):
            d = json.loads(b)
            if d["status"] == "matched":
                out.add(tuple(sorted(d["match"]["players"])))
    return out


async def service_durability(np, torch, ck, mods, path, *, waiting, requests,
                             burst, seed):
    """8a and 8b. Config #1's service at full width, with 100k restored:
    the soak of ``requests`` in bursts of ``burst`` with durability off,
    then with the journal on (fsync="window"): a compaction first anchors
    the 100k (timed; its snapshot's bytes), then the soak; requests/s,
    latency p50/p99, and the journal's host ms a window (ADMIT rows, their
    append and write, the terminals' append, the commit on its thread and
    the loop's wait for it). Checks: every request answered once, the
    segment's ADMIT records equal the windows dispatched. Then a second
    stream, crashed right after its 4th window is dispatched and
    journaled (in flight, uncollected); a successor on the same
    directory recovers on the card (rto_ms and its split, the device's
    drain after it), its waiting set equal to a host recomputation from
    the files, every player answered ``matched`` before the crash absent
    from it, every admitted player without a terminal waiting once; then
    1,024 new requests (its first window's pairs equal to a port app's on
    the CPU recovered from a copy of the directory) and the second
    stream's redeliveries (each matched player's replaying its body byte
    for byte), then 6,144 more new requests (the first 8 windows' dispatch
    ms), with block_best and quality_accum launched, and nobody in two
    matches across both apps."""
    import dataclasses
    import shutil
    import tempfile

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.utils import journal as jr

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    second = 8_192
    pop = Population(np, rng, waiting + requests + second + 7_168, t0,
                     filters=False, glicko2=False)
    res: dict = {}
    work = tempfile.mkdtemp(prefix="mm_journal_")
    jdir = os.path.join(work, "journal")
    reply = "dur.replies"
    queue = None
    try:
        # ---- 8a: the soak with durability off, then on --------------------
        for on in (False, True):
            cfg = durable_cfg(Config, path, journal_dir=jdir if on else None)
            queue = cfg.queues[0].name
            app = MatchmakingApp(cfg, device="cuda")
            await app.start()
            rt = app.runtime(queue)
            replies = Replies(app, reply)
            fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0,
                               reply)
            app.restore_columns(fill, pop.region[:waiting],
                                pop.mode[:waiting], t0)
            leg = {}
            if on:
                t = time.perf_counter()
                anchor = await rt.compact_journal()
                leg["compact_ms"] = (time.perf_counter() - t) * 1e3
                leg["snapshot_bytes"] = os.path.getsize(anchor["snapshot"])
                leg["snapshot_players"] = anchor["count"]
                if anchor["count"] != waiting:
                    raise AssertionError(f"8a: the anchor snapshotted "
                                         f"{anchor['count']} players")
            stats0 = dict(rt.journal_stats)
            windows0 = rt.counters["windows"]
            reset_counts(ck)
            soak_s, t_pub = await publish_and_wait(
                app, request_bodies(pop, waiting, waiting + requests), burst,
                reply, replies)
            await settle(app)
            windows = rt.counters["windows"] - windows0
            p50, p99 = latency_ms(replies, t_pub)
            leg.update({"requests_per_s": requests / soak_s, "soak_s": soak_s,
                        "latency_ms_p50": p50, "latency_ms_p99": p99,
                        "windows": windows,
                        "launches": dict(ck.LAUNCHES)})
            for pid in t_pub:
                if replies.statuses(pid) not in (["queued"], ["matched"],
                                                 ["queued", "matched"]):
                    raise AssertionError(f"8a: {pid} answered "
                                         f"{replies.statuses(pid)}")
            check_faults(app, "8a soak")
            if leg["launches"]["block_best"] != windows or leg["launches"][
                    "quality_accum"] != windows:
                raise AssertionError(f"8a: {leg['launches']} for {windows} "
                                     f"windows")
            if not on:
                await app.stop()
                res["off"] = leg
                continue
            stats = {k: rt.journal_stats[k] - stats0[k] for k in stats0}
            leg["journal_ms_per_window"] = {
                "admit_rows": stats["admit_rows_ms"] / windows,
                "admit_append_write": stats["admit_write_ms"] / windows,
                "terminals_append": stats["terminals_ms"] / windows,
                "commit_thread": stats["commit_thread_ms"] / windows,
                "commit_loop_wait": stats["commit_wait_ms"] / windows}
            leg["commits"] = stats["commits"]
            _, _, anchor_seq, kinds = journal_account(np, jdir, queue)
            _, recs, _, _ = jr.read_segment(jr.journal_path(jdir, queue))
            admits = sum(1 for s, t, _ in recs
                         if t == jr.RT_ADMIT and s > anchor_seq)
            if admits != windows or stats["admit_records"] != windows:
                raise AssertionError(f"8a: {admits} ADMIT records for "
                                     f"{windows} windows")
            leg["segment_bytes"] = os.path.getsize(jr.journal_path(jdir,
                                                                   queue))
            leg["records"] = kinds
            res["on"] = leg
            log(f"8a journal on: {leg['requests_per_s']:.0f} requests/s "
                f"(off {res['off']['requests_per_s']:.0f}), latency p50 "
                f"{p50:.2f} ms p99 {p99:.2f} ms (off "
                f"{res['off']['latency_ms_p50']:.2f}/"
                f"{res['off']['latency_ms_p99']:.2f}), anchor compaction "
                f"{leg['compact_ms']:.1f} ms, snapshot "
                f"{leg['snapshot_bytes']} bytes, journal ms a window "
                f"{leg['journal_ms_per_window']}")

            # ---- 8b: a second stream, crashed with windows in flight ------
            # The crash comes right after the 4th window of the stream is
            # dispatched and its ADMIT record written (so that window is in
            # flight and journaled): crash() (no awaits inside: driven to
            # its end here), then Crashed unwinds the dispatching task as
            # a kill -9 would stop it.
            rows = request_bodies(pop, waiting + requests,
                                  waiting + requests + second)
            state = {}
            real_admit = rt._journal_admit_cols

            def admit_then_crash(cols):
                real_admit(cols)
                state["windows"] = state.get("windows", 0) + 1
                if state["windows"] == 4:
                    state["in_flight"] = app.engine.inflight()
                    crash = app.crash()
                    try:
                        crash.send(None)
                    except StopIteration:
                        pass
                    raise Crashed()
            rt._journal_admit_cols = admit_then_crash
            sent = []
            for b in range(0, second, burst):
                for pid, body in rows[b:b + burst]:
                    sent.append((pid, body))
                    app.broker.publish(queue, body, Properties(
                        reply_to=reply, correlation_id=pid))
                await asyncio.sleep(0.004)
                if "in_flight" in state:
                    break
            crashed_at = state.get("in_flight")
            if not crashed_at:
                raise AssertionError(f"8b: no window in flight at the crash "
                                     f"({state})")
            flusher = rt._batcher._task
            await asyncio.sleep(0.01)
            if flusher.done() and not flusher.cancelled():
                flusher.exception()  # the Crashed it ended with, retrieved
            before = {pid: list(v) for pid, v in replies.got.items()}
            matched_before = replies.matched()
            del app, rt
            copy = os.path.join(work, "copy")
            shutil.copytree(jdir, copy)
            want_waiting, want_admitted, _, kinds = journal_account(
                np, jdir, queue)

            # The successor on the card.
            app2 = MatchmakingApp(durable_cfg(Config, path, journal_dir=jdir),
                                  device="cuda")
            t = time.perf_counter()
            await app2.start()
            start_ms = (time.perf_counter() - t) * 1e3
            recovery_events = event_rows(app2)
            t = time.perf_counter()
            torch.cuda.synchronize()
            drain_ms = (time.perf_counter() - t) * 1e3
            rt2 = app2.runtime(queue)
            rec = rt2.last_recovery
            if rec is None:
                raise AssertionError("8b: the successor did not recover")
            got_waiting = set(rt2.engine.pool._slot_of)
            if got_waiting != want_waiting:
                raise AssertionError(
                    f"8b: recovered {len(got_waiting)} waiting, the files "
                    f"say {len(want_waiting)} "
                    f"({len(got_waiting ^ want_waiting)} differ)")
            active = int(rt2.engine.dev_pool["active"].sum())
            if active != len(got_waiting) or not want_admitted <= got_waiting:
                raise AssertionError(f"8b: {active} active slots for "
                                     f"{len(got_waiting)} waiting")
            published_terminal = {p for p in matched_before}
            if published_terminal & got_waiting:
                raise AssertionError("8b: a player answered matched before "
                                     "the crash is waiting again")
            replies2 = Replies(app2, reply)
            dispatch_ms = []
            timed(rt2.engine, "search_columns_async", dispatch_ms)
            # 1,024 new requests: the first window after the recovery.
            reset_counts(ck)
            lo = waiting + requests + second
            fresh = request_bodies(pop, lo, lo + 1_024)
            await publish_and_wait(app2, fresh, 1_024, reply, replies2)
            first_pairs = window_pairs(replies2, [p for p, _ in fresh])
            # The redeliveries: every request of the second stream.
            expect = [pid for pid, _ in sent if pid not in got_waiting]
            for pid, body in sent:
                app2.broker.publish(queue, body, Properties(
                    reply_to=reply, correlation_id=pid))
            end = time.monotonic() + 120.0
            while (not all(p in replies2.got for p in expect)
                   and time.monotonic() < end):
                await asyncio.sleep(0.01)
            await settle(app2)
            if any(p not in replies2.got for p in expect):
                raise AssertionError("8b: redeliveries unanswered")
            # Six windows more of new requests: the first 8 windows'
            # dispatch ms after the recovery.
            more = request_bodies(pop, lo + 1_024, lo + 7_168)
            await publish_and_wait(app2, more, 1_024, reply, replies2)
            await settle(app2)
            launches = dict(ck.LAUNCHES)
            replays_checked = 0
            for pid, _ in sent:
                if pid not in matched_before:
                    continue
                first = [b for _, b in before[pid]
                         if json.loads(b)["status"] == "matched"][0]
                if replies2.got[pid][0][1] != first:
                    raise AssertionError(f"8b: {pid}'s replay differs")
                replays_checked += 1
            if not replays_checked:
                raise AssertionError("8b: no matched answer to replay")
            for pid, _ in sent:
                # A waiting player's copy enters nothing and gets no answer
                # of its own; an arrival may match the player (and a copy
                # that comes after that replays the match).
                bodies = {b for _, b in replies2.got.get(pid, ())}
                if pid in got_waiting and (
                        len(bodies) > 1 or set(replies2.statuses(pid))
                        - {"matched"}):
                    raise AssertionError(f"8b: waiting {pid} answered "
                                         f"{replies2.statuses(pid)}")
            both = {p: set(v) for p, v in matched_before.items()}
            for p, ids in replies2.matched().items():
                both.setdefault(p, set()).update(ids)
            twice = [p for p, ids in both.items() if len(ids) > 1]
            if twice:
                raise AssertionError(f"8b: {len(twice)} players in two "
                                     f"matches")
            if (launches["block_best"] == 0
                    or launches["quality_accum"] != launches["block_best"]):
                raise AssertionError(f"8b: {launches} on the recovered "
                                     f"service")
            check_faults(app2, "8b successor")
            # The recovery froze one incident bundle (crash_recovered).
            (rec_bundle,) = check_bundles(app2, "crash_recovery",
                                          "8b successor")
            await app2.stop()

            # The same recovery and first window on the CPU.
            cpu = MatchmakingApp(durable_cfg(Config, path, journal_dir=copy,
                                             warm=False), device="cpu")
            await cpu.start()
            cpu_events = event_rows(cpu)
            replies3 = Replies(cpu, reply)
            await publish_and_wait(cpu, fresh, 1_024, reply, replies3)
            cpu_pairs = window_pairs(replies3, [p for p, _ in fresh])
            cpu_rec = cpu.runtime(queue).last_recovery
            cpu_incidents = cpu.incidents.snapshot()["by_class"]
            await cpu.stop()
            if first_pairs != cpu_pairs or not first_pairs:
                raise AssertionError(
                    f"8b: the first window's pairs differ from the CPU "
                    f"app's ({len(first_pairs)} vs {len(cpu_pairs)})")
            if cpu_rec["transcript"] != rec["transcript"]:
                raise AssertionError("8b: the CPU app recovered another "
                                     "transcript")
            if cpu_incidents != app2.incidents.snapshot()["by_class"]:
                raise AssertionError(f"8b: incidents {cpu_incidents} on the "
                                     f"CPU app")
            if (recovery_events != cpu_events or "crash_recovered" not in
                    [k for _, k, _, _ in recovery_events]):
                raise AssertionError(f"8b: the recovery's events "
                                     f"{recovery_events}, the CPU app's "
                                     f"{cpu_events}")
            res["crash"] = {
                "in_flight_at_crash": crashed_at,
                "sent_before_crash": len(sent),
                "answered_matched_before_crash": len(matched_before),
                "records": kinds,
                "rto_ms": rec["rto_ms"], "attach_ms": rec["attach_ms"],
                "split_ms": rec["split_ms"], "start_ms": start_ms,
                "device_drain_after_start_ms": drain_ms,
                "snapshot_players": rec["snapshot_players"],
                "tail_players": rec["tail_players"],
                "removed_players": rec["removed_players"],
                "dedup_entries": rec["dedup_entries"],
                "recovered_waiting": len(got_waiting),
                "first_window_pairs": len(first_pairs),
                "replayed": rt2.counters["deduped_replays"],
                "replays_checked": replays_checked,
                "events": [k for _, k, _, _ in recovery_events],
                "incident_capture_ms": rec_bundle["capture_ms"],
                "launches": launches,
                "first_8_windows_dispatch_ms": [x * 1e3 for x in
                                                dispatch_ms[:8]]}
            log(f"8b crash with {crashed_at} windows in flight after "
                f"{len(sent)} of the second stream: recovered "
                f"{len(got_waiting)} waiting (= the files), rto "
                f"{rec['rto_ms']:.1f} ms (attach {rec['attach_ms']:.1f} ms, "
                f"{rec['split_ms']}), device drain {drain_ms:.1f} ms, "
                f"{rt2.counters['deduped_replays']} replays, first window "
                f"{len(first_pairs)} pairs = CPU app's, first 8 dispatch ms "
                f"{[round(x * 1e3, 3) for x in dispatch_ms[:8]]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


async def service_drain(np, torch, ck, mods, path, *, waiting, backlog, seed):
    """8c. Config #1's service with phase 6's overload settings and 100k
    waiting (tiered), a burst of 1,024 answered, then ``drain(dir)`` while
    ``backlog`` requests reach the broker after the consumer is cancelled
    (the handoff's unconsumed backlog). A successor runs
    ``restore_checkpoint(dir)``: the pool's columns (ids, rating, rd,
    threshold, enqueue time, tier, deadline) equal the predecessor's after
    the round trip, the backlog is re-published and answered on the card,
    and no credit is left held. Times the save and the restore, with the
    files' bytes."""
    import dataclasses
    import shutil
    import tempfile

    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.utils import checkpoint

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + 1_024 + backlog, t0, filters=False,
                     glicko2=False, deadline_frac=0.05)
    tiers = rng.choice(3, size=waiting, p=[0.25, 0.5, 0.25]).astype(np.int32)
    work = tempfile.mkdtemp(prefix="mm_drain_")
    reply = "drain.replies"
    cfg = durable_cfg(Config, path, journal_dir=None, overload=OVERLOAD)
    queue = cfg.queues[0].name

    def columns(eng):
        cols, _, _ = checkpoint.engine_waiting_columns(eng)
        order = np.argsort(cols.ids.astype(str))
        return {k: getattr(cols, k)[order] for k in (
            "ids", "rating", "rd", "threshold", "enqueued_at", "tier",
            "deadline")}

    try:
        app = MatchmakingApp(cfg, device="cuda")
        await app.start()
        rt = app.runtime(queue)
        replies = Replies(app, reply)
        fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply)
        app.restore_columns(dataclasses.replace(fill, tier=tiers),
                            pop.region[:waiting], pop.mode[:waiting], t0)
        reset_counts(ck)
        await publish_and_wait(app, request_bodies(pop, waiting,
                                                   waiting + 1_024),
                               1_024, reply, replies,
                               headers=lambda pid: {"x-tier": "1"})
        late = request_bodies(pop, waiting + 1_024, waiting + 1_024 + backlog)
        real_cancel = app.broker.basic_cancel

        def cancel(tag):
            real_cancel(tag)
            if tag == rt._tag:  # producers go on publishing
                for pid, body in late:
                    app.broker.publish(queue, body, Properties(
                        reply_to=reply, correlation_id=pid,
                        headers={"x-tier": "1"}))
        app.broker.basic_cancel = cancel
        t = time.perf_counter()
        counts = await app.drain(work)
        save_ms = (time.perf_counter() - t) * 1e3
        if rt.admission.inflight() != 0:
            raise AssertionError(f"8c: {rt.admission.inflight()} credits "
                                 f"held after the drain")
        check_faults(app, "8c predecessor")
        want = columns(app.engine)
        nbytes = {f: os.path.getsize(os.path.join(work, f))
                  for f in sorted(os.listdir(work))}
        with open(os.path.join(work, "_backlog.json")) as f:
            saved_backlog = json.load(f)["count"]
        if saved_backlog != backlog or counts[queue] != len(want["ids"]):
            raise AssertionError(f"8c: saved {counts}, backlog "
                                 f"{saved_backlog}")
        app.engine.close()
        del app, rt

        succ = MatchmakingApp(cfg, device="cuda")
        await succ.start()
        rt2 = succ.runtime(queue)
        replies2 = Replies(succ, reply)
        reset_counts(ck)
        t = time.perf_counter()
        restored = await succ.restore_checkpoint(work)
        restore_ms = (time.perf_counter() - t) * 1e3
        got = columns(succ.engine)  # before the backlog's windows land
        for k, v in want.items():
            same = (np.array_equal(v, got[k], equal_nan=True)
                    if v.dtype.kind == "f" else np.array_equal(v, got[k]))
            if not same:
                raise AssertionError(f"8c: column {k} differs after the "
                                     f"round trip")
        end = time.monotonic() + 60.0
        while (not all(p in replies2.got for p, _ in late)
               and time.monotonic() < end):
            await asyncio.sleep(0.01)
        if any(p not in replies2.got for p, _ in late):
            raise AssertionError("8c: the backlog was not answered")
        await settle(succ)
        launches = dict(ck.LAUNCHES)
        await succ.stop()
        check_faults(succ, "8c successor")
        if rt2.admission.inflight() != 0:
            raise AssertionError("8c: a credit held after the successor")
        if launches["block_best"] == 0 or launches["quality_accum"] == 0:
            raise AssertionError(f"8c: {launches} answering the backlog")
        statuses = {}
        for pid, _ in late:
            s = replies2.statuses(pid)[-1]
            statuses[s] = statuses.get(s, 0) + 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res = {"saved": counts[queue], "restored": restored[queue],
           "backlog": saved_backlog, "save_ms": save_ms,
           "restore_ms": restore_ms, "bytes": nbytes,
           "backlog_final_status": statuses, "launches": launches}
    log(f"8c drain: {counts[queue]} players + {saved_backlog} backlog saved "
        f"in {save_ms:.1f} ms ({nbytes}), restored in {restore_ms:.1f} ms, "
        f"columns equal, backlog answered {statuses}")
    return res


async def service_auth(np, ck, mods, path, *, waiting, requests, seed):
    """8d. Config #1's service with 100k waiting under auth ``rpc`` (an
    in-process responder on ``rpc_queue``, a 5 s timeout), ``static``, and
    ``none``, each
    taking ``requests`` (one in 8 with a bad token) in bursts of 512:
    the bad ones answered ``unauthorized``, the rest queued or matched on
    the card (block_best and quality_accum launched). Requests/s for each
    (rpc runs a task per delivery)."""
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=False)
    secret = "tok"
    res = {}
    for mode in ("rpc", "static", "none"):
        # A 5 s rpc timeout: the in-process responder, on the service's
        # own event loop, answers a burst of 512 round trips in series
        # (the default 250 ms timed some good tokens out as
        # auth_unavailable on one card machine).
        cfg = durable_cfg(Config, path, journal_dir=None,
                          auth={"mode": mode, "static_secret": secret,
                                "rpc_timeout_ms": 5_000.0})
        app = MatchmakingApp(cfg, device="cuda")
        await app.start()
        try:
            if mode == "rpc":
                broker = app.broker

                async def verify(d, broker=broker):
                    ok = d.body.startswith(secret.encode())
                    broker.publish(d.properties.reply_to,
                                   b"ok" if ok else b"denied",
                                   Properties(correlation_id=d.properties
                                              .correlation_id))
                    broker.ack(tag, d.delivery_tag)
                tag = broker.basic_consume(cfg.auth.rpc_queue, verify,
                                           prefetch=4096)
            reply = "auth.replies"
            replies = Replies(app, reply)
            fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0,
                               reply)
            app.restore_columns(fill, pop.region[:waiting],
                                pop.mode[:waiting], t0)
            rows = request_bodies(pop, waiting, waiting + requests)
            bad = {pid for j, (pid, _) in enumerate(rows) if j % 8 == 5}
            reset_counts(ck)
            soak_s, t_pub = await publish_and_wait(
                app, rows, 512, reply, replies,
                headers=lambda pid: {"authorization": (
                    "wrong" if pid in bad else f"{secret}-{pid}")})
            await settle(app)
            launches = dict(ck.LAUNCHES)
            check_faults(app, f"8d auth {mode}")
        finally:
            await app.stop()
        for pid, _ in rows:
            seq = replies.statuses(pid)
            if pid in bad and mode != "none":
                body = json.loads(replies.got[pid][0][1])
                if seq != ["error"] or "unauthorized" not in json.dumps(body):
                    raise AssertionError(f"8d {mode}: {pid} answered {seq}")
            elif seq not in (["queued"], ["matched"], ["queued", "matched"]):
                raise AssertionError(f"8d {mode}: {pid} answered {seq}")
        if launches["block_best"] == 0 or launches["quality_accum"] == 0:
            raise AssertionError(f"8d {mode}: {launches}")
        p50, p99 = latency_ms(replies, t_pub)
        res[mode] = {"requests_per_s": requests / soak_s,
                     "latency_ms_p50": p50, "latency_ms_p99": p99,
                     "unauthorized": len(bad) if mode != "none" else 0,
                     "launches": launches}
        log(f"8d auth {mode}: {requests} requests, "
            f"{res[mode]['requests_per_s']:.0f} requests/s, latency p50 "
            f"{p50:.2f} ms p99 {p99:.2f} ms")
    return res


# ---- phase 9: tracing ---------------------------------------------------------

#: The mark names of one 1v1 window: the engine's stamps, merged into every
#: member trace.
WINDOW_MARKS = re.compile(r"dispatch( h2d device_step)+ readback_seal collect")

#: Phase 7's event kinds, as the CPU run of its scenario logs them
#: (tests/test_torch_events.py holds the CPU app to this list): two
#: chaos-failed windows, the trip, the demotion, a failed and a passing
#: probe.
BREAKER_EVENTS = [
    "chaos_step_fault", "engine_crash", "engine_revive", "chaos_step_fault",
    "engine_crash", "breaker_trip", "degraded_revive", "engine_revive",
    "breaker_probe", "chaos_probe_fault", "probe_failed", "breaker_probe",
    "breaker_closed"]


def event_rows(app):
    """The event log without its clocks (a recovery's measured ms masked)."""
    return [(r["component"], r["kind"], r["queue"],
             re.sub(r"rto [0-9.]+ ms", "rto # ms", r["detail"]))
            for r in app.events.snapshot()]


async def service_trace_soak(np, ck, mods, path, *, waiting, requests, burst,
                             seed, mode, profile_to=None):
    """Config #1's service at full width with tracing ``mode``: "off",
    "on" (every request traced) or "sampled" (``trace_sample_n`` 16):
    ``waiting`` players restored, then ``requests`` published in bursts of
    ``burst``. Measures requests/s, latency p50/p99 (publish → first
    answer), GC ms, and the host ms of the flight recorder (its stage
    histograms) and of the attribution, each over the soak and a window.
    Checks: every window's marks are ``WINDOW_MARKS``; the traces settled
    are the requests answered (on), 1 in 16 of them (sampled), none (off);
    work + wait equals the enqueue→publish span for every trace; every
    request's own answer quotes its trace id exactly when it was traced;
    one block_best and one quality_accum launch per window; no fault."""
    import dataclasses

    from matchmaking_tpu_torch.config import ObservabilityConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.attribution import decompose_marks

    Config, _, RequestColumns, _ = mods
    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    sample_n = 16 if mode == "sampled" else 1
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        observability=ObservabilityConfig(trace=mode != "off",
                                          trace_sample_n=sample_n))
    if cfg.batcher.max_batch > max(cfg.engine.batch_buckets):
        raise AssertionError("trace soak: a window would take several chunks")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=cfg.queues[0].glicko2)
    app = MatchmakingApp(cfg, device="cuda")
    await app.start()
    queue = cfg.queues[0].name
    rt = app.runtime(queue)
    reply = "trace.replies"
    settled = []
    spent = {"recorder": 0.0, "attribution": 0.0}
    real_complete = app.recorder.complete
    real_observe = app.attribution.observe

    def observe(tr):
        t = time.perf_counter()
        real_observe(tr)
        spent["attribution"] += time.perf_counter() - t

    def complete(tr):
        t = time.perf_counter()
        real_complete(tr)
        spent["recorder"] += time.perf_counter() - t
        settled.append(tr)

    app.attribution.observe = observe
    app.recorder.complete = complete
    window_marks = []
    real_merge = rt._merge_window_marks

    def merge(tok, deliveries):
        marks = rt.engine.window_marks.get(tok)
        if marks:
            window_marks.append(" ".join(n for n, _ in marks))
        real_merge(tok, deliveries)

    rt._merge_window_marks = merge
    try:
        replies = Replies(app, reply)
        app.restore_columns(
            pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply),
            pop.region[:waiting], pop.mode[:waiting], t0)
        windows0 = rt.counters["windows"]
        reset_counts(ck)
        prof = None
        if profile_to:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        gc_clock = GcClock().__enter__()
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, waiting, waiting + requests), burst,
            reply, replies)
        gc_clock.__exit__()
        if prof is not None:
            import io
            import pstats

            prof.disable()
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(40)
            with open(profile_to, "w") as f:
                f.write(text.getvalue())
        await settle(app)
        windows = rt.counters["windows"] - windows0
        launches = dict(ck.LAUNCHES)
        p50, p99 = latency_ms(replies, t_pub)
        stages = app.metrics.report()["stage_seconds"].get(queue, {})
    finally:
        await app.stop()
    check_faults(app, f"trace soak ({mode})")
    bad = [m for m in window_marks if not WINDOW_MARKS.fullmatch(m)]
    if bad or len(window_marks) != windows:
        raise AssertionError(f"trace soak ({mode}): {len(window_marks)} "
                             f"windows' marks for {windows} windows, "
                             f"{len(bad)} not {WINDOW_MARKS.pattern}: "
                             f"{bad[:2]}")
    if (launches["block_best"] != windows
            or launches["quality_accum"] != windows):
        raise AssertionError(f"trace soak ({mode}): {launches} launches for "
                             f"{windows} windows")
    want = {"off": 0, "on": requests, "sampled": requests // sample_n}[mode]
    if abs(len(settled) - want) > (1 if mode == "sampled" else 0):
        raise AssertionError(f"trace soak ({mode}): {len(settled)} traces "
                             f"settled, want {want}")
    traced = {}
    for tr in settled:
        _, work, wait = decompose_marks(tr.marks)
        if abs(work + wait - tr.total_s) > 1e-9:
            raise AssertionError(f"trace soak ({mode}): {tr.trace_id} "
                                 f"work + wait != span")
        if tr.status not in ("matched", "queued"):
            raise AssertionError(f"trace soak ({mode}): {tr.trace_id} "
                                 f"settled {tr.status}")
        traced[tr.correlation_id] = tr.trace_id
    for pid in t_pub:
        got = json.loads(replies.got[pid][0][1]).get("trace_id", "")
        if got != traced.get(pid, ""):
            raise AssertionError(f"trace soak ({mode}): {pid} answered with "
                                 f"trace id {got!r}, traced "
                                 f"{traced.get(pid, '')!r}")
    res = {"mode": mode, "trace_sample_n": sample_n, "waiting": waiting,
           "requests": requests, "burst": burst, "windows": windows,
           "soak_s": soak_s, "requests_per_s": requests / soak_s,
           "latency_ms_p50": p50, "latency_ms_p99": p99,
           "gc_ms": gc_clock.total * 1e3, "traces_settled": len(settled),
           "recorder_ms": (spent["recorder"] - spent["attribution"]) * 1e3,
           "attribution_ms": spent["attribution"] * 1e3,
           "recorder_ms_per_window":
               (spent["recorder"] - spent["attribution"]) * 1e3
               / max(1, windows),
           "attribution_ms_per_window":
               spent["attribution"] * 1e3 / max(1, windows),
           "stage_counts": {k: v["count"] for k, v in stages.items()},
           "launches": launches}
    log(f"trace soak ({mode}): {requests} requests over {waiting} waiting, "
        f"{windows} windows, {res['requests_per_s']:.0f} requests/s, latency "
        f"p50 {p50:.2f} ms p99 {p99:.2f} ms, GC {res['gc_ms']:.1f} ms, "
        f"{len(settled)} traces settled, recorder "
        f"{res['recorder_ms']:.1f} ms ({res['recorder_ms_per_window']:.3f} a "
        f"window), attribution {res['attribution_ms']:.1f} ms "
        f"({res['attribution_ms_per_window']:.3f} a window)")
    return res


# ---- phase 10: telemetry, SLO burn, incidents, the HTTP surfaces ------------

#: Every route of the HTTP server but the profile's, fetched once at the
#: end of the soak (and by the CPU run, whose statuses they must equal).
OBS_ROUTES = ("/healthz", "/metrics", "/metrics?format=prom", "/debug/traces",
              "/debug/attribution", "/debug/quality", "/debug/placement",
              "/debug/autotune", "/debug/telemetry", "/debug/events",
              "/debug/incidents")

_PROM_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prom(text):
    """Prometheus exposition text to ({family: type}, [(name, labels,
    value)]), held to tests/test_observability.py's rules: one TYPE line
    per family, before its samples; well-formed samples and labels; no
    duplicate series; every value a number."""
    types, samples, seen = {}, [], set()
    if not text.endswith("\n"):
        raise AssertionError("prom: the text does not end with a newline")
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if (len(parts) != 4 or parts[2] in types or parts[2] in seen
                    or parts[3] not in ("counter", "gauge", "histogram",
                                        "summary", "untyped")):
                raise AssertionError(f"prom: bad TYPE line {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        if not m:
            raise AssertionError(f"prom: malformed sample {line!r}")
        name, blob, value = m.group(1), m.group(2) or "", m.group(3)
        labels = _PROM_LABEL.findall(blob)
        if ",".join(f'{k}="{v}"' for k, v in labels) != blob:
            raise AssertionError(f"prom: bad labels {line!r}")
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(
                    name[:-len(suffix)]) == "histogram":
                family = name[:-len(suffix)]
        if family not in types:
            raise AssertionError(f"prom: {name} has no TYPE line")
        seen.add(family)
        float(value)
        samples.append((name, tuple(sorted(labels)), value))
    keys = [(n, lb) for n, lb, _ in samples]
    if len(keys) != len(set(keys)):
        raise AssertionError("prom: a duplicate series")
    return types, samples


def free_port():
    """A port the OS had free (bound to port 0, then released)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def http_get(session, port, path):
    """(status, body, host ms) of one GET on this loop."""
    t = time.perf_counter()
    async with session.get(f"http://127.0.0.1:{port}{path}") as r:
        text = await r.text()
    return r.status, text, (time.perf_counter() - t) * 1e3


def check_bundles(app, cls, what, n=1):
    """``n`` bundles of trigger class ``cls`` in ``app``'s incident ring,
    each accepted by the port's ``validate_bundle``."""
    from matchmaking_tpu_torch.utils.forensics import validate_bundle

    snap = app.incidents.snapshot(include_bundles=True)
    bundles = [b for b in snap["bundles"] if b["trigger"]["class"] == cls]
    bad = [p for b in bundles for p in validate_bundle(b)]
    if len(bundles) != n or bad:
        raise AssertionError(f"{what}: {len(bundles)} {cls} bundles (want "
                             f"{n}), problems {bad}, by class "
                             f"{snap['by_class']}")
    return bundles


def observability_cfg(Config, path, on, port=0):
    """Config #1 with phase 10's observability: ``on`` the defaults
    (sampler at 1 s, tracing, capture) with ``metrics_port``, an SLO
    target of 100 ms and windows of 1 and 3 s; off, the sampler off and
    no server."""
    import dataclasses

    from matchmaking_tpu_torch.config import ObservabilityConfig

    cfg = Config.from_json(os.path.join(HERE, path), backend="gpu")
    obs = (ObservabilityConfig(slo_target_ms=100.0, slo_fast_window_s=1.0,
                               slo_slow_window_s=3.0) if on
           else ObservabilityConfig(snapshot_interval_s=0.0))
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, warm_start=True),
        observability=obs, metrics_port=port if on else 0)


async def cpu_route_statuses(np, Config, path, seed):
    """Phase 10's (b) configuration on the CPU at a small pool: 256
    requests served, then every route's status."""
    import dataclasses

    import aiohttp

    from matchmaking_tpu_torch.service.app import MatchmakingApp

    port = free_port()
    cfg = observability_cfg(Config, path, True, port)
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, pool_capacity=2048, pool_block=256,
        batch_buckets=(16, 64, 256), warm_start=False))
    rng = np.random.default_rng(seed)
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    try:
        replies = Replies(app, "cpu.obs.replies")
        rows = [(f"cpu{k}", json.dumps({"id": f"cpu{k}", "rating": float(
            rng.normal(1500, 300))}).encode()) for k in range(256)]
        await publish_and_wait(app, rows, 64, "cpu.obs.replies", replies)
        app.sample_telemetry()
        async with aiohttp.ClientSession() as session:
            out = {p: (await http_get(session, port, p))[0]
                   for p in OBS_ROUTES}
    finally:
        await app.stop()
    return out


class TimedProfile:
    """``torch.profiler.profile`` as ``/debug/profile`` builds it, with
    the hand kernels' launch counts taken at its start and stop and the
    host ms of its stop and export."""

    def __init__(self, ck, real):
        self.ck, self.real, self.runs = ck, real, []

    def __call__(self, *a, **k):
        prof, rec = self.real(*a, **k), {}
        self.runs.append(rec)
        start, stop, export = prof.start, prof.stop, prof.export_chrome_trace

        def on_start():
            t = time.perf_counter()
            start()
            rec["start_ms"] = (time.perf_counter() - t) * 1e3
            rec["launches_at_start"] = dict(self.ck.LAUNCHES)

        def on_stop():
            rec["launches_at_stop"] = dict(self.ck.LAUNCHES)
            rec["t_stop"] = time.perf_counter()
            stop()

        def on_export(path):
            export(path)
            rec["path"] = path
            rec["stop_export_ms"] = (time.perf_counter() - rec["t_stop"]) * 1e3

        prof.start, prof.stop, prof.export_chrome_trace = (on_start, on_stop,
                                                           on_export)
        return prof


def trace_kernel_counts(path):
    """Each hand kernel's device records in a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(1 for n in names if k in n) for k in OWN_KERNELS}


async def service_observability(np, ck, mods, path, *, waiting, requests,
                                burst, seed, on, cpu_statuses=None):
    """Config #1's service at full width: ``waiting`` restored, then
    ``requests`` in bursts of ``burst``, unpaced (phase 4's soak), (a) with
    the sampler off and no server, or (b) ``on``: the defaults (sampler at
    1 s, tracing, incident capture), ``metrics_port`` on a free port and
    an SLO target of 100 ms (objective 0.99, windows of 1 and 3 s). During
    (b) a client on the same loop fetches ``/metrics?format=prom`` and
    ``/healthz`` every 100 ms and ``/debug/profile?secs=1`` once after
    the first 4 windows, then every route once at the end. Checks: every
    request answered once; every Prometheus text valid; the pool gauge is
    the waiting count; each route's status the CPU run's; the queue burns
    (a /healthz lists it, a valid ``slo_burn`` bundle); the profile's
    trace names the three hand kernels (counted against the launches its
    capture saw); one block_best and one quality_accum launch a window;
    no fault. Measures requests/s, latency, the scrape's host ms split
    into ``build_report`` and ``_flatten_prom``, the Prometheus bytes, the
    tick's and the capture's host ms, the profile's ms."""
    import dataclasses
    import shutil
    import tempfile

    import aiohttp
    import torch.profiler

    from matchmaking_tpu_torch.service import observability
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    Config, _, RequestColumns, _ = mods
    port = free_port() if on else 0
    cfg = observability_cfg(Config, path, on, port)
    profile_dir = tempfile.mkdtemp(prefix="mm_smoke_profile_")
    cfg = dataclasses.replace(cfg, observability=dataclasses.replace(
        cfg.observability, profile_dir=profile_dir))
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=False)
    queue = cfg.queues[0].name
    spent = {"build_report": [], "flatten_prom": [], "tick": []}
    real_build, real_flatten = (observability.build_report,
                                observability._flatten_prom)

    def build_report(app_):
        t = time.perf_counter()
        try:
            return real_build(app_)
        finally:
            spent["build_report"].append((time.perf_counter() - t) * 1e3)

    def flatten_prom(report):
        t = time.perf_counter()
        try:
            return real_flatten(report)
        finally:
            spent["flatten_prom"].append((time.perf_counter() - t) * 1e3)

    timed_profile = TimedProfile(ck, torch.profiler.profile)
    observability.build_report, observability._flatten_prom = (build_report,
                                                               flatten_prom)
    torch.profiler.profile = timed_profile
    app = MatchmakingApp(cfg, device="cuda")
    real_tick = app.sample_telemetry

    def tick(now=None):
        t = time.perf_counter()
        try:
            return real_tick(now)
        finally:
            spent["tick"].append((time.perf_counter() - t) * 1e3)

    app.sample_telemetry = tick
    polls, routes, profile, pool_bounds, traced = [], {}, {}, (), {}
    try:
        await app.start()
        rt = app.runtime(queue)
        reply = "obs.replies"
        replies = Replies(app, reply)
        app.restore_columns(
            pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply),
            pop.region[:waiting], pop.mode[:waiting], t0)
        if on:
            # The soak starts at a tick: the next one (1 s later) falls
            # inside it, with settled traffic in both burn windows.
            while not len(app.telemetry):
                await asyncio.sleep(0.005)
        windows0 = rt.counters["windows"]
        reset_counts(ck)
        done = asyncio.Event()

        async def client():
            async with aiohttp.ClientSession() as session:
                async def poll():
                    while not done.is_set():
                        prom = await http_get(session, port,
                                              "/metrics?format=prom")
                        health = await http_get(session, port, "/healthz")
                        polls.append((prom, health))
                        await asyncio.sleep(0.1)

                async def take_profile():
                    while rt.counters["windows"] - windows0 < 4:
                        await asyncio.sleep(0.005)
                    profile["windows_at_request"] = (rt.counters["windows"]
                                                     - windows0)
                    profile["response"] = await http_get(
                        session, port, "/debug/profile?secs=1")

                await asyncio.gather(poll(), take_profile())

        poller = asyncio.create_task(client()) if on else None
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, waiting, waiting + requests), burst,
            reply, replies)
        await settle(app)
        if poller is not None:
            while "response" not in profile and not poller.done():
                await asyncio.sleep(0.01)
            done.set()
            await poller
            # Each hand kernel's records in the profile's Chrome trace.
            traced = {}
            for run in timed_profile.runs:
                traced = trace_kernel_counts(run["path"])
            app.sample_telemetry()
            async with aiohttp.ClientSession() as session:
                for p in OBS_ROUTES:
                    before = rt.engine.pool_size()
                    routes[p] = await http_get(session, port, p)
                    if p == "/metrics?format=prom":
                        pool_bounds = (before, rt.engine.pool_size())
                inc = await http_get(session, port,
                                     "/debug/incidents?bundles=1")
        windows = rt.counters["windows"] - windows0
        launches = dict(ck.LAUNCHES)
        p50, p99 = latency_ms(replies, t_pub)
        capture = app.metrics.latency.get("incident_capture")
    finally:
        observability.build_report, observability._flatten_prom = (
            real_build, real_flatten)
        torch.profiler.profile = timed_profile.real
        shutil.rmtree(profile_dir, ignore_errors=True)
        await app.stop()
    mode = "on" if on else "off"
    check_faults(app, f"observability soak ({mode})")
    for pid in t_pub:
        seq = replies.statuses(pid)
        if seq not in (["queued"], ["matched"], ["queued", "matched"]):
            raise AssertionError(f"observability soak ({mode}): {pid} "
                                 f"answered {seq}")
    if (launches["block_best"] != windows
            or launches["quality_accum"] != windows):
        raise AssertionError(f"observability soak ({mode}): {launches} "
                             f"launches for {windows} windows")
    res = {"mode": mode, "waiting": waiting, "requests": requests,
           "burst": burst, "windows": windows, "soak_s": soak_s,
           "requests_per_s": requests / soak_s, "latency_ms_p50": p50,
           "latency_ms_p99": p99, "launches": launches}
    if not on:
        if len(app.telemetry) or app._observability is not None:
            raise AssertionError("observability soak (off): the sampler or "
                                 "the server ran")
        log(f"observability soak (off): {requests} requests over {waiting} "
            f"waiting, {windows} windows, {res['requests_per_s']:.0f} "
            f"requests/s, latency p50 {p50:.2f} ms p99 {p99:.2f} ms")
        return res
    burning = False
    prom_bytes = []
    for (pstat, ptext, _), (hstat, htext, _) in polls:
        if pstat != 200 or hstat != 200:
            raise AssertionError(f"observability soak: a poll answered "
                                 f"{pstat} / {hstat}")
        _, samples = parse_prom(ptext)
        prom_bytes.append(len(ptext.encode()))
        if len([n for n, _, _ in samples
                if n == "matchmaking_pool_size"]) != 1:
            raise AssertionError("observability soak: no pool gauge")
        burning |= queue in json.loads(htext)["slo_burning_queues"]
    # The pool gauge of the last scrape is the waiting count (read just
    # before and after the scrape: a rescan tick may fall between).
    _, samples = parse_prom(routes["/metrics?format=prom"][1])
    (gauge,) = [float(v) for n, _, v in samples
                if n == "matchmaking_pool_size"]
    if not min(pool_bounds) <= gauge <= max(pool_bounds):
        raise AssertionError(f"observability soak: the pool gauge {gauge} "
                             f"is not the waiting count {pool_bounds}")
    statuses = {p: r[0] for p, r in routes.items()}
    if cpu_statuses is not None and statuses != cpu_statuses:
        raise AssertionError(f"observability soak: route statuses "
                             f"{statuses}, the CPU run's {cpu_statuses}")
    if not burning:
        raise AssertionError("observability soak: no /healthz listed the "
                             "queue as burning")
    bundles = [b for b in json.loads(inc[1])["bundles"]
               if b["trigger"]["class"] == "slo_burn"]
    check_bundles(app, "slo_burn", "observability soak", n=len(bundles))
    if not bundles:
        raise AssertionError("observability soak: no slo_burn bundle")
    status, text, profile_ms = profile["response"]
    if status != 200 or sorted(json.loads(text)) != ["secs", "trace_dir",
                                                     "viewer"]:
        raise AssertionError(f"observability soak: /debug/profile {status} "
                             f"{text}")
    (run,) = timed_profile.runs
    in_capture = {k: run["launches_at_stop"][k] - run["launches_at_start"][k]
                  for k in ("block_best", "quality_accum")}
    if not traced or not all(traced.values()):
        raise AssertionError(f"observability soak: the profile's trace "
                             f"counted {traced}")
    scrape = {k: {"p50": pct(v, 0.5), "p99": pct(v, 0.99), "n": len(v)}
              for k, v in spent.items()}
    res.update({
        "polls": len(polls), "prom_bytes_max": max(prom_bytes),
        "prom_bytes_last": prom_bytes[-1], "scrape_host_ms": scrape,
        "incident_capture_ms": capture.summary_ms() if capture else None,
        "incidents": app.incidents.snapshot()["by_class"],
        "slo_events": [e["kind"] for e in app.events.snapshot()
                       if e["kind"].startswith("slo_")],
        "route_statuses": statuses,
        "profile": {"request_ms": profile_ms, "start_ms": run["start_ms"],
                    "stop_export_ms": run["stop_export_ms"],
                    "windows_at_request": profile["windows_at_request"],
                    "launches_in_capture": in_capture,
                    "trace_kernels": traced},
        "telemetry_snapshots": len(app.telemetry)})
    log(f"observability soak (on): {requests} requests over {waiting} "
        f"waiting, {windows} windows, {res['requests_per_s']:.0f} "
        f"requests/s, latency p50 {p50:.2f} ms p99 {p99:.2f} ms; {len(polls)} "
        f"polls, scrape host ms build_report p50 "
        f"{scrape['build_report']['p50']:.3f} p99 "
        f"{scrape['build_report']['p99']:.3f}, _flatten_prom p50 "
        f"{scrape['flatten_prom']['p50']:.3f} p99 "
        f"{scrape['flatten_prom']['p99']:.3f}, prom {prom_bytes[-1]} bytes; "
        f"tick p50 {scrape['tick']['p50']:.3f} ms p99 "
        f"{scrape['tick']['p99']:.3f} ms ({scrape['tick']['n']} ticks); "
        f"capture {res['incident_capture_ms']}; incidents "
        f"{res['incidents']}; profile {profile_ms:.1f} ms (start "
        f"{run['start_ms']:.1f} ms, stop + export "
        f"{run['stop_export_ms']:.1f} ms), launches in the capture "
        f"{in_capture}, trace kernels {traced}")
    return res


# ---- phase 11: resilience: broker chaos, replication, failover --------------

#: 11a's broker chaos (the request queue only): seeded 1 % drops and
#: duplicates, seq 0's first attempt dropped, seq 1 delivered 1 + 8 times,
#: a partition from publish seq 4,096 to 4,608.
RESILIENCE_CHAOS = dict(seed=7, drop_prob=0.01, dup_prob=0.01, drop_seqs=(0,),
                        dup_seqs=((1, 8),), partitions=((4096, 4608),))
#: The replication hub's lease (s) and the primary's pump cadence.
LEASE_S, PUMP_S = 0.5, 0.02
FAULT_STATS = ("dropped", "duplicated", "delayed", "partitions",
               "dead_lettered")
FAULT_KINDS = ("chaos_drop", "chaos_dup", "partition_pause",
               "partition_resume", "dead_letter")


def resilience_cfg(Config, path, *, journal_dir=None, chaos=None,
                   consume_batch=True, replication=False, owner="primary"):
    """Config #1 with phase 11's knobs: the journal with fsync "none"
    (the disk stays out of it), ``chaos`` on the request queue with
    ``debug_invariants``, replication as primary ``owner``."""
    import dataclasses

    from matchmaking_tpu_torch.config import ChaosConfig, ReplicationConfig

    cfg = durable_cfg(Config, path, journal_dir=journal_dir, fsync="none")
    queue = cfg.queues[0].name
    return dataclasses.replace(
        cfg, broker=dataclasses.replace(cfg.broker, consume_batch=consume_batch),
        chaos=(ChaosConfig(queues=(queue,), **chaos) if chaos
               else ChaosConfig()),
        debug_invariants=chaos is not None,
        replication=(ReplicationConfig(role="primary", owner=owner,
                                       pump_interval_s=PUMP_S)
                     if replication else ReplicationConfig()))


def check_answers(replies, pids, what):
    """Every request answered (queued and/or matched), and nobody in two
    matches."""
    for pid in pids:
        if set(replies.statuses(pid)) - {"queued", "matched"} or not (
                replies.statuses(pid)):
            raise AssertionError(f"{what}: {pid} answered "
                                 f"{replies.statuses(pid)}")
    twice = [p for p, ids in replies.matched().items() if len(ids) > 1]
    if twice:
        raise AssertionError(f"{what}: {len(twice)} players in two matches")


async def service_chaos(np, ck, mods, path, *, waiting, requests, burst,
                        seed):
    """11a. Config #1's service at full width, ``waiting`` restored, then
    ``requests`` in bursts of ``burst``: twice with ``RESILIENCE_CHAOS``
    and ``debug_invariants`` (the fault stats and fault events of both
    runs equal, no invariant violated, every request answered, nothing
    dead-lettered), then without chaos on the burst path and on the
    per-delivery path (``consume_batch`` off: the path consume faults
    force). Requests/s and latency p50/p99 of each."""
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    pop = Population(np, rng, waiting + requests, t0, filters=False,
                     glicko2=False)
    reply = "chaos.replies"
    runs = {}
    for name, chaos, batch in (("chaos_1", RESILIENCE_CHAOS, True),
                               ("chaos_2", RESILIENCE_CHAOS, True),
                               ("off", None, True),
                               ("off_per_delivery", None, False)):
        cfg = resilience_cfg(Config, path, chaos=chaos, consume_batch=batch)
        app = MatchmakingApp(cfg, device="cuda")
        await app.start()
        replies = Replies(app, reply)
        fill = pop.columns(RequestColumns, app.engine, 0, waiting, t0, reply)
        app.restore_columns(fill, pop.region[:waiting], pop.mode[:waiting], t0)
        rt = app.runtime(cfg.queues[0].name)
        reset_counts(ck)
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, waiting, waiting + requests), burst,
            reply, replies)
        await settle(app)
        launches = dict(ck.LAUNCHES)
        p50, p99 = latency_ms(replies, t_pub)
        check_answers(replies, t_pub, f"11a {name}")
        check_faults(app, f"11a {name}")
        stats = app.broker.stats
        kinds = [e["kind"] for e in app.events.snapshot()]
        runs[name] = {
            "requests_per_s": requests / soak_s, "soak_s": soak_s,
            "latency_ms_p50": p50, "latency_ms_p99": p99,
            "windows": rt.counters["windows"],
            "deduped_replays": rt.counters["deduped_replays"],
            "fault_stats": {k: stats[k] for k in FAULT_STATS},
            "fault_events": {k: kinds.count(k) for k in FAULT_KINDS},
            "launches": launches}
        await app.stop()
        if launches["block_best"] == 0 or (launches["quality_accum"]
                                           != launches["block_best"]):
            raise AssertionError(f"11a {name}: launches {launches}")
    a, b = runs["chaos_1"], runs["chaos_2"]
    if (a["fault_stats"] != b["fault_stats"]
            or a["fault_events"] != b["fault_events"]):
        raise AssertionError(f"11a: the chaos runs differ: {a['fault_stats']} "
                             f"{a['fault_events']} vs {b['fault_stats']} "
                             f"{b['fault_events']}")
    fs = a["fault_stats"]
    if (fs["dead_lettered"] or fs["partitions"] != 1 or fs["dropped"] < 1
            or fs["duplicated"] < 8):
        raise AssertionError(f"11a: fault stats {fs}")
    log("11a broker chaos: " + ", ".join(
        f"{n} {r['requests_per_s']:.0f} requests/s p50 "
        f"{r['latency_ms_p50']:.2f} ms p99 {r['latency_ms_p99']:.2f} ms"
        for n, r in runs.items()) + f"; faults {fs}, events "
        f"{a['fault_events']} (equal in both chaos runs)")
    return runs


class StandbyPump:
    """A standby pumped every ``interval`` s on the loop, beside the
    primary's own pump task: the lag in records at each pump, the tap's,
    the primary pump's and the standby's apply host time (their calls
    wrapped; the in-process standby applies on the service's own loop),
    and, while a link partition holds, the lag and
    ``unacked_admit_players``."""

    def __init__(self, rt, standby, interval=PUMP_S, track_unacked=False):
        self.rt, self.standby = rt, standby
        self.lags, self.partition_lags = [], []
        self.tap_s = self.pump_s = self.apply_s = 0.0
        self.taps = self.pumps = 0
        self.peak_unacked = 0
        self.track_unacked = track_unacked
        real_tap, repl = rt.journal.tap, rt.replication
        real_pump = repl.pump

        def tap(seq, rtype, payload):
            t = time.perf_counter()
            real_tap(seq, rtype, payload)
            self.tap_s += time.perf_counter() - t
            self.taps += 1

        def pump(now):
            t = time.perf_counter()
            real_pump(now)
            self.pump_s += time.perf_counter() - t
            self.pumps += 1
        rt.journal.tap, repl.pump = tap, pump
        self.task = asyncio.ensure_future(self._run(interval))

    async def _run(self, interval):
        repl = self.rt.replication
        while True:
            await asyncio.sleep(interval)
            t = time.perf_counter()
            self.standby.pump()
            self.apply_s += time.perf_counter() - t
            self.lags.append(repl.lag())
            if self.standby.link._partitioned:
                self.partition_lags.append(repl.lag())
                if self.track_unacked:
                    self.peak_unacked = max(self.peak_unacked,
                                            repl.unacked_admit_players())

    async def quiesce(self, timeout=60.0):
        end = time.monotonic() + timeout
        while not self.rt.replication.quiescent:
            if time.monotonic() > end:
                raise AssertionError("replication did not quiesce")
            await asyncio.sleep(0.01)

    def stop(self):
        self.task.cancel()

    def summary(self):
        lags = sorted(self.lags) or [0]
        return {"lag_records_p50": statistics.median(lags),
                "lag_records_p99": pct(lags, 0.99),
                "lag_records_max": lags[-1], "pumps_seen": len(self.lags),
                "tap_us_per_record": self.tap_s / max(1, self.taps) * 1e6,
                "records": self.taps,
                "pump_ms": self.pump_s / max(1, self.pumps) * 1e3,
                "primary_pumps": self.pumps,
                "standby_apply_ms_total": self.apply_s * 1e3}


def check_replication(app, rt, standby, what):
    """The shadow is the pool, and nothing on the replication path failed
    (a tap or a send that raised, a pump error)."""
    errors = (rt.journal.tap_errors, rt.replication.send_errors,
              rt.counters["replication_pump_errors"])
    if any(errors):
        raise AssertionError(f"{what}: tap/send/pump errors {errors}")
    pool = set(rt.engine.pool._slot_of)
    shadow = set(standby.shadow.waiting)
    if pool != shadow:
        raise AssertionError(f"{what}: the shadow differs from the pool in "
                             f"{len(pool ^ shadow)} players")
    if standby.applied_seq != rt.journal.seq:
        raise AssertionError(f"{what}: applied {standby.applied_seq}, "
                             f"journal at {rt.journal.seq}")
    check_faults(app, what)


async def service_replication(np, torch, ck, mods, path, *, waiting,
                              requests, burst, seed):
    """11b-11d. Config #1's service at full width with the journal on
    (fsync "none"). The 100k waiting come from a journal: one app restores
    and anchors them, then crashes; each leg recovers a copy of that
    directory at its start. 11b: replication off and on in turns, two
    rounds each (on: an in-process hub, a standby pumped every
    ``PUMP_S``): requests/s and latency of ``requests`` in bursts of
    ``burst``; on: the lag in records (p50/p99 over the pumps), the tap's
    host µs a record, a pump's host ms, the baseline's bytes and host ms
    at 100k waiting, and the shadow equal to the pool. 11c, on the last
    on leg: a second stream crashed after its 4th window; the standby
    takes over at a scripted time; a successor on the card adopts the
    shadow (RTO and its split); the adopted pool is the shadow's and the
    primary's mirror at the crash; the fenced ex-primary's append raises
    and its publish is refused and counted; matched players' redeliveries
    replay their bodies; 1,024 new requests under torch.profiler launch
    block_best and quality_accum (the device's count equals the launch
    count); nobody is matched by both apps. 11d: a soak of 8,192 with
    ``repl_*`` link faults (a drop, a duplicate, a delay, one partition)
    relative to the baseline's seq: the lag during the partition, the
    peak ``unacked_admit_players``, and the shadow equal to the pool
    after the heal."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from matchmaking_tpu_torch.config import ChaosConfig
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.replication import ReplicationHub
    from matchmaking_tpu_torch.utils.journal import FencedError

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    second, fresh_n, faults_n = 8_192, 1_024, 8_192
    pop = Population(np, rng, waiting + requests + second + fresh_n
                     + 512 + faults_n, t0, filters=False, glicko2=False)
    work = tempfile.mkdtemp(prefix="mm_repl_")
    seed_dir = os.path.join(work, "seed")
    reply = "repl.replies"
    res: dict = {"legs": []}
    try:
        # The 100k in a journal: restored, anchored, crashed.
        cfg0 = resilience_cfg(Config, path, journal_dir=seed_dir)
        queue = cfg0.queues[0].name
        app0 = MatchmakingApp(cfg0, device="cuda")
        await app0.start()
        fill = pop.columns(RequestColumns, app0.engine, 0, waiting, t0, reply)
        app0.restore_columns(fill, pop.region[:waiting], pop.mode[:waiting],
                             t0)
        await app0.runtime(queue).compact_journal()
        await app0.crash()
        del app0

        def leg_app(name, on, hub=None, owner="hostA"):
            jdir = os.path.join(work, name)
            if os.path.exists(seed_dir) and name.startswith("leg"):
                shutil.copytree(seed_dir, jdir)
            return MatchmakingApp(
                resilience_cfg(Config, path, journal_dir=jdir, replication=on,
                               owner=owner),
                device="cuda", replication_hub=hub)

        # ---- 11b: off and on in turns ---------------------------------
        keep = None
        for i, on in enumerate((False, True, False, True)):
            hub = ReplicationHub(lease_s=LEASE_S) if on else None
            app = leg_app(f"leg{i}", on, hub)
            t = time.perf_counter()
            await app.start()
            start_ms = (time.perf_counter() - t) * 1e3
            rt = app.runtime(queue)
            rec = rt.last_recovery
            if rec is None or rec["snapshot_players"] != waiting:
                raise AssertionError(f"11b leg {i}: recovered {rec}")
            meter = standby = None
            baseline_apply_ms = None
            if on:
                standby = hub.standby(queue, owner="hostB")
                # The baseline applied before the soak (a standby that
                # attached before the traffic).
                t = time.perf_counter()
                standby.pump()
                baseline_apply_ms = (time.perf_counter() - t) * 1e3
                meter = StandbyPump(rt, standby)
            replies = Replies(app, reply)
            reset_counts(ck)
            soak_s, t_pub = await publish_and_wait(
                app, request_bodies(pop, waiting, waiting + requests), burst,
                reply, replies)
            await settle(app)
            launches = dict(ck.LAUNCHES)
            p50, p99 = latency_ms(replies, t_pub)
            check_answers(replies, t_pub, f"11b leg {i}")
            leg = {"replication": on, "requests_per_s": requests / soak_s,
                   "latency_ms_p50": p50, "latency_ms_p99": p99,
                   "start_ms": start_ms, "recovery_rto_ms": rec["rto_ms"],
                   "windows": rt.counters["windows"], "launches": launches}
            if on:
                await meter.quiesce()
                standby.pump()
                check_replication(app, rt, standby, f"11b leg {i}")
                leg.update(meter.summary())
                leg["baseline"] = dict(rt.last_baseline,
                                       standby_apply_ms=baseline_apply_ms)
                if rt.last_baseline["players"] != waiting:
                    raise AssertionError(f"11b: baseline {rt.last_baseline}")
            else:
                check_faults(app, f"11b leg {i}")
            res["legs"].append(leg)
            if i < 3:
                if meter is not None:
                    meter.stop()
                await app.stop()
                if on:
                    standby.pump()
                    if not standby.shadow.clean:
                        raise AssertionError("11b: no CLEAN on the stream")
            else:
                keep = (app, rt, hub, standby, meter, replies)
        offs = [leg for leg in res["legs"] if not leg["replication"]]
        ons = [leg for leg in res["legs"] if leg["replication"]]
        log("11b replication off/on in turns: " + ", ".join(
            f"{'on' if leg['replication'] else 'off'} "
            f"{leg['requests_per_s']:.0f}/s p50 {leg['latency_ms_p50']:.2f} "
            f"p99 {leg['latency_ms_p99']:.2f} ms" for leg in res["legs"])
            + f"; lag p50/p99 {[(o['lag_records_p50'], o['lag_records_p99']) for o in ons]} "
            f"records, tap {[round(o['tap_us_per_record'], 2) for o in ons]} "
            f"µs a record, pump {[round(o['pump_ms'], 4) for o in ons]} ms, "
            f"standby apply {[round(o['standby_apply_ms_total'], 1) for o in ons]} "
            f"ms a soak (on the service's loop), "
            f"baseline {ons[0]['baseline']}")
        del offs

        # ---- 11c: failover ----------------------------------------------
        app, rt, hub, standby, meter, replies = keep
        lo = waiting + requests
        rows = request_bodies(pop, lo, lo + second)
        state: dict = {}
        real_admit = rt._journal_admit_cols

        def admit_then_crash(cols):
            real_admit(cols)
            state["windows"] = state.get("windows", 0) + 1
            if state["windows"] == 4:
                state["in_flight"] = app.engine.inflight()
                state["mirror"] = set(rt.engine.pool._slot_of)
                crash = app.crash()
                try:
                    crash.send(None)
                except StopIteration:
                    pass
                raise Crashed()
        rt._journal_admit_cols = admit_then_crash
        sent = []
        from matchmaking_tpu_torch.service.broker import Properties
        for b in range(0, second, burst):
            for pid, body in rows[b:b + burst]:
                sent.append((pid, body))
                app.broker.publish(queue, body, Properties(
                    reply_to=reply, correlation_id=pid))
            await asyncio.sleep(0.004)
            if "in_flight" in state:
                break
        if not state.get("in_flight"):
            raise AssertionError(f"11c: no window in flight at the crash "
                                 f"({state})")
        flusher = rt._batcher._task
        await asyncio.sleep(0.01)
        if flusher.done() and not flusher.cancelled():
            flusher.exception()  # the Crashed it ended with, retrieved
        meter.stop()
        matched_before = replies.matched()
        answered_before = sum(len(v) for v in replies.got.values())
        t = time.perf_counter()
        epoch = standby.takeover(time.monotonic() + LEASE_S + 0.05)
        takeover_ms = (time.perf_counter() - t) * 1e3
        shadow = set(standby.shadow.waiting)
        if epoch != 2 or not rt.replication.superseded():
            raise AssertionError(f"11c: epoch {epoch}")
        try:
            rt.journal.append_admits([["zz", 1500.0, 350.0, "*", "*", None,
                                       t0, reply, "zz", 0, 0.0]])
            raise AssertionError("11c: the fenced primary appended")
        except FencedError:
            pass
        rt._publish(reply, "zz", b"{}")
        refused = rt.counters["fenced_publish_refused"]
        if (refused != 1 or rt.replication.role != "fenced"
                or sum(len(v) for v in replies.got.values())
                != answered_before):
            raise AssertionError(f"11c: the fenced primary published "
                                 f"({refused} refused)")
        if shadow != state["mirror"] or shadow & set(matched_before):
            raise AssertionError(
                f"11c: the shadow ({len(shadow)}) differs from the mirror at "
                f"the crash ({len(state['mirror'])}) in "
                f"{len(shadow ^ state['mirror'])} players")
        app2 = leg_app("successor", True, hub, owner="hostB")
        t = time.perf_counter()
        await app2.start()
        start2_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        torch.cuda.synchronize()
        drain_ms = (time.perf_counter() - t) * 1e3
        rt2 = app2.runtime(queue)
        rec = rt2.last_recovery
        adopted = set(rt2.engine.pool._slot_of)
        active = int(rt2.engine.dev_pool["active"].sum())
        if (rec is None or rec.get("source") != "replica" or adopted != shadow
                or active != len(adopted)):
            raise AssertionError(f"11c: adopted {len(adopted)} ({active} "
                                 f"active), shadow {len(shadow)}, {rec}")
        replies2 = Replies(app2, reply)
        # The matched players' redeliveries replay their bodies.
        again = [(pid, body) for pid, body in sent if pid in matched_before]
        again = again[:512]
        for pid, body in again:
            app2.broker.publish(queue, body, Properties(reply_to=reply,
                                                        correlation_id=pid))
        end = time.monotonic() + 60.0
        while (not all(p in replies2.got for p, _ in again)
               and time.monotonic() < end):
            await asyncio.sleep(0.01)
        for pid, _ in again:
            first = [bd for _, bd in replies.got[pid]
                     if json.loads(bd)["status"] == "matched"][0]
            if replies2.got.get(pid, [(0, b"")])[0][1] != first:
                raise AssertionError(f"11c: {pid}'s replay differs")
        await settle(app2)
        # 1,024 new requests on the successor, under the profiler.
        lo2 = lo + second
        fresh = request_bodies(pop, lo2, lo2 + fresh_n)
        reset_counts(ck)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            await publish_and_wait(app2, fresh, fresh_n, reply, replies2)
            await settle(app2)
            torch.cuda.synchronize()
        launches2 = dict(ck.LAUNCHES)
        own = {name: 0 for name in OWN_KERNELS}
        for e in prof.key_averages():
            for name in OWN_KERNELS:
                if name in e.key:
                    own[name] += e.count
        if (launches2["block_best"] == 0
                or launches2["quality_accum"] != launches2["block_best"]
                or own["block_best_kernel"] != launches2["block_best"]
                or own["quality_accum_kernel"] != launches2["quality_accum"]):
            raise AssertionError(f"11c: successor launches {launches2}, the "
                                 f"device ran {own}")
        check_answers(replies2, [p for p, _ in fresh], "11c successor")
        both = {p: set(v) for p, v in matched_before.items()}
        for p, ids in replies2.matched().items():
            both.setdefault(p, set()).update(ids)
        twice = [p for p, ids in both.items() if len(ids) > 1]
        if twice:
            raise AssertionError(f"11c: {len(twice)} players matched by both "
                                 f"apps")
        check_faults(app2, "11c successor")
        (bundle,) = check_bundles(app2, "failover", "11c successor")
        await app2.stop()
        res["failover"] = {
            "in_flight_at_crash": state["in_flight"],
            "sent_before_crash": len(sent),
            "matched_before_crash": len(matched_before),
            "takeover_ms": takeover_ms, "epoch": epoch,
            "shadow_players": len(shadow), "adopted_players": len(adopted),
            "rto_ms": rec["rto_ms"], "split_ms": rec["split_ms"],
            "successor_start_ms": start2_ms,
            "device_drain_after_start_ms": drain_ms,
            "dedup_entries": rec["dedup_entries"],
            "replays_checked": len(again),
            "fenced_publish_refused": refused,
            "incident_capture_ms": bundle["capture_ms"],
            "launches": launches2, "device_kernels": own}
        log(f"11c failover: crash with {state['in_flight']} windows in "
            f"flight; takeover {takeover_ms:.2f} ms (epoch {epoch}); the "
            f"successor adopted {len(adopted)} (= the shadow = the mirror), "
            f"rto {rec['rto_ms']:.1f} ms {rec['split_ms']}, {len(again)} "
            f"replays equal, fenced publish refused, successor launches "
            f"{launches2} = device {own}")

        # ---- 11d: link faults ---------------------------------------------
        base = ons[0]["baseline"]["seq"]
        script = ChaosConfig(
            queues=(queue,), repl_drop_seqs=(base + 3,),
            repl_dup_seqs=(base + 5,), repl_delay_seqs=((base + 7, 2),),
            repl_partitions=((base + 8, base + 16),))
        hub = ReplicationHub(lease_s=LEASE_S, chaos=script)
        app = leg_app("leg_faults", True, hub)
        await app.start()
        rt = app.runtime(queue)
        if rt.last_baseline["seq"] != base:
            raise AssertionError(f"11d: baseline seq {rt.last_baseline}, "
                                 f"11b's {base}")
        standby = hub.standby(queue, owner="hostB")
        standby.pump()  # the baseline, before the traffic
        meter = StandbyPump(rt, standby, track_unacked=True)
        replies = Replies(app, reply)
        lo3 = lo2 + fresh_n + 512
        reset_counts(ck)
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, lo3, lo3 + faults_n), burst, reply,
            replies)
        await settle(app)
        launches3 = dict(ck.LAUNCHES)
        check_answers(replies, t_pub, "11d")
        await meter.quiesce()
        standby.pump()
        meter.stop()
        check_replication(app, rt, standby, "11d")
        link = dict(standby.link.counters)
        if not (link.get("dropped") and link.get("dup") and link.get("delayed")
                and link.get("partitions") == 1 and link.get("retransmits")):
            raise AssertionError(f"11d: link counters {link}")
        plags = sorted(meter.partition_lags) or [0]
        res["link_faults"] = {
            "requests_per_s": faults_n / soak_s, "link": link,
            "partition_lag_records_max": plags[-1],
            "partition_lag_records_p50": statistics.median(plags),
            "peak_unacked_admit_players": meter.peak_unacked,
            "applier": dict(standby.counters), "launches": launches3,
            **{k: v for k, v in meter.summary().items()
               if k.startswith("lag_")}}
        await app.stop()
        log(f"11d link faults: {link}; lag during the partition up to "
            f"{plags[-1]} records, peak unacked_admit_players "
            f"{meter.peak_unacked}; the shadow converged to the pool")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


# ---- phase 12: the socket transport under replication and the lease ---------

#: Phase 12's lease (s): a renewal is confirmed every pump (20 ms), so only
#: a stall of the primary's loop longer than the budgeted lease (lease_s -
#: lease_rtt_budget_s) fences it. The stalls phase 11 measured: the 100k
#: baseline, 223-412 ms; an adoption, 1.6-1.9 s (before the successor's
#: acquire, so not inside a lease).
NET_LEASE_S = 3.0
#: Phase 12's frame and send buffer limits, on both sides: the 100k
#: baseline's frame is ~13 MB (9.6 MB of JSON in base64), past the
#: defaults (1 MiB a frame, 4 MiB of send buffer), which drop it.
NET_LIMITS = dict(max_frame_bytes=32 << 20, send_buffer_bytes=32 << 20)
#: Runs of 12c's soak (JAX's geometry: pool 4,096, 3 cycles, 6 pairs + 3
#: singles + 2 late singles a cycle, seed 29). Once: two runs took phase
#: 12 to 114 s; the CPU test holds the two-run digest identity.
NET_SOAK_RUNS = 1
#: The IO thread's name (net/transport.py).
NET_IO_THREAD = "mm-torch-net-io"


async def arpc(child, cmd, timeout=120.0, **kw):
    """A child's command from the event loop, without blocking it (the
    primary's pump and renewals run on that loop)."""
    return await asyncio.to_thread(child.rpc, cmd, timeout, **kw)


class LoopStalls:
    """The longest stall of the event loop: a task that sleeps 5 ms and
    records how much later than that it wakes."""

    def __init__(self, tick=0.005):
        self.tick, self.max_ms = tick, 0.0
        self.task = asyncio.ensure_future(self._run())

    async def _run(self):
        while True:
            t = time.perf_counter()
            await asyncio.sleep(self.tick)
            late = (time.perf_counter() - t - self.tick) * 1e3
            self.max_ms = max(self.max_ms, late)

    def stop(self):
        self.task.cancel()
        return self.max_ms


class FrameClock:
    """Host time spent on frames of at least ``min_bytes`` (the baseline's):
    base64 and ``pack_msg`` in net/link.py, ``encode_frame`` in
    net/transport.py, wrapped while the clock is open; each entry is
    (step, thread, ms, bytes)."""

    def __init__(self, link_mod, transport_mod, min_bytes=1 << 20):
        import base64
        import threading
        import types

        self.entries = []
        self._mods = (link_mod, transport_mod)
        self._saved = (link_mod.pack_msg, link_mod.base64,
                       transport_mod.encode_frame)

        def timed(step, fn, size):
            def wrapper(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                n = size(a, out)
                if n >= min_bytes:
                    self.entries.append(
                        (step, threading.current_thread().name,
                         (time.perf_counter() - t) * 1e3, n))
                return out
            return wrapper

        link_mod.pack_msg = timed("pack_msg", link_mod.pack_msg,
                                  lambda a, out: len(out))
        link_mod.base64 = types.SimpleNamespace(
            b64encode=timed("b64encode", base64.b64encode,
                            lambda a, out: len(a[0])),
            b64decode=base64.b64decode)
        transport_mod.encode_frame = timed(
            "encode_frame", transport_mod.encode_frame,
            lambda a, out: len(out))

    def close(self):
        link_mod, transport_mod = self._mods
        (link_mod.pack_msg, link_mod.base64,
         transport_mod.encode_frame) = self._saved

    def frames(self):
        """(the IO thread's ms, frame bytes, thread) of each large frame
        written to a connection, in send order: its base64, pack and
        encode (a frame drained with no connection up has no encode)."""
        out, cur = [], None
        for step, thread, ms, n in self.entries:
            if step == "b64encode":
                cur = [0.0, 0, thread]
                out.append(cur)
            if cur is not None:
                cur[0] += ms
                if step == "encode_frame":
                    cur[1] = n
        return [tuple(f) for f in out if f[1]]


class SocketMeter:
    """The primary's side of a socket-replicated soak: the lag in records
    every 20 ms and the tap's host time a record (the journal's tap
    wrapped)."""

    def __init__(self, rt, interval=PUMP_S):
        self.rt, self.lags = rt, []
        self.tap_s, self.taps = 0.0, 0
        real_tap = rt.journal.tap

        def tap(seq, rtype, payload):
            t = time.perf_counter()
            real_tap(seq, rtype, payload)
            self.tap_s += time.perf_counter() - t
            self.taps += 1
        rt.journal.tap = tap
        self.task = asyncio.ensure_future(self._run(interval))

    async def _run(self, interval):
        while True:
            await asyncio.sleep(interval)
            self.lags.append(self.rt.replication.lag())

    async def quiesce(self, timeout=60.0):
        end = time.monotonic() + timeout
        while not self.rt.replication.quiescent:
            if time.monotonic() > end:
                raise AssertionError(
                    f"replication did not quiesce: sent "
                    f"{self.rt.replication.sent_seq}, acked "
                    f"{self.rt.replication.acked_seq}")
            await asyncio.sleep(0.01)

    def stop(self):
        self.task.cancel()

    def summary(self):
        lags = sorted(self.lags) or [0]
        return {"lag_records_p50": statistics.median(lags),
                "lag_records_p99": pct(lags, 0.99),
                "lag_records_max": lags[-1], "pumps_seen": len(self.lags),
                "tap_us_per_record": self.tap_s / max(1, self.taps) * 1e6,
                "records": self.taps}


def check_socket_turn(app, rt, hub, rep, what):
    """A clean turn: the child's shadow is the pool at the journal's seq,
    and nothing on the replication path or the wire failed (tap, send,
    pump, frame, liveness, lease request, fence)."""
    from matchmaking_tpu_torch.net.failover_proc import _digest

    pool = set(rt.engine.pool._slot_of)
    if (rep.get("shadow_digest") != _digest(pool)
            or rep.get("shadow_n") != len(pool)):
        raise AssertionError(f"{what}: the child's shadow ({rep.get('shadow_n')}"
                             f") differs from the pool ({len(pool)})")
    if rep.get("applied_seq") != rt.journal.seq:
        raise AssertionError(f"{what}: the child applied "
                             f"{rep.get('applied_seq')}, journal at "
                             f"{rt.journal.seq}")
    link = dict(rt.replication.link.counters)
    slink = rep.get("standby_link", {})
    bad = {
        "tap_errors": rt.journal.tap_errors,
        "send_errors": rt.replication.send_errors,
        "replication_pump_errors": rt.counters["replication_pump_errors"],
        "link_send_errors": link.get("send_errors", 0),
        "frame_errors": link.get("frame_errors", 0)
        + slink.get("frame_errors", 0),
        "liveness_lost": link.get("liveness_lost", 0)
        + slink.get("liveness_lost", 0),
        "rpc_timeouts": hub.authority.counters.get("rpc_timeouts", 0),
        "replication_fenced": app.metrics.counters.get("replication_fenced"),
    }
    if any(bad.values()):
        raise AssertionError(f"{what}: {bad}")
    check_faults(app, what)
    return link, slink


async def wait_baseline(child, seq, sent_at, what, timeout=60.0):
    """Poll the child (every 10 ms) until it applied the baseline of
    ``seq``; the ms since ``sent_at`` (monotonic, one clock for both
    processes)."""
    end = time.monotonic() + timeout
    while True:
        rep = await arpc(child, "report")
        if (rep.get("applied_seq", 0) >= seq
                and rep.get("applier", {}).get("snapshots")):
            return (time.monotonic() - sent_at) * 1e3, rep
        if time.monotonic() > end:
            raise AssertionError(f"{what}: the baseline never applied: {rep}")
        await asyncio.sleep(0.01)


async def service_network(np, torch, ck, mods, path, *, waiting, requests,
                          burst, seed, soak_runs):
    """12a-12c. Config #1's service at full width with the journal on
    (fsync "none"), the 100k recovered from a journal at each start, its
    lease held at a ``failover_proc lease`` child and its standby a
    ``failover_proc host`` child on the card (``--device cuda``), both
    over UDS, frame and send buffer limits ``NET_LIMITS`` on both sides.
    12a: replication off and over the socket in turns, two rounds each
    (``requests`` in bursts of ``burst``): requests/s, p50/p99, the lag
    in records, the tap's µs a record, the IO thread's ms for the
    baseline frame and its bytes, send → the child's applied baseline,
    the link's counters and the loop's longest stall after the start (the
    baseline's own, inside the start, is ``last_baseline["ms"]``); the
    child's shadow is the pool, and no error, liveness loss, lease timeout
    or fence.
    12b: the JAX soak's cycle-0 script on the fwd flow (seqs relative to
    the baseline's): the link reconnects, re-sends the baseline and
    converges, every record applied once; then a crash after the 4th
    window of a second stream, the child's takeover after the real lease
    expiry, the fenced ex-primary refused at both seams, the child serving
    config #1 on the card adopting its shadow (RTO and split; the epoch
    the takeover's), 1,024 requests through the child launching both
    kernels there (its counts), the kernels against their plain versions
    on the child's pool, and nobody matched by both. 12c: the
    cross-process soak (``failover_proc.soak``, JAX's geometry) with its
    hosts on the card, ``soak_runs`` times: JAX's gates, one digest."""
    import dataclasses
    import shutil
    import tempfile

    from matchmaking_tpu_torch.config import ChaosConfig, NetConfig
    from matchmaking_tpu_torch.net import failover_proc
    from matchmaking_tpu_torch.net import link as net_link
    from matchmaking_tpu_torch.net import transport as net_transport
    from matchmaking_tpu_torch.service.app import MatchmakingApp
    from matchmaking_tpu_torch.service.broker import Properties
    from matchmaking_tpu_torch.service.replication import QueueReplication
    from matchmaking_tpu_torch.utils.journal import FencedError

    Config, _, RequestColumns, _ = mods
    rng = np.random.default_rng(seed)
    t0 = time.time()
    faults_n, second, fresh_n = 4_096, 8_192, 1_024
    pop = Population(np, rng, waiting + requests + faults_n + second
                     + fresh_n, t0, filters=False, glicko2=False)
    # A short base: UDS paths stay far under 108 bytes.
    work = tempfile.mkdtemp(prefix="mmnet")
    seed_dir = os.path.join(work, "seed")
    reply = "net.replies"
    lease_addr = f"unix:{work}/lease.sock"
    net = NetConfig(transport="socket", lease_addr=lease_addr, **NET_LIMITS)
    children = []
    res: dict = {"legs": [], "lease_s": NET_LEASE_S, "limits": NET_LIMITS}

    def spawn(name, argv):
        c = failover_proc.Child(name, argv)
        children.append(c)
        return c

    try:
        cfg0 = resilience_cfg(Config, path, journal_dir=seed_dir)
        queue = cfg0.queues[0].name
        # The lease service and the three standbys start beside the seed.
        lease = spawn("lease", ["lease", "--lease-addr", lease_addr,
                                "--lease-s", str(NET_LEASE_S)])
        hosts = {name: spawn(name, failover_proc.host_argv(
            name, queue=queue, lease_addr=lease_addr, lease_s=NET_LEASE_S,
            seed=seed, device="cuda", net=net))
            for name in ("standby1", "standby3", "successor")}
        app0 = MatchmakingApp(cfg0, device="cuda")
        await app0.start()
        fill = pop.columns(RequestColumns, app0.engine, 0, waiting, t0, reply)
        app0.restore_columns(fill, pop.region[:waiting], pop.mode[:waiting],
                             t0)
        await app0.runtime(queue).compact_journal()
        await app0.crash()
        del app0
        for c in children:
            await asyncio.to_thread(c.wait_ev, "ready", 120.0)

        def leg_cfg(name, on, target=None, chaos=None, owner="hostA"):
            jdir = os.path.join(work, name)
            shutil.copytree(seed_dir, jdir)
            cfg = resilience_cfg(Config, path, journal_dir=jdir,
                                 replication=on, owner=owner)
            if on:
                cfg = dataclasses.replace(
                    cfg, net=dataclasses.replace(net, repl_target=target),
                    chaos=chaos or ChaosConfig())
            return cfg

        sent_at = []
        real_send_baseline = QueueReplication.send_baseline

        def send_baseline(self, seq, payload):
            sent_at.append(time.monotonic())
            real_send_baseline(self, seq, payload)
        QueueReplication.send_baseline = send_baseline

        # ---- 12a: off and over the socket in turns ---------------------
        for i, on in enumerate((False, True, False, True)):
            child = hosts.get(f"standby{i}")
            listen = f"unix:{work}/s{i}.sock"
            if on:
                await arpc(child, "standby", listen=listen)
            app = MatchmakingApp(leg_cfg(f"leg{i}", on, target=listen),
                                 device="cuda")
            clock = FrameClock(net_link, net_transport) if on else None
            sent_at.clear()
            t = time.perf_counter()
            await app.start()
            start_ms = (time.perf_counter() - t) * 1e3
            stalls = LoopStalls()
            rt = app.runtime(queue)
            rec = rt.last_recovery
            if rec is None or rec["snapshot_players"] != waiting:
                raise AssertionError(f"12a leg {i}: recovered {rec}")
            leg = {"replication": on, "start_ms": start_ms}
            if on:
                hub = app.replication_hub
                cross_ms, _ = await wait_baseline(
                    child, rt.last_baseline["seq"], sent_at[0],
                    f"12a leg {i}")
                meter = SocketMeter(rt)
            replies = Replies(app, reply)
            reset_counts(ck)
            soak_s, t_pub = await publish_and_wait(
                app, request_bodies(pop, waiting, waiting + requests), burst,
                reply, replies)
            await settle(app)
            launches = dict(ck.LAUNCHES)
            p50, p99 = latency_ms(replies, t_pub)
            check_answers(replies, t_pub, f"12a leg {i}")
            leg.update(requests_per_s=requests / soak_s, latency_ms_p50=p50,
                       latency_ms_p99=p99, windows=rt.counters["windows"],
                       launches=launches)
            if on:
                await meter.quiesce()
                meter.stop()
                rep = await arpc(child, "report")
                link, slink = check_socket_turn(app, rt, hub, rep,
                                                f"12a leg {i}")
                frames = clock.frames()
                clock.close()
                leg.update(meter.summary())
                leg["baseline"] = dict(
                    rt.last_baseline, frame_bytes=frames[0][1],
                    io_thread_ms=frames[0][0], io_thread=frames[0][2],
                    send_to_applied_ms=cross_ms)
                leg["link"] = {k: link.get(k, 0) for k in (
                    "frames_tx", "frames_rx", "connects", "reconnects",
                    "backpressure_dropped", "liveness_lost", "sent")}
                leg["standby_link"] = {k: slink.get(k, 0) for k in (
                    "frames_tx", "frames_rx", "accepts", "liveness_lost",
                    "delivered")}
                leg["lease"] = {k: v for k, v in hub.authority.counters.items()
                                if k in ("rpc_timeouts", "connects",
                                         "reconnects", "frames_tx")}
                if (frames[0][2] != NET_IO_THREAD
                        or rt.last_baseline["players"] != waiting):
                    raise AssertionError(f"12a leg {i}: baseline {frames} "
                                         f"{rt.last_baseline}")
            else:
                check_faults(app, f"12a leg {i}")
            leg["loop_stall_ms_max"] = stalls.stop()
            await app.stop()
            if on:
                if app.replication_hub is not None:
                    raise AssertionError("12a: the owned hub stayed open")
                await arpc(child, "stop")
            res["legs"].append(leg)
        ons = [leg for leg in res["legs"] if leg["replication"]]
        log("12a socket replication off/on in turns: " + ", ".join(
            f"{'on' if leg['replication'] else 'off'} "
            f"{leg['requests_per_s']:.0f}/s p50 {leg['latency_ms_p50']:.2f} "
            f"p99 {leg['latency_ms_p99']:.2f} ms" for leg in res["legs"])
            + f"; lag p50/p99 {[(o['lag_records_p50'], o['lag_records_p99']) for o in ons]}"
            f" records, tap {[round(o['tap_us_per_record'], 2) for o in ons]}"
            f" µs a record, baseline {[o['baseline'] for o in ons]}, link "
            f"{[o['link'] for o in ons]}, loop stall max "
            f"{[round(leg['loop_stall_ms_max'], 1) for leg in res['legs']]} ms")

        # ---- 12b: faults on the fwd flow, then a host loss ----------------
        base = ons[0]["baseline"]["seq"]
        fwd = f"repl:{queue}:fwd"
        script = ChaosConfig(
            seed=seed, queues=(queue,), net_drop_frames=((fwd, base + 2),),
            net_dup_frames=((fwd, base + 3),),
            net_delay_frames=((fwd, base + 4, 2),),
            net_reset_frames=((fwd, base + 6),))
        succ = hosts["successor"]
        listen = f"unix:{work}/sb.sock"
        await arpc(succ, "standby", listen=listen)
        app = MatchmakingApp(leg_cfg("leg_faults", True, target=listen,
                                     chaos=script), device="cuda")
        clock = FrameClock(net_link, net_transport)
        sent_at.clear()
        await app.start()
        stalls = LoopStalls()
        rt = app.runtime(queue)
        hub = app.replication_hub
        if rt.last_baseline["seq"] != base:
            raise AssertionError(f"12b: baseline seq {rt.last_baseline}, "
                                 f"12a's {base}")
        await wait_baseline(succ, base, sent_at[0], "12b")
        meter = SocketMeter(rt)
        replies = Replies(app, reply)
        lo = waiting + requests
        reset_counts(ck)
        soak_s, t_pub = await publish_and_wait(
            app, request_bodies(pop, lo, lo + faults_n), burst, reply,
            replies)
        await settle(app)
        launches_f = dict(ck.LAUNCHES)
        check_answers(replies, t_pub, "12b faults")
        await meter.quiesce()
        rep = await arpc(succ, "report")
        link, slink = dict(rt.replication.link.counters), rep["standby_link"]
        applier = rep["applier"]
        frames = clock.frames()
        clock.close()
        if rep.get("shadow_digest") != failover_proc._digest(
                rt.engine.pool._slot_of) or rep["applied_seq"] != rt.journal.seq:
            raise AssertionError(f"12b: the shadow did not converge: {rep}")
        want = {"nemesis_dropped": 1, "nemesis_dup": 1, "nemesis_delayed": 1,
                "nemesis_resets": 1}
        if ({k: link.get(k, 0) for k in want} != want
                or link.get("reconnects", 0) < 1 or len(frames) < 2
                or applier.get("applied") != rt.journal.seq - base + 1
                or applier.get("snapshots") != 1):
            raise AssertionError(f"12b: link {link}, applier {applier}, "
                                 f"{len(frames)} baseline frames")
        faults = {"requests_per_s": faults_n / soak_s, "link": link,
                  "standby_link": slink, "applier": applier,
                  "baseline_frames": len(frames), "launches": launches_f,
                  **meter.summary()}
        meter.stop()
        # The host loss: a second stream, crashed after its 4th window.
        rows = request_bodies(pop, lo + faults_n, lo + faults_n + second)
        state: dict = {}
        real_admit = rt._journal_admit_cols

        def admit_then_crash(cols):
            real_admit(cols)
            state["windows"] = state.get("windows", 0) + 1
            if state["windows"] == 4:
                state["in_flight"] = app.engine.inflight()
                state["mirror"] = set(rt.engine.pool._slot_of)
                state["kill_bound"] = rt.replication.unacked_admit_players()
                state["lag"] = rt.replication.lag()
                crash = app.crash()
                try:
                    crash.send(None)
                except StopIteration:
                    pass
                raise Crashed()
        rt._journal_admit_cols = admit_then_crash
        reset_counts(ck)
        for b in range(0, second, burst):
            for pid, body in rows[b:b + burst]:
                app.broker.publish(queue, body, Properties(
                    reply_to=reply, correlation_id=pid))
            await asyncio.sleep(0.004)
            if "in_flight" in state:
                break
        if "mirror" not in state:
            raise AssertionError(f"12b: no crash ({state})")
        flusher = rt._batcher._task
        await asyncio.sleep(0.01)
        if flusher.done() and not flusher.cancelled():
            flusher.exception()  # the Crashed it ended with, retrieved
        launches_crash = dict(ck.LAUNCHES)
        stall_b = stalls.stop()
        matched_before = replies.matched()
        t = time.perf_counter()
        to = await arpc(succ, "takeover", timeout_s=4 * NET_LEASE_S + 30.0,
                        timeout=4 * NET_LEASE_S + 60.0)
        takeover_ms = (time.perf_counter() - t) * 1e3
        if not rt.replication.superseded():
            raise AssertionError("12b: the ex-primary is not superseded")
        try:
            rt.journal.append_admits([["zz", 1500.0, 350.0, "*", "*", None,
                                       t0, reply, "zz", 0, 0.0]])
            raise AssertionError("12b: the fenced primary appended")
        except FencedError:
            pass
        answered = sum(len(v) for v in replies.got.values())
        rt._publish(reply, "zz", b"{}")
        refused = rt.counters["fenced_publish_refused"]
        if (refused != 1 or rt.replication.role != "fenced"
                or sum(len(v) for v in replies.got.values()) != answered):
            raise AssertionError(f"12b: the fenced primary published "
                                 f"({refused} refused)")
        rep = await arpc(succ, "report", shadow=True)
        shadow = set(rep["shadow"])
        lost = state["mirror"] - shadow
        if len(lost) > state["kill_bound"] or shadow & set(matched_before):
            raise AssertionError(
                f"12b: {len(lost)} lost (bound {state['kill_bound']}), "
                f"{len(shadow & set(matched_before))} matched players in "
                f"the shadow")
        sv = await arpc(succ, "serve", target=f"unix:{work}/deadend.sock",
                        jdir=os.path.join(work, "successor_j"),
                        config=os.path.join(HERE, path), fsync="none",
                        digest=True, timeout=300.0)
        if (sv["epoch"] != to["epoch"] or sv["recovered_n"] != len(shadow)
                or sv["recovered_digest"] != failover_proc._digest(shadow)):
            raise AssertionError(f"12b: served epoch {sv['epoch']} after "
                                 f"takeover {to['epoch']}, adopted "
                                 f"{sv['recovered_n']} of {len(shadow)}")
        before = await arpc(succ, "report", digest=True)
        lo2 = lo + faults_n + second
        fresh = [[pop.ids[k], float(pop.rating[k])]
                 for k in range(lo2, lo2 + fresh_n)]
        t = time.perf_counter()
        await arpc(succ, "publish", rows=fresh, rate=1e7)
        q = await arpc(succ, "quiesce", replication=False, timeout_s=60.0,
                       timeout=90.0)
        fresh_s = time.perf_counter() - t
        after = await arpc(succ, "report", digest=True)
        launches_s = {k: after["launches"][k] - before["launches"][k]
                      for k in after["launches"]}
        if (not q["ok"] or launches_s["block_best"] == 0
                or launches_s["quality_accum"] != launches_s["block_best"]
                or after["faults"] or any(after["errors"].values())):
            raise AssertionError(f"12b: the successor: quiesced {q}, "
                                 f"launches {launches_s}, faults "
                                 f"{after['faults']}, {after['errors']}")
        kern = await arpc(succ, "kernels", rows=FULL_B)
        both = set(after["match_of"]) & set(matched_before)
        if both:
            raise AssertionError(f"12b: {len(both)} players matched by both "
                                 f"the primary and the child")
        await arpc(succ, "stop", timeout=120.0)
        res["faults"] = faults
        res["failover"] = {
            "in_flight_at_crash": state["in_flight"],
            "kill_bound": state["kill_bound"], "lag_at_crash": state["lag"],
            "lost": len(lost), "matched_before_crash": len(matched_before),
            "takeover_ms_real_expiry": takeover_ms, "epoch": to["epoch"],
            "served_epoch": sv["epoch"], "shadow_players": len(shadow),
            "rto_ms": sv["rto_ms"], "split_ms": sv["split_ms"],
            "loop_stall_ms_max": stall_b, "fresh_s": fresh_s,
            "fenced_publish_refused": refused,
            "launches_before_crash": launches_crash,
            "launches": launches_s, "kernel_check": kern,
            "matched_by_child": len(after["match_of"])}
        log(f"12b faults: link {link}, applier {applier}, "
            f"{len(frames)} baseline frames; host loss with "
            f"{state['in_flight']} windows in flight, lag "
            f"{state['lag']} records, lost {len(lost)} (bound "
            f"{state['kill_bound']}); takeover after the real expiry "
            f"{takeover_ms:.0f} ms (epoch {to['epoch']}), the child adopted "
            f"{len(shadow)} on the card, rto {sv['rto_ms']} ms "
            f"{sv['split_ms']}, its {fresh_n} requests launched "
            f"{launches_s}, kernels vs plain {kern}")
        QueueReplication.send_baseline = real_send_baseline

        # ---- 12c: the cross-process soak, hosts on the card ---------------
        t = time.perf_counter()
        soak = await asyncio.to_thread(
            failover_proc.soak, runs=soak_runs, cycles=3, device="cuda",
            log_fn=log)
        soak["seconds"] = time.perf_counter() - t
        gates = {
            "dup": soak["socket_failover_dup"] == 0,
            "lost_over_bound": soak["socket_failover_lost_over_bound"] == 0,
            "fenced_probes": soak["socket_fenced_probe_failures"] == 0,
            "reconnects": soak["socket_link_reconnects"] >= soak_runs,
            "heartbeat_false_positives":
                soak["heartbeat_false_positive_count"] == 0,
            "recoveries": soak["socket_failover_recoveries"] == 3 * soak_runs,
            "identical": soak_runs < 2
            or soak["socket_failover_transcript_identical"] is True,
            "epochs": all(a == b for run in soak["socket_failover_epochs"]
                          for a, b in run),
            "launches": soak["launches"]["block_best"] > 0
            and soak["launches"]["quality_accum"]
            == soak["launches"]["block_best"]}
        if not all(gates.values()):
            raise AssertionError(f"12c: gates {gates}: {soak}")
        res["soak"] = soak
        log(f"12c cross-process soak ({soak_runs} run(s), 3 cycles, hosts on "
            f"the card): lost {soak['socket_failover_lost']} of bound "
            f"{soak['socket_failover_lost_bound']}, dup "
            f"{soak['socket_failover_dup']}, reconnects "
            f"{soak['socket_link_reconnects']}, heartbeat false positives "
            f"{soak['heartbeat_false_positive_count']}, rto max "
            f"{soak['socket_failover_rto_ms']} ms, digests "
            f"{soak['failover_transcript_digests']}, launches "
            f"{soak['launches']}, {soak['seconds']:.1f} s")
    finally:
        for c in children:
            c.reap()
        shutil.rmtree(work, ignore_errors=True)
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
        from matchmaking_tpu_torch.engine import kernels, scoring
        from matchmaking_tpu_torch.engine.gpu import GpuEngine
        from matchmaking_tpu_torch.engine.quality import QualitySpec
        from matchmaking_tpu_torch.native import codec
        from matchmaking_tpu_torch.service.app import run_demo
        from matchmaking_tpu_torch.service.contract import (
            RequestColumns,
            SearchRequest,
        )
    except ImportError as e:
        log(f"the matchmaking_tpu_torch package is not beside this file: {e}")
        return 3
    out_path = argv[argv.index("--out") + 1] if "--out" in argv else None
    out_dir = os.path.dirname(os.path.abspath(out_path)) if out_path else None
    baseline_tree = (argv[argv.index("--baseline-tree") + 1]
                     if "--baseline-tree" in argv else None)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. build and identify: one nvcc per kernel source and g++ (the wire
    # codec), all started together
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(ck.SOURCES) + 1) as pool:
        codec_build = pool.submit(codec.build)
        builds = {name: pool.submit(ck.compile_report, name)
                  for name in ck.SOURCES}
        built = {name: f.result() for name, f in builds.items()}
        codec_so = codec_build.result()
    build_s = time.perf_counter() - t
    so = built["block_best"][0]
    log(f"built the wire codec: {codec_so}")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    max_sm_clock = card_line("clocks.max.sm")
    resources = ptxas_report("".join(text for _, text in built.values()))
    log(f"built {', '.join(built)} in {build_s:.1f} s on {kind} ({card}, max "
        f"SM clock {max_sm_clock})")
    for inst, res in resources.items():
        log(f"ptxas {inst}: {res}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    sass = sass_inner_loop(so, out_dir)
    log(f"SASS, ELO scorer's inner loop: {sass}")
    baseline = load_baseline(baseline_tree) if baseline_tree else None

    # 2. kernels vs plain: block_best (dense, then the span launch) and
    #    quality_accum
    kernel, max_err = phase_kernel(torch, ck, scoring, device, baseline)
    sweep = (plan_sweep(torch, ck, scoring, device) if "--plan-sweep" in argv
             else None)
    span = phase_span(torch, np, ck, kernels, scoring, device,
                      sweep=sweep is not None)
    if sweep is not None:
        sweep["span_chunk16"] = span["chunk16"]["plans"]
    quality, q_err = phase_quality(torch, np, ck, kernels, QualitySpec(),
                                   device, baseline)

    # 3. the engine main path: columnar, pipelined, at full width
    phase_s = {"1-2": time.perf_counter() - t_start}
    t_phase = time.perf_counter()
    mods = (Config, GpuEngine, RequestColumns, SearchRequest)
    launches = {}
    main_run = run_columnar(torch, np, ck, scoring, mods, "configs/elo_1v1.json",
                            waiting=100_000, windows=48, glicko2=False,
                            filters=False, seed=1, cpu_windows=3,
                            object_windows=8, profile_windows=8)
    launches["columnar_elo_1v1"] = main_run["launches"]
    launches["object_elo_1v1"] = main_run["object"]["launches"]
    if main_run["profile"]["step_kernels_per_window"] > 402:
        raise AssertionError(f"the main path's window runs "
                             f"{main_run['profile']['step_kernels_per_window']}"
                             f" kernels, over 401 + the quality_accum launch")
    phase_s["3"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # 3b. the pruned main path: config #1 with BENCH_SWEEP.md §5's pruning
    pruned_run = run_columnar(torch, np, ck, scoring, mods,
                              "configs/elo_1v1.json", waiting=100_000,
                              windows=48, glicko2=False, filters=False, seed=1,
                              cpu_windows=3, object_windows=0,
                              profile_windows=8, engine_over=PRUNE)
    launches["columnar_elo_1v1_pruned"] = pruned_run["launches"]
    # 3c. the bucketed main path: config #1 with the JAX bench's bucketed
    #     geometry, a heartbeat (the index rebuild) mid-stream
    phase_s["3b"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    bucketed_run = run_columnar(torch, np, ck, scoring, mods,
                                "configs/elo_1v1.json", waiting=100_000,
                                windows=48, glicko2=False, filters=False,
                                seed=1, cpu_windows=3, object_windows=0,
                                profile_windows=8, engine_over=BUCKETED,
                                heartbeat_at=24)
    launches["columnar_elo_1v1_bucketed"] = bucketed_run["launches"]
    phase_s["3c"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    filters_run = run_columnar(torch, np, ck, scoring, mods,
                               "configs/multiqueue_filters.json",
                               waiting=50_000, windows=6, glicko2=False,
                               filters=True, seed=2, cpu_windows=1,
                               object_windows=0, profile_windows=0)
    launches["columnar_multiqueue_filters"] = filters_run["launches"]
    glicko_run = run_columnar(torch, np, ck, scoring, mods,
                              "configs/glicko2.json", waiting=100_000,
                              windows=24, glicko2=True, filters=False, seed=4,
                              cpu_windows=1, object_windows=0,
                              profile_windows=0)
    launches["columnar_glicko2"] = glicko_run["launches"]
    rescan = run_rescan(torch, np, ck, scoring, mods, "configs/glicko2.json",
                        waiting=50_000, seed=5)
    launches["rescan_tick_glicko2"] = rescan["tick_launches"]
    launches["rescan_arrivals_glicko2"] = rescan["arrival_launches"]
    phase_s["3 (#2, #4, rescan)"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # 3d. speculation: the dense rescan family (config #4) and the
    #     bucketed one (config #1 bucketed)
    speculation = {
        "glicko2": run_speculation(torch, np, ck, mods, "configs/glicko2.json",
                                   engine_over={}, waiting=50_000, windows=4,
                                   seed=14),
        "elo_1v1_bucketed": run_speculation(
            torch, np, ck, mods, "configs/elo_1v1.json", engine_over=BUCKETED,
            waiting=100_000, windows=4, seed=15)}
    for name, run in speculation.items():
        launches["speculation_" + name] = run["speculate_launches"]
    phase_s["3d"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 4. the service on the card: the demo, the full-width soak, and
    #    config #4's rescan loop
    answers = asyncio.run(run_demo(device="cuda"))
    by_id = {r.player_id: r for r in answers}
    for r in answers:
        if r.status != "matched":
            raise AssertionError(f"demo: {r.player_id} got {r.status}")
        partner = next(p for p in r.match.players if p != r.player_id)
        if by_id[partner].status != "matched":
            raise AssertionError(f"demo: partner {partner} not matched")
    log(f"service demo: {len(answers)} players answered, all matched")
    profile_soak = "--profile-soak" in argv and out_dir
    soak = asyncio.run(service_soak(
        np, ck, mods, "configs/elo_1v1.json", waiting=100_000,
        requests=16_384, burst=512, seed=6,
        profile_to=(os.path.join(out_dir, "soak_profile_on.txt")
                    if profile_soak else None)))
    launches["service_soak"] = soak["launches"]
    # The same soak on the per-delivery path (consume_batch off).
    soak_off = asyncio.run(service_soak(
        np, ck, mods, "configs/elo_1v1.json", waiting=100_000,
        requests=16_384, burst=512, seed=6, consume_batch=False,
        profile_to=(os.path.join(out_dir, "soak_profile_off.txt")
                    if profile_soak else None)))
    launches["service_soak_per_delivery"] = soak_off["launches"]
    service_rescan_run = asyncio.run(service_rescan(
        np, ck, mods, "configs/glicko2.json", waiting=20_000, seed=7))
    launches["service_rescan_glicko2"] = service_rescan_run["launches"]
    multiqueue = asyncio.run(service_multiqueue(
        np, ck, mods, "configs/multiqueue_filters.json", waiting=20_000,
        requests=2_048, burst=512, seed=12))
    launches["service_multiqueue_filters"] = multiqueue["launches"]
    spec_service = asyncio.run(service_spec(ck, mods, "configs/elo_1v1.json"))
    launches["service_speculation_bucketed"] = spec_service["launches"]
    phase_s["4"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 5. team and role queues at full width: configs #3 and #5 on the card
    #    (their steps score no 1v1 blocks: block_best must stay at 0), the
    #    role queue's hand-over to the host oracle, config #3's service
    ck.LAUNCHES["block_best"] = 0
    team_run = run_team(torch, np, mods, "configs/team_5v5.json",
                        waiting=50_000, windows=24, profile_windows=8,
                        cpu_windows=3, seed=8, roles=False)
    role_run = run_team(torch, np, mods, "configs/role_party.json",
                        waiting=12_000, windows=8, profile_windows=8,
                        cpu_windows=3, seed=9, roles=True)
    delegation = role_delegation(torch, np, mods, "configs/role_party.json",
                                 waiting=200, seed=10)
    role_health = asyncio.run(service_role_health(
        np, mods, "configs/role_party.json", waiting=200, seed=13))
    team_service = asyncio.run(service_team(
        np, mods, "configs/team_5v5.json", waiting=50_000, requests=8_192,
        burst=512, seed=11))
    launches["team_and_role_paths"] = ck.LAUNCHES["block_best"]
    phase_s["5"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 6. overload control at full width: config #1's service with the
    #    waiting cap, tiers, EDF and deadlines, then the same soak without
    overload = {on: asyncio.run(service_overload(
        np, ck, mods, "configs/elo_1v1.json", waiting=100_000,
        requests=16_384, burst=512, seed=16, overload_on=on))
        for on in (True, False)}
    launches["service_overload"] = overload[True]["launches"]
    phase_s["6"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 7. the circuit breaker at full width: two failed windows demote the
    #    queue to the host oracle, the second probe brings it back
    breaker_run = asyncio.run(service_breaker(
        np, ck, mods, "configs/elo_1v1.json", waiting=100_000, seed=17))
    launches["service_breaker_probe"] = (
        breaker_run["probe_launches"]["block_best"])
    launches["service_breaker_after_repromotion"] = (
        breaker_run["launches_after"])
    phase_s["7"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 8. durability at full width: the write-ahead journal's cost (on
    #    against off), a hard crash with windows in flight and the
    #    recovery on the card, the drain's round trip with its backlog,
    #    and auth rpc and static
    elo = "configs/elo_1v1.json"
    durability = asyncio.run(service_durability(
        np, torch, ck, mods, elo, waiting=100_000, requests=16_384,
        burst=512, seed=18))
    drain_run = asyncio.run(service_drain(
        np, torch, ck, mods, elo, waiting=100_000, backlog=512, seed=19))
    auth_run = asyncio.run(service_auth(
        np, ck, mods, elo, waiting=100_000, requests=1_024, seed=20))
    phase8 = {"service_journal_soak": durability["on"]["launches"],
              "service_recovered": durability["crash"]["launches"],
              "service_drain_restore": drain_run["launches"],
              "service_auth_rpc": auth_run["rpc"]["launches"],
              "service_auth_static": auth_run["static"]["launches"]}
    for name, counts in phase8.items():
        launches[name] = counts["block_best"]
    phase_s["8"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 9. tracing at full width: config #1's soak with tracing off, on and
    #    sampled (1 in 16), in turns in this process
    tracing = {mode: asyncio.run(service_trace_soak(
        np, ck, mods, elo, waiting=100_000, requests=16_384, burst=512,
        seed=21, mode=mode,
        profile_to=(os.path.join(out_dir, f"trace_profile_{mode}.txt")
                    if profile_soak else None)))
        for mode in ("off", "on", "sampled")}
    for mode, run in tracing.items():
        launches["service_trace_" + mode] = run["launches"]["block_best"]
    phase_s["9"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 10. telemetry, the SLO burn monitors, incident capture and the HTTP
    #     surfaces at full width: config #1's soak with the sampler off and
    #     no server, then with the defaults, metrics_port and an SLO
    #     target, in turns in this process; the routes' statuses against
    #     a CPU run's
    cpu_statuses = asyncio.run(cpu_route_statuses(np, Config, elo, seed=22))
    observed = {name: asyncio.run(service_observability(
        np, ck, mods, elo, waiting=100_000, requests=16_384, burst=512,
        seed=22, on=on, cpu_statuses=cpu_statuses))
        for name, on in (("off", False), ("on", True))}
    for name, run in observed.items():
        launches["service_observability_" + name] = (
            run["launches"]["block_best"])
    phase_s["10"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 11. resilience at full width: config #1's service under seeded
    #     broker chaos with the invariant checker (twice, then without),
    #     replication off and on in turns, a failover onto a successor on
    #     the card, and replication-link faults
    chaos_runs = asyncio.run(service_chaos(
        np, ck, mods, elo, waiting=100_000, requests=16_384, burst=512,
        seed=23))
    replication = asyncio.run(service_replication(
        np, torch, ck, mods, elo, waiting=100_000, requests=16_384,
        burst=512, seed=24))
    phase11 = {"service_" + name: run["launches"]
               for name, run in chaos_runs.items()}
    phase11.update({f"service_replication_{i}_"
                    f"{'on' if leg['replication'] else 'off'}": leg["launches"]
                    for i, leg in enumerate(replication["legs"])})
    phase11["service_failover_successor"] = (
        replication["failover"]["launches"])
    phase11["service_replication_link_faults"] = (
        replication["link_faults"]["launches"])
    for name, counts in phase11.items():
        launches[name] = counts["block_best"]
    phase_s["11"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 12. the socket transport at full width: config #1's service
    #     replicating to a standby in a child process over UDS, its lease
    #     at a lease child; faults on the wire and a host loss onto the
    #     child; the cross-process failover soak with its hosts on the card
    network = asyncio.run(service_network(
        np, torch, ck, mods, elo, waiting=100_000, requests=16_384,
        burst=512, seed=25, soak_runs=NET_SOAK_RUNS))
    ons11 = [leg for leg in replication["legs"] if leg["replication"]]
    ons12 = [leg for leg in network["legs"] if leg["replication"]]
    log("12a against 11b (on legs, requests/s; p50 / p99 ms): socket "
        + ", ".join(f"{o['requests_per_s']:.0f}; {o['latency_ms_p50']:.1f} / "
                    f"{o['latency_ms_p99']:.1f}" for o in ons12)
        + " · in-process " + ", ".join(
            f"{o['requests_per_s']:.0f}; {o['latency_ms_p50']:.1f} / "
            f"{o['latency_ms_p99']:.1f}" for o in ons11))
    phase12 = {f"service_network_{i}_"
               f"{'on' if leg['replication'] else 'off'}": leg["launches"]
               for i, leg in enumerate(network["legs"])}
    phase12["service_network_faults"] = network["faults"]["launches"]
    phase12["service_network_before_host_loss"] = (
        network["failover"]["launches_before_crash"])
    phase12["child_successor"] = network["failover"]["launches"]
    phase12["child_soak_hosts"] = network["soak"]["launches"]
    for name, counts in phase12.items():
        launches[name] = counts["block_best"]
    phase_s["12"] = time.perf_counter() - t_phase
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    if launches["team_and_role_paths"]:
        raise AssertionError("block_best ran on a team/role path")
    team_launches = team_run["step"]["launches"]
    role_launches = role_run["step"]["launches"]
    if team_launches > 300 or role_launches > team_launches + 60:
        raise AssertionError(f"step launch budget: team {team_launches} "
                             f"(<= 300), role {role_launches} (<= team + 60)")
    torch.cuda.synchronize()

    main_k = kernel["elo"]
    # The main paths: config #1's columnar windows, dense and pruned, and
    # the rescan tick's own chunks (each path's count is in
    # launches_by_path; quality_accum runs once behind each of those steps).
    main_launches = (launches["columnar_elo_1v1"]
                     + launches["columnar_elo_1v1_pruned"]
                     + launches["columnar_elo_1v1_bucketed"]
                     + launches["rescan_tick_glicko2"]
                     + sum(r["speculate_launches"]
                           for r in speculation.values())
                     + sum(c["block_best"] for c in phase8.values())
                     + sum(r["launches"]["block_best"]
                           for r in tracing.values())
                     + sum(r["launches"]["block_best"]
                           for r in observed.values())
                     + sum(c["block_best"] for c in phase11.values())
                     + sum(c["block_best"] for c in phase12.values()))
    q_launches = (main_run["quality_launches"]
                  + pruned_run["quality_launches"]
                  + bucketed_run["quality_launches"]
                  + rescan["tick_launches"]
                  + sum(r["commit_launches"] for r in speculation.values())
                  + sum(c["quality_accum"] for c in phase8.values())
                  + sum(r["launches"]["quality_accum"]
                        for r in tracing.values())
                  + sum(r["launches"]["quality_accum"]
                        for r in observed.values())
                  + sum(c["quality_accum"] for c in phase11.values())
                  + sum(c["quality_accum"] for c in phase12.values()))
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
        "launches_by_path": launches,
        "ms_by_bucket": main_k["ms_by_bucket"],
        "host_us": main_k["host_us_by_bucket"][FULL_B],
        "span_launch": span,
    }, {
        "name": "quality_accum",
        "route": "cuda",
        "source": "matchmaking_tpu_torch/csrc/quality_accum.cu",
        "replaces": "matchmaking_tpu/engine/kernels.py:1239",
        "launches": q_launches,
        "max_abs_err": q_err,
        "ms": quality["ms"],
        "plain_ms": quality["plain_ms"],
        "bound_ms": quality["bound_ms"],
        "bound_by": quality["bound_by"],
        "library_ms": None,
        "launches_by_path": {
            "columnar_elo_1v1": main_run["quality_launches"],
            "columnar_elo_1v1_pruned": pruned_run["quality_launches"],
            "columnar_elo_1v1_bucketed": bucketed_run["quality_launches"],
            "rescan_tick_glicko2": rescan["tick_launches"],
            **{"spec_commit_" + name: run["commit_launches"]
               for name, run in speculation.items()},
            "service_speculation_bucketed": spec_service["quality_launches"],
            "service_soak": soak["launches"],
            "service_multiqueue_filters": multiqueue["launches"],
            "service_overload": overload[True]["launches"],
            "service_breaker_probe":
                breaker_run["probe_launches"]["quality_accum"],
            "service_breaker_after_repromotion":
                breaker_run["launches_after"],
            **{name: c["quality_accum"] for name, c in phase8.items()},
            **{"service_trace_" + mode: run["launches"]["quality_accum"]
               for mode, run in tracing.items()},
            **{"service_observability_" + name: run["launches"]["quality_accum"]
               for name, run in observed.items()},
            **{name: c["quality_accum"] for name, c in phase11.items()},
            **{name: c["quality_accum"] for name, c in phase12.items()}},
        "ms_by_bucket": quality["ms_by_bucket"],
        "host_us": quality["host_us"],
        "host_us_by_bucket": quality["host_us_by_bucket"],
        "empty_ms_by_bucket": quality["empty_ms_by_bucket"],
        "empty_host_us_by_bucket": quality["empty_host_us_by_bucket"],
        "ms_32_edges": quality["ms_32_edges"],
        **{k: quality[k] for k in ("baseline_ms_by_bucket",
                                   "baseline_host_us_by_bucket")
           if k in quality},
    }]}
    for k in line["kernels"]:
        for path, n in k["launches_by_path"].items():
            if n == 0 and path != "team_and_role_paths":
                raise AssertionError(f"{k['name']} never ran on {path}")
    columnar = {}
    for name, run in (("elo_1v1", main_run), ("elo_1v1_pruned", pruned_run),
                      ("elo_1v1_bucketed", bucketed_run),
                      ("multiqueue_filters", filters_run),
                      ("glicko2", glicko_run)):
        columnar[name] = {k: run[k] for k in (
            "dispatch_ms_p50", "dispatch_ms_p99", "turnaround_ms_p50",
            "turnaround_ms_p99", "requests_per_s", "idle_fraction",
            "gc_ms_total", "gc_ms_max", "matches", "launches",
            "quality_samples", "prune", "formation", "eager_windows_equal")}
        columnar[name]["graphs"] = {k: v for k, v in run["graphs"].items()
                                    if k != "by_graph"}
        if run["profile"]:
            columnar[name]["kernels_per_window"] = (
                run["profile"]["step_kernels_per_window"])
            columnar[name]["queued_per_window"] = (
                run["profile"]["queued_per_window"])
            columnar[name]["own_kernels"] = run["profile"]["own_kernels"]
            own_ms = run["profile"]["own_kernel_ms_per_window"]
            columnar[name]["block_best_device_ms_per_window"] = (
                own_ms["prep_kernel"] + own_ms["block_best_kernel"])
            columnar[name]["quality_accum_device_ms_per_window"] = (
                own_ms["quality_accum_kernel"])
    summary = {
        "card": card, "columnar": columnar,
        "split_ms_per_window": main_run["split_ms_per_window"],
        "device_busy_share": main_run["profile"]["device_busy_share"],
        "kernels_per_window": main_run["profile"]["kernels_per_window"],
        "greedy_pair_kernels_per_call":
            main_run["profile"]["greedy_pair_kernels_per_call"],
        "object_step_ms_p50": main_run["object"]["step_ms_p50"],
        "object_step_ms_max": main_run["object"]["step_ms_max"],
        "object_gc_ms_max": max(main_run["object"]["gc_ms"]),
        "rescan": {k: v for k, v in rescan.items() if k != "tick_profile"}
        | {"tick_" + k + "_per_chunk": rescan["tick_profile"][k + "_per_window"]
           for k in ("queued", "graph_launches", "kernels", "device_ms")}
        | {"tick_own_kernels": rescan["tick_profile"]["own_kernels"]},
        "service_rescan": service_rescan_run,
        "speculation": speculation,
        "service_speculation": spec_service,
        "phase_s": phase_s,
        "soak": {k: soak[k] for k in ("latency_ms_p50", "latency_ms_p99",
                                      "latency_ms_max", "requests_per_s",
                                      "windows", "publish_batches",
                                      "players_matched", "quality_samples",
                                      "decode_calls")},
        "soak_per_delivery": {k: soak_off[k] for k in (
            "latency_ms_p50", "latency_ms_p99", "latency_ms_max",
            "requests_per_s", "windows", "players_matched", "decode_calls")},
        "team": {name: {k: run[k] for k in (
            "dispatch_ms_p50", "dispatch_ms_p99", "turnaround_ms_p50",
            "turnaround_ms_p99", "requests_per_s", "matches",
            "matches_per_window", "finalize_ms_per_window",
            "team_delegated", "rescan", "quality_samples")}
            | {"kernels_per_window": run["profile"]["kernels_per_window"],
               "queued_per_window": run["profile"]["queued_per_window"],
               "device_ms_per_window": run["profile"]["device_ms_per_window"],
               "device_busy_share": run["profile"]["device_busy_share"],
               "graphs": {k: v for k, v in run["graphs"].items()
                          if k != "by_graph"},
               "step_queue_ms_per_window": run["step_queue_ms_per_window"]}
            for name, run in (("team_5v5", team_run),
                              ("role_party", role_run))},
        "role_delegation": delegation,
        "role_health": role_health,
        "multiqueue_service": {k: multiqueue[k] for k in (
            "windows", "requests_per_s", "players_matched", "probes")},
        "team_service": {k: team_service[k] for k in (
            "latency_ms_p50", "latency_ms_p99", "latency_ms_max",
            "requests_per_s", "windows", "publish_batches",
            "players_matched")},
        "overload": {("on" if on else "off"): {k: run[k] for k in (
            "requests_per_s", "latency_ms_p50", "latency_ms_p99",
            "latency_ms_by_tier", "final_status_by_tier", "shed_by_tier",
            "expired_by_tier", "pool_max_after_window", "backlog_at_cut",
            "admission_cut_us_per_window", "debt_windows",
            "debt_ms_per_window", "debt_pick_ms_per_window", "windows")}
            for on, run in overload.items()},
        "breaker": {k: v for k, v in breaker_run.items()
                    if k != "quality_counts"},
        "durability": durability,
        "drain": drain_run,
        "auth": auth_run,
        "tracing": {mode: {k: v for k, v in run.items()
                           if k not in ("launches", "stage_counts")}
                    for mode, run in tracing.items()},
        "observability": {name: {k: v for k, v in run.items()
                                 if k not in ("launches", "route_statuses")}
                          for name, run in observed.items()},
        "chaos": {name: {k: v for k, v in run.items() if k != "launches"}
                  for name, run in chaos_runs.items()},
        "replication": {
            "legs": [{k: v for k, v in leg.items() if k != "launches"}
                     for leg in replication["legs"]],
            "failover": {k: v for k, v in replication["failover"].items()
                         if k not in ("launches", "device_kernels")},
            "link_faults": {k: v for k, v in
                            replication["link_faults"].items()
                            if k != "launches"}},
        "network": {
            "legs": [{k: v for k, v in leg.items() if k != "launches"}
                     for leg in network["legs"]],
            "faults": {k: v for k, v in network["faults"].items()
                       if k != "launches"},
            "failover": {k: v for k, v in network["failover"].items()
                         if not k.startswith("launches")},
            "soak": {k: v for k, v in network["soak"].items()
                     if k not in ("launches", "socket_failover_epochs")}},
    }
    steps_line = {"steps": [
        dict(name=name, config=run["config"], replaces=src,
             **{k: run["step"][k] for k in ("launches", "device_ms", "ms",
                                            "host_ms", "pool", "batch",
                                            "bound_ms", "bound_by")})
        for name, run, src in (
            ("team_step", team_run, "matchmaking_tpu/engine/teams.py:317"),
            ("role_step", role_run,
             "matchmaking_tpu/engine/role_kernels.py:224"))]}
    total_s = time.perf_counter() - t_start
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": card, "kind": kind, "build_s": build_s,
                       "max_sm_clock": max_sm_clock, "ptxas": resources,
                       "sass_elo_inner_loop": sass, "plan_sweep": sweep,
                       "kernel": kernel, "max_abs_err": max_err,
                       "span": span, "quality": quality,
                       "columnar": [main_run, pruned_run, bucketed_run,
                                    filters_run, glicko_run],
                       "speculation": speculation,
                       "service_speculation": spec_service,
                       "rescan": rescan, "demo_players": len(answers),
                       "soak": soak, "soak_per_delivery": soak_off,
                       "service_rescan": service_rescan_run,
                       "team": [team_run, role_run],
                       "role_delegation": delegation,
                       "role_health": role_health,
                       "multiqueue_service": multiqueue,
                       "team_service": team_service,
                       "overload": overload, "breaker": breaker_run,
                       "durability": durability, "drain": drain_run,
                       "auth": auth_run, "tracing": tracing,
                       "observability": observed,
                       "cpu_route_statuses": cpu_statuses,
                       "chaos": chaos_runs, "replication": replication,
                       "network": network,
                       "total_s": total_s, "summary": summary,
                       "steps_line": steps_line,
                       "kernels_line": line}, f, indent=1)
    print(f"total {total_s:.1f} s")
    print(json.dumps(summary))
    print(f"max SM clock: {max_sm_clock}")
    print(json.dumps(steps_line))
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
