#!/usr/bin/env python
"""Stage split of the port's 1v1 window step (the port of
``scripts/profile_step.py``).

The step's one device number (device ms a window) split into its stages,
at the bench geometry, on synthetic inputs made from
``np.random.default_rng(7)``: ratings N(1500, 300), threshold 100,
``--pool`` active players in random slots of ``--capacity``, and a window
of B fresh requests in free slots, packed f32[9, B].

    admit          the window's rows written into their slots (``admit``)
    cands          the candidate pass alone: ``block_best`` against the pool
                   before admission (``KernelSet.candidates``), with the
                   region/mode filters as the JAX tool's (and
                   ``cands_nofilter``: without, as config #1's all-ANY
                   windows run it)
    pair           ``greedy_pair`` on the candidate pass's real outputs
    pair_rN        ``greedy_pair`` at 1/2/4/8 rounds, with the matches each
                   forms (where formation saturates)
    evict          the eviction of the window's B slots and B pool slots
    full           ``KernelSet.search_step_packed``, chained on one pool
    full_nofilter  the same with ``skip_filters=True``

Stage times overlap as the JAX tool's do: the split reads
full ~= cands + pair + evict (+ admit), and full_nofilter ~=
cands_nofilter + pair + evict (+ admit).

On the card each stage is captured into a CUDA graph of its own (its
inputs made beforehand, outside the graph) and timed by N replays queued
back to back between two CUDA events, with no host sync among them (the
loop runs under ``torch.cuda.set_sync_debug_mode("error")``). The eager
call's host µs stands beside it, and the kernels each graph holds are read
back from the graph itself (``engine/graphs.audit_dot``). A stage that
writes the pool times on its own copy of it; ``full`` chains on one, as
the JAX tool's ``chain=True``. Before the timing, each graph's first
replay is held to its eager call from the same state (equal outputs and
pools), and at B above 1,024 the candidate pass to its plain version
(``cuda_kernels.block_best_reference``) on the same CUDA tensors: equal
slots, bit-equal values. Any difference fails the run.

With ``--device cpu`` the stages run eagerly on the CPU (the kernels'
plain versions) and each time is the host's wall clock: a check of the
script, not a device number. Without a card, and without ``--device
cpu``, it exits non-zero.

    python scripts/torch_profile_step.py                 # on the card
    python scripts/torch_profile_step.py --window 1024 --json out.json
    python scripts/torch_profile_step.py --device cpu --capacity 4096 \\
        --pool-block 512 --pool 3000 --window 64
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

#: The repository's root: the port's package is imported from there.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Round counts of the pairing sweep.
ROUNDS = (1, 2, 4, 8)
#: Largest window a card run has held ``block_best`` to its plain version
#: at inside the main path; above it every script checks first.
CHECKED_WINDOW = 1024


def resolve_device(name: str):
    """``--device`` → a torch device. No card and no ``--device cpu``:
    exit non-zero (no fallback to the CPU)."""
    import torch

    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: torch.cuda.is_available() is False, no card "
            f"here; pass --device cpu to run the plain versions on the CPU")
    return torch.device(name)


def device_line(device) -> str:
    import torch

    if device.type == "cuda":
        return (f"device: {device} ({torch.cuda.get_device_name(device)}, "
                f"count {torch.cuda.device_count()})")
    return "device: cpu (plain versions; times are the host's wall clock)"


def make_inputs(capacity: int, window: int, pool: int,
                threshold: float) -> dict:
    """``profile_step.py``'s seeded inputs as numpy: the pool's columns
    (``arrays``), the packed window, the window's free slots, the occupied
    slots, and the B + B slots the evict stage clears."""
    rng = np.random.default_rng(7)
    P, B = capacity, window
    active = np.zeros(P, bool)
    occupied = rng.choice(P, size=pool, replace=False)
    active[occupied] = True
    arrays = {
        "rating": rng.normal(1500.0, 300.0, P).astype(np.float32),
        "rd": np.zeros(P, np.float32),
        "region": np.zeros(P, np.int32),
        "mode": np.zeros(P, np.int32),
        "threshold": np.full(P, np.float32(threshold)),
        "enqueue_t": np.zeros(P, np.float32),
        "active": active,
    }
    free = np.setdiff1d(np.arange(P, dtype=np.int32), occupied)[:B]
    packed = np.zeros((9, B), np.float32)
    packed[0] = free
    packed[1] = rng.normal(1500.0, 300.0, B).astype(np.float32)
    packed[5] = threshold
    packed[7] = 1.0
    matched = np.concatenate([free, occupied[:B].astype(np.int32)])
    return {"arrays": arrays, "packed": packed, "free": free,
            "occupied": occupied, "matched": matched}


def kernel_set(capacity: int, pool_block: int):
    """The JAX tool's ``kernel_set(capacity, 8, pool_block, False, 0.0,
    400.0)``: ELO, no widening."""
    from matchmaking_tpu_torch.engine.kernels import KernelSet

    return KernelSet(capacity=capacity, top_k=8, pool_block=pool_block,
                     glicko2=False, widen_per_sec=0.0, max_threshold=400.0)


def clone_pool(pool):
    from matchmaking_tpu_torch.engine.kernels import DevicePool

    return DevicePool({k: v.clone() for k, v in pool.full.items()})


def reset_pool(dst, src) -> None:
    """``dst`` := ``src`` in place (a captured graph keeps its addresses)."""
    for k, v in src.full.items():
        dst.full[k].copy_(v)


def same(a, b) -> bool:
    """Tensors (or tuples, or pools) equal bit for bit."""
    import torch

    if a is None or b is None:
        return a is b
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def check_candidates(ks, pool, batch, q_thr, now, *, filters: bool = True
                     ) -> dict:
    """The candidate pass against its plain version on the same tensors:
    equal slots and bit-equal values, or ``AssertionError``. The kernel's
    launch here counts as any other; ``launches`` says how many it made,
    for a caller that reports comparison launches apart."""
    from matchmaking_tpu_torch.engine import cuda_kernels, scoring

    before = cuda_kernels.LAUNCHES["block_best"]
    got = ks.candidates(batch, q_thr, pool, now, skip_filters=not filters)
    launches = cuda_kernels.LAUNCHES["block_best"] - before
    want = cuda_kernels.block_best_reference(
        pool, batch, q_thr, now, pool_block=ks.pool_block,
        glicko2=ks.glicko2, filters=filters,
        widen_per_sec=ks.widen_per_sec, max_threshold=ks.max_threshold,
        g_coeff=scoring.G_COEFF_F32)
    rows = int(batch["slot"].shape[0])
    if not same(got[1], want[1]):
        bad = int((got[1] != want[1]).sum())
        raise AssertionError(f"candidate pass at B={rows}: {bad} slots "
                             f"differ from the plain version")
    if not same(got[0], want[0]):
        raise AssertionError(f"candidate pass at B={rows}: values are not "
                             f"bit-equal to the plain version")
    return {"window": rows, "slots_equal": True, "values_bit_equal": True,
            "candidates": int((want[0] > float("-inf")).sum()),
            "launches": launches}


@contextlib.contextmanager
def no_sync(device):
    """Any host sync inside raises (the card only)."""
    import torch

    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class Stages:
    """Captures a stage into a CUDA graph and times it (the card), or runs
    and times it eagerly (the CPU). A stage is ``fn(pool) -> outputs``;
    its other inputs are made beforehand."""

    def __init__(self, ks, device, iters: int):
        import torch

        from matchmaking_tpu_torch.engine.graphs import StepGraphs

        self.ks, self.device, self.iters = ks, device, iters
        self.torch = torch
        self.graphs = (StepGraphs(ks, device) if device.type == "cuda"
                       else None)

    def run(self, name: str, fn, base) -> dict:
        """One stage from pool state ``base`` (left as it is): the graph's
        first replay against the eager call, then the timing. The timed
        calls all run on one copy of the pool: admission and eviction
        write the same slots each time, and the full step chains. Returns
        {ms, host_us, kernels, memsets, own_kernel_nodes, launches,
        graph_equals_eager, out} (the eager outputs)."""
        torch = self.torch
        eager_pool = clone_pool(base)
        out = fn(eager_pool)
        if self.graphs is None:
            t = time.perf_counter()
            for _ in range(self.iters):
                fn(eager_pool)
            ms = (time.perf_counter() - t) / self.iters * 1e3
            return {"ms": ms, "host_us": None, "kernels": None,
                    "memsets": None, "own_kernel_nodes": None,
                    "launches": None, "graph_equals_eager": None, "out": out}
        from matchmaking_tpu_torch.engine.graphs import audit_dot

        # The eager call's host time, warm (the first call built whatever
        # was lazy).
        t = time.perf_counter()
        fn(eager_pool)
        host_us = (time.perf_counter() - t) * 1e6
        pool, scratch = clone_pool(base), clone_pool(base)
        g = self.graphs.capture(name, 0, lambda p, _: fn(p), pool,
                                torch.zeros(1), scratch, debug=True)
        audit = audit_dot(g.dot, g.launches)
        if audit["problems"]:
            raise AssertionError(f"stage {name}: {audit['problems']}")
        # First replay from ``base`` against the eager call from ``base``.
        reset_pool(pool, base)
        got = self.graphs.replay(g)
        check_pool = clone_pool(base)
        want = fn(check_pool)
        equal = same(got, want) and same(dict(pool), dict(check_pool))
        if not equal:
            raise AssertionError(f"stage {name}: the graph's replay differs "
                                 f"from its eager call")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with no_sync(self.device):
            start.record()
            for _ in range(self.iters):
                self.graphs.replay(g)
            end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / self.iters
        return {"ms": ms, "host_us": host_us,
                "kernels": audit["kernel_nodes"],
                "memsets": audit["memset_nodes"],
                "own_kernel_nodes": audit["own_kernel_nodes"],
                "launches": dict(g.launches), "graph_equals_eager": True,
                "out": want}

    def close(self) -> None:
        """Give the stage graphs' memory back (each graph went with its
        ``run``)."""
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
            self.torch.cuda.empty_cache()


def profile(capacity: int = 131_072, pool_block: int = 8192,
            window: int = 4096, pool: int = 100_000, iters: int = 30,
            threshold: float = 100.0, device="cuda", log=print) -> dict:
    """The stage split (see the module docstring). Returns every number it
    prints; ``log`` gets the lines."""
    import torch

    from matchmaking_tpu_torch.engine.kernels import (
        admit,
        evict,
        greedy_pair,
        packed_now,
        pool_from_reference,
        unpack_batch,
    )

    device = torch.device(device)
    ks = kernel_set(capacity, pool_block)
    P, B = ks.capacity, window
    log(device_line(device))
    log(f"geometry: P={P} blk={ks.pool_block} n_blocks={ks.n_blocks} "
        f"B={B} rounds={ks.pair_rounds} active={pool}")
    inp = make_inputs(capacity, window, pool, threshold)
    base = pool_from_reference(inp["arrays"], device)
    packed = torch.from_numpy(inp["packed"]).to(device)
    batch = unpack_batch(packed)
    now = packed_now(packed)
    q_thr = batch["threshold"]
    matched = torch.from_numpy(inp["matched"]).to(device)
    res: dict = {"device": str(device), "capacity": P,
                 "pool_block": ks.pool_block, "n_blocks": ks.n_blocks,
                 "window": B, "rounds": ks.pair_rounds, "active": pool,
                 "iters": iters, "candidate_check": None}
    if device.type == "cuda":
        res["card"] = torch.cuda.get_device_name(device)
        if B > CHECKED_WINDOW:
            res["candidate_check"] = check_candidates(ks, base, batch, q_thr,
                                                      now)
            log(f"candidate pass vs plain at B={B}: slots equal, values "
                f"bit-equal")
    st = Stages(ks, device, iters)
    stages: dict[str, dict] = {}
    try:
        stages["admit"] = st.run("admit", lambda p: admit(p, batch), base)
        stages["cands"] = st.run(
            "cands", lambda p: ks.candidates(batch, q_thr, p, now), base)
        stages["cands_nofilter"] = st.run(
            "cands_nofilter",
            lambda p: ks.candidates(batch, q_thr, p, now, skip_filters=True),
            base)
        vals, idxs = stages["cands"]["out"]
        n_cand = int((vals > float("-inf")).sum(1).float().mean())
        log(f"mean candidates/row: {n_cand}")
        matches = {}
        for r in ROUNDS:
            stages[f"pair_r{r}"] = st.run(
                f"pair_r{r}",
                lambda p, r=r: greedy_pair(vals, idxs, batch["slot"], P, r),
                base)
            q = stages[f"pair_r{r}"]["out"][0]
            matches[r] = int((q < P).sum())
            log(f"matches at rounds={r}: {matches[r]}/{B}")
        stages["pair"] = stages[f"pair_r{ks.pair_rounds}"]
        stages["evict"] = st.run("evict", lambda p: evict(p, matched), base)
        stages["full"] = st.run(
            "full", lambda p: ks.search_step_packed(p, packed), base)
        stages["full_nofilter"] = st.run(
            "full_nofilter",
            lambda p: ks.search_step_packed(p, packed, skip_filters=True),
            base)
    finally:
        st.close()
    if device.type == "cuda":
        log("graph = eager: " + " ".join(
            n for n, s in stages.items() if n != "pair"
            and s["graph_equals_eager"]))
    log("")
    unit = "ms" if device.type == "cuda" else "ms (cpu wall)"
    for name, s in stages.items():
        extra = ""
        if s["kernels"] is not None:
            extra = (f"  host {s['host_us']:9.1f} us  kernels "
                     f"{s['kernels']:4d}")
        log(f"{name:>13}: {s['ms']:8.3f} {unit}{extra}")
    pe = stages["pair"]["ms"] + stages["evict"]["ms"]
    cpe = stages["cands"]["ms"] + pe
    acpe = cpe + stages["admit"]["ms"]
    nf = stages["cands_nofilter"]["ms"] + pe + stages["admit"]["ms"]
    log(f"{'sum(c+p+e)':>13}: {cpe:8.3f} {unit}  "
        f"(full = {stages['full']['ms']:.3f})")
    log(f"{'sum(a+c+p+e)':>13}: {acpe:8.3f} {unit}  "
        f"(full = {stages['full']['ms']:.3f})")
    log(f"{'nofilter':>13}: {nf:8.3f} {unit}  (a+c+p+e; full_nofilter = "
        f"{stages['full_nofilter']['ms']:.3f})")
    res.update({
        "mean_candidates": n_cand, "matches": matches,
        "stages": {n: {k: v for k, v in s.items() if k != "out"}
                   for n, s in stages.items()},
        "sum_cpe_ms": cpe, "sum_acpe_ms": acpe, "sum_acpe_nofilter_ms": nf,
        "full_ms": stages["full"]["ms"],
        "full_nofilter_ms": stages["full_nofilter"]["ms"]})
    return res


def main(argv: "list[str] | None" = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--capacity", type=int, default=131_072)
    p.add_argument("--pool-block", type=int, default=8192)
    p.add_argument("--window", type=int, default=4096)
    p.add_argument("--pool", type=int, default=100_000)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--threshold", type=float, default=100.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--json", default=None,
                   help="also write every number to this file")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    res = profile(args.capacity, args.pool_block, args.window, args.pool,
                  args.iters, args.threshold, device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
