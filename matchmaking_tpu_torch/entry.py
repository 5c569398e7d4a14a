"""The port's single-card step and multi-card dry run.

``entry()`` gives the flagship window step, the full 1v1 matchmaking step
over a device-resident pool in its production packed form (one f32[9, B]
window in, one f32[3, B] result out: ``core/pool.py`` ``PACKED_ROWS`` and
the window's time):

    admission → ``block_best`` (the hand-written kernel on the card) →
    greedy conflict-free pairing → eviction

``dryrun_multichip(n)`` runs the sharded steps over an n-shard pool mesh
(``engine/sharded.py``): the all-gather merge twice, the ring merge, the
sharded team step and the sharded role step, one window each, on tiny
shapes, and prints what they formed.

``python -m matchmaking_tpu_torch.entry`` captures ``entry()``'s step as
a CUDA graph, replays it, and runs the dry run over the visible cards.

Port of the JAX package's ``__graft_entry__.py``, at its geometry and
windows; the step writes the pool in place where the JAX step returns it.
"""

from __future__ import annotations

import sys
from typing import Sequence

import numpy as np
import torch

from matchmaking_tpu_torch.core.pool import BatchArrays, PlayerPool, pack_batch
from matchmaking_tpu_torch.engine import kernels, sharded
from matchmaking_tpu_torch.engine.graphs import StepGraphs
from matchmaking_tpu_torch.engine.role_kernels import ShardedRoleKernelSet
from matchmaking_tpu_torch.engine.teams import ShardedTeamKernelSet


def example_packed(capacity: int, bucket: int, ratings,
                   now: float = 1.0) -> np.ndarray:
    """A packed window of ``bucket`` lanes: ``ratings`` in slots 0..n-1
    (threshold 100, region and mode ANY, enqueued at 0), the rest
    padding."""
    batch = BatchArrays(
        slot=np.full(bucket, capacity, np.int32),
        rating=np.zeros(bucket, np.float32),
        rd=np.zeros(bucket, np.float32),
        region=np.zeros(bucket, np.int32),
        mode=np.zeros(bucket, np.int32),
        threshold=np.full(bucket, 100.0, np.float32),
        enqueue_t=np.zeros(bucket, np.float32),
        valid=np.zeros(bucket, np.bool_),
    )
    n = len(ratings)
    batch.slot[:n] = np.arange(n, dtype=np.int32)
    batch.rating[:n] = ratings
    batch.valid[:n] = True
    return pack_batch(batch, now)


def entry(device="cuda"):
    """``(fn, (pool, packed))``: the 1v1 packed window step
    (``KernelSet.search_step_packed``; capacity 8,192, top_k 8, blocks of
    1,024, ELO, no widening, max threshold 400) and its example
    arguments: an empty pool and a window of bucket 64 holding 48
    ratings. ``fn(pool, packed)`` writes the pool in place and returns
    f32[3, 64] (q_slot, c_slot, dist)."""
    dev = torch.device(device)
    capacity, bucket = 8192, 64
    ks = kernels.KernelSet(capacity=capacity, top_k=8, pool_block=1024,
                           glicko2=False, widen_per_sec=0.0,
                           max_threshold=400.0)
    pool = kernels.fresh_pool(capacity, dev)
    packed = torch.from_numpy(example_packed(
        capacity, bucket, [1500.0 + 7.0 * i for i in range(48)])).to(dev)
    return ks.search_step_packed, (pool, packed)


def captured_entry(device="cuda"):
    """``entry()``'s step captured as a CUDA graph, as the engine captures
    its steps (``engine/graphs.StepGraphs``: one eager run on a fresh
    pool, then the capture on the example pool and window): (the graphs,
    the captured step, the example pool). ``graphs.replay(step)`` runs
    the window on the pool and returns its f32[3, 64] result (counting
    the launches a replay makes)."""
    fn, (pool, packed) = entry(device)
    graphs = StepGraphs(None, packed.device)
    step = graphs.capture("dense", packed.shape[1], fn, pool,
                          packed.cpu().pin_memory(),
                          kernels.fresh_pool(pool["rating"].shape[0],
                                             packed.device))
    return graphs, step, pool


def _mesh(n_devices: int, devices: Sequence | None, device):
    return sharded.pool_mesh(n_devices, devices, device=device)


def _paired(out: torch.Tensor, capacity: int) -> int:
    return int((out[0].to(torch.int32) < capacity).sum())


def dryrun_multichip(n_devices: int, devices: Sequence | None = None,
                     device="cuda") -> None:
    """Run five sharded windows over an ``n_devices``-shard pool mesh and
    print what they formed: the all-gather step twice (the second window
    into fresh slots), the ring step, the sharded team step and the
    sharded role step, 16 slots a shard. ``devices`` None takes
    ``n_devices`` distinct visible cards (raises when fewer are visible)
    or, with ``device="cpu"``, the CPU for each shard; a list may repeat
    a card."""
    dev = torch.device(device)
    capacity = 16 * n_devices  # tiny shapes: 16 slots per shard
    ks = sharded.ShardedKernelSet(
        capacity=capacity, top_k=4, pool_block=16, glicko2=False,
        widen_per_sec=5.0, max_threshold=400.0,
        mesh=_mesh(n_devices, devices, dev), ring=False)
    home = ks.mesh.home
    pool = ks.place_pool(PlayerPool.empty_device_arrays(ks.capacity))
    ratings = [1500.0 + 3.0 * i for i in range(12)]
    packed = torch.from_numpy(example_packed(ks.capacity, 16, ratings,
                                             now=0.5)).to(home)
    out = ks.search_step_packed(pool, packed)
    # Sanity: the tiny window must actually pair players across the mesh.
    matched = _paired(out, ks.capacity)
    assert matched >= len(ratings) // 2 - 1, f"only {matched} pairs formed"
    # A second window into fresh slots on the same pool.
    packed2 = example_packed(ks.capacity, 16, [2500.0, 2504.0], now=1.5)
    packed2[0, :2] += len(ratings)
    ks.search_step_packed(pool, torch.from_numpy(packed2).to(home))

    ring = sharded.ShardedKernelSet(
        capacity=capacity, top_k=4, pool_block=16, glicko2=False,
        widen_per_sec=0.0, max_threshold=400.0,
        mesh=_mesh(n_devices, devices, dev), ring=True)
    rpool = ring.place_pool(PlayerPool.empty_device_arrays(ring.capacity))
    rout = ring.search_step_packed(rpool, torch.from_numpy(
        example_packed(ring.capacity, 16, ratings)).to(home))
    ring_matched = _paired(rout, ring.capacity)

    # The sharded team step (config #3 over the mesh).
    tks = ShardedTeamKernelSet(
        capacity=capacity, team_size=2, widen_per_sec=0.0,
        max_threshold=400.0, mesh=_mesh(n_devices, devices, dev),
        max_matches=4, rounds=4)
    tpool = tks.place_pool(PlayerPool.empty_device_arrays(tks.capacity))
    tout = tks.search_step_packed(tpool, torch.from_numpy(example_packed(
        tks.capacity, 16, [1500.0 + 2.0 * i for i in range(8)])).to(home))
    tslots = tout[:tks.need].to(torch.int32)
    team_players = int((tslots[0] < tks.capacity).sum()) * tks.need
    assert team_players >= tks.need, "sharded team step formed no match"

    # The sharded role step (config #5 over the mesh): role_mask sharded
    # with the pool, a tank/dps alternating window.
    rks = ShardedRoleKernelSet(
        capacity=capacity, team_size=2, role_slots=("tank", "dps"),
        widen_per_sec=0.0, max_threshold=400.0,
        mesh=_mesh(n_devices, devices, dev), max_matches=4, rounds=4)
    rk_arrays = PlayerPool.empty_device_arrays(rks.capacity)
    rk_arrays["role_mask"] = np.zeros(rks.capacity, np.int32)
    rk_pool = rks.place_pool(rk_arrays)
    rk_packed = example_packed(rks.capacity, 16,
                               [1500.0 + 2.0 * i for i in range(8)])
    masks = np.zeros((1, 16), np.float32)
    masks[0, :8] = [1, 2, 1, 2, 1, 2, 1, 2]
    rk_packed = np.concatenate([rk_packed[:8], masks, rk_packed[8:]])
    rk_out = rks.search_step_packed(rk_pool,
                                    torch.from_numpy(rk_packed).to(home))
    rk_slots = rk_out[:rks.need].to(torch.int32)
    role_players = int((rk_slots[0] < rks.capacity).sum()) * rks.need
    assert role_players >= rks.need, "sharded role step formed no match"

    print(f"dryrun_multichip: devices={n_devices} windows=5 "
          f"allgather_merge_paired={matched} ring_merge_paired={ring_matched} "
          f"team_players_matched={team_players} "
          f"role_players_matched={role_players}",
          flush=True)


def main(argv: Sequence[str] | None = None) -> int:
    """Capture ``entry()``'s step as a CUDA graph and replay it, then run
    the dry run over the visible cards."""
    del argv
    if not torch.cuda.is_available():
        print("the port's entry runs on the card: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 2
    graphs, step, _ = captured_entry()
    out = graphs.replay(step)
    torch.cuda.synchronize()
    print("entry compile check:", tuple(out.shape), flush=True)
    n = torch.cuda.device_count()
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
