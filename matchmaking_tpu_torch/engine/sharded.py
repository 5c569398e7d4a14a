"""The pool sharded over a mesh of shards: the multi-device 1v1 step.

Port of ``matchmaking_tpu/engine/sharded.py``. The pool's slots are cut
into ``D`` equal slices, one per shard, each a ``kernels.DevicePool`` of
its own on its shard's device, and each window is matched so:

1. every shard admits its slice of the window and runs ``block_best`` (the
   hand-written kernel, ``cuda_kernels.block_best``) on its own slice: the
   window's slots shifted by −offset for the self-mask, at the block width
   the GLOBAL capacity gives, so the blocks are the dense step's;
2. the shards' best-per-block lists, with global slot ids, are collected
   in canonical shard order, by one all-gather (default) or by a ring of
   D − 1 neighbour hops (``ring``) — the same buffers either way;
3. greedy pairing runs once on the merged lists (the JAX step runs it
   replicated on every shard, each copy identical), and each shard evicts
   its slice of the matched slots.

The merged lists are the dense step's candidate lists, so sharded and
single-device engines form the same pairs, bit for bit.

The bucket-frontier family (``bucket_step``): each shard compacts every
local block (a rating bucket under ``band_spec``) into its first ``k``
active rows; only these frontiers cross the shard boundary, by the ring,
and the window is scored against the merged ``global_blocks · k`` rows in
blocks of ``k`` by the same ``block_best`` kernel. Bit-equal to the dense
step while no bucket holds more than ``k`` players (the engine checks the
mirror's bucket counts per window and falls back above).

The mesh (``pool_mesh``): one device per shard, driven by this process.
On the card it is the first D of the visible cards and raises when fewer
are visible; with ``device="cpu"`` it is D entries of the CPU (the tests'
stand-in for the JAX package's 8 virtual CPU devices). An explicit device
list may name one device more than once: ``(cuda:0,) * 4`` on one card
stands in for four, every shard's work then queuing on that card; a
service's ``DeviceInventory`` resolves a queue's logical device ids to
such entries. The mesh over processes, one shard per rank, is
``distributed.global_pool_mesh``; its merges ride ``torch.distributed``
collectives.

Every step is sync-free: on a mesh whose shards sit on one card it is
captured into a CUDA graph like every other step (``engine/graphs.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Sequence

import numpy as np
import torch

from matchmaking_tpu_torch.core.pool import PACKED_ROWS
from matchmaking_tpu_torch.engine import cuda_kernels, scoring
from matchmaking_tpu_torch.engine.cuda_kernels import effective_threshold
from matchmaking_tpu_torch.engine.kernels import (
    ADMIT_FIELDS,
    DevicePool,
    KernelSet,
    admit,
    effective_pool_block,
    evict,
    fresh_pool,
    greedy_pair,
    packed_now,
    pool_from_reference,
    unpack_batch,
)

#: Pool columns of a frontier row, then its global slot (f32-exact ids).
FRONTIER_FIELDS = ("rating", "rd", "region", "mode", "threshold",
                   "enqueue_t")


def mesh_device(d, base=None) -> torch.device:
    """A mesh entry: an int is a card index (``cuda:<i>``; on a CPU mesh,
    ``base`` "cpu", the CPU), anything else what ``torch.device`` makes of
    it."""
    if isinstance(d, int):
        if base is not None and torch.device(base).type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", d)
    return torch.device(d)


class DeviceInventory:
    """The logical devices a service binds queues to (the JAX package's
    ``jax.devices()``): logical id ``i`` is entry ``i``. ``devices`` None:
    the visible cards (``cuda:<i>``), or the CPU for every id when
    ``base`` is the CPU; an explicit list is taken as it is and may repeat
    an entry, ``("cuda:0",) * 4`` on one card standing in for four. An id
    past the inventory raises ``IndexError``, as ``jax.devices()[i]``
    does."""

    def __init__(self, devices: Sequence | None = None, base=None):
        self.base = torch.device("cuda" if base is None else base)
        #: The explicit entries (None: the default inventory).
        self.explicit = tuple(devices) if devices is not None else None

    def __len__(self) -> int:
        if self.explicit is not None:
            return len(self.explicit)
        if self.base.type == "cpu":
            return 1
        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    def __getitem__(self, i: int) -> torch.device:
        i = int(i)
        if self.explicit is None and self.base.type == "cpu" and i >= 0:
            return torch.device("cpu")
        if not 0 <= i < len(self):
            raise IndexError(f"logical device {i} is outside the inventory "
                             f"of {len(self)}")
        if self.explicit is None:
            return torch.device("cuda", i)
        return mesh_device(self.explicit[i], self.base)

    def resolve(self, ids: Sequence[int]) -> tuple[torch.device, ...]:
        return tuple(self[i] for i in ids)


def ring_perm(n: int) -> tuple[tuple[int, int], ...]:
    """The ring's hop: (source, destination) shard pairs, each shard
    sending to its right neighbour (the JAX ``ppermute`` permutation
    ``[(i, (i + 1) % n)]``). Both meshes take every hop from it."""
    return tuple((i, (i + 1) % n) for i in range(n))


class PoolMesh:
    """``n_shards`` shards driven by this process, shard i on
    ``devices[i]``. Its collectives take, per local shard, a tuple of
    tensors and return each tensor's shards stacked in canonical shard
    order, ``(n_shards, *shape)``, on ``home`` (shard 0's device).

    ``ring_hops`` holds the (source, destination) pairs of each hop of
    the last ring gather (host data, set when the step's Python runs: a
    captured graph's replays leave it as its capture left it)."""

    #: Merges are collectives of a process group (``ProcessMesh``).
    process = False
    ring_hops: tuple[tuple[tuple[int, int], ...], ...] = ()

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        self.n_shards = len(self.devices)
        if self.n_shards < 1:
            raise ValueError("a pool mesh needs at least one device")
        #: The shards this process holds, by shard index.
        self.local_shards = tuple(range(self.n_shards))
        self.home = self.devices[0]
        #: Every shard on one device (a step can then be one CUDA graph).
        self.single_device = len(set(self.devices)) == 1

    def all_gather(self, parts: Sequence[tuple[torch.Tensor, ...]]
                   ) -> tuple[torch.Tensor, ...]:
        """One gather: shard i's tensors are copied to ``home`` and
        stacked in shard order."""
        home = self.home
        return tuple(torch.stack([p[j].to(home, non_blocking=True)
                                  for p in parts])
                     for j in range(len(parts[0])))

    def ring_all_gather(self, parts: Sequence[tuple[torch.Tensor, ...]]
                        ) -> tuple[torch.Tensor, ...]:
        """The JAX ``ring_all_gather``: the shards' ORIGINAL tensors rotate
        one hop to the right per step, D − 1 hops, each shard copying what
        it receives into its source's row of its own buffers, so after the
        last hop every shard holds every shard's tensors in canonical
        order. Returns ``home``'s buffers (every shard's are equal)."""
        n = self.n_shards
        outs = []
        for i, p in enumerate(parts):
            bufs = []
            for x in p:
                b = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                device=self.devices[i])
                b[i].copy_(x, non_blocking=True)
                bufs.append(b)
            outs.append(bufs)
        rots = [tuple(p) for p in parts]
        # origin[i]: the shard whose original tensors shard i now holds.
        origin = list(range(n))
        perm = ring_perm(n)
        hops = []
        for _ in range(1, n):
            moved, held = list(rots), list(origin)
            for src, dst in perm:
                moved[dst] = tuple(x.to(self.devices[dst], non_blocking=True)
                                   for x in rots[src])
                held[dst] = origin[src]
            rots, origin = moved, held
            hops.append(perm)
            for i in range(n):
                for b, r in zip(outs[i], rots[i]):
                    b[origin[i]].copy_(r, non_blocking=True)
        self.ring_hops = tuple(hops)
        return tuple(outs[0])

    def gather(self, parts, ring: bool = False) -> tuple[torch.Tensor, ...]:
        return self.ring_all_gather(parts) if ring else self.all_gather(parts)


def pool_mesh(n_shards: int, devices: Sequence | None = None, *,
              device="cuda") -> PoolMesh:
    """A mesh of ``n_shards`` shards. ``devices`` None: on CUDA the first
    ``n_shards`` of the ``torch.cuda.device_count()`` visible cards
    (raises when fewer are visible, as the JAX ``pool_mesh`` does); on the
    CPU, ``n_shards`` entries of the CPU. An explicit list is taken as it
    is, and may repeat a device (one card standing in for several)."""
    base = torch.device(device)
    if devices is None:
        if base.type == "cpu":
            devs = [base] * n_shards
        else:
            visible = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if visible < n_shards:
                raise ValueError(
                    f"mesh_pool_axis={n_shards} but only {visible} CUDA "
                    f"devices visible")
            devs = [torch.device("cuda", i) for i in range(n_shards)]
    else:
        devs = [mesh_device(d, base) for d in devices][:n_shards]
        if len(devs) < n_shards:
            raise ValueError(f"mesh_pool_axis={n_shards} but only "
                             f"{len(devs)} devices named")
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA pool mesh needs torch.cuda."
                               "is_available(); pass device='cpu'")
    return PoolMesh(devs)


def tournament_merge_topk(bufs: Sequence[torch.Tensor], key_fn
                          ) -> torch.Tensor:
    """Tournament-tree top-k merge of per-shard SORTED frontier buffers.

    ``bufs`` holds D buffers f32[C, k] in canonical shard order, each
    sorted by the lexicographic key ``key_fn(buf) -> (group i32[k], rating
    f32[k], gslot i32[k])``. Pairwise stable merges up a ⌈log2 D⌉-level
    tree keep the first k merged rows at each node; ties keep the lower
    shard's row first (its concat order). Each node computes every row's
    merged position by rank compares (k×k) and takes the rows with one
    index gather, so the values keep their bits (the JAX package selects
    with one-hot matmuls at full precision, which a TF32 matmul would
    not). Returns the merged f32[C, k]."""
    def lt(ka, kb):
        ga, ra, sa = ka
        gb, rb, sb = kb
        return ((ga < gb) | ((ga == gb) & (ra < rb))
                | ((ga == gb) & (ra == rb) & (sa < sb)))

    def merge2(fa, fb):
        n = fa.shape[1]
        ka = tuple(c[:, None] for c in key_fn(fa))
        kb = tuple(c[None, :] for c in key_fn(fb))
        b_before_a = lt(kb, ka)                      # [i, j]: b_j < a_i
        ar = torch.arange(n, dtype=torch.int64, device=fa.device)
        pos_a = ar + b_before_a.sum(1)
        pos_b = ar + (~b_before_a).sum(0)
        # The positions are a permutation of [0, 2n): its inverse names
        # the source row of every merged position.
        src = torch.argsort(torch.cat([pos_a, pos_b]))[:n]
        return torch.cat([fa, fb], dim=1).index_select(1, src)

    level = list(bufs)
    while len(level) > 1:
        nxt = [merge2(level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def localize(slots: torch.Tensor, offset: int, local_capacity: int
             ) -> torch.Tensor:
    """Global slot ids → a shard's local ids; ids of other shards (and
    the sentinels) → the local sentinel ``local_capacity``."""
    local = slots - offset
    mine = (local >= 0) & (local < local_capacity)
    return torch.where(mine, local, local_capacity).to(torch.int32)


class ShardedPool:
    """A sharded device pool: ``shards[i]`` is local shard
    ``local_shards[i]``'s ``kernels.DevicePool`` of ``local_capacity``
    slots (global slots ``[s · local_capacity, (s + 1) · local_capacity)``).
    Read as a mapping, a column is the local shards' columns concatenated
    on the first shard's device (the whole pool on an in-process mesh): a
    copy, for checks and reports."""

    def __init__(self, shards: Sequence[DevicePool], local_shards,
                 local_capacity: int):
        self.shards = list(shards)
        self.local_shards = tuple(local_shards)
        self.local_capacity = local_capacity

    def offsets(self):
        return [s * self.local_capacity for s in self.local_shards]

    def __getitem__(self, name: str) -> torch.Tensor:
        dev = self.shards[0][name].device
        return torch.cat([p[name].to(dev) for p in self.shards])

    def keys(self):
        return self.shards[0].keys()

    def __iter__(self):
        return iter(self.keys())

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def zero_(self) -> None:
        """Every column of every shard zeroed in place (every slot
        inactive)."""
        for p in self.shards:
            for col in p.full.values():
                col.zero_()


class _ShardedBase:
    """What every sharded kernel set shares: the mesh, the slice geometry
    and the pool I/O (``fresh_pool``, ``place_pool``, ``admit_packed``,
    ``evict``), over ``DevicePool`` shards."""

    is_role = False
    extra_pool_fields: dict[str, Any] = {}
    pack_rows = len(PACKED_ROWS) + 1
    admit_fields: tuple[str, ...] = ADMIT_FIELDS

    def _geometry(self, capacity: int, mesh) -> int:
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        if capacity % self.n_shards:
            capacity += self.n_shards - capacity % self.n_shards
        self.capacity = capacity
        self.local_capacity = capacity // self.n_shards
        return capacity

    def _locals(self, pool: ShardedPool, packed: torch.Tensor | None = None):
        """(local pool, global offset, its device's copy of ``packed``)
        per local shard (one copy per other device, none on one)."""
        copies: dict[torch.device, torch.Tensor] = {}
        for lp, off in zip(pool.shards, pool.offsets()):
            pk = None
            if packed is not None:
                dev = lp["active"].device
                pk = copies.get(dev)
                if pk is None:
                    pk = copies[dev] = packed.to(dev, non_blocking=True)
            yield lp, off, pk

    def unpack(self, packed: torch.Tensor) -> dict[str, torch.Tensor]:
        return unpack_batch(packed)

    def fresh_pool(self) -> ShardedPool:
        """An empty pool: one fresh ``DevicePool`` slice per local shard,
        on its device."""
        m = self.mesh
        return ShardedPool(
            [fresh_pool(self.local_capacity, m.devices[i],
                        self.extra_pool_fields)
             for i in range(len(m.local_shards))],
            m.local_shards, self.local_capacity)

    def place_pool(self, arrays: dict[str, np.ndarray]) -> ShardedPool:
        """Global pool arrays (the JAX package's pool dict layout) → each
        local shard's slice on its device."""
        lc, m = self.local_capacity, self.mesh
        shards = []
        for i, s in enumerate(m.local_shards):
            # matchlint: ignore[device] host arrays in, never a step's tensors
            part = {k: np.asarray(v)[s * lc:(s + 1) * lc]
                    for k, v in arrays.items()}
            shards.append(pool_from_reference(part, m.devices[i],
                                              self.extra_pool_fields))
        return ShardedPool(shards, m.local_shards, lc)

    def admit_packed(self, pool: ShardedPool, packed: torch.Tensor) -> None:
        """Admit a packed window without matching: each shard its slice."""
        for lp, off, pk in self._locals(pool, packed):
            batch = self.unpack(pk)
            admit(lp, dict(batch, slot=localize(batch["slot"], off,
                                                self.local_capacity)),
                  self.admit_fields)

    def evict(self, pool: ShardedPool, slots: torch.Tensor) -> None:
        """Clear globally numbered ``slots`` (sentinels ≥ capacity are
        padding): each shard its own."""
        for lp, off, _ in self._locals(pool):
            evict(lp, localize(slots.reshape(-1).to(lp["active"].device,
                                                    non_blocking=True),
                               off, self.local_capacity))


class ShardedKernelSet(_ShardedBase):
    """The sharded 1v1 step; the call surface of ``KernelSet``
    (``search_step_packed``, ``search_step_packed_rescan``,
    ``admit_packed``, ``evict``) over a ``ShardedPool``.

    Capacity rounds up to a multiple of D. The local set's block width is
    derived from the GLOBAL capacity (``effective_pool_block``) and kept
    (``exact_block``): identical block boundaries are what make the sharded
    and dense candidate lists, and so the pairs, identical. Where the
    global block is wider than a shard's slice, blocks shrink to the slice
    and the candidate lists (not the best candidate) may differ.

    ``bucket_frontier_k`` > 0 (the ladder's ceiling) enables
    ``bucket_step(k)`` for frontier widths up to it."""

    def __init__(self, *, capacity: int, top_k: int, pool_block: int,
                 glicko2: bool, widen_per_sec: float, max_threshold: float,
                 mesh, ring: bool = False, pair_rounds: int = 8,
                 bucket_frontier_k: int = 0):
        capacity = self._geometry(capacity, mesh)
        self.ring = ring
        self.pair_rounds = pair_rounds
        global_block = effective_pool_block(capacity, pool_block, top_k)
        self.local = KernelSet(
            capacity=self.local_capacity, top_k=top_k,
            pool_block=min(global_block, self.local_capacity),
            glicko2=glicko2, widen_per_sec=widen_per_sec,
            max_threshold=max_threshold, pair_rounds=pair_rounds,
            exact_block=True)
        self.glicko2 = glicko2
        self.widen_per_sec = widen_per_sec
        self.max_threshold = max_threshold
        self.pool_block = self.local.pool_block
        self.local_blocks = self.local.n_blocks
        self.global_blocks = self.n_shards * self.local_blocks
        self.bucket_frontier_k = (min(max(1, bucket_frontier_k),
                                      self.pool_block)
                                  if bucket_frontier_k > 0 else 0)
        if self.bucket_frontier_k and capacity >= (1 << 24):
            raise ValueError(f"capacity {capacity} >= 2**24: frontier slot "
                             f"ids must stay f32-exact")
        self._bucket_steps: dict[int, Any] = {}

    # ---- the sharded step ---------------------------------------------------

    def _shard_candidates(self, lp, off: int, pk: torch.Tensor,
                          skip_filters: bool, admit_window: bool):
        """One shard: admit its slice of the window (unless a rescan),
        ``block_best`` on its slice with the window's slots shifted by
        −offset (ids of other shards fall outside the slice and never
        self-mask), the kernel's local ids made global. Returns (vals,
        global ids, the lanes whose slot is active here)."""
        lc = self.local_capacity
        batch = unpack_batch(pk)
        now = packed_now(pk)
        local = localize(batch["slot"], off, lc)
        if admit_window:
            admit(lp, dict(batch, slot=local))
        q_thr = effective_threshold(batch["threshold"], batch["enqueue_t"],
                                    now, self.widen_per_sec,
                                    self.max_threshold)
        vals, idxs = self.local.candidates(
            dict(batch, slot=batch["slot"] - off), q_thr, lp, now,
            skip_filters)
        gidx = torch.where(idxs >= lc, self.capacity, idxs + off)
        lane_act = (local < lc) & lp["active"].index_select(
            0, local.clamp(0, lc - 1))
        return vals, gidx.to(torch.int32), lane_act

    def _step(self, pool: ShardedPool, packed: torch.Tensor,
              skip_filters: bool, rescan: bool) -> torch.Tensor:
        parts = [self._shard_candidates(lp, off, pk, skip_filters,
                                        not rescan)
                 for lp, off, pk in self._locals(pool, packed)]
        if not rescan:
            parts = [p[:2] for p in parts]
        gathered = self.mesh.gather(parts, ring=self.ring)
        av, ai = gathered[0], gathered[1]
        n, b, k = av.shape
        mv = av.transpose(0, 1).reshape(b, n * k)
        mi = ai.transpose(0, 1).reshape(b, n * k)
        if rescan:
            # A lane whose player an earlier window matched proposes
            # nothing (the dense rescan's active gate on its row).
            mv = torch.where(gathered[2].any(0)[:, None], mv,
                             float("-inf"))
        slot = unpack_batch(packed)["slot"]
        out_q, out_c, out_d = greedy_pair(mv, mi, slot, self.capacity,
                                          self.pair_rounds)
        self.evict(pool, torch.cat([out_q, out_c]))
        return torch.stack([out_q.to(torch.float32),
                            out_c.to(torch.float32), out_d])

    def search_step_packed(self, pool: ShardedPool, packed: torch.Tensor,
                           skip_filters: bool = False) -> torch.Tensor:
        """One window: f32[9, B] in (now on the device, row 8), f32[3, B]
        (q_slot, c_slot, dist; global slots) out, the shards updated in
        place. ``skip_filters`` as ``KernelSet``'s (exact when every lane
        is the ANY wildcard)."""
        return self._step(pool, packed, skip_filters, rescan=False)

    def search_step_packed_rescan(self, pool: ShardedPool,
                                  packed: torch.Tensor) -> torch.Tensor:
        """The rescan step: nothing admitted, each lane gated by its
        slot's device-side active flag (read on its shard and gathered
        with the candidates), so it is safe with windows in flight. With
        the pool equal to the mirror it is what the JAX package's drained
        re-admitting rescan gives."""
        return self._step(pool, packed, False, rescan=True)

    # ---- the bucket-frontier family -----------------------------------------

    def bucket_step(self, k: int):
        """The bucket-frontier step of frontier width ``k`` (clamped to
        [1, pool_block]): ``search_step_packed``'s call surface, f32[4, B]
        out (row 3 the pool rows each lane's formation scored). Exact only
        while every bucket's live population fits ``k`` rows."""
        k = min(max(1, k), self.pool_block)
        fn = self._bucket_steps.get(k)
        if fn is None:
            fn = self._bucket_steps[k] = functools.partial(
                self._search_step_bucket, k=k)
        return fn

    def _pack_block_frontier(self, lp: DevicePool, off: int, k: int
                             ) -> torch.Tensor:
        """Per local block its first ``k`` rows with active rows first, in
        slot order (a stable sort of the inactive flag): f32[nb_local, 8,
        k] rows (``FRONTIER_FIELDS``, active, global slot; padding rows
        carry the capacity sentinel). A block with ≤ k active rows is
        whole in its frontier."""
        nb, blk = self.local_blocks, self.pool_block
        act = lp["active"].view(nb, blk)
        top = torch.sort((~act).to(torch.uint8), dim=1,
                         stable=True).indices[:, :k]
        rows = [lp[f].view(nb, blk).gather(1, top).to(torch.float32)
                for f in FRONTIER_FIELDS]
        a = act.gather(1, top)
        start = torch.arange(nb, dtype=torch.int64,
                             device=top.device)[:, None] * blk
        gslot = torch.where(a, start + top + off, self.capacity)
        return torch.stack(rows + [a.to(torch.float32),
                                   gslot.to(torch.float32)], dim=1)

    def frontier_pool(self, pool: ShardedPool, k: int):
        """Every shard's block frontiers, gathered by the ring (only
        frontiers cross the shard boundary), as one pool of
        ``global_blocks · k`` rows in blocks of ``k`` (the columns
        ``block_best`` reads) and the rows' global slots (i32)."""
        (buf,) = self.mesh.ring_all_gather(
            [(self._pack_block_frontier(lp, off, k),)
             for lp, off, _ in self._locals(pool)])
        nb_g = self.global_blocks
        rows = buf.reshape(nb_g, 8, k).transpose(0, 1).reshape(8, nb_g * k)
        fpool = {f: rows[i].contiguous() for i, f in
                 enumerate(FRONTIER_FIELDS)}
        fpool["region"] = fpool["region"].to(torch.int32)
        fpool["mode"] = fpool["mode"].to(torch.int32)
        fpool["active"] = rows[6] > 0.5
        return fpool, rows[7].to(torch.int32)

    def frontier_rows(self, gslot: torch.Tensor, slot: torch.Tensor, k: int
                      ) -> torch.Tensor:
        """Each window lane's own row in the frontier pool (its self-mask),
        found among its block's gathered global slots; ``global_blocks ·
        k`` (no row) for a padding lane or one not in the frontier."""
        nb_g = self.global_blocks
        real = slot < self.capacity
        blk = torch.where(real, slot // self.pool_block, 0).long()
        own = (gslot.view(nb_g, k).index_select(0, blk) == slot[:, None]) \
            & real[:, None]
        return torch.where(own.any(1),
                           blk * k + own.to(torch.int32).argmax(1),
                           nb_g * k).to(torch.int32)

    def _search_step_bucket(self, pool: ShardedPool, packed: torch.Tensor,
                            k: int) -> torch.Tensor:
        """Local admits, the frontier pool (``frontier_pool``), then
        ``block_best`` over it in blocks of ``k``: the JAX step's
        per-frontier-block score scan. The kernel's row ids map back to
        global slots (lowest slot on ties: active rows ascend by slot
        within a block). Then pairing and the shards' evictions."""
        lc = self.local_capacity
        for lp, off, pk in self._locals(pool, packed):
            batch = unpack_batch(pk)
            admit(lp, dict(batch, slot=localize(batch["slot"], off, lc)))
        fpool, gslot = self.frontier_pool(pool, k)
        batch = unpack_batch(packed)
        now = packed_now(packed)
        slot = batch["slot"]
        q_thr = effective_threshold(batch["threshold"], batch["enqueue_t"],
                                    now, self.widen_per_sec,
                                    self.max_threshold)
        vals, fidx = cuda_kernels.block_best(
            fpool, dict(batch, slot=self.frontier_rows(gslot, slot, k)),
            q_thr, now, pool_block=k, glicko2=self.glicko2, filters=True,
            widen_per_sec=self.widen_per_sec,
            max_threshold=self.max_threshold, g_coeff=scoring.G_COEFF_F32)
        gs = torch.cat([gslot, gslot.new_full((1,), self.capacity)])
        gidx = torch.where(vals > float("-inf"),
                           gs.index_select(0, fidx.reshape(-1).long())
                           .view(fidx.shape), self.capacity)
        out_q, out_c, out_d = greedy_pair(vals, gidx, slot, self.capacity,
                                          self.pair_rounds)
        self.evict(pool, torch.cat([out_q, out_c]))
        b = slot.shape[0]
        out = torch.empty((4, b), dtype=torch.float32, device=slot.device)
        out[0].copy_(out_q)
        out[1].copy_(out_c)
        out[2].copy_(out_d)
        out[3].fill_(float(min(self.global_blocks * k, self.capacity)))
        return out


def resolve_mesh(n_shards: int, device_ids: tuple | None = None,
                 device="cuda"):
    """The mesh of a sharded kernel set: with a process group joined
    (``distributed.init_distributed``) the process mesh, one shard per
    rank (``n_shards`` must be the world size); else ``pool_mesh``."""
    from matchmaking_tpu_torch.engine import distributed

    if distributed.process_group_active():
        mesh = distributed.global_pool_mesh(device)
        if mesh.n_shards != n_shards:
            raise ValueError(
                f"mesh_pool_axis={n_shards} but the process group has "
                f"{mesh.n_shards} ranks (one shard per rank)")
        return mesh
    return pool_mesh(n_shards, device_ids, device=device)


def sharded_kernel_set(capacity: int, top_k: int, pool_block: int,
                       glicko2: bool, widen_per_sec: float,
                       max_threshold: float, n_shards: int, ring: bool,
                       pair_rounds: int = 8,
                       device_ids: tuple | None = None,
                       bucket_frontier_k: int = 0,
                       device="cuda") -> ShardedKernelSet:
    """The sharded 1v1 kernel set, cached per arguments as the JAX one is
    (over a process group, built anew: the group may be torn down).
    ``device_ids`` names the mesh's devices (ints are card indices; may
    repeat); None takes the first ``n_shards`` (``pool_mesh``)."""
    from matchmaking_tpu_torch.engine import distributed

    if device_ids is not None and len(device_ids) != n_shards:
        raise ValueError(f"device_ids {device_ids} must match "
                         f"n_shards={n_shards}")
    args = (capacity, top_k, pool_block, glicko2, widen_per_sec,
            max_threshold, n_shards, ring, pair_rounds,
            None if device_ids is None else tuple(device_ids),
            bucket_frontier_k, str(device))
    if distributed.process_group_active():
        return _build_sharded(*args)
    return _cached_sharded(*args)


def _build_sharded(capacity, top_k, pool_block, glicko2, widen_per_sec,
                   max_threshold, n_shards, ring, pair_rounds, device_ids,
                   bucket_frontier_k, device) -> ShardedKernelSet:
    return ShardedKernelSet(
        capacity=capacity, top_k=top_k, pool_block=pool_block,
        glicko2=glicko2, widen_per_sec=widen_per_sec,
        max_threshold=max_threshold,
        mesh=resolve_mesh(n_shards, device_ids, device), ring=ring,
        pair_rounds=pair_rounds, bucket_frontier_k=bucket_frontier_k)


_cached_sharded = functools.lru_cache(maxsize=None)(_build_sharded)
