"""The 1v1 window step in PyTorch: admit → block-best → pair → evict.

One call processes a whole request window against the whole pool:

    admission (indexed write of the window's rows into their slots)
    → candidate lists: the best slot per pool block, per request
      (cuda_kernels.block_best: the hand-written kernel on the card)
    → parallel greedy conflict-free pairing (``greedy_pair``)
    → eviction of both sides of every formed pair

The rescan step (``search_step_rescan``) is the same step without the
admission, with each lane's validity gated by its slot's device-side
``active`` flag.

The rating-banded pruned step (``prune_window_blocks`` > 0) sorts the
window by rating, cuts it into chunks, and lets each chunk score only a
span of pool blocks that can hold its candidates, chosen from every
block's live rating bounds; a window whose spans do not fit scores every
block. Both branches are one launch of ``block_best``'s span form, which
reads the choice from the device, so the step never reads it on the host.
The outputs equal the dense step's bit for bit (see ``KernelSet``).

The bucketed step (``bucketed``) is the pruned step with the blocks'
rating bounds kept as state: four per-block columns of the device pool
(``INDEX_FIELDS``), which admission widens, matching and eviction count
down, and ``index_rebuild`` re-tightens with one exact scan (the engine's
heartbeat). It takes no O(P) pass per window, and its rescan twin scores
spans too. Its packed output has a fourth row, the pool slots each lane's
formation scored.

``QualityAccumKernel`` folds each window's matches into a device-resident
quality state (cuda_kernels.QualityAccum: a hand-written kernel on the
card, which reads the window's time from the packed ``now`` row).

Port of ``matchmaking_tpu/engine/kernels.py``'s single-device
``KernelSet`` and ``QualityAccumKernel``. Plain functions on tensors with
an explicit device: the pool is a ``DevicePool``, a dict of 1-D tensors
(``core.pool.POOL_FIELDS``) updated IN PLACE where the JAX code donated its
buffers. Admission, pairing and eviction are plain PyTorch; the JAX code's
scatter-free forms (equality matmuls, compare masks, the pruned step's
one-hot unsort) were TPU workarounds, so the port writes them as the
indexed updates they stand for, with the same results. For the same
reason the JAX pruned step's chunk-local admission (``_admit_chunked``)
has no counterpart: the port's admission writes B lanes by slot, which is
already O(B), and leaves the same pool.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch

from matchmaking_tpu_torch.core.pool import PACKED_ROWS, POOL_FIELDS
from matchmaking_tpu_torch.engine import cuda_kernels, scoring
from matchmaking_tpu_torch.engine.cuda_kernels import Span, effective_threshold

#: Numeric pool fields admitted from a window (active is set separately).
ADMIT_FIELDS = ("rating", "rd", "region", "mode", "threshold", "enqueue_t")

#: The bucket index of a bucketed kernel set: per pool block (= rating
#: bucket under ``band_spec``) its live count, rating bounds and largest
#: rating deviation, as columns of the device pool (the JAX package's
#: ``INDEX_FIELDS``). The bounds only widen between rebuilds, so they
#: always hold the live bounds, which is all the span choice needs.
INDEX_FIELDS = (("bidx_count", np.int32), ("bidx_min", np.float32),
                ("bidx_max", np.float32), ("bidx_rd", np.float32))

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.bool_): torch.bool}


def effective_pool_block(capacity: int, pool_block: int, top_k: int,
                         *, min_blocks: bool = True) -> int:
    """The block width actually used for a pool geometry (identical to the
    JAX engine's, so both build the same candidate lists):

    - it must divide ``capacity`` — rounded down by halving;
    - candidate lists are best-per-block, so small pools split into at
      least ``min(top_k, capacity // 128)`` blocks (each halving re-checks
      divisibility). A shard's local set passes ``min_blocks=False``: its
      block width comes from the global capacity
      (``sharded.ShardedKernelSet``), and a local re-derivation would
      shrink it and part the sharded and dense candidate lists."""
    pool_block = max(1, min(pool_block, capacity))
    while capacity % pool_block != 0:
        pool_block //= 2
    if min_blocks:
        need = min(top_k, max(1, capacity // 128))
        while capacity // pool_block < need and pool_block > 1:
            pool_block //= 2
            while capacity % pool_block != 0:
                pool_block //= 2
    return pool_block


class DevicePool(dict):
    """The device pool: a dict of the ``POOL_FIELDS`` columns (and a kernel
    set's ``extra_pool_fields``), each the first ``capacity`` elements of
    the tensor of the same name in ``full``, which has one spare element
    more. ``admit`` writes padding lanes into
    the spare (index ``capacity``), which no column shows. The bucket
    index's columns have ``n_blocks`` elements and a spare (index
    ``n_blocks``), where the index updates send the padding lanes."""

    def __init__(self, full: dict[str, torch.Tensor]):
        super().__init__((name, t[:-1]) for name, t in full.items())
        self.full = full


def _pool_fields(extra: dict[str, Any] | None
                 ) -> list[tuple[str, Any, int | None]]:
    """(name, numpy dtype, length or None for ``capacity``) of every
    column: ``extra`` maps a name to a dtype or to (dtype, length)."""
    out = [(name, dt, None) for name, dt in POOL_FIELDS]
    for name, spec in (extra or {}).items():
        dt, n = spec if isinstance(spec, tuple) else (spec, None)
        out.append((name, dt, n))
    return out


def fresh_pool(capacity: int, device,
               extra_fields: dict[str, Any] | None = None) -> DevicePool:
    """Empty device pool: every slot inactive, every column zero.
    ``extra_fields`` (name → numpy dtype, or (dtype, length)) adds columns
    beyond ``POOL_FIELDS``, e.g. the role step's ``role_mask`` or the
    bucket index (whose empty state ``KernelSet.index_rebuild`` writes);
    each has the spare element too."""
    return DevicePool({name: torch.zeros((capacity if n is None else n) + 1,
                                         dtype=_TORCH_DTYPE[np.dtype(dt)],
                                         device=device)
                       for name, dt, n in _pool_fields(extra_fields)})


def pool_from_reference(arrays: dict[str, np.ndarray], device,
                        extra_fields: dict[str, Any] | None = None
                        ) -> DevicePool:
    """The JAX package's pool dict (``PlayerPool.empty_device_arrays``
    layout plus a kernel set's ``extra_pool_fields``, fetched with
    ``np.asarray``) → the port's device pool."""
    full = {}
    for name, dt, _ in _pool_fields(extra_fields):
        # matchlint: ignore[device] host arrays in, never a step's tensors
        a = np.asarray(arrays[name], dtype=dt)
        full[name] = torch.zeros(a.shape[0] + 1,
                                 dtype=_TORCH_DTYPE[np.dtype(dt)], device=device)
        full[name][:-1] = torch.from_numpy(a)
    return DevicePool(full)


def pool_to_numpy(pool: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``pool_from_reference`` (host numpy, for comparisons)."""
    # matchlint: ignore[device] a checker's readback, called by no step
    return {name: t.cpu().numpy() for name, t in pool.items()}


def packed_now(packed: torch.Tensor) -> torch.Tensor:
    """The window's time from a packed window: its last row's first
    element, as a one-element f32 view on the window's device (row 8 of
    the 1v1 and team windows, row 9 of the role window; the JAX steps read
    ``packed[8, 0]``). The steps read it there, never as a host float, so
    a step captured into a CUDA graph reads each replay's own time."""
    return packed[-1, :1]


def unpack_batch(packed: torch.Tensor) -> dict[str, torch.Tensor]:
    """f32[9, B] (core.pool.PACKED_ROWS, row 8 = now) → the batch dict."""
    return {
        "slot": packed[0].to(torch.int32),
        "rating": packed[1].contiguous(),
        "rd": packed[2].contiguous(),
        "region": packed[3].to(torch.int32),
        "mode": packed[4].to(torch.int32),
        "threshold": packed[5].contiguous(),
        "enqueue_t": packed[6].contiguous(),
        "valid": packed[7] > 0,
    }


def admit(pool: DevicePool, batch: dict[str, torch.Tensor],
          fields: tuple[str, ...] = ADMIT_FIELDS) -> None:
    """Write ``fields`` of every lane with a real slot (< capacity) into the
    pool, in place, and mark it active (the role step adds ``role_mask``,
    as the JAX ``_admit_block`` takes ``(*_ADMIT_FIELDS, "role_mask")``).
    Like the JAX admission, this goes by slot, not by ``valid``: padding
    lanes carry the sentinel slot ``capacity``.

    No host sync: every lane is written, the padding lanes into the spare
    element past the pool (index ``capacity``), which no view shows. Real
    slots of a window are distinct, so only the spare sees duplicate
    indices, whose last writer does not matter."""
    if not isinstance(pool, DevicePool):
        raise ValueError("admit needs a DevicePool, whose columns have the "
                         "spare element (fresh_pool / pool_from_reference)")
    capacity = pool["rating"].shape[0]
    idx = torch.where(batch["slot"] < capacity, batch["slot"], capacity).long()
    for f in fields:
        pool.full[f].index_put_((idx,), batch[f].to(pool[f].dtype))
    pool.full["active"].index_fill_(0, idx, True)


def evict(pool: dict[str, torch.Tensor], slots: torch.Tensor) -> None:
    """Mark ``slots`` inactive, in place; entries ≥ capacity are padding.
    The sentinel lands in a spare last element of a scratch mask, so no
    host round trip is needed to drop it. (``index_fill_`` with a Python
    scalar, where ``t[idx] = True`` would copy the scalar from the host.)"""
    capacity = pool["active"].shape[0]
    hit = torch.zeros(capacity + 1, dtype=torch.bool, device=slots.device)
    hit.index_fill_(0, slots.long().clamp(0, capacity), True)
    pool["active"] &= ~hit[:capacity]


def greedy_pair(vals, idxs, self_slot, capacity: int, rounds: int = 8,
                rid=None):
    """Parallel greedy conflict-free pairing over (B, K) candidate lists.

    Each round: every live request proposes its best remaining candidate;
    a proposal survives iff no conflicting proposal (sharing an endpoint
    slot) is better (higher score, ties to the lower ``rid``); winners
    retire both endpoint slots and losers propose again next round.

    All ``rounds`` run, with no per-round host read: the JAX loop stops
    early once no live proposal remains, and a round without one changes
    nothing, so the outputs are the same. Retired slots are marked in a
    (capacity + 1) scratch mask; the JAX code's (B, K, B) compares against
    the winner lists mark exactly the same candidates (including the
    sentinel ``capacity`` that losers carry).

    Returns (q_slot i32[B], c_slot i32[B], dist f32[B]); unmatched lanes
    hold ``capacity`` / +inf."""
    b, _ = vals.shape
    dev = vals.device
    # Device scalars made by a fill, not copied from the host (no sync).
    neg_inf = torch.full((), float("-inf"), dtype=vals.dtype, device=dev)
    cap = torch.full((), capacity, dtype=torch.int32, device=dev)
    if rid is None:
        rid = torch.arange(b, dtype=torch.int32, device=dev)
    s = self_slot
    not_diag = ~torch.eye(b, dtype=torch.bool, device=dev)
    same_row = s[:, None] == s[None, :]
    row_dead = torch.zeros(b, dtype=torch.bool, device=dev)
    cand_dead = torch.zeros(vals.shape, dtype=torch.bool, device=dev)
    out_q = torch.full((b,), capacity, dtype=torch.int32, device=dev)
    out_c = torch.full((b,), capacity, dtype=torch.int32, device=dev)
    out_d = torch.full((b,), float("inf"), dtype=vals.dtype, device=dev)
    for _ in range(rounds):
        masked = torch.where(cand_dead | row_dead[:, None], neg_inf, vals)
        bj = masked.argmax(dim=1, keepdim=True)
        bv = masked.gather(1, bj)[:, 0]
        bc = idxs.gather(1, bj)[:, 0]
        live = bv > neg_inf
        conflict = ((same_row | (s[:, None] == bc[None, :])
                     | (bc[:, None] == s[None, :])
                     | (bc[:, None] == bc[None, :]))
                    & live[None, :] & live[:, None] & not_diag)
        better = (bv[None, :] > bv[:, None]) | (
            (bv[None, :] == bv[:, None]) & (rid[None, :] < rid[:, None]))
        win = live & ~(conflict & better).any(dim=1)
        out_q = torch.where(win, s, out_q)
        out_c = torch.where(win, bc, out_c)
        out_d = torch.where(win, -bv, out_d)
        retired = torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
        retired.index_fill_(0, torch.where(win, s, cap).long()
                            .clamp(0, capacity), True)
        retired.index_fill_(0, torch.where(win, bc, cap).long()
                            .clamp(0, capacity), True)
        cand_dead = cand_dead | retired[idxs.long().clamp(0, capacity)]
        row_dead = row_dead | retired[s.long().clamp(0, capacity)]
    return out_q, out_c, out_d


class KernelSet:
    """The window step for one (pool geometry × queue config).

    With ``prune_window_blocks`` W > 0 (clamped to the block count) the
    traffic steps take the pruned form (``_search_step_pruned``): the
    window is sorted by rating (padding last, original lanes kept for the
    pairing's tie-break and the unsort), cut into chunks of
    ``prune_chunk`` rows, and each chunk scores only the W-block span of
    the pool whose live rating bounds, widened by the chunk's largest
    reach, meet the chunk's rating interval. A block outside that span
    holds no admissible candidate for the chunk (the reach is inflated
    past f32 rounding), so the dense scan would find -inf there too: the
    candidate lists are the dense step's, and so are the pairs. Where a
    chunk's span is wider than W, the whole window scores every block.
    Rescans of a pruned set stay dense.

    With ``bucketed`` the blocks' bounds come from the bucket index in the
    pool (``INDEX_FIELDS``, an ``extra_pool_fields`` of this set) instead
    of a scan of the pool: admission widens them by the window's own
    per-block bounds, so they hold the post-admission live bounds, and a
    wider bound only widens a span, which keeps the dense step's result.
    Every traffic and rescan step, ``admit_packed`` and ``evict`` keep the
    index's counts exact; ``index_rebuild`` re-tightens the bounds. The
    rescan step scores spans too, from the index alone. The packed steps
    return f32[4, B]: the flat step's three rows, then the pool slots each
    lane scored (``W · pool_block`` on the span path, ``capacity`` on the
    fallback). W defaults to a quarter of the blocks (at least 2).

    ``exact_block`` takes ``pool_block`` as it is (only rounded down to a
    divisor of the capacity): a shard's local set, whose width the global
    geometry fixed."""

    is_role = False
    #: Device pool columns beyond ``POOL_FIELDS`` (a bucketed set's index).
    extra_pool_fields: dict[str, Any] = {}
    #: Rows of the packed window: ``PACKED_ROWS`` + now.
    pack_rows = len(PACKED_ROWS) + 1

    def __init__(self, *, capacity: int, top_k: int, pool_block: int,
                 glicko2: bool, widen_per_sec: float, max_threshold: float,
                 pair_rounds: int = 8, prune_window_blocks: int = 0,
                 prune_chunk: int = 128, bucketed: bool = False,
                 exact_block: bool = False):
        pool_block = effective_pool_block(capacity, pool_block, top_k,
                                          min_blocks=not exact_block)
        self.capacity = capacity
        self.pool_block = pool_block
        self.n_blocks = capacity // pool_block
        self.glicko2 = glicko2
        self.widen_per_sec = widen_per_sec
        self.max_threshold = max_threshold
        self.pair_rounds = pair_rounds
        self.bucketed = bucketed
        if bucketed:
            if prune_window_blocks <= 0:
                prune_window_blocks = max(2, self.n_blocks // 4)
            self.extra_pool_fields = {name: (dt, self.n_blocks)
                                      for name, dt in INDEX_FIELDS}
        self.prune_window_blocks = min(max(0, prune_window_blocks),
                                       self.n_blocks)
        self.prune_chunk = max(1, prune_chunk)
        #: Pruned (or bucketed) traffic steps run, and (a device i32[1]
        #: counter, made on the first such step) how many of them took the
        #: span path: the step adds its feasibility flag on the device, so
        #: reading the count is one host sync, at the caller's choice.
        self.pruned_steps = 0
        self.span_steps: torch.Tensor | None = None

    @contextlib.contextmanager
    def uncounted(self):
        """Steps run inside count in neither ``pruned_steps`` nor
        ``span_steps`` (a warm-up's all-padding windows are not windows).
        The device counter is put back in place, on the current stream, so
        a step captured inside keeps its address."""
        steps = self.pruned_steps
        span = None if self.span_steps is None else self.span_steps.clone()
        try:
            yield
        finally:
            self.pruned_steps = steps
            if self.span_steps is not None:
                if span is None:
                    self.span_steps.zero_()
                else:
                    self.span_steps.copy_(span)

    def candidates(self, batch: dict[str, Any], q_thr_eff,
                   pool: dict[str, Any], now: torch.Tensor,
                   skip_filters: bool = False, span: Span | None = None):
        """Best-per-block candidate lists (vals f32[B, n_blocks], idx
        i32[B, n_blocks]) — the hand-written kernel on CUDA tensors.
        ``skip_filters`` drops the region/mode tests, which is exact when
        every window lane carries the ANY wildcard (code 0); ``span`` is
        the pruned step's span launch."""
        return cuda_kernels.block_best(
            pool, batch, q_thr_eff, now, pool_block=self.pool_block,
            glicko2=self.glicko2, filters=not skip_filters,
            widen_per_sec=self.widen_per_sec,
            max_threshold=self.max_threshold,
            g_coeff=scoring.G_COEFF_F32, span=span)

    def search_step(self, pool: dict[str, Any], batch: dict[str, Any],
                    now: torch.Tensor, skip_filters: bool = False):
        """One window: admit → block-best → pair → evict matched, with
        the pool updated in place, at the window's time ``now`` (a
        one-element f32 tensor on the pool's device: ``packed_now``).
        Returns (q_slot[B], c_slot[B], dist[B]) with sentinel
        ``capacity`` / +inf in unmatched lanes."""
        if self.bucketed:
            order = _rating_order(batch["valid"], batch["rating"])
            sb = {k: v.index_select(0, order) for k, v in batch.items()}
            *outs, _ = self._search_step_bucketed(pool, sb, order, now,
                                                  skip_filters)
            return tuple(torch.empty_like(o).index_copy_(0, order, o)
                         for o in outs)
        if self.prune_window_blocks:
            order = _rating_order(batch["valid"], batch["rating"])
            sb = {k: v.index_select(0, order) for k, v in batch.items()}
            outs = self._search_step_pruned(pool, sb, order, now, skip_filters)
            return tuple(torch.empty_like(o).index_copy_(0, order, o)
                         for o in outs)
        q_thr_eff = effective_threshold(batch["threshold"], batch["enqueue_t"],
                                        now, self.widen_per_sec,
                                        self.max_threshold)
        admit(pool, batch)
        vals, idxs = self.candidates(batch, q_thr_eff, pool, now,
                                     skip_filters)
        out_q, out_c, out_d = greedy_pair(vals, idxs, batch["slot"],
                                          self.capacity, self.pair_rounds)
        evict(pool, torch.cat([out_q, out_c]))
        return out_q, out_c, out_d

    def search_step_packed(self, pool: dict[str, Any], packed: torch.Tensor,
                           skip_filters: bool = False):
        """Packed window step: f32[9, B] in (``now`` read on the device from
        row 8: ``packed_now``), f32[3, B] (q_slot, c_slot, dist) out — slot
        ids ≪ 2^24 are f32-exact. The pruned form sorts the packed window
        with one gather and unsorts the packed result with one indexed
        copy; the bucketed form adds the touched row (f32[4, B] out)."""
        now = packed_now(packed)
        if self.bucketed:
            order = _rating_order(packed[7] > 0, packed[1])
            *outs, touched = self._search_step_bucketed(
                pool, unpack_batch(packed.index_select(1, order)), order,
                now, skip_filters)
            return _pack_bucketed(order, outs, touched)
        if self.prune_window_blocks:
            order = _rating_order(packed[7] > 0, packed[1])
            outs = self._search_step_pruned(
                pool, unpack_batch(packed.index_select(1, order)), order,
                now, skip_filters)
            return torch.empty_like(packed[:3]).index_copy_(
                1, order, _stack_out(*outs))
        return _stack_out(*self.search_step(pool, unpack_batch(packed), now,
                                            skip_filters))

    def search_step_rescan(self, pool: dict[str, Any],
                           batch: dict[str, Any], now: torch.Tensor):
        """No-admission window step for rescans: nothing is admitted, and
        each lane's validity is ANDed with the device-side ``active`` flag
        of its own slot (a gather, no host read). A lane built from a host
        mirror that lags the device — a player an in-flight window already
        matched and evicted — is then a no-op, which is what makes a rescan
        safe to dispatch with windows in flight, and to split into chunks
        (a later chunk cannot re-match players an earlier one retired).
        Scoring, pairing and eviction are the full-filter dense step's (a
        bucketed set's: its rescan over spans, ``_rescan_step_bucketed``)."""
        batch = self._gate_active(pool, batch)
        if self.bucketed:
            order = _rating_order(batch["valid"], batch["rating"])
            sb = {k: v.index_select(0, order) for k, v in batch.items()}
            *outs, _ = self._rescan_step_bucketed(pool, sb, order, now)
            return tuple(torch.empty_like(o).index_copy_(0, order, o)
                         for o in outs)
        q_thr_eff = effective_threshold(batch["threshold"], batch["enqueue_t"],
                                        now, self.widen_per_sec,
                                        self.max_threshold)
        vals, idxs = self.candidates(batch, q_thr_eff, pool, now)
        out_q, out_c, out_d = greedy_pair(vals, idxs, batch["slot"],
                                          self.capacity, self.pair_rounds)
        evict(pool, torch.cat([out_q, out_c]))
        return out_q, out_c, out_d

    def search_step_packed_rescan(self, pool: dict[str, Any],
                                  packed: torch.Tensor):
        """Packed-I/O twin of ``search_step_rescan`` (the layout of
        ``search_step_packed``; f32[4, B] for a bucketed set)."""
        now = packed_now(packed)
        if self.bucketed:
            batch = self._gate_active(pool, unpack_batch(packed))
            order = _rating_order(batch["valid"], batch["rating"])
            sb = {k: v.index_select(0, order) for k, v in batch.items()}
            *outs, touched = self._rescan_step_bucketed(pool, sb, order, now)
            return _pack_bucketed(order, outs, touched)
        return _stack_out(*self.search_step_rescan(
            pool, unpack_batch(packed), now))

    def _gate_active(self, pool: dict[str, Any],
                     batch: dict[str, Any]) -> dict[str, Any]:
        """A rescan window with each lane's validity ANDed with its slot's
        device-side ``active`` flag."""
        lane_act = pool["active"].index_select(
            0, batch["slot"].long().clamp(0, self.capacity - 1))
        return dict(batch, valid=batch["valid"] & lane_act)

    def admit_packed(self, pool: dict[str, Any], packed: torch.Tensor) -> None:
        """Admit a packed window without matching (restores); a bucketed
        set's index counts it and widens its bounds."""
        batch = unpack_batch(packed)
        admit(pool, batch)
        if self.bucketed:
            self._index_admit(pool, batch)

    def evict(self, pool: dict[str, Any], slots: torch.Tensor) -> None:
        """Clear ``slots`` (sentinels ≥ capacity are padding), in place. A
        bucketed set counts down only the slots that were active when
        called, so a slot evicted twice counts once (the JAX
        ``_evict_indexed``); bounds stay as they are."""
        if not self.bucketed:
            evict(pool, slots)
            return
        live_now = pool["active"].index_select(
            0, slots.long().clamp(0, self.capacity - 1)) & (slots < self.capacity)
        live = torch.where(live_now, slots, self.capacity)
        evict(pool, slots)
        self._index_release(pool, live)

    # ---- the bucket index ----------------------------------------------------

    def _block_of(self, slots: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
        """Each slot's pool block where ``hit``, else the index columns'
        spare element ``n_blocks`` (i64, for the indexed updates)."""
        return torch.where(hit, slots // self.pool_block, self.n_blocks).long()

    def _index_admit(self, pool: DevicePool, batch: dict[str, Any]) -> None:
        """Count a window's valid lanes into their blocks and widen the
        blocks' bounds by the lanes' ratings and rating deviations, in
        place (indexed adds and min/max scatters: no host read, no
        ``bincount``). The JAX ``_incoming_stats`` merge: the same bounds."""
        hit = batch["valid"] & (batch["slot"] < self.capacity)
        blk = self._block_of(batch["slot"], hit)
        full = pool.full
        full["bidx_count"].index_add_(0, blk, hit.to(torch.int32))
        full["bidx_min"].scatter_reduce_(0, blk, batch["rating"], "amin")
        full["bidx_max"].scatter_reduce_(0, blk, batch["rating"], "amax")
        full["bidx_rd"].scatter_reduce_(0, blk, batch["rd"], "amax")

    def _index_release(self, pool: DevicePool, slots: torch.Tensor) -> None:
        """Count ``slots`` (< capacity; sentinels skipped) out of their
        blocks, in place. Bounds stay: they only re-tighten at a
        rebuild."""
        hit = slots < self.capacity
        pool.full["bidx_count"].index_add_(0, self._block_of(slots, hit),
                                           hit.to(torch.int32), alpha=-1)

    def index_rebuild(self, pool: DevicePool) -> None:
        """The exact index of the pool, written in place (the addresses a
        captured step holds stay): per block the active count, the live
        rating bounds (+inf / -inf when empty) and the largest live rating
        deviation (0 when empty), kept for ELO too. One O(P) pass, off
        the window path: the engine's heartbeat, and a fresh pool's empty
        index."""
        shape = (self.n_blocks, self.pool_block)
        act = pool["active"].view(shape)
        r = pool["rating"].view(shape)
        inf = float("inf")
        pool["bidx_count"].copy_(act.sum(1, dtype=torch.int32))
        pool["bidx_min"].copy_(torch.where(act, r, inf).amin(1))
        pool["bidx_max"].copy_(torch.where(act, r, -inf).amax(1))
        pool["bidx_rd"].copy_(torch.where(act, pool["rd"].view(shape),
                                          0.0).amax(1))

    # ---- the rating-banded pruned step ----------------------------------

    def _search_step_pruned(self, pool: dict[str, Any], sb: dict[str, Any],
                            order: torch.Tensor, now: torch.Tensor,
                            skip_filters: bool = False):
        """The pruned step on a window sorted by ``_rating_order``
        (``order[k]`` is sorted lane k's original lane): admit, the blocks'
        bounds, the chunks' spans, the span launch, pairing with the
        original lanes as tie-break, eviction. Returns the sorted lanes'
        (q_slot, c_slot, dist). Nothing is read on the host: the dense
        fallback is the span launch's own device flag."""
        q_thr_eff = effective_threshold(sb["threshold"], sb["enqueue_t"], now,
                                        self.widen_per_sec, self.max_threshold)
        admit(pool, sb)
        bmin, bmax, brd = self._live_stats(pool)
        dstart, feasible = self._chunk_windows(sb, q_thr_eff, bmin, bmax, brd)
        if self.span_steps is None:
            self.span_steps = torch.zeros(1, dtype=torch.int32,
                                          device=feasible.device)
        self.span_steps += feasible
        self.pruned_steps += 1
        span = Span(dstart, self._chunk_size(sb["rating"].shape[0]),
                    self.prune_window_blocks, feasible.reshape(1))
        vals, idxs = self.candidates(sb, q_thr_eff, pool, now, skip_filters,
                                     span)
        s_q, s_c, s_d = greedy_pair(vals, idxs, sb["slot"], self.capacity,
                                    self.pair_rounds,
                                    rid=order.to(torch.int32))
        evict(pool, torch.cat([s_q, s_c]))
        return s_q, s_c, s_d

    # ---- the bucketed steps ------------------------------------------------

    def _span_launch(self, sb: dict[str, Any], q_thr_eff, bmin, bmax, brd,
                     count: bool):
        """The chunks' spans from the blocks' bounds, as a span launch's
        arguments, and the window's touched row: ``W · pool_block`` pool
        slots per lane on the span path, ``capacity`` on the fallback
        (f32[1], read from the device flag). ``count`` adds the step to
        the pruned counts (traffic steps)."""
        dstart, feasible = self._chunk_windows(sb, q_thr_eff, bmin, bmax, brd)
        if count:
            if self.span_steps is None:
                self.span_steps = torch.zeros(1, dtype=torch.int32,
                                              device=feasible.device)
            self.span_steps += feasible
            self.pruned_steps += 1
        span = Span(dstart, self._chunk_size(sb["rating"].shape[0]),
                    self.prune_window_blocks, feasible.reshape(1))
        per_lane = float(min(self.prune_window_blocks * self.pool_block,
                             self.capacity))
        touched = torch.where(span.feasible, per_lane, float(self.capacity))
        return span, touched

    def _search_step_bucketed(self, pool: DevicePool, sb: dict[str, Any],
                              order: torch.Tensor, now: torch.Tensor,
                              skip_filters: bool = False):
        """The bucketed traffic step on a window sorted by
        ``_rating_order``: admit the whole window (the pool the JAX
        ``_admit_chunked`` leaves), count it into the index and widen the
        bounds (the JAX merge of the index with ``_incoming_stats``), the
        spans from the index, the span launch (its own dense fallback),
        pairing with the original lanes as tie-break, the matched slots
        counted out of the index, eviction. Plain ``evict`` stands in for
        the JAX ``_evict_spans``: every matched slot lies in a span, so the
        pool after is the same. Returns the sorted lanes' (q_slot, c_slot,
        dist) and the touched row."""
        q_thr_eff = effective_threshold(sb["threshold"], sb["enqueue_t"], now,
                                        self.widen_per_sec, self.max_threshold)
        admit(pool, sb)
        self._index_admit(pool, sb)
        span, touched = self._span_launch(
            sb, q_thr_eff, pool["bidx_min"], pool["bidx_max"],
            pool["bidx_rd"], count=True)
        vals, idxs = self.candidates(sb, q_thr_eff, pool, now, skip_filters,
                                     span)
        s_q, s_c, s_d = greedy_pair(vals, idxs, sb["slot"], self.capacity,
                                    self.pair_rounds,
                                    rid=order.to(torch.int32))
        matched = torch.cat([s_q, s_c])
        self._index_release(pool, matched)
        evict(pool, matched)
        return s_q, s_c, s_d, touched

    def _rescan_step_bucketed(self, pool: DevicePool, sb: dict[str, Any],
                              order: torch.Tensor, now: torch.Tensor):
        """The bucketed rescan on a gated window sorted by
        ``_rating_order``: nothing is admitted, the spans come from the
        index alone (every live lane is in the pool, so the index bounds
        cover it), the span launch with every filter, pairing with the
        original lanes as tie-break, and only the matched slots leave the
        index. Returns what ``_search_step_bucketed`` returns."""
        q_thr_eff = effective_threshold(sb["threshold"], sb["enqueue_t"], now,
                                        self.widen_per_sec, self.max_threshold)
        span, touched = self._span_launch(
            sb, q_thr_eff, pool["bidx_min"], pool["bidx_max"],
            pool["bidx_rd"], count=False)
        vals, idxs = self.candidates(sb, q_thr_eff, pool, now, span=span)
        s_q, s_c, s_d = greedy_pair(vals, idxs, sb["slot"], self.capacity,
                                    self.pair_rounds,
                                    rid=order.to(torch.int32))
        matched = torch.cat([s_q, s_c])
        self._index_release(pool, matched)
        evict(pool, matched)
        return s_q, s_c, s_d, touched

    def _live_stats(self, pool: dict[str, Any]):
        """Per-block rating bounds of the pool: (min_r, max_r, max_rd)
        f32[n_blocks] over active slots (max_rd for Glicko-2 only, else
        None); an empty block has (+inf, -inf), which no overlap test
        selects. One masked reduction over a (n_blocks, pool_block) view
        per bound.

        The pruned step takes them AFTER admission, where the JAX step
        merges the pre-admission pool's bounds with the window's own per
        block (``_incoming_stats``): admitted slots were inactive and hold
        exactly the window's valid lanes, so the two are equal."""
        shape = (self.n_blocks, self.pool_block)
        act = pool["active"].view(shape)
        r = pool["rating"].view(shape)
        inf = float("inf")
        maxrd = (torch.where(act, pool["rd"].view(shape), 0.0).amax(1)
                 if self.glicko2 else None)
        return (torch.where(act, r, inf).amin(1),
                torch.where(act, r, -inf).amax(1), maxrd)

    def _chunk_size(self, b: int) -> int:
        c = max(1, min(self.prune_chunk, b))
        while b % c:
            c //= 2
        return c

    def _chunk_windows(self, sb: dict[str, Any], q_thr_eff, bmin, bmax, brd):
        """Per-chunk span starts i32[n_chunks] and the window's
        feasibility (a 0-dim bool tensor), on the device.

        A (chunk, block) pair can hold an admissible edge only if the
        block's live rating interval, widened by the chunk's reach E,
        meets the chunk's rating interval: E = the chunk's largest
        effective threshold (ELO), or that over g(max rd of the chunk, max
        rd of the block) (Glicko-2: g ≤ 1 falls with rd, so it bounds
        every pair's g). The 0.1 % + 0.5 inflation swamps f32 rounding in
        the kernel's distance. Chunks with no valid lane park on the first
        busy chunk's span (their rows score -inf wherever they point)."""
        b = sb["rating"].shape[0]
        c = self._chunk_size(b)
        n_chunks = b // c
        nb, w = self.n_blocks, self.prune_window_blocks
        inf = float("inf")
        v = sb["valid"].view(n_chunks, c)
        r = sb["rating"].view(n_chunks, c)
        cmin = torch.where(v, r, inf).amin(1)
        cmax = torch.where(v, r, -inf).amax(1)
        cthr = torch.where(v, q_thr_eff.view(n_chunks, c), 0.0).amax(1)
        if self.glicko2:
            crd = torch.where(v, sb["rd"].view(n_chunks, c), 0.0).amax(1)
            rd2 = (crd * crd)[:, None] + (brd * brd)[None, :]
            g = 1.0 / torch.sqrt(1.0 + scoring.G_COEFF_F32 * rd2)
            reach = cthr[:, None] / g.clamp_min(cuda_kernels._f32(1e-6))
        else:
            reach = cthr[:, None]
        reach = (reach * cuda_kernels._f32(1.001) + 0.5).expand(n_chunks, nb)
        ov = ((bmin[None, :] - reach <= cmax[:, None])
              & (bmax[None, :] + reach >= cmin[:, None]))
        idx = torch.arange(nb, dtype=torch.int32, device=ov.device)
        first = torch.where(ov, idx, nb).amin(1)
        last = torch.where(ov, idx, -1).amax(1)
        width = (last - first + 1).clamp_min(0)
        feasible = (width <= w).all()
        dstart = first.clamp(0, nb - w)
        busy = width > 0
        common = dstart.gather(0, busy.to(torch.int32).argmax().reshape(1))
        dstart = torch.where(busy, dstart,
                             torch.where(busy.any(), common, 0))
        return dstart.to(torch.int32), feasible


def _rating_order(valid, rating) -> torch.Tensor:
    """The pruned step's window order: a stable sort by rating, padding
    lanes (rating key +inf) last. Stable, as the JAX ``lax.sort`` is (CUDA's
    default sort is not)."""
    key = torch.where(valid, rating, float("inf"))
    return torch.sort(key, stable=True).indices


def _stack_out(out_q, out_c, out_d) -> torch.Tensor:
    return torch.stack([out_q.to(torch.float32), out_c.to(torch.float32),
                        out_d])


def _pack_bucketed(order: torch.Tensor, outs, touched: torch.Tensor
                   ) -> torch.Tensor:
    """A bucketed step's packed result, f32[4, B]: rows 0-2 the sorted
    lanes' (q_slot, c_slot, dist) back in the window's order, byte for
    byte the flat packed step's; row 3 the touched count in every lane."""
    b = order.shape[0]
    out = torch.empty((4, b), dtype=torch.float32, device=order.device)
    out[:3].index_copy_(1, order, _stack_out(*outs))
    out[3:].copy_(touched.reshape(1, 1).expand(1, b))
    return out


class QualityState(dict):
    """The device quality state: ``cuda_kernels.QUALITY_FIELDS`` shaped by
    the edges, each a view into one flat i32 buffer ``flat`` (the sums as
    f32 views of theirs), so that one copy reads it all back."""

    def __init__(self, flat: torch.Tensor, shapes: dict[str, tuple[int, ...]]):
        views, at = {}, 0
        for name, dtype in cuda_kernels.QUALITY_FIELDS:
            n = int(np.prod(shapes[name]))
            views[name] = flat[at:at + n].view(dtype).view(shapes[name])
            at += n
        super().__init__(views)
        self.flat = flat


class QualityAccumKernel:
    """Device-resident match-quality/wait accumulator of a 1v1 queue.

    One ``accum`` per window step folds the step's own result ``(q_slot,
    c_slot, dist)`` into per-rating-bucket histograms, counts and sums,
    in place on the device: one launch of the ``quality_accum`` kernel,
    no host read. The matched slots' rating/enqueue/threshold come from
    the POST-step pool: eviction clears only ``active``, so the columns
    still hold the matched players' values.

    The bucket rules are engine/quality.QualitySpec's, on the f32 edges
    (``rating_edges`` / ``wait_edges`` rounded to f32, as the JAX step
    takes them)."""

    def __init__(self, *, capacity: int, widen_per_sec: float,
                 max_threshold: float, rating_edges, n_quality: int,
                 wait_edges):
        self.capacity = capacity
        self.widen_per_sec = widen_per_sec
        self.max_threshold = max_threshold
        self.rating_edges = tuple(float(e) for e in
                                  np.asarray(rating_edges, np.float32))
        self.wait_edges = tuple(float(e) for e in
                                np.asarray(wait_edges, np.float32))
        self.n_rating = len(self.rating_edges) + 1
        self.n_quality = n_quality
        self.n_wait = len(self.wait_edges) + 1  # + overflow
        r = self.n_rating
        self.shapes = {"q_hist": (r, n_quality), "w_hist": (r, self.n_wait),
                       "count": (r,), "q_sum": (r,), "w_sum": (r,),
                       "d_sum": (r,)}
        self.size = sum(int(np.prod(v)) for v in self.shapes.values())
        #: The launch bound to the last state and pool columns accumulated.
        self._bound: cuda_kernels.QualityAccum | None = None

    def init_state(self, device) -> QualityState:
        return QualityState(torch.zeros(self.size, dtype=torch.int32,
                                        device=device), self.shapes)

    def accum(self, state: QualityState, pool: dict[str, torch.Tensor],
              out: torch.Tensor, now) -> None:
        """Fold one window result (f32[3, B]) into ``state``, in place, at
        the window's device time ``now``: the packed window's ``now`` row
        (a f32 tensor on the state's device; on the CPU also a float). The
        launch is bound to ``state`` and the pool's columns, and bound
        again, with every check, whenever they are other tensors (revive,
        restore and re-promotion build a fresh pool)."""
        cols = (pool["rating"], pool["enqueue_t"], pool["threshold"])
        bound = self._bound
        if (bound is None or bound.state is not state
                or any(a is not b for a, b in zip(bound.columns, cols))):
            self._bound = bound = cuda_kernels.QualityAccum(
                state, *cols, capacity=self.capacity,
                widen_per_sec=self.widen_per_sec,
                max_threshold=self.max_threshold,
                rating_edges=self.rating_edges, n_quality=self.n_quality,
                wait_edges=self.wait_edges)
        bound(out, now)

    def arrays(self, flat: np.ndarray) -> dict[str, np.ndarray]:
        """A host copy of ``state.flat`` → the state's numpy arrays."""
        out, at = {}, 0
        for name, dtype in cuda_kernels.QUALITY_FIELDS:
            n = int(np.prod(self.shapes[name]))
            part = flat[at:at + n]
            if dtype == torch.float32:
                part = part.view(np.float32)
            out[name] = part.reshape(self.shapes[name]).copy()
            at += n
        return out
