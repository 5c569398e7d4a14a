"""The GPU engine: batched window matching over a device-resident pool.

Port of the object path of ``matchmaking_tpu/engine/tpu.py``'s 1v1
``TpuEngine``. A window of requests is admitted into the device pool and
matched by one window step (engine/kernels.py, whose candidate stage is
the hand-written ``block_best`` kernel on the card).

Host/device split:

- Host (this class): slot allocation and the request mirror (= the
  checkpoint), padding windows to batch buckets, mapping matched slot pairs
  back to requests. Single writer — callers serialize windows per queue, so
  a matched player leaves the pool before the next window is dispatched.
- Device: the pool tensors (updated in place) and the window step.

Synchronous: each window chunk (≤ the largest bucket) runs its step and
reads its f32[3, B] result back once. All chunks of a window are
dispatched before any is finalized, as the JAX engine does, so slot
allocation — and with it every candidate list — is the same on both.

Runs on ``device`` (default ``"cuda"``, which must exist); ``device="cpu"``
runs the plain PyTorch versions of the kernels instead.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from matchmaking_tpu_torch.config import Config, QueueConfig
from matchmaking_tpu_torch.core.pool import PlayerPool, pack_batch
from matchmaking_tpu_torch.engine import kernels, scoring
from matchmaking_tpu_torch.engine.interface import Engine, Match, SearchOutcome
from matchmaking_tpu_torch.service.contract import SearchRequest, new_match_id


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means the card. A CUDA device
    on a machine without CUDA raises instead of running elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "GpuEngine needs a CUDA device and torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


class GpuEngine(Engine):
    def __init__(self, cfg: Config, queue: QueueConfig, device=None):
        super().__init__(cfg, queue)
        if queue.team_size > 1 or queue.role_slots:
            raise ValueError("GpuEngine serves 1v1 queues; team and role "
                             "queues are not ported yet")
        self.device = resolve_device(device)
        ec = cfg.engine
        self.kernels = kernels.KernelSet(
            capacity=ec.pool_capacity,
            top_k=ec.top_k,
            pool_block=min(ec.pool_block, ec.pool_capacity),
            glicko2=queue.glicko2,
            widen_per_sec=queue.widen_per_sec,
            max_threshold=queue.max_threshold,
            pair_rounds=ec.pair_rounds,
        )
        self.pool = PlayerPool(ec.pool_capacity, queue.rating_threshold)
        self.dev_pool = kernels.fresh_pool(ec.pool_capacity, self.device)
        self.buckets = tuple(sorted(ec.batch_buckets))
        # Device times are f32, so every device-visible time is relative to
        # the first timestamp this engine sees.
        self._t0: float | None = None

    # ---- Engine API -------------------------------------------------------

    def search(self, requests: Sequence[SearchRequest], now: float) -> SearchOutcome:
        out = SearchOutcome()
        fresh: list[SearchRequest] = []
        seen: set[str] = set()
        for req in requests:
            if req.party_size > 1:
                out.rejected.append((req, "party_not_supported"))
            elif req.id in self.pool or req.id in seen:
                continue  # idempotent redelivery (waiting, or twice here)
            else:
                seen.add(req.id)
                fresh.append(req)
        done = []
        top = self.buckets[-1]
        for start in range(0, len(fresh), top):
            chunk = self._dispatch(fresh[start:start + top], now, out)
            if chunk is not None:
                done.append(chunk)
        for window, result in done:
            self._finalize(window, result, now, out)
        return out

    def remove(self, player_id: str) -> SearchRequest | None:
        slot = self.pool.slot_of(player_id)
        if slot is None:
            return None
        req = self.pool.request_at(slot)
        self._release_and_evict(np.array([slot], np.int32))
        return req

    def expire(self, now: float, timeout: float) -> list[SearchRequest]:
        """Vectorized timeout sweep over the mirror (enqueue time 0.0 means
        unstamped and never expires); one device eviction."""
        slots = self.pool.waiting_slots()
        if slots.size == 0:
            return []
        enq = self.pool.m_enqueued[slots]
        expired = slots[(enq != 0.0) & (now - enq > timeout)]
        if expired.size == 0:
            return []
        reqs = [self.pool.request_at(int(s)) for s in expired]
        self._release_and_evict(expired)
        return reqs

    def pool_size(self) -> int:
        return len(self.pool)

    def waiting(self) -> list[SearchRequest]:
        return self.pool.waiting()

    def restore(self, requests: Sequence[SearchRequest], now: float) -> None:
        """Re-admit a checkpoint without matching (device state is a pure
        function of the mirror)."""
        fresh = [r for r in requests if r.id not in self.pool]
        top = self.buckets[-1]
        for start in range(0, len(fresh), top):
            chunk = fresh[start:start + top]
            slots = self.pool.allocate(chunk)
            batch = self.pool.batch_arrays(chunk, slots, top,
                                           self._rel_base(now))
            self.kernels.admit_packed(self.dev_pool,
                                      self._to_device(pack_batch(batch, 0.0)))

    def warmup(self) -> None:
        """Build the kernel (CUDA) and run every bucket's all-padding
        window through both step variants, reading each result back as a
        window does: nothing is admitted, matched or evicted, so the pool
        is unchanged, and no first-of-its-kind window pays a first use."""
        for bucket in self.buckets:
            packed = self._to_device(
                pack_batch(self.pool.batch_arrays([], [], bucket), 0.0))
            for skip in (False, True):
                self.kernels.search_step_packed(
                    self.dev_pool, packed, 0.0, skip_filters=skip).cpu()
        # _finalize's first release: np.unique imports numpy.ma on first use
        # (numpy 2.3), ~50 ms where no bytecode is cached. Nothing is freed.
        self.pool.release(np.empty(0, np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- internals --------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _release_and_evict(self, slots: np.ndarray) -> None:
        self.pool.release(slots)
        kernels.evict(self.dev_pool,
                      self._to_device(np.asarray(slots, np.int32)))

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _rel_base(self, now: float) -> float:
        if self._t0 is None:
            self._t0 = now
        return self._t0

    def _dispatch(self, window: list[SearchRequest], now: float,
                  out: SearchOutcome):
        """Admit + run the step for one chunk; returns (window, f32[3, B]
        host result) or None when nothing was admitted."""
        if not window:
            return None
        # Admit what fits and reject the overflow.
        free = self.pool.free_count()
        if len(window) > free:
            for req in window[free:]:
                out.rejected.append((req, "pool_full"))
            window = window[:free]
            if not window:
                return None
        slots = self.pool.allocate(window)
        bucket = self._bucket_for(len(window))
        t0 = self._rel_base(now)
        batch = self.pool.batch_arrays(window, slots, bucket, t0)
        now_rel = float(np.float32(now - t0))
        # The all-ANY variant drops the region/mode tests (exact when no
        # lane carries a filter; padding lanes hold code 0).
        skip = not batch.region.any() and not batch.mode.any()
        result = self.kernels.search_step_packed(
            self.dev_pool, self._to_device(pack_batch(batch, now_rel)),
            now_rel, skip_filters=skip)
        return window, result.cpu().numpy()

    def _finalize(self, window: list[SearchRequest], result: np.ndarray,
                  now: float, out: SearchOutcome) -> None:
        """Map one chunk's (q_slot, c_slot, dist) back to requests."""
        q_slot = result[0].astype(np.int32)
        c_slot = result[1].astype(np.int32)
        hit = q_slot < self.kernels.capacity
        matched_ids: set[str] = set()
        if hit.any():
            qs_l = q_slot[hit].tolist()
            cs_l = c_slot[hit].tolist()
            for qs, cs, d in zip(qs_l, cs_l, result[2][hit].tolist()):
                req_q = self.pool.request_at(qs)
                req_c = self.pool.request_at(cs)
                matched_ids.add(req_q.id)
                matched_ids.add(req_c.id)
                qual = scoring.quality(d, self.effective_threshold(req_q, now),
                                       self.effective_threshold(req_c, now))
                out.matches.append(Match(match_id=new_match_id(),
                                         teams=((req_q,), (req_c,)),
                                         quality=qual))
            self.pool.release(qs_l)
            self.pool.release(cs_l)
        for req in window:
            if req.id not in matched_ids:
                out.queued.append(req)

