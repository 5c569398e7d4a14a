"""The plain reference of the 1v1 columnar engine.

It works out again, from a run's inputs alone, what every window and
every rescan tick of the run had to answer. It replays the run's log: the
calls the harness made, in order, with the rows and the times it handed
over, and where in that order each answer was collected (collection frees
the matched players' slots, and the next allocation takes them back).

It imports nothing of ``matchmaking_tpu_torch`` and nothing of JAX. What
it needs of the engine's rules it holds as a plain copy:

- the slot allocator: one LIFO stack of free slots, first pops 0, 1, 2,
  ...; a window's players take the top of the stack in turn; freed slots
  go back in ascending order; the waiting players in insertion order;
- time: every device time is ``f32(t - t0)``, where ``t0`` is the time of
  the first call; a window's time is ``f32(now - t0)``;
- the effective threshold, ``min(max, thr + widen * max(0, now - enq))``,
  each step an f32 operation;
- the distance, ``|r_a - r_b|``, and under Glicko-2 ``|r_a - r_b| *
  (1 / sqrt(1 + g * (rd_a^2 + rd_b^2)))`` with ``g`` rounded to f32 once,
  each step an f32 operation;
- the candidate of a request in a pool block of ``pool_block`` slots: the
  active slot, not its own, within both effective thresholds, at the
  least distance, the lowest slot on a tie; its score is minus the
  distance;
- a traffic window first admits its own players, so that they can pair
  with one another; a rescan admits nothing and drops the lanes whose
  slot a window ahead of it has already emptied;
- the pairing: ``pair_rounds`` rounds in which every live request
  proposes its best remaining candidate, and a proposal wins unless a
  conflicting one (sharing a slot) scores higher or ties from a lower
  lane; winners retire both slots; the matched slots are emptied;
- the answer: the pairs in lane order with their distances and their
  quality, ``1 - d / min(eff_a, eff_b)`` clipped to [0, 1] at the
  window's time, and the window's players left waiting, in lane order;
- a rescan tick takes at most ``min(max_window, pipeline_depth * top
  bucket)`` of the waiting players, the longest waiting first, in slot
  order, in chunks of the top bucket.

``dtype`` is the precision of the distance arithmetic: float32 is the
reference, bfloat16 the control that must fail the comparison.
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass, field

import numpy as np
import torch

# Glicko-2's g-function constant, q = ln 10 / 400: 3 q^2 / pi^2.
_Q = math.log(10.0) / 400.0
G_COEFF = 3.0 * _Q * _Q / (math.pi * math.pi)


def f32(x: float) -> float:
    """``x`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(x))


def pool_block_of(capacity: int, pool_block: int, top_k: int) -> int:
    """The block width the engine uses: halved until it divides the
    capacity, and until there are ``min(top_k, capacity // 128)`` blocks."""
    pb = max(1, min(pool_block, capacity))
    while capacity % pb:
        pb //= 2
    need = min(top_k, max(1, capacity // 128))
    while capacity // pb < need and pb > 1:
        pb //= 2
        while capacity % pb:
            pb //= 2
    return pb


@dataclass
class Spec:
    """What the reference reads of a configuration (every value stated in
    the configuration file, so that none comes from the program)."""

    capacity: int
    pool_block: int
    buckets: tuple[int, ...]
    pair_rounds: int
    depth: int
    threshold: float
    widen: float
    max_threshold: float
    glicko2: bool

    @staticmethod
    def from_config(cfg: dict) -> "Spec":
        eng, q = cfg["engine"], cfg["queues"][0]
        cap = int(eng["pool_capacity"])
        return Spec(
            capacity=cap,
            pool_block=pool_block_of(cap, int(eng["pool_block"]),
                                     int(eng["top_k"])),
            buckets=tuple(sorted(int(b) for b in eng["batch_buckets"])),
            pair_rounds=int(eng["pair_rounds"]),
            depth=int(eng["pipeline_depth"]),
            threshold=float(q["rating_threshold"]),
            widen=float(q["widen_per_sec"]),
            max_threshold=float(q["max_threshold"]),
            glicko2=bool(q["glicko2"]))

    def bucket_for(self, n: int) -> int:
        return next((b for b in self.buckets if n <= b), self.buckets[-1])


class Mirror:
    """The host side: who waits in which slot."""

    def __init__(self, capacity: int, threshold: float):
        self.capacity = capacity
        self.threshold = np.float32(threshold)
        self.free = np.arange(capacity - 1, -1, -1, dtype=np.int32)
        self.head = capacity
        self.slot_of: dict[str, int] = {}
        self.m_id = np.full(capacity, None, dtype=object)
        self.m_held = np.zeros(capacity, bool)
        self.m_rating = np.zeros(capacity, np.float32)
        self.m_rd = np.zeros(capacity, np.float32)
        self.m_threshold = np.zeros(capacity, np.float32)
        self.m_enqueued = np.zeros(capacity, np.float64)

    def __len__(self) -> int:
        return len(self.slot_of)

    def fresh(self, ids: np.ndarray) -> np.ndarray:
        """The rows to admit: not waiting, first of their id."""
        pids = ids.tolist()
        if len(set(pids)) == len(pids):
            return ~np.fromiter(map(self.slot_of.__contains__, pids), bool,
                                len(pids))
        seen: set[str] = set()
        keep = np.empty(len(pids), bool)
        for j, pid in enumerate(pids):
            keep[j] = pid not in self.slot_of and pid not in seen
            seen.add(pid)
        return keep

    def allocate(self, ids, rating, rd, enqueued) -> np.ndarray:
        n = len(ids)
        slots = self.free[self.head - n:self.head][::-1].copy()
        self.head -= n
        self.m_id[slots] = ids
        self.m_held[slots] = True
        self.m_rating[slots] = rating
        self.m_rd[slots] = rd
        self.m_threshold[slots] = self.threshold
        self.m_enqueued[slots] = enqueued
        self.slot_of.update(zip(ids.tolist(), slots.tolist()))
        return slots

    def release(self, slots: np.ndarray) -> None:
        arr = np.sort(np.asarray(slots, np.int32))
        if arr.size > 1:  # the distinct slots, ascending
            arr = arr[np.concatenate(([True], arr[1:] != arr[:-1]))]
        arr = arr[self.m_held[arr]]
        collections.deque(map(self.slot_of.__delitem__,
                              self.m_id[arr].tolist()), maxlen=0)
        self.m_id[arr] = None
        self.m_held[arr] = False
        self.free[self.head:self.head + arr.size] = arr
        self.head += arr.size

    def waiting_slots(self) -> np.ndarray:
        return np.fromiter(self.slot_of.values(), np.int32, len(self.slot_of))


def effective(thr, enq, now, widen: float, max_thr: float):
    """The widened threshold, one f32 operation at a time (torch); ``now``
    is the window's time, f32[1] on the device."""
    if widen <= 0.0:
        return thr
    waited = (now - enq).clamp_min(0.0)
    return (thr + f32(widen) * waited).clamp_max(f32(max_thr))


def distances(q_rating, q_rd, c_rating, c_rd, glicko2: bool):
    """(lanes, slots) distances, one f32 operation at a time (torch)."""
    d = q_rating[:, None] - c_rating[None, :]
    d.abs_()
    if glicko2:
        fac = (q_rd * q_rd)[:, None] + (c_rd * c_rd)[None, :]
        fac.mul_(f32(G_COEFF)).add_(1.0).sqrt_().reciprocal_()
        d.mul_(fac)
    return d


def screen(d, q_lim, c_lim, q_slot):
    """Set to +inf, in place, every (lane, slot) distance that may not
    match: beyond the lane's or the slot's effective threshold (-inf for a
    padding lane and an empty slot), or the lane's own slot."""
    bad = d > q_lim[:, None]
    bad.logical_or_(d > c_lim[None, :])
    d.masked_fill_(bad, float("inf"))
    p = d.shape[1]
    own = torch.arange(d.shape[0], device=d.device) * p + q_slot.clamp(max=p - 1)
    d.view(-1).index_fill_(0, own, float("inf"))
    return d


def block_best(d, pool_block: int, capacity: int):
    """Per lane and pool block of screened distances ``d``: (score f32 =
    -distance or -inf, slot or ``capacity``), the least distance and the
    lowest slot on a tie."""
    b = d.shape[0]
    n_blocks = d.shape[1] // pool_block
    best, arg = d.view(b, n_blocks, pool_block).min(dim=2)
    base = (torch.arange(n_blocks, device=d.device) * pool_block)[None, :]
    hit = best < float("inf")
    vals = torch.where(hit, -best.float(), float("-inf"))
    idx = torch.where(hit, arg + base, capacity)
    return vals, idx


def pair(vals, idx, slot, capacity: int, rounds: int):
    """The greedy pairing: (q_slot, c_slot, dist) per lane, ``capacity`` /
    +inf where a lane formed no pair."""
    b = vals.shape[0]
    dev = vals.device
    lane = torch.arange(b, device=dev)
    dead_row = torch.zeros(b, dtype=torch.bool, device=dev)
    dead_cand = torch.zeros(vals.shape, dtype=torch.bool, device=dev)
    out_q = torch.full((b,), capacity, dtype=torch.long, device=dev)
    out_c = torch.full((b,), capacity, dtype=torch.long, device=dev)
    out_d = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
    other = ~torch.eye(b, dtype=torch.bool, device=dev)
    for _ in range(rounds):
        live_vals = torch.where(dead_cand | dead_row[:, None],
                                torch.full_like(vals, float("-inf")), vals)
        j = live_vals.argmax(dim=1)
        bv = live_vals[lane, j]
        bc = idx[lane, j]
        live = bv > float("-inf")
        share = ((slot[:, None] == slot[None, :]) | (slot[:, None] == bc[None, :])
                 | (bc[:, None] == slot[None, :]) | (bc[:, None] == bc[None, :]))
        rival = share & live[:, None] & live[None, :] & other
        beats = (bv[None, :] > bv[:, None]) | ((bv[None, :] == bv[:, None])
                                               & (lane[None, :] < lane[:, None]))
        win = live & ~(rival & beats).any(dim=1)
        out_q = torch.where(win, slot, out_q)
        out_c = torch.where(win, bc, out_c)
        out_d = torch.where(win, -bv, out_d)
        gone = torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
        gone.index_fill_(0, torch.where(win, slot, capacity), True)
        gone.index_fill_(0, torch.where(win, bc, capacity), True)
        dead_cand |= gone[idx.clamp(0, capacity)]
        dead_row |= gone[slot.clamp(0, capacity)]
    return out_q, out_c, out_d


@dataclass
class Answer:
    """One window's or tick's answer, as the engine reports it."""

    id_a: np.ndarray
    id_b: np.ndarray
    dist: np.ndarray
    quality: np.ndarray
    queued: np.ndarray
    #: Players refused for want of a free slot (``pool_full``).
    refused: np.ndarray


@dataclass
class _Open:
    chunks: list = field(default_factory=list)  # (ids, slots, out, now)
    refused: list = field(default_factory=list)


class Reference:
    """The engine's answers, worked out again from the log of a run."""

    def __init__(self, spec: Spec, device="cpu", dtype=torch.float32,
                 on_work=None):
        self.spec = spec
        self.device = torch.device(device)
        self.dtype = dtype
        cap = spec.capacity
        self.mirror = Mirror(cap, spec.threshold)
        z = lambda dt: torch.zeros(cap, dtype=dt, device=self.device)
        self.rating, self.rd = z(torch.float32), z(torch.float32)
        self.thr, self.enq = z(torch.float32), z(torch.float32)
        self.active = z(torch.bool)
        self.t0: float | None = None
        self.open: dict[int, _Open] = {}
        #: Called with (kind, admissible pair count, lanes) after each step
        #: while ``count_work`` is set: the roofline's work of the step.
        self.on_work = on_work
        self.count_work = False
        self._graphs: dict[tuple[int, bool, bool], _Graph] = {}
        self._mark = np.zeros(cap, bool)  # scratch: the slots a chunk matched

    # -- the calls of a run ---------------------------------------------

    def _base(self, now: float) -> float:
        if self.t0 is None:
            self.t0 = now
        return self.t0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device, without waiting for the copy."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def restore(self, ids, rating, rd, enqueued, now: float) -> None:
        t0 = self._base(now)
        keep = self.mirror.fresh(ids)
        ids, rating, rd, enqueued = (a[keep] for a in (ids, rating, rd,
                                                       enqueued))
        # (The engine raises where the pool cannot hold them all; only a
        # control that matches less than the run can get there: it keeps
        # what fits.)
        n = min(len(ids), self.mirror.head)
        slots = self.mirror.allocate(ids[:n], rating[:n], rd[:n],
                                     enqueued[:n])
        self._admit(slots, rating[:n], rd[:n], enqueued[:n], t0)

    def _admit(self, slots, rating, rd, enqueued, t0: float) -> torch.Tensor:
        """Write the rows into their slots on the device and mark them
        active; returns the slots on the device."""
        rows = np.empty((4, slots.size), np.float32)
        rows[0], rows[1], rows[2] = slots, rating, rd  # slots < 2**24: exact
        rows[3] = (enqueued - t0).astype(np.float32)
        r = self._dev(rows)
        s = r[0].long()
        self.rating[s] = r[1]
        self.rd[s] = r[2]
        self.thr.index_fill_(0, s, f32(self.spec.threshold))
        self.enq[s] = r[3]
        self.active.index_fill_(0, s, True)
        return s

    def dispatch(self, token: int, ids, rating, rd, enqueued,
                 now: float) -> None:
        """A traffic window: admit its new players, then the step."""
        t0 = self._base(now)
        keep = self.mirror.fresh(ids)
        ids, rating, rd, enqueued = (a[keep] for a in (ids, rating, rd,
                                                       enqueued))
        op = self.open[token] = _Open()
        top = self.spec.buckets[-1]
        for lo in range(0, len(ids), top):
            # A chunk takes what the free slots hold; the rest is refused.
            hi = lo + min(top, len(ids) - lo, self.mirror.head)
            op.refused.append(ids[hi:lo + top])
            if hi == lo:
                continue
            sl = slice(lo, hi)
            slots = self.mirror.allocate(ids[sl], rating[sl], rd[sl],
                                         enqueued[sl])
            s = self._admit(slots, rating[sl], rd[sl], enqueued[sl], t0)
            op.chunks.append((ids[sl], slots,
                              self._step(s, now, gate=False), now))

    def rescan(self, token: int, now: float, max_window: int) -> None:
        """A rescan tick: the longest waiting, in chunks, no admission."""
        m = self.mirror
        top = self.spec.buckets[-1]
        max_window = min(max_window, self.spec.depth * top)
        slots_all = m.waiting_slots()
        if slots_all.size > max_window:
            order = np.lexsort((m.m_enqueued[slots_all],
                                np.full(slots_all.size, np.inf),
                                np.zeros(slots_all.size, np.int32)))
            chosen = np.sort(slots_all[order[:max_window]]).astype(np.int32)
        else:
            chosen = np.sort(slots_all).astype(np.int32)
        op = self.open[token] = _Open()
        for lo in range(0, chosen.size, top):
            slots = chosen[lo:lo + top]
            s = self._dev(slots.astype(np.int64))
            op.chunks.append((m.m_id[slots], slots,
                              self._step(s, now, gate=True), now))

    def collect(self, token: int) -> Answer:
        """The answer of ``token``, at the point of the log where the run
        collected it: the matched players' slots go free here."""
        op = self.open.pop(token)
        m = self.mirror
        parts: dict[str, list] = {k: [] for k in
                                  ("id_a", "id_b", "dist", "quality",
                                   "queued")}
        for ids, slots, (out, done), now in op.chunks:
            if done is not None:
                done.synchronize()
            out = out.numpy()
            q, c = out[0].astype(np.int64), out[1].astype(np.int64)
            d = out[2]
            hit = q < self.spec.capacity
            qs, cs, dd = q[hit], c[hit], d[hit]
            if qs.size:
                lim = np.minimum(self._eff(qs, now), self._eff(cs, now))
                quality = np.where(
                    lim > 0.0,
                    np.clip(1.0 - dd / np.maximum(lim, 1e-30), 0.0, 1.0),
                    0.0).astype(np.float32)
                parts["id_a"].append(m.m_id[qs])
                parts["id_b"].append(m.m_id[cs])
                parts["dist"].append(dd)
                parts["quality"].append(quality)
                matched = np.concatenate([qs, cs])
                m.release(matched)
                self._mark[matched] = True
                parts["queued"].append(ids[~self._mark[slots]])
                self._mark[matched] = False
            else:
                parts["queued"].append(ids)
        cat = lambda k, dt: (np.concatenate(parts[k]) if parts[k]
                             else np.empty(0, dt))
        refused = (np.concatenate(op.refused) if op.refused
                   else np.empty(0, object))
        return Answer(cat("id_a", object), cat("id_b", object),
                      cat("dist", np.float32), cat("quality", np.float32),
                      cat("queued", object), refused)

    def pool_size(self) -> int:
        return len(self.mirror)

    # -- the step ---------------------------------------------------------

    def _eff(self, slots: np.ndarray, now: float) -> np.ndarray:
        """Effective thresholds at finalize (host, from the mirror)."""
        m, s = self.mirror, self.spec
        thr = m.m_threshold[slots]
        if s.widen <= 0.0:
            return thr
        waited = np.maximum(0.0, now - m.m_enqueued[slots])
        return np.minimum(s.max_threshold, thr + s.widen * waited
                          ).astype(np.float32)

    def _body(self, lane, n, now, gate: bool, count: bool = False):
        """The step on the device over a padded chunk: ``lane`` i64[bucket]
        (``capacity`` past the ``n`` real lanes, a 0-d tensor), at the
        window's time ``now`` (f32[1]). Returns (f32[3, bucket]: q_slot,
        c_slot, dist, slots exact in f32; with ``count``, the admissible
        pairs as a 0-d tensor, else None). Only device tensors in, nothing
        read on the host: a CUDA graph captures it."""
        s, dt = self.spec, self.dtype
        bucket = lane.shape[0]
        safe = lane.clamp(max=s.capacity - 1)
        ok = torch.arange(bucket, device=lane.device) < n
        if gate:
            ok &= self.active[safe]
        now = now.to(dt)
        q_thr = effective(self.thr[safe].to(dt), self.enq[safe].to(dt), now,
                          s.widen, s.max_threshold)
        c_thr = effective(self.thr.to(dt), self.enq.to(dt), now, s.widen,
                          s.max_threshold)
        d = distances(self.rating[safe].to(dt), self.rd[safe].to(dt),
                      self.rating.to(dt), self.rd.to(dt), s.glicko2)
        screen(d, torch.where(ok, q_thr, float("-inf")),
               torch.where(self.active, c_thr, float("-inf")), lane)
        work = (d < float("inf")).sum() if count else None
        vals, idx = block_best(d, s.pool_block, s.capacity)
        del d
        q, c, dist = pair(vals, idx, lane, s.capacity, s.pair_rounds)
        gone = torch.zeros(s.capacity + 1, dtype=torch.bool,
                           device=lane.device)
        gone.index_fill_(0, q, True)
        gone.index_fill_(0, c, True)
        self.active &= ~gone[:s.capacity]
        return torch.stack([q.float(), c.float(), dist.float()]), work

    def _graph(self, bucket: int, gate: bool, count: bool) -> "_Graph":
        """The step of (bucket, gate, count) captured as one CUDA graph
        (made at its first use): its hundreds of small launches become
        one."""
        key = (bucket, gate, count)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _Graph(self, bucket, gate, count)
        return g

    def _step(self, slot: torch.Tensor, now: float, gate: bool):
        """One chunk on the device: candidates, pairing, eviction, queued
        behind the chunks before it. ``slot``: the chunk's slots on the
        device. Returns f32[3, n] (q_slot, c_slot, dist) on the host, and
        on the card the event after which it is there."""
        s, dev = self.spec, self.device
        n = slot.shape[0]
        bucket = s.bucket_for(n)
        now_rel = f32(now - self.t0)
        kind = "rescan" if gate else "window"
        count = self.count_work and self.on_work is not None
        if dev.type != "cuda":
            lane = torch.full((bucket,), s.capacity, dtype=torch.long)
            lane[:n] = slot
            out, work = self._body(lane, torch.tensor(n),
                                   torch.tensor([now_rel]), gate, count)
            if count:
                self.on_work(kind, int(work), n)
            return out[:, :n].clone(), None
        g = self._graph(bucket, gate, count)
        g.lane.fill_(s.capacity)
        g.lane[:n].copy_(slot)
        g.n.fill_(n)
        g.now.fill_(now_rel)
        g.graph.replay()
        if count:
            self.on_work(kind, int(g.work.item()), n)
        # Copied out right behind the step (the next replay overwrites the
        # graph's output), so that collecting it waits for this chunk and
        # not for the chunks queued after it.
        host = torch.empty((3, n), dtype=torch.float32, pin_memory=True)
        host.copy_(g.out[:, :n], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done


class _Graph:
    """One step of the reference captured as a CUDA graph: static inputs
    (lanes, their count, the time) and outputs. An all-padding run first,
    which changes nothing, makes what the step makes lazily."""

    def __init__(self, ref: Reference, bucket: int, gate: bool,
                 count: bool):
        dev = ref.device
        self.lane = torch.full((bucket,), ref.spec.capacity, dtype=torch.long,
                               device=dev)
        self.n = torch.zeros((), dtype=torch.long, device=dev)
        self.now = torch.zeros(1, dtype=torch.float32, device=dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            ref._body(self.lane, self.n, self.now, gate, count)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out, self.work = ref._body(self.lane, self.n, self.now,
                                            gate, count)
