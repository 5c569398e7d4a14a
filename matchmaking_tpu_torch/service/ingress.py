"""Consume-burst decode and the per-shard ingress state of one queue.

The broker's burst consume (``BrokerConfig.consume_batch``) hands a 1v1
queue's runtime ONE callback per drained burst of deliveries.
``IngressShards.decode_burst`` packs the burst's bodies into one buffer
and its offsets and decodes them in one native call
(``codec.decode_batch_concat``). Each kept delivery gets a ``(DecodedBurst,
index)`` reference in ``Delivery.row``, so the window flush assembles its
columns with ``gather_rows`` (one take per burst and column) instead of
decoding the bodies again; the columns merge at the window cut, whichever
bursts they came from.

- Rows the native decoder flags NEEDS_PYTHON (string escapes, parties,
  roles) fall back through ``contract.decode_request``, the semantic source
  of truth, consistent-hashed by correlation id (the request's identity
  before it is decoded) into ``BrokerConfig.ingress_shards`` slices. At
  N = 1 the fallback runs inline; at N > 1 each shard's slice runs on a
  worker thread: disjoint row indices, so the workers' writes into the
  burst's arrays never meet, and they touch no other shared state.
- ``ShardedRecent`` splits the terminal-replay cache (player id → (body,
  expiry)) into per-shard dicts by the same hash of the player id. All of
  its mutation stays on the event loop.

Region and mode stay names in the burst's columns ("" = the wildcard) and
are interned at the flush: interner codes belong to one engine, and a
revive between consume and flush rebuilds them.

The port's own copy of ``matchmaking_tpu/service/ingress.py``. Its rejects
carry the port's (code, reason) and no counter name: the port's service
counts every reject under ``rejected``.
"""

from __future__ import annotations

import asyncio
import zlib
from typing import TYPE_CHECKING

import numpy as np

from matchmaking_tpu_torch.native import codec
from matchmaking_tpu_torch.service.contract import ContractError, decode_request

if TYPE_CHECKING:  # typing only
    from matchmaking_tpu_torch.service.broker import Delivery

#: A reject settled at consume: (delivery, error code, reason).
Reject = tuple["Delivery", str, str]


def shard_of(key: str, n: int) -> int:
    """Consistent key → shard hash. crc32, not ``hash()``: the builtin is
    salted per process (PYTHONHASHSEED), and shard routing must repeat
    across runs."""
    if n <= 1:
        return 0
    return zlib.crc32(key.encode()) % n


class ShardedRecent:
    """The terminal-replay cache (player id → (encoded body, expiry)),
    split into per-shard dicts by ``shard_of`` the player id. N = 1 is a
    single dict. Mutated on the event loop only."""

    __slots__ = ("n", "_shards")

    def __init__(self, n: int = 1):
        self.n = max(1, int(n))
        self._shards: list[dict[str, tuple[bytes, float]]] = [
            {} for _ in range(self.n)]

    def _dict(self, pid: str) -> dict[str, tuple[bytes, float]]:
        if self.n == 1:
            return self._shards[0]
        return self._shards[zlib.crc32(pid.encode()) % self.n]

    def get(self, pid: str) -> tuple[bytes, float] | None:
        return self._dict(pid).get(pid)

    def pop(self, pid: str) -> None:
        self._dict(pid).pop(pid, None)

    def set(self, pid: str, value: tuple[bytes, float]) -> None:
        self._dict(pid)[pid] = value

    def __len__(self) -> int:
        return sum(len(d) for d in self._shards)

    def items(self):
        """Every (pid, (body, expiry)), shard-major (a pure function of
        the ids): the journal compaction's carry of the live entries."""
        for d in self._shards:
            yield from d.items()

    def prune(self, now: float) -> None:
        """Drop the entries expired at ``now``."""
        for i, d in enumerate(self._shards):
            self._shards[i] = {k: v for k, v in d.items() if v[1] > now}


class DecodedBurst:
    """One consume burst's decoded request columns. Row i is valid iff
    ``ok[i]`` (the others were settled at consume). Region and mode are
    names ("" = the wildcard).

    An all-OK burst adopts the native decoder's arrays as they are; a
    burst with fallback or rejected rows allocates its own and fills
    them."""

    __slots__ = ("ids", "rating", "rd", "threshold", "region", "mode", "ok")

    def __init__(self, ids, rating, rd, threshold, region, mode, ok):
        self.ids = ids
        self.rating = rating
        self.rd = rd
        self.threshold = threshold
        self.region = region
        self.mode = mode
        self.ok = ok

    @classmethod
    def empty(cls, n: int) -> "DecodedBurst":
        return cls(np.empty(n, object), np.empty(n, np.float32),
                   np.empty(n, np.float32), np.empty(n, np.float32),
                   np.empty(n, object), np.empty(n, object),
                   np.zeros(n, bool))


class IngressShards:
    """The ingress shard workers of one queue runtime."""

    def __init__(self, n: int = 1):
        self.n = max(1, int(n))

    @staticmethod
    def _fallback_slice(burst: DecodedBurst, deliveries: list[Delivery],
                        idxs: list[int]) -> list[tuple[int, str, str]]:
        """Decode one shard's NEEDS_PYTHON rows through the contract
        module into the burst's arrays (disjoint indices per shard: safe
        on a worker thread). Returns its rejects as (row, code, reason),
        classified as the flush's decode classifies them: a contract error
        with its own code and reason, a party (a 1v1 queue serves none) as
        ``party_not_supported``."""
        rejects: list[tuple[int, str, str]] = []
        for i in idxs:
            try:
                req = decode_request(deliveries[i].body)
            except ContractError as e:
                rejects.append((i, e.code, e.reason))
                continue
            if req.party_size > 1:
                rejects.append((i, "party_not_supported",
                                "engine rejected request: party_not_supported"))
                continue
            burst.ids[i] = req.id
            burst.rating[i] = req.rating
            burst.rd[i] = req.rating_deviation
            burst.threshold[i] = (np.nan if req.rating_threshold is None
                                  else req.rating_threshold)
            burst.region[i] = "" if req.region == "*" else req.region
            burst.mode[i] = "" if req.game_mode == "*" else req.game_mode
            burst.ok[i] = True
        return rejects

    async def decode_burst(
            self, deliveries: list[Delivery],
    ) -> tuple[list[Delivery], list[Reject]]:
        """Decode one consume burst: one native call over its bodies, the
        contract fallback for NEEDS_PYTHON rows, per shard. Sets ``d.row =
        (burst, i)`` on every kept delivery. Returns (kept deliveries,
        rejects); the caller settles the rejects (answer and ack)."""
        n = len(deliveries)
        bodies = [d.body if isinstance(d.body, bytes) else bytes(d.body)
                  for d in deliveries]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(np.fromiter((len(b) for b in bodies), np.int64, n),
                  out=offsets[1:])
        ids_n, rating_n, rd_n, thr_n, reg_n, mode_n, status_n = (
            codec.decode_batch_concat(b"".join(bodies), offsets))
        if not status_n.any():  # every row OK (codec.OK == 0)
            burst = DecodedBurst(ids_n, rating_n, rd_n, thr_n, reg_n, mode_n,
                                 np.ones(n, bool))
            for i, d in enumerate(deliveries):
                d.row = (burst, i)
            return deliveries, []
        burst = DecodedBurst.empty(n)
        rejects_i: list[tuple[int, str, str]] = []
        fallback: list[int] = []
        for i, st in enumerate(status_n.tolist()):
            if st == codec.OK:
                burst.ok[i] = True
            elif st == codec.NEEDS_PYTHON:
                fallback.append(i)
            else:
                rejects_i.append((i, codec.error_code(st), "malformed payload"))
        ok = burst.ok
        burst.ids[ok] = ids_n[ok]
        burst.rating[ok] = rating_n[ok]
        burst.rd[ok] = rd_n[ok]
        burst.threshold[ok] = thr_n[ok]
        burst.region[ok] = reg_n[ok]
        burst.mode[ok] = mode_n[ok]
        if fallback:
            if self.n > 1 and len(fallback) > 1:
                by_shard: list[list[int]] = [[] for _ in range(self.n)]
                for i in fallback:
                    key = deliveries[i].properties.correlation_id or str(i)
                    by_shard[shard_of(key, self.n)].append(i)
                results = await asyncio.gather(*(
                    asyncio.to_thread(self._fallback_slice, burst,
                                      deliveries, idxs)
                    for idxs in by_shard if idxs))
                for rej in results:
                    rejects_i.extend(rej)
            else:
                rejects_i.extend(self._fallback_slice(burst, deliveries,
                                                      fallback))
        kept: list[Delivery] = []
        for i, (d, good) in enumerate(zip(deliveries, burst.ok.tolist())):
            if good:
                d.row = (burst, i)
                kept.append(d)
        rejects_i.sort()  # settled in burst order, whichever shard found them
        return kept, [(deliveries[i], code, reason)
                      for i, code, reason in rejects_i]


def gather_rows(refs: list[tuple[DecodedBurst, int]]):
    """A window's rows from their bursts' columns, in window order: one
    take per (burst, column). Returns (ids, rating, rd, threshold, region
    names, mode names)."""
    k = len(refs)
    if k and all(burst is refs[0][0] for burst, _ in refs):
        b = refs[0][0]
        idx = np.fromiter((i for _, i in refs), np.int64, k)
        return (b.ids[idx], b.rating[idx], b.rd[idx], b.threshold[idx],
                b.region[idx], b.mode[idx])
    ids = np.empty(k, object)
    rating = np.empty(k, np.float32)
    rd = np.empty(k, np.float32)
    threshold = np.empty(k, np.float32)
    region = np.empty(k, object)
    mode = np.empty(k, object)
    by_burst: dict[int, tuple[DecodedBurst, list[int], list[int]]] = {}
    for j, (burst, i) in enumerate(refs):
        entry = by_burst.get(id(burst))
        if entry is None:
            entry = by_burst[id(burst)] = (burst, [], [])
        entry[1].append(i)
        entry[2].append(j)
    for burst, src, dst in by_burst.values():
        s = np.asarray(src, np.int64)
        t = np.asarray(dst, np.int64)
        ids[t] = burst.ids[s]
        rating[t] = burst.rating[s]
        rd[t] = burst.rd[s]
        threshold[t] = burst.threshold[s]
        region[t] = burst.region[s]
        mode[t] = burst.mode[s]
    return ids, rating, rd, threshold, region, mode
