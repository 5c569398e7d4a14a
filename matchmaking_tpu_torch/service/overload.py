"""Overload control: admission, deadline propagation, tiered shedding.

The port's copy of ``matchmaking_tpu/service/overload.py``. It bounds the
queue in front of the matcher and answers what it refuses: an explicit
``shed`` response with a retry-after hint, never a request left to rot.

- **Deadline propagation.** A client stamps an absolute wall-clock
  deadline into the ``x-deadline`` header (headers survive a broker
  redelivery). The service checks it at admission, at the window cut and
  right before the dispatch, and answers ``timeout`` without spending
  device work on a request whose client gave up. Every comparison here
  takes ``now`` from its caller.
- **``AdmissionController``**, one per queue: a credit limiter (a credit
  is held from admission until the delivery is acked or nacked, so
  ``inflight()`` counts what the service committed to and has not
  finished) and a waiting-pool cap (the live pool plus the credits on
  their way into it). Decisions are pure functions of its counts at the
  decision point: two identical ingress sequences shed identically.
- **Tiers** (``OverloadConfig.tiers``): a request's ``x-tier`` header (0 =
  the most latency-critical; missing → the queue's ``default_tier``)
  places it on a nested ladder. Tier t is shed once the usage of tiers
  0..t reaches ``cap * tier_shares[t]``, so the lowest tier stops
  admitting first, and under ``shed_policy="oldest"`` the eviction takes
  the lowest tier's oldest players first: tier 0 is not shed while a
  lower tier holds anyone.
- **Adaptive tightening**: a credit fraction scaling both caps, updated
  once per cut window from batch fill, pipeline occupancy and the p99 of
  the "total" stage over the traces settled since the last cut (None when
  none settled, or with tracing off).

``begin_drain()`` turns the controller into shed-everything.

Its counters (``shed_requests``, ``shed_requests_t{k}``,
``expired_requests``, ``expired_requests_t{k}``) go to the ``counters``
dict it is given (the queue runtime's) and, as in the JAX package, to
``metrics`` (utils/metrics.Metrics) with the gauges
``overload_inflight[q]`` and ``overload_credit_fraction[q]``; the
``shed``, ``expired``, ``overload_tighten`` and
``drain_admission_stopped`` events go to ``events`` (the app's event
log).
"""

from __future__ import annotations

from typing import Any, Mapping, MutableMapping, Sequence

from matchmaking_tpu_torch.config import OverloadConfig

#: Message header carrying the absolute wall-clock request deadline
#: (epoch seconds, ``repr(float)``).
DEADLINE_HEADER = "x-deadline"

#: Message header carrying the QoS tier (decimal int; 0 = the most
#: latency-critical class, higher numbers shed first). Missing or garbled
#: reads as the queue's default tier.
TIER_HEADER = "x-tier"

#: Admission decisions.
ADMIT = "admit"
SHED = "shed"
EXPIRED = "expired"


def stamp_deadline(headers: MutableMapping[str, Any], now: float,
                   budget_s: float) -> None:
    """Stamp ``now + budget_s`` as the request deadline unless one is
    already set (a client's stamp wins; a redelivery reuses the same
    headers, so the deadline survives it)."""
    headers.setdefault(DEADLINE_HEADER, repr(now + budget_s))


def deadline_of(headers: Mapping[str, Any]) -> float | None:
    """The absolute deadline stamped in ``headers``, or None (missing or
    garbled: a foreign value must not crash a window flush)."""
    raw = headers.get(DEADLINE_HEADER)
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


def stamp_tier(headers: MutableMapping[str, Any], tier: int) -> None:
    """Stamp the QoS tier unless one is already set."""
    headers.setdefault(TIER_HEADER, str(int(tier)))


def tier_of(headers: Mapping[str, Any], default: int = 0,
            n_tiers: int = 1) -> int:
    """The tier stamped in ``headers``, clamped into ``[0, n_tiers)``;
    missing or garbled reads as ``default``."""
    raw = headers.get(TIER_HEADER)
    if raw is None:
        return min(max(int(default), 0), max(0, n_tiers - 1))
    try:
        t = int(float(raw))
    except (TypeError, ValueError):
        t = int(default)
    return min(max(t, 0), max(0, n_tiers - 1))


class AdmissionController:
    """Per-queue credit limiter, deadline gate and adaptive shedding.
    Called from the queue runtime's event loop only, so it has no lock."""

    def __init__(self, cfg: OverloadConfig, queue: str,
                 counters: MutableMapping[str, int] | None = None,
                 default_tier: int = 0, metrics=None, events=None):
        self.cfg = cfg
        self.queue = queue
        self._counters = counters
        self._metrics = metrics
        self._events = events
        #: The QoS ladder (1 = untiered).
        self.tiers = max(1, cfg.tiers)
        self.default_tier = min(max(int(default_tier), 0), self.tiers - 1)
        # Per-tier cap shares: tier t is shed once the usage of tiers 0..t
        # reaches cap * share[t]; share[0] is 1.0; () → the equal ladder.
        if cfg.tier_shares:
            shares = [min(1.0, max(0.0, float(s)))
                      for s in cfg.tier_shares[:self.tiers]]
            while len(shares) < self.tiers:
                shares.append(shares[-1])
        else:
            shares = [(self.tiers - t) / self.tiers
                      for t in range(self.tiers)]
        shares[0] = 1.0
        self._shares = tuple(shares)
        #: Delivery tag → tier, for every delivery holding a credit. Keyed
        #: by tag, so that ``release`` is idempotent.
        self._credits: dict[int, int] = {}
        #: Held credits per tier (the prefix sums the ladder checks).
        self._held = [0] * self.tiers
        #: Adaptive credit fraction in [min_credit_fraction, 1].
        self._fraction = 1.0
        #: Drain mode: shed everything.
        self.draining = False
        self.shed_total = 0
        self.expired_total = 0
        self.shed_by_tier = [0] * self.tiers
        self.expired_by_tier = [0] * self.tiers
        self._publish_gauges()

    # ---- decisions ---------------------------------------------------------

    def _eff(self, cap: int) -> int:
        """``cap`` scaled by the adaptive fraction, at least 1 (tightening
        may starve a queue, never shut it)."""
        if cap <= 0:
            return 0
        return max(1, int(cap * self._fraction))

    def _tier_cap(self, cap: int, tier: int) -> int:
        """Tier ``tier``'s slice of an (already scaled) cap."""
        if tier == 0:
            return cap
        return max(1, int(cap * self._shares[tier]))

    def _held_upto(self, tier: int) -> int:
        """Credits held by tiers 0..tier: lower tiers never block a higher
        one."""
        return sum(self._held[: tier + 1])

    def tier_of_delivery(self, delivery) -> int:
        """The delivery's tier (header, else the queue default), stamped
        back into its headers on a tiered queue so redeliveries keep it."""
        headers = delivery.properties.headers
        tier = tier_of(headers, self.default_tier, self.tiers)
        if self.tiers > 1:
            stamp_tier(headers, tier)
        return tier

    def _stamp_and_cache(self, delivery, now: float) -> float | None:
        """Stamp the default deadline (from first receive, so a redelivery
        gets no fresh budget), and cache the tier and the deadline on the
        delivery (``Delivery.tier`` / ``Delivery.deadline``: the EDF key
        and the flush read them). Returns the deadline (None: none)."""
        headers = delivery.properties.headers
        if self.cfg.default_deadline_ms > 0:
            try:
                first = float(headers.get("x-first-received", now))
            except (TypeError, ValueError):
                first = now
            stamp_deadline(headers, first, self.cfg.default_deadline_ms / 1e3)
        delivery.tier = self.tier_of_delivery(delivery)
        deadline = deadline_of(headers)
        delivery.deadline = deadline if deadline is not None else 0.0
        return deadline

    def _over_wait_cap(self, tier: int, cap_wait: int, pool_size: int,
                       pool_tiers: Sequence[int] | None) -> bool:
        """Would tier ``tier`` be shed at the waiting cap? Under
        ``shed_policy="oldest"`` an over-cap arrival is admitted when a
        victim of its tier or lower exists (the dispatch settles the debt
        from the pool's actual occupancy)."""
        if pool_tiers is None or self.tiers == 1:
            pool_upto = pool_size
        else:
            pool_upto = sum(pool_tiers[: tier + 1])
        if pool_upto + self._held_upto(tier) < self._tier_cap(cap_wait, tier):
            return False
        return not (self.cfg.shed_policy == "oldest"
                    and (self.tiers == 1 or pool_tiers is None
                         or any(pool_tiers[tier:])))

    def decide(self, delivery, now: float, pool_size: int,
               pool_tiers: Sequence[int] | None = None) -> str:
        """ADMIT / SHED / EXPIRED for one arriving delivery (the
        per-delivery path). ``pool_tiers`` is the waiting pool per tier
        (``Engine.pool_tier_counts``); None counts every waiting player
        against every tier. Admits nothing itself: the caller does."""
        deadline = self._stamp_and_cache(delivery, now)
        if deadline is not None and now >= deadline:
            return EXPIRED
        if self.draining:
            return SHED
        tier = delivery.tier
        cap = self._eff(self.cfg.max_inflight)
        if cap and self._held_upto(tier) >= self._tier_cap(cap, tier):
            return SHED
        cap = self._eff(self.cfg.max_waiting)
        if cap and self._over_wait_cap(tier, cap, pool_size, pool_tiers):
            return SHED
        return ADMIT

    def pre_decide(self, delivery, now: float) -> str:
        """Window-granular admission's ingress pre-check: stamp and cache
        (as ``decide``), then settle what cannot wait for the cut: expired
        at receive (a redelivered copy flows on, so the flush's terminal
        replay can answer it) and drain mode."""
        deadline = self._stamp_and_cache(delivery, now)
        if (deadline is not None and now >= deadline
                and not delivery.redelivered):
            return EXPIRED
        if self.draining:
            return SHED
        return ADMIT

    def pre_decide_batch(self, deliveries, now: float) -> list[str]:
        """``pre_decide`` over a consume burst, in burst order."""
        return [self.pre_decide(d, now) for d in deliveries]

    def decide_batch(self, deliveries, now: float, pool_size: int,
                     pool_tiers: Sequence[int] | None = None) -> list[str]:
        """One admission pass over a cut window, in the order given (the
        caller passes arrival order): the ``decide`` ladder on the cached
        tier and deadline of each row, admitting as it goes, so the
        per-tier counts evolve as they would per delivery. A row already
        past its deadline is admitted (with a credit): the flush's deadline
        check answers it after the terminal-replay probe. Returns ADMIT or
        SHED per row."""
        decisions: list[str] = []
        cap_in = self._eff(self.cfg.max_inflight)
        cap_wait = self._eff(self.cfg.max_waiting)
        for d in deliveries:
            tier = d.tier
            if d.deadline > 0.0 and now >= d.deadline:
                self.admit(d.delivery_tag, tier)
                decisions.append(ADMIT)
                continue
            if self.draining:
                decisions.append(SHED)
                continue
            if cap_in and self._held_upto(tier) >= self._tier_cap(cap_in,
                                                                  tier):
                decisions.append(SHED)
                continue
            if cap_wait and self._over_wait_cap(tier, cap_wait, pool_size,
                                                pool_tiers):
                decisions.append(SHED)
                continue
            self.admit(d.delivery_tag, tier)
            decisions.append(ADMIT)
        return decisions

    def admit(self, delivery_tag: int, tier: int = 0) -> None:
        if delivery_tag not in self._credits:
            tier = min(max(tier, 0), self.tiers - 1)
            self._credits[delivery_tag] = tier
            self._held[tier] += 1
        if self._metrics is not None:
            self._metrics.set_gauge(f"overload_inflight[{self.queue}]",
                                    len(self._credits))

    def release(self, delivery_tag: int) -> None:
        """Return the delivery's credit (idempotent: an unknown tag is a
        no-op)."""
        tier = self._credits.pop(delivery_tag, None)
        if tier is not None:
            self._held[tier] -= 1
            if self._metrics is not None:
                self._metrics.set_gauge(f"overload_inflight[{self.queue}]",
                                        len(self._credits))

    def inflight(self) -> int:
        return len(self._credits)

    def _count(self, name: str) -> None:
        if self._counters is not None:
            self._counters[name] = self._counters.get(name, 0) + 1
        if self._metrics is not None:
            self._metrics.counters.inc(name)

    def record_shed(self, detail: str = "", tier: int = 0) -> None:
        self.shed_total += 1
        tier = min(max(tier, 0), self.tiers - 1)
        self.shed_by_tier[tier] += 1
        self._count("shed_requests")
        if self.tiers > 1:
            self._count(f"shed_requests_t{tier}")
        if self._events is not None:
            self._events.append("shed", self.queue,
                                f"tier={tier} {detail}" if self.tiers > 1
                                else detail)

    def record_expired(self, detail: str = "", tier: int = 0) -> None:
        self.expired_total += 1
        tier = min(max(tier, 0), self.tiers - 1)
        self.expired_by_tier[tier] += 1
        self._count("expired_requests")
        if self.tiers > 1:
            self._count(f"expired_requests_t{tier}")
        if self._events is not None:
            self._events.append("expired", self.queue,
                                f"tier={tier} {detail}" if self.tiers > 1
                                else detail)

    def eviction_debt(self, n_entering: int, pool_size: int) -> int:
        """``shed_policy="oldest"``: how many waiting players the dispatch
        must shed so that the ``n_entering`` requests fit under the
        waiting cap, from the pool's occupancy at the dispatch."""
        if self.cfg.shed_policy != "oldest":
            return 0
        cap = self._eff(self.cfg.max_waiting)
        if not cap:
            return 0
        return max(0, pool_size + n_entering - cap)

    # ---- adaptive tightening ----------------------------------------------

    def observe_window(self, batch_fill: float, pipeline_frac: float,
                       p99_s: float | None) -> None:
        """One window was cut: tighten the credit fraction while the
        pipeline is full (or the p99 is over target), relax it once both
        recovered. Called once per window, so identical runs tighten at
        identical windows."""
        if not self.cfg.adaptive:
            return
        target_s = self.cfg.target_p99_ms / 1e3
        old = self._fraction
        overloaded = ((p99_s is not None and p99_s > target_s)
                      or pipeline_frac >= 1.0)
        if overloaded:
            self._fraction = max(self.cfg.min_credit_fraction,
                                 self._fraction * self.cfg.tighten_step)
        elif ((p99_s is None or p99_s < target_s / 2.0)
              and pipeline_frac < 1.0 and batch_fill < 1.0):
            self._fraction = min(1.0, self._fraction * self.cfg.relax_step)
        if self._fraction != old:
            self._publish_gauges()
            if self._events is not None and self._fraction < old:
                self._events.append(
                    "overload_tighten", self.queue,
                    f"credit fraction {old:.3f} -> {self._fraction:.3f} "
                    f"(p99 {0.0 if p99_s is None else p99_s * 1e3:.1f} ms, "
                    f"pipeline {pipeline_frac:.2f})")

    @property
    def credit_fraction(self) -> float:
        return self._fraction

    def set_fraction(self, fraction: float) -> float:
        """Set the credit fraction directly (clamped to
        [min_credit_fraction, 1]); returns the value applied."""
        self._fraction = min(1.0, max(self.cfg.min_credit_fraction,
                                      float(fraction)))
        self._publish_gauges()
        return self._fraction

    # ---- checkpoint / restore ----------------------------------------------

    def checkpoint(self) -> dict[str, Any]:
        """What a successor needs to decide identically: the credit
        fraction and the shed and expired accounting. Held credits are not
        kept: a drain settles every delivery holding one."""
        return {
            "credit_fraction": self._fraction,
            "shed_total": self.shed_total,
            "expired_total": self.expired_total,
            "shed_by_tier": list(self.shed_by_tier),
            "expired_by_tier": list(self.expired_by_tier),
        }

    def restore_state(self, state: Mapping[str, Any] | None) -> None:
        """Fold a predecessor's ``checkpoint`` in (missing or foreign keys
        are ignored)."""
        if not state:
            return
        frac = state.get("credit_fraction")
        if isinstance(frac, (int, float)):
            self._fraction = min(1.0, max(self.cfg.min_credit_fraction,
                                          float(frac)))
        for key in ("shed_total", "expired_total"):
            v = state.get(key)
            if isinstance(v, int) and v >= 0:
                setattr(self, key, v)
        for key in ("shed_by_tier", "expired_by_tier"):
            v = state.get(key)
            if isinstance(v, list):
                dst = getattr(self, key)
                for t in range(min(len(dst), len(v))):
                    if isinstance(v[t], int) and v[t] >= 0:
                        dst[t] = v[t]
        self._publish_gauges()

    # ---- drain / observability --------------------------------------------

    def begin_drain(self) -> None:
        """Stop admission: every delivery from here on is shed."""
        self.draining = True
        if self._events is not None:
            self._events.append("drain_admission_stopped", self.queue)

    def _publish_gauges(self) -> None:
        if self._metrics is None:
            return
        self._metrics.set_gauge(f"overload_inflight[{self.queue}]",
                                len(self._credits))
        self._metrics.set_gauge(f"overload_credit_fraction[{self.queue}]",
                                self._fraction)

    def snapshot(self) -> dict[str, Any]:
        snap: dict[str, Any] = {
            "inflight": len(self._credits),
            "credit_fraction": round(self._fraction, 4),
            "max_inflight": self.cfg.max_inflight,
            "max_waiting": self.cfg.max_waiting,
            "shed_policy": self.cfg.shed_policy,
            "shed_total": self.shed_total,
            "expired_total": self.expired_total,
            "draining": self.draining,
        }
        if self.tiers > 1:
            snap["tiers"] = {
                str(t): {
                    "share": round(self._shares[t], 4),
                    "held": self._held[t],
                    "shed": self.shed_by_tier[t],
                    "expired": self.expired_by_tier[t],
                }
                for t in range(self.tiers)
            }
        return snap
