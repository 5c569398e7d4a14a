"""Deterministic placement simulation: seeded load + fake telemetry.

The policy must be unit-testable (and bench-soakable) WITHOUT devices and
without the service's wall-clock nondeterminism.  This module models a
tiny cluster — queues with piecewise offered-load curves, devices with a
fixed per-shard capacity — derives the same signal shapes the live
controller reads (idle fraction, occupancy, SLO burn) from pure
arithmetic, and runs the real :class:`~matchmaking_tpu_torch.control.policy.
PlacementPolicy` + :class:`~matchmaking_tpu_torch.control.state.PlacementState`
through it.  Everything is a pure function of ``(spec, seed)``: two runs
produce bit-identical decision traces.

The simulated "blackout" is the model's migration cost: proportional to
the pool being carried (the live cost is drain + restore, both linear in
waiting players), so blackout-bounding policy logic can be exercised here
too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from matchmaking_tpu_torch.config import PlacementConfig
from matchmaking_tpu_torch.control.policy import (
    GreedyPolicy,
    PlacementPolicy,
    QueueSignals,
    SignalView,
)
from matchmaking_tpu_torch.control.state import PlacementState


@dataclasses.dataclass(frozen=True)
class SimQueue:
    """One simulated queue: a load curve in 'device-seconds of demand per
    tick' (1.0 = exactly one chip's capacity)."""

    name: str
    #: Offered load per tick, as a fraction of ONE device's capacity.
    #: Piecewise-constant: entry i covers ticks [edges[i], edges[i+1]).
    load: tuple[float, ...] = (0.5,)
    edges: tuple[int, ...] = (0,)
    device: int = 0
    shardable: bool = False
    #: Load jitter fraction (seeded; 0 = none).
    jitter: float = 0.0

    def offered(self, tick: int, rng: np.random.Generator) -> float:
        idx = 0
        for i, e in enumerate(self.edges):
            if tick >= e:
                idx = i
        base = self.load[min(idx, len(self.load) - 1)]
        if self.jitter > 0.0:
            base *= 1.0 + self.jitter * float(rng.uniform(-1.0, 1.0))
        return max(0.0, base)


@dataclasses.dataclass
class SimTickRow:
    """One tick of the simulated trajectory (telemetry-shaped)."""

    tick: int
    signals: dict[str, dict[str, Any]]
    actions: list[dict[str, Any]]


def run_simulation(cfg: PlacementConfig, queues: Sequence[SimQueue],
                   *, ticks: int, seed: int = 0,
                   policy: PlacementPolicy | None = None,
                   ) -> dict[str, Any]:
    """Run ``ticks`` control ticks over the simulated cluster.  Returns a
    JSON-ready dict: the decision trace, the final bindings, and the
    per-tick signal trajectory."""
    if cfg.devices <= 0:
        raise ValueError("simulation needs an explicit device inventory "
                         "(PlacementConfig.devices > 0)")
    rng = np.random.default_rng(seed)
    state = PlacementState(cfg.devices, decision_ring=cfg.decision_ring)
    for q in queues:
        state.bind(q.name, (q.device,))
    policy = policy or GreedyPolicy(cfg)
    by_name = {q.name: q for q in queues}
    trajectory: list[SimTickRow] = []
    #: Simulated waiting pools (players) — grow under overload, drain
    #: under headroom; feed the blackout model.
    pools: dict[str, float] = {q.name: 0.0 for q in queues}

    for tick in range(ticks):
        now = float(tick)  # sim time: one second per tick
        # Per-device demand: each tenant's offered load lands on its
        # device set (a D-way shard spreads demand evenly).
        offered = {q.name: by_name[q.name].offered(tick, rng)
                   for q in queues}
        demand: dict[int, float] = {}
        for name, p in state.placements().items():
            share = offered[name] / max(1, p.shard)
            for d in p.devices:
                demand[d] = demand.get(d, 0.0) + share
        # Signals: a queue's idle fraction is its WORST device's headroom;
        # occupancy approximates served/capacity; the pool integrates
        # unserved demand; burn fires while the pool grows.
        sig: dict[str, QueueSignals] = {}
        for name, p in state.placements().items():
            q = by_name[name]
            util = max(min(demand.get(d, 0.0), 1.0) for d in p.devices)
            capacity = float(p.shard)
            served = min(offered[name], capacity)
            backlog_delta = offered[name] - served
            pools[name] = max(0.0, pools[name] + 100.0 * backlog_delta)
            sig[name] = QueueSignals(
                burning=backlog_delta > 1e-9 or pools[name] > 0.0,
                idle_frac=round(1.0 - util, 6),
                occupancy=round(min(1.0, offered[name] / capacity), 6),
                p99_ms=round(50.0 + 500.0 * min(1.0, pools[name] / 100.0), 3),
                pool=int(pools[name]),
                shardable=q.shardable,
            )
            # Served headroom drains the backlog.
            if served < capacity:
                pools[name] = max(0.0, pools[name]
                                  - 100.0 * (capacity - offered[name]))
        view = SignalView(queues=sig)
        actions = policy.plan(state, view, now)
        applied: list[dict[str, Any]] = []
        if actions:
            act = actions[0]  # the controller's one-action-per-tick rule
            decision = state.begin(act.kind, act.queue, act.devices, now,
                                   signals=act.signals)
            # Simulated blackout: linear in the pool carried across.
            blackout_s = 0.001 + pools[act.queue] * 1e-5
            state.complete(decision, now, blackout_s,
                           int(pools[act.queue]), detail=act.reason)
            applied.append(decision.to_dict())
        trajectory.append(SimTickRow(
            tick=tick,
            signals={n: s.to_dict() for n, s in sorted(sig.items())},
            actions=applied))

    return {
        "seed": seed,
        "ticks": ticks,
        "final": state.snapshot(),
        "decisions": [d.to_dict() for d in state.decisions],
        "trajectory": [
            {"tick": r.tick, "signals": r.signals, "actions": r.actions}
            for r in trajectory
        ],
    }
