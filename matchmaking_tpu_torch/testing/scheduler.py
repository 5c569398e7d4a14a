"""Deterministic bounded-interleaving explorer.

The generic half of the small-scope model checker: a cooperative
scheduler that drives a WORLD — any object exposing the seven-method
protocol below — through bounded exhaustive enumeration of action
interleavings, with state-digest deduplication, sleep-set-style
commutation pruning (partial-order reduction), greedy counterexample
minimization, and a replayable schedule digest for bit-identical CI
repro.

World protocol (duck-typed; ``analysis/modelcheck.py`` implements it
over the REAL lease/replication/journal objects):

- ``enabled() -> list[str]``   action keys, canonical order
- ``step(key) -> str``         apply one action, return an effect line
- ``check() -> str | None``    invariant sweep after a step (a violation
                               raised DURING the step may also be
                               surfaced here; the first non-None return
                               ends the schedule)
- ``digest() -> Hashable``     canonical state fingerprint (dedup)
- ``slot(key) -> Hashable``    commutativity class: two actions in
                               different slots are independent
- ``index(key) -> int``        fixed canonical order for the POR rule
- ``close()``                  release resources (tmpdir, fds)

Worlds must be DETERMINISTIC: replaying the same action sequence on a
fresh world must reach the same digest. The explorer is replay-based —
it rebuilds the world from the action prefix at every node rather than
snapshotting live objects — so what it explores is, by construction,
exactly what a replay (and therefore a minimized counterexample, and a
CI repro from the schedule digest) reproduces.

Soundness of the POR rule: successor ``a`` is skipped directly after
``b`` when ``slot(a) != slot(b)`` and ``index(a) < index(b)``. For
worlds where different-slot actions truly commute (disjoint state;
enabling of one never depends on the other beyond monotonically
consumed budgets), every reachable state keeps a canonical
representative schedule in which adjacent independent actions appear in
index order — the skipped schedules only revisit states the canonical
ones pass through, and per-slot invariant violations surface
identically along the canonical order.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Callable

__all__ = ["ExploreResult", "Explorer", "schedule_digest"]


def schedule_digest(schedule: "list[str] | tuple[str, ...]",
                    scope: "dict[str, Any] | None" = None) -> str:
    """Replay token for one counterexample: sha256 over the canonical
    JSON of (action sequence, scope knobs). Two checkouts that agree on
    the digest agree on the exact schedule a CI repro will replay."""
    blob = json.dumps({"schedule": list(schedule), "scope": scope or {}},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


@dataclasses.dataclass
class ExploreResult:
    """Outcome of one bounded-exhaustive exploration."""

    #: First invariant violation found (None = clean at this scope).
    violation: "str | None" = None
    #: Minimized failing schedule (empty when clean).
    schedule: "list[str]" = dataclasses.field(default_factory=list)
    #: Replay token for ``schedule`` (see :func:`schedule_digest`).
    digest: str = ""
    #: Spine-style causal timeline of the minimized schedule.
    timeline: "list[str]" = dataclasses.field(default_factory=list)
    #: Unique state digests visited.
    states: int = 0
    #: Schedules executed end-to-end (DFS nodes, each one full replay).
    nodes: int = 0
    #: Worlds constructed (nodes + minimization/trace replays).
    replays: int = 0
    pruned_dedup: int = 0
    pruned_por: int = 0
    max_depth: int = 0
    #: True when the bounded space was fully enumerated (no state/time
    #: cap hit, no early stop on violation).
    exhaustive: bool = False
    elapsed_s: float = 0.0


class Explorer:
    """Replay-based DFS over bounded action schedules.

    ``factory`` builds a FRESH deterministic world (the caller owns
    giving each one a clean working directory). The explorer replays
    each candidate schedule from scratch, so no world object is ever
    snapshotted or rolled back — determinism of the factory is the only
    state-management contract.
    """

    def __init__(self, factory: "Callable[[], Any]", *, max_depth: int,
                 max_states: int = 250_000,
                 deadline_s: "float | None" = None,
                 dedup: bool = True, por: bool = True):
        self.factory = factory
        self.max_depth = int(max_depth)
        self.max_states = int(max_states)
        self.deadline_s = deadline_s
        self.dedup = dedup
        self.por = por
        self.replays = 0

    # ---- replay ------------------------------------------------------------

    def _run(self, schedule: "tuple[str, ...]"):
        """Execute one schedule on a fresh world. Returns
        ``(world, violation, step_index)`` — the world is NOT closed (the
        caller reads its digest/enabled set first)."""
        self.replays += 1
        world = self.factory()
        try:
            for i, key in enumerate(schedule):
                if key not in world.enabled():
                    # A minimization candidate dropped an action some
                    # later action's precondition needed — the shorter
                    # schedule is simply invalid, not a counterexample.
                    return world, None, None
                world.step(key)
                bad = world.check()
                if bad is not None:
                    return world, bad, i
            return world, None, None
        except BaseException:
            world.close()
            raise

    def trace(self, schedule: "list[str] | tuple[str, ...]"):
        """Replay one schedule collecting the causal timeline. Returns
        ``(timeline lines, violation | None)``."""
        self.replays += 1
        world = self.factory()
        lines: "list[str]" = []
        try:
            for i, key in enumerate(schedule):
                if key not in world.enabled():
                    lines.append(f"step {i + 1}: {key} -> NOT ENABLED "
                                 f"(schedule invalid from here)")
                    return lines, None
                effect = world.step(key)
                lines.append(f"step {i + 1}: {key} -> {effect}")
                bad = world.check()
                if bad is not None:
                    lines.append(f"VIOLATION after step {i + 1}: {bad}")
                    return lines, bad
            return lines, None
        finally:
            world.close()

    # ---- counterexample minimization ---------------------------------------

    def minimize(self, schedule: "tuple[str, ...]") -> "tuple[str, ...]":
        """Greedy delta-debugging to a fixed point: drop one action at a
        time (left to right), keep any shorter schedule that still
        violates SOME invariant, and truncate at the violating step.
        Deterministic, so the minimized schedule — not just its length —
        is stable across runs."""
        sched = tuple(schedule)
        changed = True
        while changed:
            changed = False
            for i in range(len(sched)):
                cand = sched[:i] + sched[i + 1:]
                world, bad, at = self._run(cand)
                world.close()
                if bad is not None:
                    sched = cand[:at + 1]
                    changed = True
                    break
        return sched

    # ---- exploration -------------------------------------------------------

    def explore(self) -> ExploreResult:
        """Bounded-exhaustive DFS. Stops at the FIRST violation (then
        minimizes it); otherwise enumerates the whole space or reports
        ``exhaustive=False`` when a state/time cap interrupts."""
        t0 = time.monotonic()
        res = ExploreResult(max_depth=self.max_depth)
        # digest -> best remaining budget seen; re-expand only when a
        # shallower path (more remaining depth) reaches the same state.
        seen: "dict[Any, int]" = {}
        stack: "list[tuple[str, ...]]" = [()]
        capped = False
        found: "tuple[tuple[str, ...], str] | None" = None
        while stack:
            if self.deadline_s is not None and (
                    time.monotonic() - t0 > self.deadline_s):
                capped = True
                break
            if len(seen) >= self.max_states:
                capped = True
                break
            sched = stack.pop()
            world, bad, at = self._run(sched)
            res.nodes += 1
            if bad is not None:
                world.close()
                found = (sched[:at + 1], bad)
                break
            remaining = self.max_depth - len(sched)
            if self.dedup:
                dig = world.digest()
                prev = seen.get(dig)
                if prev is not None and prev >= remaining:
                    res.pruned_dedup += 1
                    world.close()
                    continue
                seen[dig] = remaining
            else:
                seen[len(seen)] = remaining
            if remaining <= 0:
                world.close()
                continue
            last = sched[-1] if sched else None
            # Reversed push so DFS visits canonical-order successors
            # first — counterexamples read in natural action order.
            for key in reversed(world.enabled()):
                if (self.por and last is not None
                        and world.slot(key) != world.slot(last)
                        and world.index(key) < world.index(last)):
                    res.pruned_por += 1
                    continue
                stack.append(sched + (key,))
            world.close()
        res.states = len(seen)
        if found is not None:
            sched, _bad = found
            small = self.minimize(sched)
            timeline, bad2 = self.trace(small)
            res.violation = bad2 if bad2 is not None else found[1]
            res.schedule = list(small)
            res.timeline = timeline
        res.exhaustive = not capped and found is None
        res.replays = self.replays
        res.elapsed_s = time.monotonic() - t0
        return res
