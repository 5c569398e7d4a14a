"""The migration mechanism: rebuild an engine on target devices.

The drain/checkpoint/restore round trip packaged as an engine-level
primitive, shared by the live path (``_QueueRuntime.migrate``, which owns
the pool lock, the drain and the bind) and the deterministic tests (the
D=1→2→1 shard-cycle bit-identity proof drives it directly, no service or
wall clock involved).

What crosses the move, explicitly:

- the waiting pool: between two 1v1 device engines as columns
  (``waiting_columns`` → ``restore_columns``, no request objects built:
  at 100k players the object path would put ~1 s of host work into the
  blackout), otherwise as requests (``waiting()`` → ``restore``: team and
  role queues, and the host oracle). Either way the players re-enter in
  the mirror's order, without matching — the checkpoint semantics;
- the quality accumulators (``quality_checkpoint``/``quality_restore``:
  /debug/quality stays monotone across the move);
- region/game-mode interner state (``adopt_interners``): codes already
  handed out by the old pool keep their meaning on the successor.

Admission credits and EDF deadline state live in the QUEUE RUNTIME
(AdmissionController, Delivery caches), not the engine — a live migration
keeps the runtime, so they survive by construction.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

log = logging.getLogger(__name__)


class MigrationFailed(RuntimeError):
    """The candidate engine could not be built or restored; the source
    engine is untouched and still serving."""


def adopt_interners(new_engine, old_engine) -> None:
    """Copy the old pool's region/mode interner tables (core/pool.py
    ``Interner``) into the new pool (superset merge: names already
    interned keep their OLD codes, so columns assembled against the old
    engine stay valid)."""
    new_pool = getattr(new_engine, "pool", None)
    old_pool = getattr(old_engine, "pool", None)
    if new_pool is None or old_pool is None:
        return
    for attr in ("regions", "modes"):
        old_i = getattr(old_pool, attr, None)
        new_i = getattr(new_pool, attr, None)
        if old_i is None or new_i is None:
            return
        # Interners are append-only name<->code tables; replay the old
        # assignment order so codes match exactly, then let the new table
        # keep growing from there.
        for code in range(1, len(old_i._names)):
            new_i.code(old_i._names[code])


def rebuild_engine(old_engine, make_engine, *, now: float | None = None,
                   columns: bool = False) -> tuple[Any, dict[str, Any]]:
    """Snapshot ``old_engine``, build a successor via ``make_engine()``
    (a zero-arg factory the caller parameterizes with the target devices /
    shard degree), restore, and verify the pool carried over losslessly.
    ``columns``: the queue is a 1v1 queue, so the pool moves as columns
    where both engines have the columnar API.

    Returns ``(new_engine, stats)``; raises :class:`MigrationFailed` with
    the old engine intact on any failure BEFORE the hand-off point.  The
    caller closes the old engine after binding the new one (same order as
    the breaker's probe swap: a transfer failure must leave the source
    serving).
    """
    t = time.time() if now is None else now
    cols = columns and hasattr(old_engine, "waiting_columns")
    snapshot = old_engine.waiting_columns() if cols else old_engine.waiting()
    n = len(snapshot[0]) if cols else len(snapshot)
    q_snap = None
    try:
        q_snap = old_engine.quality_checkpoint()
    except Exception:
        log.exception("quality checkpoint unreadable; counters will reset")
    try:
        candidate = make_engine()
    except Exception as e:
        raise MigrationFailed(f"candidate engine build failed: {e}") from e
    try:
        adopt_interners(candidate, old_engine)
        if cols and hasattr(candidate, "restore_columns"):
            restore_columns(candidate, *snapshot, t)
        elif cols:
            # The successor has no columnar API (the host oracle).
            candidate.restore(old_engine.waiting(), t)
        else:
            candidate.restore(snapshot, t)
        candidate.quality_restore(q_snap)
        restored = candidate.pool_size()
        if restored != n:
            raise MigrationFailed(
                f"pool transfer lost players: snapshot {n}, "
                f"restored {restored}")
    except MigrationFailed:
        _close_quietly(candidate)
        raise
    except Exception as e:
        _close_quietly(candidate)
        raise MigrationFailed(f"pool restore failed: {e}") from e
    return candidate, {"transferred": n}


def restore_columns(engine, cols, regions, modes, now: float) -> None:
    """Re-admit a ``waiting_columns()`` checkpoint into ``engine``: the
    region and mode names are interned into its pool first (the codes in
    ``cols`` belong to the pool they were read from)."""
    reg, mode = engine.intern_columns(list(regions), list(modes))
    engine.restore_columns(dataclasses.replace(cols, region=reg, mode=mode),
                           now)


def _close_quietly(engine) -> None:
    try:
        engine.close()
    except Exception:
        log.exception("candidate engine close failed")
