"""The settle predicate of soak and test drains.

A drain polls until every published request has settled (the match count
reached and nothing buffered at any stage between the broker and the
device) instead of sleeping for a while and hoping. The conjunction names
every buffering stage the runtime has; a new stage is added here, so that
every caller stays exact together.
"""

from __future__ import annotations

from typing import Any

__all__ = ["fully_drained"]


def fully_drained(app: Any, rt: Any, queue: str,
                  matched_at_least: int, *,
                  replication: bool = True) -> bool:
    """True once ``matched_at_least`` players have matched and the whole
    request path is empty: the broker queue drained, the delivery handlers
    idle, the batcher empty, no window flushing (a flush holds
    ``_pool_lock`` for its span, as do compaction and recovery), no answer
    waiting for its journal commit (``_settler``), no window in flight on
    the device, and, with replication attached, the standby's ack caught
    up with the last record sent.

    The replication clause does not depend on the fabric:
    ``repl.quiescent`` compares the sender's own acked and sent
    watermarks, so over the socket link it holds only once real ack
    frames crossed the wire, after every reconnect, scripted fault and
    retransmission converged. ``replication=False`` drops it, for soaks
    that hold the stream open on purpose (a partitioned link never
    acks)."""
    repl = getattr(rt, "replication", None)
    return (app.metrics.counters.get("players_matched") >= matched_at_least
            and app.broker.queue_depth(queue) == 0
            and app.broker.handlers_idle()
            and rt._batcher.depth == 0
            and not rt._pool_lock.locked()
            and rt._settler is None
            and (not hasattr(rt.engine, "inflight")
                 or rt.engine.inflight() == 0)
            and (not replication or repl is None or repl.quiescent))
