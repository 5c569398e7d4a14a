"""The remote lease service and its client.

``LeaseService`` puts a ``LeaseAuthority`` (service/replication.py) behind
a framed-transport listener: the coordination service a deployment across
hosts runs. Every request is stamped with the service's own
``time.monotonic()`` (the monotonic clocks of two processes are unrelated,
so a caller's clock can never extend a lease), except in
``trust_caller_now`` mode, the loopback fabric of one process, where the
caller's clock is the service's and a scripted fast-forward works.

``RemoteLeaseAuthority`` has the ``LeaseAuthority`` surface over the wire.
It caches each grant as valid until ``t_send + lease_s -
lease_rtt_budget_s``: anchored at the request's send time, so it
under-approximates the authority's own deadline by whatever the request
spent in flight. A renewal still in flight when that deadline passes does
not count: ``is_current`` (the journal and publish fences) turns False,
and only a confirmed answer makes the lease valid again. A primary that
cannot hear the answers (an asymmetric partition) fences itself within
one lease, whether or not the authority expired it.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any

from matchmaking_tpu_torch.config import NetConfig
from matchmaking_tpu_torch.net.transport import (
    MsgConn,
    MsgServer,
    ReconnectingConn,
    io_loop,
    run_io,
)
from matchmaking_tpu_torch.service.replication import (
    LeaseAuthority,
    LeaseHeldError,
)

__all__ = ["LeaseService", "RemoteLeaseAuthority"]

log = logging.getLogger(__name__)


class LeaseService:
    """One ``LeaseAuthority`` behind a listener. Stateless per connection:
    any client may send any op, and the answer goes back on the
    connection that asked."""

    def __init__(self, addr: str, *, lease_s: float = 0.5,
                 net: NetConfig | None = None,
                 fail_renewals: tuple[int, ...] = (),
                 trust_caller_now: bool = False):
        self.addr = addr
        self.net = net or NetConfig(transport="socket")
        self.lease_s = float(lease_s)
        self.trust_caller_now = bool(trust_caller_now)
        self.authority = LeaseAuthority(lease_s, fail_renewals=fail_renewals)
        self.counters: collections.Counter = collections.Counter()
        self._clock = threading.Lock()
        self._conns: list[MsgConn] = []
        self._server = MsgServer(
            addr, name="lease-svc", on_conn=self._on_conn,
            conn_kwargs=dict(
                on_msg=lambda msg: None,
                counters=self.counters, counters_lock=self._clock,
                heartbeat_interval_s=self.net.heartbeat_interval_s,
                heartbeat_timeout_s=self.net.heartbeat_timeout_s,
                max_frame=self.net.max_frame_bytes,
                send_buffer_bytes=self.net.send_buffer_bytes))

    def _on_conn(self, conn: MsgConn) -> None:
        self._conns.append(conn)
        conn._on_msg = lambda msg: self._handle(conn, msg)

    def _handle(self, conn: MsgConn, msg: dict[str, Any]) -> None:
        if msg.get("t") != "lr":
            return
        now = time.monotonic()
        if self.trust_caller_now and "now" in msg:
            now = max(now, float(msg["now"]))
        op = str(msg.get("op", ""))
        q = str(msg.get("q", ""))
        owner = str(msg.get("owner", ""))
        epoch = int(msg.get("epoch", 0))
        auth = self.authority
        resp: dict[str, Any] = {"t": "lr.r", "rid": msg.get("rid"),
                                "ok": True, "lease_s": self.lease_s}
        with self._clock:
            self.counters[f"op_{op}"] += 1
        try:
            if op == "acquire":
                resp["epoch"] = auth.acquire(q, owner, now)
            elif op == "renew":
                resp["ok"] = auth.renew(q, owner, epoch, now)
                resp["cur_epoch"] = auth.epoch_of(q)
            elif op == "expired":
                resp["expired"] = auth.expired(q, now)
            elif op == "takeover":
                try:
                    resp["epoch"] = auth.takeover(
                        q, owner, now, force=bool(msg.get("force", False)))
                except LeaseHeldError:
                    # A retried takeover whose answer was lost: the
                    # requester already holds the lease, and a same-owner
                    # acquire returns its epoch; a foreign holder raises.
                    resp["epoch"] = auth.acquire(q, owner, now)
            elif op == "release":
                auth.release(q, owner, epoch, now)
            elif op == "epoch_of":
                resp["epoch"] = auth.epoch_of(q)
            else:
                resp["ok"] = False
                resp["error"] = f"unknown lease op {op!r}"
        except LeaseHeldError as e:
            resp["ok"] = False
            resp["held"] = True
            resp["error"] = str(e)
        except Exception as e:  # an answer always goes back
            resp["ok"] = False
            resp["error"] = f"{type(e).__name__}: {e}"
        resp["cur_epoch"] = resp.get("cur_epoch", auth.epoch_of(q))
        conn.send_msg(resp)

    def start(self) -> None:
        run_io(self._server.start(), timeout=5.0)

    def close(self) -> None:
        async def _close() -> None:
            await self._server.close()
            for c in list(self._conns):
                await c.close("service closed")
        try:
            run_io(_close(), timeout=5.0)
        except Exception:
            pass


class _QState:
    __slots__ = ("owner", "epoch", "valid_until", "stale", "cur_epoch")

    def __init__(self, owner: str, epoch: int, valid_until: float):
        self.owner = owner
        self.epoch = epoch
        #: t_send + lease_s - budget of the last confirmed grant (only
        #: ever moved forward).
        self.valid_until = valid_until
        #: The authority refuted this (owner, epoch), for good.
        self.stale = False
        self.cur_epoch = epoch


class RemoteLeaseAuthority:
    """The ``LeaseAuthority`` surface over the framed transport.

    The blocking ops (acquire, takeover, expired, release, and the
    re-confirm of a lapsed lease in ``renew``) wait up to
    ``request_timeout_s`` for their answer; ``renew`` of a still-valid
    lease fires one background renewal (at most one in flight per queue)
    and answers from the cache; ``is_current``, the fence check that the
    journal's threads call, is local: the cached (owner, epoch) and the
    budgeted deadline. No answer is no grant."""

    def __init__(self, addr: str, *, net: NetConfig | None = None,
                 seed: int = 0, client: str = "client", nemesis: Any = None):
        self.addr = addr
        self.net = net or NetConfig(transport="socket")
        self.client = client
        self.counters: collections.Counter = collections.Counter()
        self._clock = threading.Lock()
        self._lock = threading.Lock()
        self._state: dict[str, _QState] = {}
        self._pending: dict[int, dict[str, Any]] = {}
        self._pending_evt: dict[int, threading.Event] = {}
        self._renew_inflight: dict[str, tuple[int, float]] = {}
        self._rid = 0
        self._lease_s = 0.0  # learned from the answers
        flow = f"lease:{client}"
        rx_deaf = nemesis.rx_deaf(flow) if nemesis is not None else None
        self._conn = ReconnectingConn(
            addr, name=flow, seed=seed, on_msg=self._on_msg,
            counters=self.counters, counters_lock=self._clock,
            connect_timeout_s=self.net.connect_timeout_s,
            reconnect_base_s=self.net.reconnect_base_s,
            reconnect_cap_s=self.net.reconnect_cap_s,
            conn_kwargs=dict(
                heartbeat_interval_s=self.net.heartbeat_interval_s,
                heartbeat_timeout_s=self.net.heartbeat_timeout_s,
                max_frame=self.net.max_frame_bytes,
                send_buffer_bytes=self.net.send_buffer_bytes,
                rx_deaf=rx_deaf))
        self._conn.start()

    # ---- the wire ----------------------------------------------------------

    def _on_msg(self, msg: dict[str, Any]) -> None:
        if msg.get("t") != "lr.r":
            return
        rid = msg.get("rid")
        with self._lock:
            if rid in self._pending_evt:
                self._pending[rid] = msg
                self._pending_evt[rid].set()
            else:
                self._fold_async(rid, msg)

    def _next_rid(self) -> int:
        with self._lock:
            self._rid += 1
            return self._rid

    def _grant_s(self, resp: dict[str, Any]) -> float:
        lease_s = float(resp.get("lease_s", self._lease_s) or 0.0)
        if lease_s > 0:
            self._lease_s = lease_s
        return max(0.0, lease_s - self.net.lease_rtt_budget_s)

    def _rpc(self, msg: dict[str, Any],
             timeout: float | None = None) -> dict[str, Any] | None:
        """A blocking request: sent again on each new connection (the ops
        are idempotent at the service); None at the deadline, which the
        caller must treat as no grant."""
        rid = self._next_rid()
        msg = dict(msg, t="lr", rid=rid)
        evt = threading.Event()
        with self._lock:
            self._pending_evt[rid] = evt
        deadline = time.monotonic() + (
            self.net.request_timeout_s if timeout is None else timeout)
        loop = io_loop()
        sent_on: Any = None
        try:
            while True:
                c = self._conn.conn
                if c is not None and c is not sent_on:
                    loop.call_soon_threadsafe(c.send_msg, msg)
                    sent_on = c
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    with self._clock:
                        self.counters["rpc_timeouts"] += 1
                    return None
                if evt.wait(min(0.02, remaining)):
                    with self._lock:
                        return self._pending.pop(rid, None)
        finally:
            with self._lock:
                self._pending_evt.pop(rid, None)
                self._pending.pop(rid, None)

    # ---- the LeaseAuthority surface ----------------------------------------

    def acquire(self, queue: str, owner: str, now: float) -> int:
        resp = self._rpc({"op": "acquire", "q": queue, "owner": owner,
                          "now": now})
        if resp is None:
            raise TimeoutError(
                f"lease acquire for {queue!r} timed out (no answer is not "
                f"a grant)")
        if not resp.get("ok"):
            raise LeaseHeldError(resp.get("error", "lease held"))
        epoch = int(resp["epoch"])
        with self._lock:
            self._state[queue] = _QState(owner, epoch,
                                         now + self._grant_s(resp))
        return epoch

    def renew(self, queue: str, owner: str, epoch: int, now: float) -> bool:
        with self._lock:
            st = self._state.get(queue)
        if (st is None or st.owner != owner or st.epoch != epoch
                or st.stale):
            return False
        if now < st.valid_until:
            # Inside the budgeted deadline: answer from the cache, keep one
            # renewal in flight; it counts only once its answer lands.
            self._fire_renew(queue, owner, epoch, now)
            return True
        # Past it, only a confirmed answer makes the lease valid again: a
        # remote primary cannot see the authority's truth, so a lapse
        # fences unless the authority answers in time.
        resp = self._rpc({"op": "renew", "q": queue, "owner": owner,
                          "epoch": epoch, "now": now})
        if resp is None:
            return False
        self._note_cur_epoch(st, resp)
        if not resp.get("ok"):
            if int(resp.get("cur_epoch", epoch)) != epoch:
                st.stale = True
            return False
        st.valid_until = max(st.valid_until, now + self._grant_s(resp))
        return True

    def _fire_renew(self, queue: str, owner: str, epoch: int,
                    now: float) -> None:
        with self._lock:
            if queue in self._renew_inflight:
                return
            rid = self._rid = self._rid + 1
            self._renew_inflight[queue] = (rid, now)
        c = self._conn.conn
        if c is None:
            with self._lock:
                self._renew_inflight.pop(queue, None)
            return
        io_loop().call_soon_threadsafe(
            c.send_msg, {"t": "lr", "rid": rid, "op": "renew", "q": queue,
                         "owner": owner, "epoch": epoch, "now": now})

    def _fold_async(self, rid: Any, resp: dict[str, Any]) -> None:
        """Fold a background renewal's answer in (under ``_lock``),
        anchored at the renewal's send time: the authority's own deadline
        can only be later than t_send + lease_s."""
        for queue, (r, t_send) in list(self._renew_inflight.items()):
            if r != rid:
                continue
            del self._renew_inflight[queue]
            st = self._state.get(queue)
            if st is None:
                return
            self._note_cur_epoch(st, resp)
            if resp.get("ok"):
                st.valid_until = max(st.valid_until,
                                     t_send + self._grant_s(resp))
            elif int(resp.get("cur_epoch", st.epoch)) != st.epoch:
                st.stale = True
            return

    def _note_cur_epoch(self, st: _QState, resp: dict[str, Any]) -> None:
        try:
            st.cur_epoch = int(resp.get("cur_epoch", st.cur_epoch))
        except (TypeError, ValueError):
            pass

    def expired(self, queue: str, now: float) -> bool:
        resp = self._rpc({"op": "expired", "q": queue, "now": now})
        # No answer is not proof of expiry: a standby must not take over
        # on a timeout.
        return bool(resp is not None and resp.get("expired"))

    def takeover(self, queue: str, owner: str, now: float,
                 force: bool = False) -> int:
        resp = self._rpc({"op": "takeover", "q": queue, "owner": owner,
                          "now": now, "force": force})
        if resp is None:
            raise TimeoutError(f"lease takeover for {queue!r} timed out")
        if not resp.get("ok"):
            raise LeaseHeldError(resp.get("error", "lease held"))
        epoch = int(resp["epoch"])
        with self._lock:
            self._state[queue] = _QState(owner, epoch,
                                         now + self._grant_s(resp))
        return epoch

    def release(self, queue: str, owner: str, epoch: int,
                now: float) -> None:
        self._rpc({"op": "release", "q": queue, "owner": owner,
                   "epoch": epoch, "now": now})
        with self._lock:
            st = self._state.get(queue)
            if st is not None and st.owner == owner and st.epoch == epoch:
                st.valid_until = now

    def is_current(self, queue: str, owner: str, epoch: int) -> bool:
        """The fence check of the journal and publish seams: local, the
        cached (owner, epoch), not refuted, before the budgeted deadline.
        A renewal in flight counts for nothing."""
        with self._lock:
            st = self._state.get(queue)
            return (st is not None and st.owner == owner
                    and st.epoch == epoch and not st.stale
                    and time.monotonic() < st.valid_until)

    def epoch_of(self, queue: str) -> int:
        with self._lock:
            st = self._state.get(queue)
            return 0 if st is None else st.cur_epoch

    def close(self) -> None:
        try:
            run_io(self._conn.close(), timeout=5.0)
        except Exception:
            pass
