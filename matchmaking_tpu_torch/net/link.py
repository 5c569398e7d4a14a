"""The socket replication link and its hub.

``SocketReplicationLink`` (the primary's half) and ``SocketStandbyLink``
(the standby's half) give the in-process link's ``send`` / ``recv`` /
``ack`` / ``acked`` surface over the framed transport, so
``QueueReplication`` and ``StandbyApplier`` run unchanged: the sender's
unacked tail, the pump's stall retransmission and the applier's seq dedup
and gap buffer make the stream at-least-once, and a torn frame, a dropped
one, a reset connection or a whole reconnect needs no recovery of its own.
The stream resumes by cumulative ack on the journal's seqs.

Flow ids (the nemesis's vocabulary): ``repl:<queue>:fwd``, records from
the primary to the standby; ``repl:<queue>:ack``, the cumulative acks
back; ``lease:<owner>``, lease requests. A scripted fault on a replication
flow names a record seq and fires on its first transmission only.

``SocketReplicationHub`` has ``ReplicationHub``'s surface (``authority``,
``link()``, ``standby()``, ``adopted``) over sockets. With no
``lease_addr`` it runs in loopback mode: an embedded lease service that
trusts the caller's clock (so a scripted takeover time works) and one UDS
rendezvous path per queue under ``base_dir``. Across processes,
``lease_addr`` names a real service and each side names its addresses.
"""

from __future__ import annotations

import asyncio
import base64
import collections
import logging
import re
import tempfile
import threading
from typing import Any

from matchmaking_tpu_torch.config import NetConfig
from matchmaking_tpu_torch.net.lease import LeaseService, RemoteLeaseAuthority
from matchmaking_tpu_torch.net.nemesis import FlowNemesis, NetNemesis
from matchmaking_tpu_torch.net.transport import (
    MsgConn,
    MsgServer,
    ReconnectingConn,
    io_loop,
    pack_msg,
    run_io,
)
from matchmaking_tpu_torch.service.replication import (
    RT_REPL_SNAPSHOT,
    StandbyApplier,
)

__all__ = ["SocketReplicationLink", "SocketStandbyLink",
           "SocketReplicationHub"]

log = logging.getLogger(__name__)


def _slug(queue: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", queue)


class SocketReplicationLink:
    """The primary's half: the outbound connection to the standby's
    listener, with ``send``, ``acked``, ``queue``, ``counters`` and
    ``partition`` (what ``QueueReplication`` uses).

    ``send`` runs under the journal's lock on whatever thread appends: it
    only enqueues (bounded: past ``send_buffer_bytes`` of queued payload
    the record is dropped and counted ``backpressure_dropped``, and the
    pump's stall retransmission heals) and wakes the IO loop, which runs
    the nemesis, frames and writes. Every (re)connect replays the newest
    baseline the link ever carried, so a standby that attaches late, or
    again after a torn stream, starts from a baseline and the
    retransmitted tail. A retransmission of a seq already written on the
    live connection is not written again (``retransmits_elided``): the
    stream delivers it, or dies and the next connection starts afresh.
    The JAX package's link writes it again."""

    def __init__(self, queue: str, target: str, *,
                 net: NetConfig | None = None,
                 nemesis: NetNemesis | None = None, seed: int = 0):
        self.queue = queue
        self.target = target
        self.net = net or NetConfig(transport="socket")
        self._seed = int(seed)
        self.counters: collections.Counter = collections.Counter()
        self._clock = threading.Lock()
        self._acked = 0
        self.flow = f"repl:{queue}:fwd"
        nem = (nemesis.flow(self.flow, self._count)
               if nemesis is not None else None)
        #: Always there: ``partition()`` needs the pipeline with no script.
        self._nem = nem if nem is not None else FlowNemesis(
            self.flow, None, seed, self._count)
        self._out: collections.deque[tuple[int, int, bytes]] = (
            collections.deque())
        self._out_bytes = 0
        self._last_baseline: tuple[int, int, bytes] | None = None
        #: Seqs written on the connection ``_written_on`` (IO loop only).
        self._written: set[int] = set()
        self._written_on: MsgConn | None = None
        self._drain_scheduled = False
        self._closed = False
        rx_deaf = (nemesis.rx_deaf(f"repl:{queue}:ack")
                   if nemesis is not None else None)
        self._client = ReconnectingConn(
            target, name=self.flow, seed=seed, on_msg=self._on_msg,
            counters=self.counters, counters_lock=self._clock,
            connect_timeout_s=self.net.connect_timeout_s,
            reconnect_base_s=self.net.reconnect_base_s,
            reconnect_cap_s=self.net.reconnect_cap_s,
            conn_kwargs=dict(
                heartbeat_interval_s=self.net.heartbeat_interval_s,
                heartbeat_timeout_s=self.net.heartbeat_timeout_s,
                max_frame=self.net.max_frame_bytes,
                send_buffer_bytes=self.net.send_buffer_bytes,
                rx_deaf=rx_deaf),
            on_connect=self._on_connect)
        self._client.start()

    def _count(self, key: str, n: int = 1) -> None:
        with self._clock:
            self.counters[key] += n

    # ---- the primary's surface (any thread) ---------------------------------

    def send(self, seq: int, rtype: int, payload: bytes) -> None:
        with self._clock:
            self.counters["sent"] += 1
            if self._out_bytes + len(payload) > self.net.send_buffer_bytes:
                # Surface backpressure instead of buffering without bound:
                # the unacked tail keeps the record and the stall
                # retransmission offers it again.
                self.counters["backpressure_dropped"] += 1
                return
            self._out.append((int(seq), int(rtype), payload))
            self._out_bytes += len(payload)
        if rtype == RT_REPL_SNAPSHOT:
            self._last_baseline = (int(seq), int(rtype), payload)
        io_loop().call_soon_threadsafe(self._schedule_drain)

    @property
    def acked(self) -> int:
        return self._acked

    def partition(self, start: int, resume: int | None = None) -> None:
        """As the in-process link's: record seqs >= start are held at the
        sender until a transmission reaches ``resume`` (default never)."""
        self._nem.partition(start, resume)
        self._count("partitions")

    # ---- the IO loop's side --------------------------------------------------

    def _on_msg(self, msg: dict[str, Any]) -> None:
        if msg.get("t") == "ack":
            seq = int(msg.get("seq", 0))
            if seq > self._acked:
                self._acked = seq

    def _on_connect(self, conn: MsgConn) -> None:
        # A late standby, or one behind a torn stream, rebases from this
        # and the retransmitted tail; a stale copy is absorbed by the
        # applier's snapshot dedup.
        lb = self._last_baseline
        if lb is not None:
            with self._clock:
                self._out.appendleft(lb)
                self._out_bytes += len(lb[2])
        self._schedule_drain()

    def _schedule_drain(self) -> None:
        if not self._drain_scheduled and not self._closed:
            self._drain_scheduled = True
            io_loop().create_task(self._drain())

    async def _drain(self) -> None:
        try:
            while True:
                with self._clock:
                    if not self._out:
                        break
                    seq, rtype, payload = self._out.popleft()
                    self._out_bytes -= len(payload)
                conn = self._client.conn
                if conn is not self._written_on:
                    self._written_on, self._written = conn, set()
                if conn is not None and seq in self._written:
                    # A stream delivers what was written on it or dies
                    # (and the redial replays the baseline and clears
                    # this set): a retransmission is not encoded and
                    # written again. Re-encoding a 100k baseline (~13 MB)
                    # every two stalled pumps saturated the IO thread
                    # until heartbeats missed their deadline.
                    self._count("retransmits_elided")
                    continue
                frame = pack_msg({
                    "t": "rec", "q": self.queue, "seq": seq, "rt": rtype,
                    "p": base64.b64encode(payload).decode("ascii")})
                for action in self._nem.transmit(seq, frame):
                    conn = self._client.conn
                    if action[0] == "reset":
                        if conn is not None:
                            conn.reset()
                        continue
                    if conn is None:
                        # A down link: the frame vanishes, and the unacked
                        # tail heals it, as an in-process scripted drop.
                        self._count("send_no_conn")
                        continue
                    bps = self._nem.bandwidth_bps
                    if bps:
                        await asyncio.sleep(len(action[1]) / float(bps))
                    if (conn.send_payload(action[1]) and action[1] is frame
                            and conn is self._written_on):
                        self._written.add(seq)
        finally:
            self._drain_scheduled = False
            with self._clock:
                more = bool(self._out)
            if more and not self._closed:
                self._schedule_drain()

    def close(self) -> None:
        self._closed = True
        try:
            run_io(self._client.close(), timeout=5.0)
        except Exception:
            pass


class SocketStandbyLink:
    """The standby's half: listens for the primary's stream and gives
    ``recv``, ``ack``, ``max_delivered``, ``queue`` and ``counters`` (what
    ``StandbyApplier`` uses). A new connection replaces the old (the
    latest primary wins); acks go out on the current one with the
    cumulative watermark, so a lost ack frame is superseded by the next."""

    def __init__(self, queue: str, listen: str, *,
                 net: NetConfig | None = None,
                 nemesis: NetNemesis | None = None, seed: int = 0):
        self.queue = queue
        self.listen = listen
        self.net = net or NetConfig(transport="socket")
        self.counters: collections.Counter = collections.Counter()
        self._clock = threading.Lock()
        self.flow = f"repl:{queue}:ack"
        self._nem = (nemesis.flow(self.flow, self._count)
                     if nemesis is not None else None)
        self._ack_nseq = 0
        self._rx: collections.deque[tuple[int, int, bytes]] = (
            collections.deque())
        #: The highest seq ``recv`` handed out: an ack never passes it.
        self.max_delivered = 0
        self._conn: MsgConn | None = None
        rx_deaf = (nemesis.rx_deaf(f"repl:{queue}:fwd")
                   if nemesis is not None else None)
        self._server = MsgServer(
            listen, name=self.flow, on_conn=self._on_conn,
            conn_kwargs=dict(
                on_msg=self._on_msg, counters=self.counters,
                counters_lock=self._clock,
                heartbeat_interval_s=self.net.heartbeat_interval_s,
                heartbeat_timeout_s=self.net.heartbeat_timeout_s,
                max_frame=self.net.max_frame_bytes,
                send_buffer_bytes=self.net.send_buffer_bytes,
                rx_deaf=rx_deaf))
        run_io(self._server.start(), timeout=5.0)

    def _count(self, key: str, n: int = 1) -> None:
        with self._clock:
            self.counters[key] += n

    def _on_conn(self, conn: MsgConn) -> None:
        prev, self._conn = self._conn, conn
        self._count("accepts")
        if prev is not None:
            prev._schedule_close("replaced by newer connection")

    def _on_msg(self, msg: dict[str, Any]) -> None:
        if msg.get("t") != "rec" or msg.get("q") != self.queue:
            return
        try:
            rec = (int(msg["seq"]), int(msg["rt"]),
                   base64.b64decode(msg["p"]))
        except (KeyError, ValueError, TypeError):
            self._count("bad_records")
            return
        self._rx.append(rec)

    # ---- the standby's surface (any thread) ----------------------------------

    def recv(self) -> list[tuple[int, int, bytes]]:
        out: list[tuple[int, int, bytes]] = []
        while True:
            try:
                out.append(self._rx.popleft())
            except IndexError:
                break
        for rec in out:
            if rec[0] > self.max_delivered:
                self.max_delivered = rec[0]
        if out:
            self._count("delivered", len(out))
        return out

    def ack(self, seq: int) -> None:
        """The cumulative watermark, back to the primary."""
        io_loop().call_soon_threadsafe(self._send_ack, int(seq))

    def _send_ack(self, seq: int) -> None:
        conn = self._conn
        if conn is None:
            return
        frame = pack_msg({"t": "ack", "q": self.queue, "seq": seq})
        if self._nem is None:
            conn.send_payload(frame)
            return
        self._ack_nseq += 1
        for action in self._nem.transmit(self._ack_nseq, frame):
            if action[0] == "reset":
                conn.reset()
            else:
                conn.send_payload(action[1])

    def peer_alive(self) -> bool:
        conn = self._conn
        return conn is not None and conn.peer_alive()

    def close(self) -> None:
        async def _close() -> None:
            await self._server.close()
            if self._conn is not None:
                await self._conn.close("standby closed")
        try:
            run_io(_close(), timeout=5.0)
        except Exception:
            pass


class SocketReplicationHub:
    """``ReplicationHub``'s surface (``authority``, ``link()``,
    ``standby()``, ``adopted``) over sockets, so
    ``MatchmakingApp(replication_hub=...)`` runs unchanged on either
    fabric.

    Loopback mode (no ``net.lease_addr``): an embedded lease service on a
    UDS path that trusts the caller's clock, and one UDS rendezvous path
    per queue under ``base_dir``. Across processes: ``net.lease_addr``
    names the shared service; the primary streams to ``set_target`` or
    ``net.repl_target``, the standby listens at ``standby(...,
    listen=...)``."""

    def __init__(self, *, net: NetConfig | None = None, lease_s: float = 0.5,
                 chaos: Any = None, seed: int = 0,
                 base_dir: str | None = None, owner: str = "hub"):
        self.net = net or NetConfig(transport="socket")
        self.chaos = chaos
        self.seed = int(seed)
        self.nemesis = NetNemesis(chaos, seed)
        #: queue → {"epoch", "owner", "state", "applied_seq"}, taken by a
        #: successor's ``start_replication``.
        self.adopted: dict[str, dict[str, Any]] = {}
        self.lease_service: LeaseService | None = None
        self._base_dir = base_dir
        lease_addr = self.net.lease_addr
        if not lease_addr:
            if self._base_dir is None:
                self._base_dir = tempfile.mkdtemp(prefix="mm_net_")
            lease_addr = f"unix:{self._base_dir}/lease.sock"
            self.lease_service = LeaseService(
                lease_addr, lease_s=lease_s, net=self.net,
                fail_renewals=getattr(chaos, "repl_fail_renewals", ()) or (),
                trust_caller_now=True)
            self.lease_service.start()
        self.authority = RemoteLeaseAuthority(
            lease_addr, net=self.net, seed=seed, client=owner,
            nemesis=self.nemesis)
        self._targets: dict[str, str] = {}
        self._links: dict[str, SocketReplicationLink] = {}
        self._standby_links: dict[str, SocketStandbyLink] = {}

    def _rendezvous(self, queue: str) -> str:
        if self._base_dir is None:
            raise ValueError(
                f"no replication target for queue {queue!r}: set "
                f"net.repl_target, call set_target(), or use loopback "
                f"mode (no lease_addr)")
        return f"unix:{self._base_dir}/repl.{_slug(queue)}.sock"

    def set_target(self, queue: str, addr: str) -> None:
        """Point this primary's stream of ``queue`` at a (new) standby
        listener, retiring the queue's current link."""
        self._targets[queue] = addr
        lk = self._links.pop(queue, None)
        if lk is not None:
            lk.close()

    def target_for(self, queue: str) -> str:
        return (self._targets.get(queue) or self.net.repl_target
                or self._rendezvous(queue))

    def link(self, queue: str) -> SocketReplicationLink:
        lk = self._links.get(queue)
        if lk is None:
            chaos = self.chaos
            if chaos is not None:
                qs = getattr(chaos, "queues", ()) or ()
                if qs and queue not in qs:
                    chaos = None
            nem = self.nemesis if chaos is self.chaos else NetNemesis(
                chaos, self.seed)
            lk = SocketReplicationLink(
                queue, self.target_for(queue), net=self.net, nemesis=nem,
                seed=self.seed)
            self._links[queue] = lk
        return lk

    def standby(self, queue: str, owner: str = "standby",
                listen: str | None = None) -> StandbyApplier:
        prev = self._standby_links.pop(queue, None)
        if prev is not None:
            # One listener per queue: the new standby takes the address
            # over; the primary's redial, baseline replay and tail
            # retransmission bring it up to date.
            prev.close()
        slink = SocketStandbyLink(
            queue, listen or self._rendezvous(queue), net=self.net,
            nemesis=self.nemesis, seed=self.seed)
        self._standby_links[queue] = slink
        return StandbyApplier(queue, slink, self.authority, owner=owner,
                              hub=self)

    def cycle_reset(self, queue: str) -> None:
        """A host-generation boundary: retire the queue's primary link and
        standby listener, so the next generation starts from a fresh acked
        watermark and stream. Without it, a previous generation's
        cumulative ack (its journal seqs restart on a fresh directory)
        would mark the new generation's low seqs acked and disarm the
        retransmission of the unacked tail. The in-process hub needs no
        such hook: its wire never loses a record."""
        lk = self._links.pop(queue, None)
        if lk is not None:
            lk.close()
        sl = self._standby_links.pop(queue, None)
        if sl is not None:
            sl.close()

    def close(self) -> None:
        for lk in self._links.values():
            lk.close()
        self._links.clear()
        for sl in self._standby_links.values():
            sl.close()
        self._standby_links.clear()
        self.authority.close()
        if self.lease_service is not None:
            self.lease_service.close()
