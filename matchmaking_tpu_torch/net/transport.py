"""Framed message transport over Unix-domain and TCP sockets.

The wire unit is a frame: a fixed header (magic, payload length, CRC32)
and the payload, the journal's own record framing. A torn or flipped frame
is detected (``FrameError``), the connection dies, and the stream resumes
by cumulative ack over the next connection: a frame error never hands a
corrupt payload to the application.

Messages are JSON dicts (binary payloads travel base64 in ``"p"``). This
module owns the connection mechanics only (heartbeats, the peer-liveness
deadline, seeded reconnect backoff, bounded send buffers); fault decisions
live in ``net/nemesis.py`` and retransmission stays in
``QueueReplication``'s unacked tail and the applier's dedup, so delivery
is at-least-once over either link.

Threading: one daemon IO thread per process runs a private asyncio loop,
and every connection object is confined to it. Callers on other threads
(the journal's tap, the service loop, a soak) hand work over with
``call_soon_threadsafe``; nothing awaits across loops. Every deadline is
``time.monotonic()`` arithmetic and every jitter draw is ``hash01``.
"""

from __future__ import annotations

import asyncio
import binascii
import collections
import json
import logging
import os
import struct
import threading
import time
from typing import Any, Awaitable, Callable

from matchmaking_tpu_torch.utils.chaos import hash01

__all__ = [
    "FrameError", "FrameDecoder", "encode_frame", "pack_msg", "unpack_msg",
    "backoff_delay", "parse_addr", "io_loop", "run_io", "MsgConn",
    "MsgServer", "ReconnectingConn",
]

log = logging.getLogger(__name__)

#: Frame header: magic (a torn-stream guard), payload length, CRC32 of the
#: payload; little-endian, as the journal's record header.
_HEADER = struct.Struct("<HII")
MAGIC = 0x4D4E  # "MN"
HEADER_LEN = _HEADER.size


class FrameError(ValueError):
    """The stream is torn, hostile or corrupt at this byte: the only safe
    answer is to close the connection (the stream resumes by ack)."""


def encode_frame(payload: bytes, max_frame: int = 1 << 20) -> bytes:
    if len(payload) > max_frame:
        raise FrameError(
            f"frame payload {len(payload)} bytes exceeds max_frame "
            f"{max_frame}")
    return _HEADER.pack(MAGIC, len(payload),
                        binascii.crc32(payload) & 0xFFFFFFFF) + payload


class FrameDecoder:
    """Incremental frame parser: ``feed`` returns every complete payload
    the buffered bytes hold and keeps a partial tail for the next feed. A
    bad magic, a length past ``max_frame`` or a CRC mismatch raises
    ``FrameError``: the byte stream cannot be trusted after it."""

    def __init__(self, max_frame: int = 1 << 20):
        self.max_frame = int(max_frame)
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[bytes]:
        self._buf.extend(data)
        out: list[bytes] = []
        while True:
            if len(self._buf) < HEADER_LEN:
                return out
            magic, length, crc = _HEADER.unpack_from(self._buf, 0)
            if magic != MAGIC:
                raise FrameError(f"bad frame magic 0x{magic:04x}")
            if length > self.max_frame:
                raise FrameError(
                    f"hostile frame length {length} > max_frame "
                    f"{self.max_frame}")
            if len(self._buf) < HEADER_LEN + length:
                return out
            payload = bytes(self._buf[HEADER_LEN:HEADER_LEN + length])
            if (binascii.crc32(payload) & 0xFFFFFFFF) != crc:
                raise FrameError(f"frame CRC mismatch (len {length})")
            del self._buf[:HEADER_LEN + length]
            out.append(payload)


def pack_msg(msg: dict[str, Any]) -> bytes:
    return json.dumps(msg, separators=(",", ":")).encode("utf-8")


def unpack_msg(payload: bytes) -> dict[str, Any]:
    d = json.loads(payload.decode("utf-8"))
    if not isinstance(d, dict) or "t" not in d:
        raise FrameError("frame payload is not a typed message")
    return d


def backoff_delay(seed: int, conn_id: str, attempt: int,
                  base_s: float, cap_s: float) -> float:
    """Seeded exponential backoff with jitter: min(cap, base · 2^n) scaled
    into [0.5, 1] by ``hash01(seed, "backoff", conn, n)``, so two seeded
    runs redial on the same schedule."""
    d = min(float(cap_s), float(base_s) * (2.0 ** min(int(attempt), 16)))
    return d * (0.5 + 0.5 * hash01(seed, "backoff", conn_id, attempt))


def parse_addr(addr: str) -> tuple[Any, ...]:
    """``"unix:/path.sock"`` or ``"tcp:host:port"``."""
    if addr.startswith("unix:"):
        return ("unix", addr[5:])
    if addr.startswith("tcp:"):
        host, _, port = addr[4:].rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad tcp addr {addr!r} (tcp:host:port)")
        return ("tcp", host, int(port))
    raise ValueError(f"bad addr {addr!r} (unix:/path or tcp:host:port)")


# ---- the process-wide IO thread ---------------------------------------------

_io_lock = threading.Lock()
_io: asyncio.AbstractEventLoop | None = None


def io_loop() -> asyncio.AbstractEventLoop:
    """The process's network IO loop (a daemon thread started at first
    use). Connections live there; other threads hand work over with
    ``call_soon_threadsafe`` or ``run_io``."""
    global _io
    with _io_lock:
        if _io is not None and not _io.is_closed():
            return _io
        loop = asyncio.new_event_loop()
        ready = threading.Event()

        def run() -> None:
            asyncio.set_event_loop(loop)
            loop.call_soon(ready.set)
            loop.run_forever()

        threading.Thread(target=run, name="mm-torch-net-io",
                         daemon=True).start()
        ready.wait(5.0)
        _io = loop
        return loop


def run_io(coro: Awaitable[Any], timeout: float | None = None) -> Any:
    """Run a coroutine on the IO loop from another thread and wait."""
    return asyncio.run_coroutine_threadsafe(coro, io_loop()).result(timeout)


# ---- connections ------------------------------------------------------------


class MsgConn:
    """One framed connection, confined to the IO loop: the read task
    (decode, then ``on_msg``), the heartbeat task (``{"t":"hb"}`` every
    ``heartbeat_interval_s``; the peer is dead, and the connection closes,
    after ``heartbeat_timeout_s`` without an inbound frame) and the bounded
    send (a frame that would push the transport's write buffer past
    ``send_buffer_bytes`` is dropped and counted ``backpressure_dropped``:
    the retransmission upstream heals it).

    ``rx_deaf`` is the nemesis's receiver-side verdict (an asymmetric
    partition): while it says True, inbound bytes, heartbeats included,
    are dropped before they refresh the liveness deadline, so a deaf
    receiver sees its peer as dead."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *, name: str,
                 on_msg: Callable[[dict[str, Any]], None],
                 counters: collections.Counter,
                 counters_lock: threading.Lock,
                 heartbeat_interval_s: float = 0.1,
                 heartbeat_timeout_s: float = 0.6,
                 max_frame: int = 1 << 20,
                 send_buffer_bytes: int = 4 << 20,
                 rx_deaf: Callable[[], bool] | None = None,
                 on_close: Callable[[MsgConn], None] | None = None):
        self.name = name
        self._reader = reader
        self._writer = writer
        self._on_msg = on_msg
        self._counters = counters
        self._clock = counters_lock
        self._hb_interval = float(heartbeat_interval_s)
        self._hb_timeout = float(heartbeat_timeout_s)
        self._max_frame = int(max_frame)
        self._send_limit = int(send_buffer_bytes)
        self._rx_deaf = rx_deaf
        self._on_close = on_close
        self._last_rx = time.monotonic()
        self._closed = False
        self.closed_evt = asyncio.Event()
        self._tasks: list[asyncio.Task] = []

    def _count(self, key: str, n: int = 1) -> None:
        with self._clock:
            self._counters[key] += n

    def start(self) -> None:
        self._tasks.append(asyncio.ensure_future(self._read_loop()))
        self._tasks.append(asyncio.ensure_future(self._hb_loop()))

    # ---- send (on the IO loop) ---------------------------------------------

    def send_payload(self, payload: bytes) -> bool:
        """Write one frame; False (dropped and counted) under backpressure
        or on a closed connection. Never blocks."""
        if self._closed:
            self._count("send_closed_dropped")
            return False
        transport = self._writer.transport
        if (transport is not None
                and transport.get_write_buffer_size() > self._send_limit):
            self._count("backpressure_dropped")
            return False
        try:
            self._writer.write(encode_frame(payload, self._max_frame))
        except Exception:
            self._count("send_errors")
            self._schedule_close("write failed")
            return False
        self._count("frames_tx")
        return True

    def send_msg(self, msg: dict[str, Any]) -> bool:
        return self.send_payload(pack_msg(msg))

    # ---- liveness ----------------------------------------------------------

    def peer_alive(self, now: float | None = None) -> bool:
        t = time.monotonic() if now is None else now
        return (t - self._last_rx) < self._hb_timeout

    # ---- internals ---------------------------------------------------------

    async def _read_loop(self) -> None:
        dec = FrameDecoder(self._max_frame)
        try:
            while True:
                data = await self._reader.read(1 << 16)
                if not data:
                    self._schedule_close("peer closed")
                    return
                if self._rx_deaf is not None and self._rx_deaf():
                    self._count("rx_deaf_dropped")
                    continue
                for payload in dec.feed(data):
                    self._last_rx = time.monotonic()
                    self._count("frames_rx")
                    msg = unpack_msg(payload)
                    if msg.get("t") == "hb":
                        continue
                    try:
                        self._on_msg(msg)
                    except Exception:
                        log.exception("%s: on_msg failed", self.name)
        except FrameError as e:
            # Nothing after the bad byte is delivered; the stream resumes
            # by cumulative ack over the next connection.
            self._count("frame_errors")
            log.warning("%s: frame error (%s), closing", self.name, e)
            self._schedule_close("frame error")
        except (asyncio.CancelledError, GeneratorExit):
            raise
        except Exception:
            self._count("read_errors")
            self._schedule_close("read failed")

    async def _hb_loop(self) -> None:
        try:
            while not self._closed:
                await asyncio.sleep(self._hb_interval)
                if not self.peer_alive():
                    self._count("liveness_lost")
                    log.warning("%s: peer liveness lost, closing", self.name)
                    self._schedule_close("liveness lost")
                    return
                self.send_msg({"t": "hb"})
        except (asyncio.CancelledError, GeneratorExit):
            raise
        except Exception:
            self._schedule_close("heartbeat failed")

    def _schedule_close(self, reason: str) -> None:
        if not self._closed:
            asyncio.ensure_future(self.close(reason))

    async def close(self, reason: str = "closed") -> None:
        if self._closed:
            return
        self._closed = True
        for t in self._tasks:
            if t is not asyncio.current_task():
                t.cancel()
        try:
            self._writer.close()
        except Exception:
            pass
        self.closed_evt.set()
        if self._on_close is not None:
            try:
                self._on_close(self)
            except Exception:
                log.exception("%s: on_close failed", self.name)

    def reset(self) -> None:
        """An abrupt close (the nemesis's mid-stream reset): no flush, the
        peer sees EOF or ECONNRESET mid-frame."""
        try:
            transport = self._writer.transport
            if transport is not None:
                transport.abort()
        except Exception:
            pass
        self._schedule_close("reset")


class MsgServer:
    """A listener on a TCP or UDS address; hands every accepted connection
    to ``on_conn`` on the IO loop before starting it (so the acceptor can
    rebind its message handler first)."""

    def __init__(self, addr: str, *, name: str,
                 on_conn: Callable[[MsgConn], None],
                 conn_kwargs: dict[str, Any]):
        self.addr = addr
        self.name = name
        self._on_conn = on_conn
        self._conn_kwargs = conn_kwargs
        self._server: asyncio.base_events.Server | None = None

    async def start(self) -> None:
        kind = parse_addr(self.addr)

        async def accept(reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
            conn = MsgConn(reader, writer,
                           name=f"{self.name}<-", **self._conn_kwargs)
            self._on_conn(conn)
            conn.start()

        if kind[0] == "unix":
            try:
                # A stale socket file of a closed or killed listener: the
                # path is the rendezvous, not the inode.
                os.unlink(kind[1])
            except OSError:
                pass
            self._server = await asyncio.start_unix_server(accept, kind[1])
        else:
            self._server = await asyncio.start_server(accept, kind[1],
                                                      kind[2])

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
            self._server = None


class ReconnectingConn:
    """The client half of a long-lived link: dial ``addr`` within the
    connect timeout, run a ``MsgConn`` until it dies, then redial after
    the seeded backoff, until ``close``. ``on_connect`` runs on the IO
    loop after every dial (the replication link replays its baseline
    there)."""

    def __init__(self, addr: str, *, name: str, seed: int,
                 on_msg: Callable[[dict[str, Any]], None],
                 counters: collections.Counter,
                 counters_lock: threading.Lock,
                 connect_timeout_s: float = 1.0,
                 reconnect_base_s: float = 0.02,
                 reconnect_cap_s: float = 1.0,
                 conn_kwargs: dict[str, Any] | None = None,
                 on_connect: Callable[[MsgConn], None] | None = None):
        self.addr = addr
        self.name = name
        self._seed = int(seed)
        self._on_msg = on_msg
        self._counters = counters
        self._clock = counters_lock
        self._connect_timeout = float(connect_timeout_s)
        self._base = float(reconnect_base_s)
        self._cap = float(reconnect_cap_s)
        self._conn_kwargs = dict(conn_kwargs or {})
        self._on_connect = on_connect
        self.conn: MsgConn | None = None
        self._closed = False
        self._task: asyncio.Task | None = None

    def _count(self, key: str, n: int = 1) -> None:
        with self._clock:
            self._counters[key] += n

    def start(self) -> None:
        io_loop().call_soon_threadsafe(self._start_on_loop)

    def _start_on_loop(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def _dial(self) -> tuple[asyncio.StreamReader,
                                   asyncio.StreamWriter]:
        kind = parse_addr(self.addr)
        if kind[0] == "unix":
            fut = asyncio.open_unix_connection(kind[1])
        else:
            fut = asyncio.open_connection(kind[1], kind[2])
        return await asyncio.wait_for(fut, timeout=self._connect_timeout)

    async def _run(self) -> None:
        attempt = 0
        connects = 0
        while not self._closed:
            try:
                reader, writer = await self._dial()
            except (asyncio.CancelledError, GeneratorExit):
                raise
            except Exception:
                self._count("connect_failures")
                attempt += 1
                await asyncio.sleep(backoff_delay(
                    self._seed, self.name, attempt, self._base, self._cap))
                continue
            attempt = 0
            connects += 1
            self._count("connects")
            if connects > 1:
                self._count("reconnects")
            conn = MsgConn(reader, writer, name=f"{self.name}->",
                           on_msg=self._on_msg, counters=self._counters,
                           counters_lock=self._clock, **self._conn_kwargs)
            conn.start()
            self.conn = conn
            if self._on_connect is not None:
                try:
                    self._on_connect(conn)
                except Exception:
                    log.exception("%s: on_connect failed", self.name)
            await conn.closed_evt.wait()
            self.conn = None
            if not self._closed:
                attempt += 1
                await asyncio.sleep(backoff_delay(
                    self._seed, self.name, attempt, self._base, self._cap))

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self.conn is not None:
            await self.conn.close("client closed")
            self.conn = None
