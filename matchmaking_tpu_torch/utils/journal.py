"""Per-queue write-ahead pool journal and hard-crash recovery.

The port's copy of the JAX package's journal module. Segment files,
record frames and payloads are byte-equal to the JAX package's for the
same records, so either package recovers the other's journal directory.

- **Framing.** A segment is a sequence of CRC-framed records: a ``<IIQB``
  header (crc32, payload length, record seq, record type) and the payload;
  the crc covers (length, seq, type, payload). The first record is a
  version-stamped SEGMENT header naming the snapshot the segment follows.
  A torn tail (a crash mid-write) parses as "stop here", never as garbage.
- **Records.** ``ADMIT``: one cut window's dispatched players, as rows of
  columns (one append per window, not per player). ``TERMINAL`` /
  ``TERMINALS``: one player's, or one window's, terminal answers (the
  response body and its dedup expiry: what the terminal-replay cache
  holds). ``ADMISSION``: the admission controller's decision checkpoint,
  written at compaction. ``CLEAN``: the clean-shutdown marker; its absence
  at boot is the crash detector.
- **Write-ahead.** Appends are buffered (or written out at once, for the
  per-window records); ``commit()`` writes the buffer in one ``os.write``
  and fsyncs per the policy (``none`` | ``interval`` | ``window``). The
  service commits before any answer is published and before any delivery
  is acked, so under ``fsync="window"`` an answer a client saw implies a
  durable record of it.
- **Compaction.** The queue's pool is snapshotted to
  ``<queue>.snap.<S>.npz`` (``utils/checkpoint.py``) at the anchor seq
  ``S``, the live segment rotates to ``.prev`` and a fresh segment opens
  anchored at ``S``, carrying the live dedup entries and the admission
  checkpoint. Replay filters pool effects by seq, not by file, so a crash
  at any point of a compaction recovers without loss.
- **Recovery.** ``PoolJournal`` attaches to whatever exists at
  construction: the newest snapshot that verifies (falling back to an
  older one, with a note, when the newest is corrupt), then every retained
  segment's records after the snapshot's seq, folded into the final
  (waiting, removed, recent, admission) state, and whether the shutdown
  was clean. The service applies that state to its engine.

``tap`` and ``fence`` are the replication hooks (service/replication.py):
the stream of every sealed record, and the epoch fence checked at the top
of every append. Both are None while replication is off.
"""

from __future__ import annotations

import base64
import dataclasses
import glob
import json
import logging
import os
import re
import struct
import threading
import time
import zlib
from typing import Any

import numpy as np

from matchmaking_tpu_torch.service.contract import SearchRequest

log = logging.getLogger(__name__)

FORMAT_VERSION = 1

#: Record frame header: crc32, payload length, record seq, record type.
_HEADER = struct.Struct("<IIQB")

RT_SEGMENT = 0    #: segment header (version stamp + snapshot anchor)
RT_ADMIT = 1      #: one cut window's dispatched players (columns)
RT_TERMINAL = 2   #: one player's terminal (response body + dedup expiry)
RT_ADMISSION = 3  #: admission controller decision checkpoint
RT_CLEAN = 4      #: clean-shutdown marker
RT_TERMINALS = 5  #: one window's terminals in one record


class FencedError(RuntimeError):
    """Append refused: the journal's owner was epoch-fenced (a standby
    took the queue over). Raised by ``_append`` when the installed
    ``fence`` check fails."""


_FSYNC_POLICIES = ("none", "interval", "window")

_SNAP_RE = re.compile(r"\.snap\.(\d+)\.npz$")


def journal_path(directory: str, queue: str) -> str:
    return os.path.join(directory, f"{queue}.journal")


def snapshot_path(directory: str, queue: str, seq: int) -> str:
    return os.path.join(directory, f"{queue}.snap.{seq:012d}.npz")


def list_snapshots(directory: str, queue: str) -> list[tuple[int, str]]:
    """(seq, path) of every compaction snapshot of ``queue``, newest
    first. Leftover ``.tmp`` files of an interrupted compaction never
    match."""
    out: list[tuple[int, str]] = []
    for path in glob.glob(os.path.join(directory, f"{queue}.snap.*.npz")):
        m = _SNAP_RE.search(path)
        if m is not None:
            out.append((int(m.group(1)), path))
    out.sort(reverse=True)
    return out


def _frame(seq: int, rtype: int, payload: bytes) -> bytes:
    crc = zlib.crc32(struct.pack("<IQB", len(payload), seq, rtype))
    crc = zlib.crc32(payload, crc)
    return _HEADER.pack(crc, len(payload), seq, rtype) + payload


def read_segment(path: str) -> tuple[dict[str, Any], list[tuple[int, int, bytes]], bool, int]:
    """Parse one segment: (header dict, [(seq, rtype, payload)], torn,
    intact byte offset). Stops at the first truncated or CRC-bad frame (a
    torn tail is the normal shape after a crash; everything before it is
    intact, and ``intact`` is where a re-attaching writer truncates).
    Raises ``ValueError`` only when the SEGMENT header is unreadable."""
    records: list[tuple[int, int, bytes]] = []
    torn = False
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    header: dict[str, Any] | None = None
    while off + _HEADER.size <= len(data):
        crc, length, seq, rtype = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + length
        if end > len(data):
            torn = True
            break
        payload = data[off + _HEADER.size:end]
        want = zlib.crc32(struct.pack("<IQB", length, seq, rtype))
        want = zlib.crc32(payload, want)
        if want != crc:
            torn = True
            break
        if rtype == RT_SEGMENT:
            if header is None:
                header = json.loads(payload.decode("utf-8"))
        else:
            records.append((seq, rtype, payload))
        off = end
    if off < len(data):
        torn = True
    if header is None:
        raise ValueError(f"{path}: no valid segment header")
    if header.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"{path}: unsupported journal version {header.get('version')}")
    return header, records, torn, off


def admit_payload(rows: list[list[Any]]) -> bytes:
    """One cut window's ADMIT payload. Each row: [id, rating, rd, region,
    mode, threshold|None, enqueued_at, reply_to, correlation_id, tier,
    deadline], region and mode by NAME (codes are process-local)."""
    return json.dumps({"rows": rows}, separators=(",", ":")).encode("utf-8")


def terminal_payload(pid: str, body: bytes, expiry: float) -> bytes:
    return json.dumps(
        {"id": pid, "body": base64.b64encode(body).decode("ascii"),
         "exp": expiry}, separators=(",", ":")).encode("utf-8")


def terminals_payload(entries: "list[tuple[str, bytes, float]]") -> bytes:
    """One window's terminals as one RT_TERMINALS payload."""
    return json.dumps(
        {"t": [[pid, base64.b64encode(body).decode("ascii"), exp]
               for pid, body, exp in entries]},
        separators=(",", ":")).encode("utf-8")


def row_to_request(row: list[Any]) -> SearchRequest:
    """An ADMIT row → the ``SearchRequest`` that ``engine.restore`` takes."""
    thr = row[5]
    return SearchRequest(
        id=str(row[0]), rating=float(row[1]), rating_deviation=float(row[2]),
        region=str(row[3]), game_mode=str(row[4]),
        rating_threshold=None if thr is None else float(thr),
        enqueued_at=float(row[6]), reply_to=str(row[7]),
        correlation_id=str(row[8]), tier=int(row[9]),
        deadline_at=float(row[10]))


@dataclasses.dataclass
class RecoveredQueue:
    """The journal's account of one queue at boot, ready to apply."""

    queue: str
    #: The clean-shutdown marker is the last record (no recovery needed).
    clean: bool = True
    #: Newest snapshot that verified, or "" (start from empty).
    snapshot: str = ""
    snapshot_seq: int = 0
    #: A newer snapshot existed but failed verification.
    fallback: bool = False
    #: Notes on corrupt snapshots and torn tails.
    corrupt: list[str] = dataclasses.field(default_factory=list)
    #: id → ADMIT row of journal-admitted players still waiting.
    waiting: dict[str, list[Any]] = dataclasses.field(default_factory=dict)
    #: ids that reached a terminal after the snapshot and were not
    #: re-admitted after it (removed from the snapshot at recovery).
    removed: set[str] = dataclasses.field(default_factory=set)
    #: id → (response body, dedup expiry): the terminal-replay cache.
    recent: dict[str, tuple[bytes, float]] = dataclasses.field(
        default_factory=dict)
    #: The newest admission checkpoint, or None.
    admission: dict[str, Any] | None = None
    last_seq: int = 0
    replayed: int = 0

    def transcript(self) -> dict[str, Any]:
        """A pure function of the recovered state (independent of window
        framing, record grouping and compaction cadence: the snapshot's
        name carries its anchor seq, so only its presence counts)."""
        return {
            "queue": self.queue,
            "clean": self.clean,
            "snapshot": bool(self.snapshot),
            "fallback": self.fallback,
            "waiting": sorted(self.waiting),
            "removed": sorted(self.removed),
            "recent": sorted(self.recent),
        }


def _verify_snapshot(path: str) -> bool:
    """Read a pool snapshot whole (meta and every array, so the zip CRCs
    check every byte): a truncated or bit-flipped file is caught here,
    before recovery replays against it."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("version") is None:
                return False
            for name in z.files:
                z[name]
        return True
    except Exception:
        return False


# protocol-monotone: seq, synced_seq, last_seq
class PoolJournal:
    """One queue's write-ahead journal. Every mutation runs under an
    internal ``threading.Lock``: appends come from the event loop, commits
    and compactions from worker threads.

    Construction attaches to the artifacts on disk (the recovery parse is
    ``self.recovered``; None on a fresh directory) and continues the seq
    numbering past the newest record. It never truncates state:
    compaction and the clean marker are explicit calls."""

    def __init__(self, directory: str, queue: str, *, fsync: str = "none",
                 fsync_interval_s: float = 0.05,
                 compact_records: int = 50_000,
                 compact_bytes: int = 8 << 20,
                 keep_snapshots: int = 2):
        if fsync not in _FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync policy {fsync!r} (one of {_FSYNC_POLICIES})")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.queue = queue
        self.fsync = fsync
        self.fsync_interval_s = fsync_interval_s
        self.compact_records = max(1, compact_records)
        self.compact_bytes = max(1, compact_bytes)
        self.keep_snapshots = max(1, keep_snapshots)
        self._lock = threading.Lock()
        self._buf: list[bytes] = []  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        #: Bytes written out but not yet fsynced: what a policy commit
        #: still owes.
        self._unsynced = False  # guarded-by: _lock
        self._last_fsync = time.monotonic()  # guarded-by: _lock
        #: Monotone record sequence (the replay order).
        self.seq = 0  # guarded-by: _lock
        #: Highest seq covered by an fsync (seq - synced_seq records could
        #: still be lost to a host loss).
        self.synced_seq = 0  # guarded-by: _lock
        #: Live-segment size (the compaction trigger).
        self.segment_records = 0  # guarded-by: _lock
        self.segment_bytes = 0  # guarded-by: _lock
        #: Lifetime file bytes written and logical payload bytes.
        self.bytes_written = 0  # guarded-by: _lock
        self.payload_bytes = 0  # guarded-by: _lock
        self._fd: int | None = None  # guarded-by: _lock
        #: Replication stream (None: off): ``tap(seq, rtype, payload)`` for
        #: every sealed record, appends and compaction carries alike.
        self.tap = None
        #: Records whose tap raised (logged; the append itself stands).
        self.tap_errors = 0
        #: Epoch fence (None: unfenced): a ``() -> bool`` check at the top
        #: of every append; False raises ``FencedError``.
        self.fence = None
        self.recovered: RecoveredQueue | None = self._attach()
        if self.recovered is not None:
            self.seq = self.recovered.last_seq
            self._reopen_live()
        else:
            self._open_segment(snapshot="", snapshot_seq=0)
        self.synced_seq = self.seq

    # ---- attach / recovery -------------------------------------------------

    def _reopen_live(self) -> None:
        """Re-attach the writer to the live segment: truncate a torn tail
        back to the last intact frame (appending after garbage would hide
        every later record from replay), then append. A missing or
        headerless live segment is replaced by a fresh one."""
        live = journal_path(self.directory, self.queue)
        if not os.path.exists(live) or self._live_intact < 0:
            self._open_segment(snapshot="", snapshot_seq=0)
            return
        fd = os.open(live, os.O_WRONLY)
        if self._live_intact:
            os.ftruncate(fd, self._live_intact)
        os.lseek(fd, 0, os.SEEK_END)
        self._fd = fd
        self.segment_records = 0
        self.segment_bytes = os.fstat(fd).st_size

    def _attach(self) -> RecoveredQueue | None:
        #: Intact byte offset of the live segment: -1 unreadable, 0 intact
        #: to its end (no truncation needed).
        self._live_intact = 0
        live = journal_path(self.directory, self.queue)
        prev = live + ".prev"
        snaps = list_snapshots(self.directory, self.queue)
        if not os.path.exists(live) and not os.path.exists(prev) \
                and not snaps:
            return None
        rec = RecoveredQueue(queue=self.queue)
        first = True
        for seq, path in snaps:
            if _verify_snapshot(path):
                rec.snapshot, rec.snapshot_seq = path, seq
                rec.fallback = not first
                break
            rec.corrupt.append(
                f"snapshot {os.path.basename(path)} failed verification "
                f"(truncated or corrupt) — falling back")
            first = False
        records: list[tuple[int, int, bytes]] = []
        clean = False
        torn_any = False
        any_segment = False
        for path in (prev, live):
            if not os.path.exists(path):
                continue
            try:
                _header, recs, torn, intact = read_segment(path)
            except ValueError as e:
                rec.corrupt.append(str(e))
                if path == live:
                    self._live_intact = -1
                continue
            any_segment = True
            if torn:
                torn_any = True
                rec.corrupt.append(
                    f"{os.path.basename(path)}: torn tail — replay stops "
                    f"at the last intact record")
                if path == live:
                    self._live_intact = intact
            records.extend(recs)
        records.sort(key=lambda r: r[0])
        for seq, rtype, payload in records:
            rec.last_seq = max(rec.last_seq, seq)
            if rtype == RT_CLEAN:
                clean = True
                continue
            clean = False  # any later record reopens the journal
            if rtype == RT_ADMIT:
                if seq <= rec.snapshot_seq:
                    continue  # the snapshot supersedes it
                rec.replayed += 1
                for row in json.loads(payload.decode("utf-8"))["rows"]:
                    rec.waiting[str(row[0])] = row
                    rec.removed.discard(str(row[0]))
            elif rtype in (RT_TERMINAL, RT_TERMINALS):
                # Terminals rebuild ``recent`` whatever their seq (the dedup
                # horizon is not pool state: a pre-anchor terminal left in
                # ``.prev`` still counts, which makes a crash between a
                # compaction's two renames lossless); their pool effects
                # are seq-filtered.
                d = json.loads(payload.decode("utf-8"))
                entries = (d["t"] if rtype == RT_TERMINALS
                           else [[d["id"], d["body"], d["exp"]]])
                for pid, b64, exp in entries:
                    pid = str(pid)
                    rec.recent[pid] = (base64.b64decode(b64), float(exp))
                    if seq > rec.snapshot_seq:
                        rec.replayed += 1
                        rec.waiting.pop(pid, None)
                        rec.removed.add(pid)
            elif rtype == RT_ADMISSION:
                # A checkpoint, not a delta: the newest one wins.
                rec.admission = json.loads(payload.decode("utf-8"))
        # No segment (a snapshot-only directory: the process died between
        # the snapshot and the segment) or a torn tail: unclean.
        rec.clean = clean and not torn_any if any_segment else False
        return rec

    # ---- append / commit ----------------------------------------------------

    def _open_segment(self, snapshot: str, snapshot_seq: int) -> None:
        header = {"version": FORMAT_VERSION, "queue": self.queue,
                  "snapshot": os.path.basename(snapshot) if snapshot else "",
                  "snapshot_seq": snapshot_seq}
        frame = _frame(0, RT_SEGMENT,
                       json.dumps(header, separators=(",", ":")).encode())
        path = journal_path(self.directory, self.queue)
        fd = os.open(path + ".new", os.O_CREAT | os.O_TRUNC | os.O_WRONLY,
                     0o644)
        os.write(fd, frame)
        os.fsync(fd)
        os.replace(path + ".new", path)
        self._fd = fd
        self.segment_records = 0
        self.segment_bytes = len(frame)
        self.bytes_written += len(frame)

    # protocol-effect: journal_append requires-fence fence
    def _append(self, rtype: int, payload: bytes, logical: int,
                writeout: bool = False) -> int:
        """Assign the next seq, frame the record and buffer it; with
        ``writeout``, ``os.write`` it in the same lock hold (the per-window
        records: a process crash cannot lose written bytes, so a window
        that crashes mid-flight recovers its players as waiting). Returns
        the seq."""
        if self.fence is not None and not self.fence():
            raise FencedError(
                f"journal append for {self.queue!r} refused: owner was "
                f"epoch-fenced (a standby took over this queue)")
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    f"journal for {self.queue!r} is closed (append after "
                    f"clean-shutdown marker)")
            self.seq += 1
            seq = self.seq
            frame = _frame(seq, rtype, payload)
            if writeout and self._fd is not None:
                os.write(self._fd, frame)
                self.segment_records += 1
                self.segment_bytes += len(frame)
                self.bytes_written += len(frame)
                self._unsynced = True
            else:
                self._buf.append(frame)
            self.payload_bytes += logical
            if self.tap is not None:
                # A tap failure must not fail the append.
                try:
                    self.tap(seq, rtype, payload)
                except Exception:
                    self.tap_errors += 1
                    log.exception("journal tap failed for %r seq %d",
                                  self.queue, seq)
            return seq

    def append_admits(self, rows: list[list[Any]]) -> int:
        """One cut window's dispatched players: one record, written out in
        the append (the policy fsync runs at the commit points)."""
        payload = admit_payload(rows)
        return self._append(RT_ADMIT, payload, len(payload), writeout=True)

    def append_terminal(self, pid: str, body: bytes, expiry: float) -> int:
        return self._append(RT_TERMINAL, terminal_payload(pid, body, expiry),
                            len(body))

    def append_terminals(self,
                         entries: "list[tuple[str, bytes, float]]") -> int:
        """One window's terminals: one record, written out in the append."""
        return self._append(RT_TERMINALS, terminals_payload(entries),
                            sum(len(b) for _, b, _ in entries),
                            writeout=True)

    @property
    def dirty(self) -> bool:
        return bool(self._buf)

    # holds-lock: _lock
    def _writeout_locked(self) -> None:
        """Write the frame buffer in one os.write (the caller holds
        ``_lock``)."""
        if not self._buf or self._fd is None:
            return
        data = b"".join(self._buf)
        n = len(self._buf)
        self._buf.clear()
        os.write(self._fd, data)
        self.segment_records += n
        self.segment_bytes += len(data)
        self.bytes_written += len(data)
        self._unsynced = True

    def flush_buffer(self) -> None:
        """Write the buffered frames without an fsync, whatever the policy
        (the admit-at-dispatch point: a process crash cannot lose written
        bytes; host-loss durability is promised at the commit points)."""
        with self._lock:
            self._writeout_locked()

    @property
    def needs_commit(self) -> bool:
        """Buffered frames, or written bytes a policy still owes an fsync."""
        if self._buf:
            return True
        return self._unsynced and self.fsync in ("interval", "window")

    def commit(self, force_sync: bool = False) -> None:
        """Write the buffer in one os.write and fsync per policy (covering
        earlier ``flush_buffer`` writes too). The service calls it before
        an answer is published and before a delivery is acked."""
        with self._lock:
            self._writeout_locked()
            if self._fd is None or not (force_sync or self._unsynced):
                return
            if force_sync or self.fsync == "window":
                written = self.seq
                os.fsync(self._fd)
                self._unsynced = False
                self.synced_seq = max(self.synced_seq, written)
                self._last_fsync = time.monotonic()
            elif self.fsync == "interval":
                now = time.monotonic()
                if now - self._last_fsync >= self.fsync_interval_s:
                    written = self.seq
                    os.fsync(self._fd)
                    self._unsynced = False
                    self.synced_seq = max(self.synced_seq, written)
                    self._last_fsync = now

    def wants_compact(self) -> bool:
        return (self.segment_records >= self.compact_records
                or self.segment_bytes >= self.compact_bytes)

    # ---- compaction ---------------------------------------------------------

    def compact_begin(self) -> tuple[int, str]:
        """Capture the compaction anchor. The caller keeps the pool still
        (no dispatch, no collection, no append) from here until
        ``compact_finish`` returns, and writes the pool snapshot to the
        returned path in between. Returns (anchor seq, snapshot path)."""
        self.commit()
        with self._lock:
            return self.seq, snapshot_path(self.directory, self.queue,
                                           self.seq)

    # protocol-effect: journal_append requires-fence fence
    def compact_finish(self, anchor_seq: int, snap_path: str,
                       carry_terminals: list[tuple[str, bytes, float]] = (),
                       admission: dict[str, Any] | None = None) -> None:
        """Rotate to a fresh segment anchored at the (verified) snapshot,
        carrying the live dedup entries and the admission checkpoint.
        Crash-atomic: the successor segment is written whole (header,
        carries, admission; fsynced) to a side file before the two
        renames, and the seq-unfiltered terminal replay covers the moment
        between the renames."""
        if self.fence is not None and not self.fence():
            raise FencedError(
                f"journal compaction for {self.queue!r} refused: owner "
                f"was epoch-fenced")
        if not _verify_snapshot(snap_path):
            # Never truncate history against a snapshot that does not read
            # back: the old segment keeps covering the pool.
            raise ValueError(
                f"compaction snapshot {snap_path!r} failed verification — "
                f"keeping the current journal segment")
        live = journal_path(self.directory, self.queue)
        with self._lock:
            header = {"version": FORMAT_VERSION, "queue": self.queue,
                      "snapshot": os.path.basename(snap_path),
                      "snapshot_seq": anchor_seq}
            frames = [_frame(0, RT_SEGMENT,
                             json.dumps(header,
                                        separators=(",", ":")).encode())]
            logical = 0
            tapped: list[tuple[int, int, bytes]] = []
            for pid, body, exp in carry_terminals:
                self.seq += 1
                payload = terminal_payload(pid, body, exp)
                frames.append(_frame(self.seq, RT_TERMINAL, payload))
                tapped.append((self.seq, RT_TERMINAL, payload))
                logical += len(body)
            if admission is not None:
                self.seq += 1
                payload = json.dumps(admission,
                                     separators=(",", ":")).encode("utf-8")
                frames.append(_frame(self.seq, RT_ADMISSION, payload))
                tapped.append((self.seq, RT_ADMISSION, payload))
                logical += len(payload)
            if self.tap is not None:
                for seq, rtype, payload in tapped:
                    try:
                        self.tap(seq, rtype, payload)
                    except Exception:
                        self.tap_errors += 1
                        log.exception("journal tap failed for %r seq %d",
                                      self.queue, seq)
            data = b"".join(frames)
            fd = os.open(live + ".new",
                         os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o644)
            os.write(fd, data)
            os.fsync(fd)
            if self._fd is not None:
                os.fsync(self._fd)
                os.close(self._fd)
                self._fd = None
            if os.path.exists(live):
                os.replace(live, live + ".prev")
            os.replace(live + ".new", live)
            self._fd = fd
            self.segment_records = len(frames) - 1
            self.segment_bytes = len(data)
            self.bytes_written += len(data)
            self.payload_bytes += logical
            # Both segments were fsynced: everything so far is durable.
            self._unsynced = False
            self.synced_seq = max(self.synced_seq, self.seq)
        self._gc(anchor_seq)

    def _gc(self, anchor_seq: int) -> None:
        """Drop snapshot generations beyond ``keep_snapshots`` (the anchor
        counts as the first)."""
        snaps = list_snapshots(self.directory, self.queue)
        keep = {path for _seq, path in snaps[:self.keep_snapshots]}
        for _seq, path in snaps:
            if path not in keep:
                try:
                    os.unlink(path)
                except OSError:
                    log.warning("could not gc old snapshot %s", path)

    # ---- lifecycle ------------------------------------------------------------

    def mark_clean(self) -> None:
        """Append the clean-shutdown marker, durably: the next boot skips
        crash recovery."""
        self._append(RT_CLEAN, b"", 0)
        self.commit(force_sync=True)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fd is not None:
                if self._buf:
                    data = b"".join(self._buf)
                    self._buf.clear()
                    os.write(self._fd, data)
                    self.bytes_written += len(data)
                os.fsync(self._fd)
                os.close(self._fd)
                self._fd = None

    def abandon(self) -> None:
        """Crash-fidelity teardown: drop the uncommitted buffer and close
        the file without a clean marker or an fsync, leaving on disk what
        a ``kill -9`` would."""
        with self._lock:
            self._closed = True
            self._buf.clear()
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
