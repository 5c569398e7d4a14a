"""The port's write-ahead journal (utils/journal.py) against the JAX
package's, on the CPU.

- Frames and payloads of seeded records byte-equal to the JAX package's,
  and the segment file of one scripted run (admits, terminals, a
  compaction with carries and an admission checkpoint, a torn tail)
  byte-equal whichever package wrote it.
- A directory written by either package's ``PoolJournal`` recovered by the
  other's: equal ``RecoveredQueue`` and ``transcript()``.
- The JAX package's journal cases, run on the port's: a torn tail, the
  clean marker, an append after close, a crash mid-window, a corrupt
  newest snapshot falling back, a crash during compaction keeping the old
  state, and ``FencedError`` with a fence installed.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
from matchmaking_tpu.engine.cpu import CpuEngine as JaxCpuEngine
from matchmaking_tpu.utils import checkpoint as jax_ck
from matchmaking_tpu.utils import journal as jax_jr
from matchmaking_tpu_torch.config import Config, QueueConfig
from matchmaking_tpu_torch.engine.cpu import CpuEngine
from matchmaking_tpu_torch.utils import checkpoint as ck
from matchmaking_tpu_torch.utils import journal as jr

Q = "q"


def _row(pid, rating=1500.0):
    return [pid, rating, 0.0, "", "", None, 1.0, "r.q", pid, 0, 0.0]


def _rows(seed, n, start=0):
    """Seeded ADMIT rows: f32-exact ratings, thresholds or None, names,
    enqueue times, reply queues, tiers and deadlines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(start, start + n):
        thr = None if rng.random() < 0.5 else float(np.float32(
            rng.uniform(20, 300)))
        out.append([f"p{i}", float(np.float32(rng.normal(1500, 300))),
                    float(np.float32(rng.uniform(0, 350))),
                    ["*", "eu", "na"][int(rng.integers(0, 3))],
                    ["*", "ranked"][int(rng.integers(0, 2))], thr,
                    float(1.7e9 + rng.uniform(0, 100)), f"rq.{i}", f"c{i}",
                    int(rng.integers(0, 3)),
                    0.0 if rng.random() < 0.5 else float(1.7e9 + 200.0)])
    return out


def _terminals(seed, ids):
    rng = np.random.default_rng(seed)
    return [(pid, bytes(rng.integers(0, 256, int(rng.integers(1, 90)),
                                     dtype=np.uint8)),
             float(1.7e9 + rng.uniform(0, 60))) for pid in ids]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_and_payloads_equal_jax(seed):
    rows = _rows(seed, 40)
    terms = _terminals(seed, [r[0] for r in rows[:25]])
    assert jr.admit_payload(rows) == jax_jr.admit_payload(rows)
    assert jr.terminals_payload(terms) == jax_jr.terminals_payload(terms)
    for pid, body, exp in terms:
        assert jr.terminal_payload(pid, body, exp) == \
            jax_jr.terminal_payload(pid, body, exp)
    for seq, rtype in ((1, jr.RT_ADMIT), (2**40, jr.RT_TERMINALS),
                       (7, jr.RT_CLEAN)):
        payload = jr.admit_payload(rows[:3])
        assert jr._frame(seq, rtype, payload) == \
            jax_jr._frame(seq, rtype, payload)
    assert (jr.RT_SEGMENT, jr.RT_ADMIT, jr.RT_TERMINAL, jr.RT_ADMISSION,
            jr.RT_CLEAN, jr.RT_TERMINALS, jr.FORMAT_VERSION) == (
        jax_jr.RT_SEGMENT, jax_jr.RT_ADMIT, jax_jr.RT_TERMINAL,
        jax_jr.RT_ADMISSION, jax_jr.RT_CLEAN, jax_jr.RT_TERMINALS,
        jax_jr.FORMAT_VERSION)
    mine = jr.row_to_request(rows[0])
    theirs = jax_jr.row_to_request(rows[0])
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def _script(pkg, directory, seed):
    """One queue's scripted journal run with the package ``pkg`` ("jax"
    or "port"): two windows of admits, terminals, a compaction (snapshot
    of the waiting players, carried replay entries, an admission
    checkpoint), more windows after it, a single buffered terminal that
    the crash loses, then a partial frame (a torn tail)."""
    jmod, ckmod = (jax_jr, jax_ck) if pkg == "jax" else (jr, ck)
    rows = _rows(seed, 30)
    j = jmod.PoolJournal(directory, Q, fsync="window")
    j.append_admits(rows[:12])
    j.append_terminals(_terminals(seed, [r[0] for r in rows[:4]]))
    j.append_admits(rows[12:20])
    j.append_terminal(rows[5][0], b"timeout-body", 1.7e9 + 30.0)
    j.commit()
    anchor, snap = j.compact_begin()
    gone = {r[0] for r in rows[:4]} | {rows[5][0]}
    waiting = [jmod.row_to_request(r) for r in rows[:20] if r[0] not in gone]
    if pkg == "jax":
        eng = JaxCpuEngine(JaxConfig(), JaxQueueConfig())
    else:
        eng = CpuEngine(Config(), QueueConfig())
    eng.restore(waiting, 1.7e9)
    ckmod.save_pool(eng, snap, queue_name=Q)
    j.compact_finish(anchor, snap,
                     _terminals(seed + 1, [r[0] for r in rows[:4]]),
                     {"credit_fraction": 0.5, "shed_total": 3})
    j.append_admits(rows[20:30])
    j.append_terminals(_terminals(seed + 2, [rows[7][0], rows[22][0]]))
    j.append_admits([rows[7]])  # re-admitted after its terminal
    j.commit()
    j.append_terminal(rows[25][0], b"never-committed", 1.7e9)
    j.abandon()
    with open(jmod.journal_path(directory, Q), "ab") as f:
        f.write(b"\x05\x00torn")
    return snap


def _recovered(jmod, directory):
    j = jmod.PoolJournal(directory, Q)
    rec = j.recovered
    j.abandon()
    return rec


def _same(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    for field in ("snapshot",):
        a[field], b[field] = os.path.basename(a[field]), os.path.basename(
            b[field])
    assert a == b
    assert got.transcript() == want.transcript()


@pytest.mark.parametrize("seed", [3, 4])
def test_segment_bytes_equal_whichever_package_wrote_it(tmp_path, seed):
    _script("jax", str(tmp_path / "jax"), seed)
    _script("port", str(tmp_path / "port"), seed)
    for suffix in ("", ".prev"):
        name = f"{Q}.journal{suffix}"
        with open(tmp_path / "jax" / name, "rb") as f:
            theirs = f.read()
        with open(tmp_path / "port" / name, "rb") as f:
            mine = f.read()
        assert mine == theirs, suffix


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("seed", [5, 6])
def test_either_package_recovers_the_others_journal(tmp_path, writer, seed):
    src = str(tmp_path / "src")
    _script(writer, src, seed)
    shutil.copytree(src, tmp_path / "a")
    shutil.copytree(src, tmp_path / "b")
    mine = _recovered(jr, str(tmp_path / "a"))
    theirs = _recovered(jax_jr, str(tmp_path / "b"))
    _same(mine, theirs)
    assert not mine.clean and mine.snapshot and not mine.fallback
    assert any("torn tail" in note for note in mine.corrupt)
    assert mine.admission == {"credit_fraction": 0.5, "shed_total": 3}
    # The snapshot the writer made loads into the reader's engine.
    eng = CpuEngine(Config(), QueueConfig())
    assert ck.load_pool(eng, mine.snapshot, 1.7e9) == 15
    jeng = JaxCpuEngine(JaxConfig(), JaxQueueConfig())
    assert jax_ck.load_pool(jeng, theirs.snapshot, 1.7e9) == 15
    assert sorted(r.id for r in eng.waiting()) == sorted(
        r.id for r in jeng.waiting())


# ---- the JAX package's journal cases, on the port's ---------------------------


def test_journal_roundtrip_and_torn_tail(tmp_path):
    j = jr.PoolJournal(str(tmp_path), Q, fsync="window")
    j.append_admits([_row("a"), _row("b")])
    j.append_terminal("a", b"matched-body", 99.0)
    j.commit()
    j.abandon()
    with open(jr.journal_path(str(tmp_path), Q), "ab") as f:
        f.write(b"\x01\x02garbage-partial-frame")
    j2 = jr.PoolJournal(str(tmp_path), Q)
    rec = j2.recovered
    assert rec is not None and not rec.clean
    assert sorted(rec.waiting) == ["b"]
    assert rec.removed == {"a"}
    assert rec.recent["a"] == (b"matched-body", 99.0)
    assert any("torn tail" in note for note in rec.corrupt)
    # The re-attached writer truncated the tail and numbers on from it.
    assert j2.seq == rec.last_seq
    j2.append_admits([_row("c")])
    j2.commit()
    j2.abandon()
    rec = jr.PoolJournal(str(tmp_path), Q).recovered
    assert sorted(rec.waiting) == ["b", "c"] and not rec.corrupt


def test_journal_clean_marker_skips_recovery(tmp_path):
    j = jr.PoolJournal(str(tmp_path), Q)
    j.append_admits([_row("a")])
    j.commit()
    j.mark_clean()
    j.close()
    j2 = jr.PoolJournal(str(tmp_path), Q)
    assert j2.recovered is not None and j2.recovered.clean
    # A record after the re-attach makes the next attach unclean again.
    j2.append_admits([_row("b")])
    j2.commit()
    j2.abandon()
    j3 = jr.PoolJournal(str(tmp_path), Q)
    assert j3.recovered is not None and not j3.recovered.clean
    assert "b" in j3.recovered.waiting
    j3.abandon()


def test_journal_append_after_close_raises(tmp_path):
    j = jr.PoolJournal(str(tmp_path), Q)
    j.mark_clean()
    j.close()
    with pytest.raises(RuntimeError):
        j.append_terminal("p", b"x", 1.0)


def test_crash_mid_window_players_recover_as_waiting(tmp_path):
    j = jr.PoolJournal(str(tmp_path), Q, fsync="window")
    j.append_admits([_row("a"), _row("b")])
    j.commit()
    j.append_terminal("a", b"never-committed", 99.0)  # buffered only
    j.abandon()
    rec = jr.PoolJournal(str(tmp_path), Q).recovered
    assert rec is not None and not rec.clean
    assert sorted(rec.waiting) == ["a", "b"]
    assert not rec.removed and not rec.recent


def _cpu_engine(ids=()):
    eng = CpuEngine(Config(), QueueConfig(rating_threshold=100.0))
    if ids:
        eng.restore([jr.row_to_request(_row(p)) for p in ids], 1.0)
    return eng


def test_corrupt_newest_snapshot_falls_back_to_previous(tmp_path):
    j = jr.PoolJournal(str(tmp_path), Q, keep_snapshots=2)
    j.append_admits([_row("a"), _row("b")])
    j.commit()
    anchor1, snap1 = j.compact_begin()
    ck.save_pool(_cpu_engine(["a", "b"]), snap1)
    j.compact_finish(anchor1, snap1)
    j.append_admits([_row("c")])
    j.commit()
    anchor2, snap2 = j.compact_begin()
    ck.save_pool(_cpu_engine(["a", "b", "c"]), snap2)
    j.compact_finish(anchor2, snap2)
    j.abandon()
    with open(snap2, "rb") as f:
        blob = f.read()
    with open(snap2, "wb") as f:
        f.write(blob[:len(blob) // 2])
    rec = jr.PoolJournal(str(tmp_path), Q).recovered
    assert rec is not None
    assert rec.snapshot == snap1 and rec.fallback
    assert any("failed verification" in note for note in rec.corrupt)
    assert sorted(rec.waiting) == ["c"]  # the tail after anchor 1


def test_crash_during_compaction_old_state_wins(tmp_path):
    # The snapshot never finished writing: the rotation is refused and the
    # old segment keeps covering the pool.
    j = jr.PoolJournal(str(tmp_path), Q)
    j.append_admits([_row("a"), _row("b")])
    j.commit()
    anchor, snap = j.compact_begin()
    with open(snap, "wb") as f:
        f.write(b"not an npz")
    with pytest.raises(ValueError):
        j.compact_finish(anchor, snap)
    j.abandon()
    rec = jr.PoolJournal(str(tmp_path), Q).recovered
    assert rec is not None and sorted(rec.waiting) == ["a", "b"]
    assert rec.snapshot == ""
    os.unlink(snap)
    # The snapshot was written, the process died before the rotation: the
    # snapshot wins, and the old terminals still fill the replay cache.
    j = jr.PoolJournal(str(tmp_path / "p2"), Q)
    j.append_admits([_row("a"), _row("b")])
    j.append_terminal("x", b"old-terminal", 99.0)
    j.commit()
    anchor, snap = j.compact_begin()
    ck.save_pool(_cpu_engine(["a", "b"]), snap)
    j.abandon()
    rec = jr.PoolJournal(str(tmp_path / "p2"), Q).recovered
    assert rec is not None
    assert rec.snapshot == snap and not rec.fallback
    assert not rec.waiting
    assert rec.recent["x"] == (b"old-terminal", 99.0)


def test_fence_refuses_appends_and_compaction(tmp_path):
    j = jr.PoolJournal(str(tmp_path), Q)
    tapped = []
    j.tap = lambda seq, rtype, payload: tapped.append((seq, rtype))
    j.append_admits([_row("a")])
    assert tapped == [(1, jr.RT_ADMIT)]
    fenced = [False]
    j.fence = lambda: not fenced[0]
    j.append_terminal("a", b"body", 9.0)
    fenced[0] = True
    with pytest.raises(jr.FencedError):
        j.append_admits([_row("b")])
    with pytest.raises(jr.FencedError):
        j.compact_finish(j.seq, "unused.npz")
    assert j.seq == 2 and tapped == [(1, jr.RT_ADMIT), (2, jr.RT_TERMINAL)]
    j.abandon()
