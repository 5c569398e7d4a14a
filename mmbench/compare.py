"""The comparison that decides ``correct``.

``replay`` runs the reference over a run's log; ``details`` holds the
run's answers against the reference's, answer by answer, every window and
every rescan tick of the run (set-up's, the window's and the traced
slice's), and counts where they part:

- ``windows_wrong`` / ``rescans_wrong``: windows and ticks whose pairs
  (both ids of every match, in lane order) differ: the step's admission,
  candidate search, pairing and eviction;
- ``dist_wrong`` / ``quality_wrong``: matches, in answers whose pairs
  agree, whose distance or quality differs in any bit (finalize);
- ``queued_wrong``: answers whose players left waiting, or refused for
  want of a free slot, differ;
- ``unanswered``: windows and ticks handed over and never answered;
- ``pool_wrong``: readings of the waiting count, after each collection,
  that differ (the pool's accounting).

Two numbers are compared (``LIMITS``): ``answers_wrong``, the answers
that part in any of the first five ways, and ``pool_wrong``. Both are
exact, so both limits are 0; the control (the same reference in
bfloat16, ``control.py``) fails both.
"""

from __future__ import annotations

import numpy as np
import torch

from mmbench.reference import Answer, Reference, Spec

LIMITS = {"answers_wrong": 0, "pool_wrong": 0}
DETAILS = ("windows_wrong", "rescans_wrong", "dist_wrong", "quality_wrong",
           "queued_wrong", "unanswered", "pool_wrong")


def replay(log, config: dict, device="cpu", dtype=torch.float32,
           on_work=None) -> tuple[dict, list]:
    """The reference's answers by token, and its waiting count at each
    ``pool`` entry of the log."""
    ref = Reference(Spec.from_config(config), device=device, dtype=dtype,
                    on_work=on_work)
    answers: dict[int, Answer] = {}
    pools: list[int] = []
    for ev in log:
        kind = ev[0]
        if kind == "restore":
            _, ids, rating, rd, enq, now = ev
            ref.restore(ids, rating, rd, enq, now)
        elif kind == "dispatch":
            _, tok, ids, rating, rd, enq, now = ev
            ref.dispatch(tok, ids, rating, rd, enq, now)
        elif kind == "rescan":
            _, tok, now, rows = ev
            ref.rescan(tok, now, rows)
        elif kind == "collect":
            answers[ev[1]] = ref.collect(ev[1])
        elif kind == "pool":
            pools.append(ref.pool_size())
        elif kind == "traced":
            ref.count_work = True
        elif kind == "untraced":
            ref.count_work = False
    return answers, pools


def as_answer(out) -> Answer:
    """An engine's ColumnarOutcome as an ``Answer``."""
    refused = np.empty(len(out.rejected), object)
    refused[:] = [pid for pid, _ in out.rejected]
    return Answer(out.m_id_a, out.m_id_b, out.m_dist, out.m_quality,
                  out.q_ids, refused)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return len(a) == len(b) and bool(np.all(a == b))


def _bits_differ(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.count_nonzero(np.asarray(a, np.float32).view(np.uint32)
                                != np.asarray(b, np.float32).view(np.uint32)))


def details(log, got: dict, want: dict, pools_got: list,
            pools_want: list) -> dict[str, int]:
    """``got``'s answers and waiting counts held against ``want``'s: the
    counts of ``DETAILS``, and ``answers_wrong``."""
    kinds = {ev[1]: ev[0] for ev in log if ev[0] in ("dispatch", "rescan")}
    n = dict.fromkeys(DETAILS, 0)
    wrong = 0
    for tok, kind in kinds.items():
        if tok not in got or tok not in want:
            n["unanswered"] += 1
            wrong += 1
            continue
        g, w = got[tok], want[tok]
        bad = 0
        if not (_same(g.id_a, w.id_a) and _same(g.id_b, w.id_b)):
            n["windows_wrong" if kind == "dispatch" else "rescans_wrong"] += 1
            bad = 1
        else:
            dist, qual = _bits_differ(g.dist, w.dist), _bits_differ(
                g.quality, w.quality)
            n["dist_wrong"] += dist
            n["quality_wrong"] += qual
            bad = int(bool(dist or qual))
        if not (_same(g.queued, w.queued) and _same(g.refused, w.refused)):
            n["queued_wrong"] += 1
            bad = 1
        wrong += bad
    n["pool_wrong"] = (sum(a != b for a, b in zip(pools_got, pools_want))
                       + abs(len(pools_got) - len(pools_want)))
    n["answers_wrong"] = wrong
    return n


def check(log, got: dict, config: dict, device="cpu", on_work=None,
          control: bool = False) -> tuple[dict, dict, dict | None]:
    """The run's answers ``got`` (``Answer`` by token) held against the
    reference's: the compared numbers, each with its limit; the details;
    with ``control``, the control's details: the reference in bfloat16 put
    in the program's place, held against the same float32 reference."""
    want, pools = replay(log, config, device=device, on_work=on_work)
    n = details(log, got, want, [ev[1] for ev in log if ev[0] == "pool"],
                pools)
    checks = {k: {"value": n[k], "limit": v} for k, v in LIMITS.items()}
    if not control:
        return checks, n, None
    low, low_pools = replay(log, config, device=device, dtype=torch.bfloat16)
    return checks, n, details(log, low, want, low_pools, pools)


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
