"""Pool checkpoints and the drain's sidecars.

The port's copy of the JAX package's checkpoint module, with the same
file formats byte for byte, so a snapshot either package saved loads into
the other's engine:

- the waiting pool as a numpy ``.npz`` (``save_pool`` / ``load_pool``):
  string columns as unicode arrays, region and game mode by NAME (interner
  codes are process-local), the QoS tier and absolute deadline columns;
  written to a temp file in the target directory, then renamed;
- the broker backlog of a drain (``save_backlog`` / ``load_backlog``) and
  the admission controllers' decision state (``save_admission`` /
  ``load_admission``), JSON sidecars stamped with a CRC32 of their
  canonical dump, so a truncated or bit-flipped sidecar is refused at load
  instead of restoring half a backlog.

``engine_waiting_columns`` reads a ``GpuEngine``'s host mirror
(``core/pool.py``) as columns; an engine without one (the host oracle,
``engine/cpu.py``) is read through ``waiting()``. ``load_pool`` restores
through ``intern_columns`` + ``restore_columns`` where the engine has them
(no host sync on the card), else through ``restore`` of request objects.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import time
import zlib

import numpy as np

from matchmaking_tpu_torch.service.contract import RequestColumns, SearchRequest

FORMAT_VERSION = 1

#: Broker-backlog sidecar format (the drain's unconsumed deliveries).
BACKLOG_VERSION = 1

#: Admission-state sidecar format: a restored queue resumes with the same
#: admission decisions (the adaptive credit fraction is decision state).
ADMISSION_VERSION = 1


def _canonical(payload: dict) -> bytes:
    return json.dumps({k: v for k, v in payload.items() if k != "crc32"},
                      sort_keys=True, separators=(",", ":")).encode("utf-8")


def _stamp_crc(payload: dict) -> dict:
    """Stamp ``crc32`` over the canonical dump of everything else."""
    payload["crc32"] = zlib.crc32(_canonical(payload))
    return payload


def _check_crc(payload: dict, path: str) -> None:
    """Verify a sidecar's CRC when it has one (older files carry none)."""
    crc = payload.get("crc32")
    if crc is None:
        return
    want = zlib.crc32(_canonical(payload))
    if want != crc:
        raise ValueError(
            f"{path}: sidecar CRC mismatch (stored {crc}, computed {want}) "
            f"— the file is truncated or corrupt")


def _atomic_write(path: str, suffix: str, write) -> None:
    """``write(file)`` into a temp file beside ``path``, then rename."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=suffix)
    try:
        with os.fdopen(fd, "wb" if suffix.startswith(".npz") else "w") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_backlog(path: str, per_queue: "dict[str, list]") -> int:
    """Write unconsumed broker deliveries (queue → list of ``Delivery``)
    as a JSON sidecar: bodies in base64, and of the properties only
    reply_to, correlation_id and headers (delivery tags are minted afresh
    at re-publish). Returns the deliveries saved; 0 still writes the file,
    so a restore can tell "no backlog" from "no handoff"."""
    rows = {
        queue: [
            {
                "body": base64.b64encode(bytes(d.body)).decode("ascii"),
                "reply_to": d.properties.reply_to,
                "correlation_id": d.properties.correlation_id,
                # Headers are str/float by convention; a value JSON cannot
                # hold must not lose the whole backlog.
                "headers": {k: (v if isinstance(v, (str, int, float, bool))
                                else str(v))
                            for k, v in d.properties.headers.items()},
                "redelivered": bool(d.redelivered),
            }
            for d in deliveries
        ]
        for queue, deliveries in per_queue.items()
    }
    n = sum(len(v) for v in rows.values())
    payload = _stamp_crc({"version": BACKLOG_VERSION,
                          "saved_at": time.time(),
                          "count": n, "queues": rows})
    _atomic_write(path, ".json.tmp", lambda f: json.dump(payload, f))
    return n


def load_backlog(path: str) -> "dict[str, list[dict]]":
    """Inverse of ``save_backlog``: queue → rows with the ``body`` bytes,
    reply_to, correlation_id, headers and the redelivered flag."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != BACKLOG_VERSION:
        raise ValueError(
            f"unsupported backlog version: {payload.get('version')}")
    _check_crc(payload, path)
    return {
        queue: [
            {
                "body": base64.b64decode(row["body"]),
                "reply_to": row.get("reply_to", ""),
                "correlation_id": row.get("correlation_id", ""),
                "headers": dict(row.get("headers", {})),
                "redelivered": bool(row.get("redelivered", False)),
            }
            for row in rows
        ]
        for queue, rows in payload.get("queues", {}).items()
    }


def save_admission(path: str, per_queue: "dict[str, dict]") -> int:
    """Write each queue's ``AdmissionController.checkpoint()``. Returns
    the queues saved."""
    payload = _stamp_crc({"version": ADMISSION_VERSION,
                          "saved_at": time.time(), "queues": per_queue})
    _atomic_write(path, ".json.tmp", lambda f: json.dump(payload, f))
    return len(per_queue)


def load_admission(path: str) -> "dict[str, dict]":
    """Inverse of ``save_admission``: queue → checkpoint dict for
    ``AdmissionController.restore_state``."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != ADMISSION_VERSION:
        raise ValueError(
            f"unsupported admission checkpoint version: "
            f"{payload.get('version')}")
    _check_crc(payload, path)
    return {q: dict(v) for q, v in payload.get("queues", {}).items()}


def engine_waiting_columns(engine) -> tuple[RequestColumns, np.ndarray, np.ndarray]:
    """The waiting pool as columns, plus region and mode NAME arrays: from
    the host mirror where the engine has one (no request objects built),
    else from ``waiting()``."""
    pool = getattr(engine, "pool", None)
    if pool is not None and hasattr(pool, "waiting_slots"):
        slots = pool.waiting_slots()
        regions = np.asarray([pool.regions.name(c) for c in
                              pool.m_region[slots].tolist()], object)
        modes = np.asarray([pool.modes.name(c) for c in
                            pool.m_mode[slots].tolist()], object)
        thr = np.where(pool.m_thr_override[slots], pool.m_threshold[slots],
                       np.nan).astype(np.float32)
        cols = RequestColumns(
            ids=pool.m_id[slots].copy(),
            rating=pool.m_rating[slots].copy(),
            rd=pool.m_rd[slots].copy(),
            region=pool.m_region[slots].copy(),
            mode=pool.m_mode[slots].copy(),
            threshold=thr,
            enqueued_at=pool.m_enqueued[slots].copy(),
            reply_to=pool.m_reply[slots].copy(),
            correlation_id=pool.m_corr[slots].copy(),
            tier=pool.m_tier[slots].copy(),
            deadline=pool.m_deadline[slots].copy(),
        )
        return cols, regions, modes
    reqs = engine.waiting()
    n = len(reqs)
    cols = RequestColumns(
        ids=np.fromiter((r.id for r in reqs), object, n),
        rating=np.fromiter((r.rating for r in reqs), np.float32, n),
        rd=np.fromiter((r.rating_deviation for r in reqs), np.float32, n),
        region=np.zeros(n, np.int32),
        mode=np.zeros(n, np.int32),
        threshold=np.fromiter(
            (np.nan if r.rating_threshold is None else r.rating_threshold
             for r in reqs), np.float32, n),
        enqueued_at=np.fromiter((r.enqueued_at for r in reqs), np.float64, n),
        reply_to=np.fromiter((r.reply_to for r in reqs), object, n),
        correlation_id=np.fromiter((r.correlation_id for r in reqs), object, n),
        tier=np.fromiter((r.tier for r in reqs), np.int32, n),
        deadline=np.fromiter((r.deadline_at for r in reqs), np.float64, n),
    )
    regions = np.fromiter((r.region for r in reqs), object, n)
    modes = np.fromiter((r.game_mode for r in reqs), object, n)
    return cols, regions, modes


def save_pool(engine, path: str, *, queue_name: str = "") -> int:
    """Write an engine's waiting pool to ``path``. Returns the number of
    players. Atomic (temp file, then rename)."""
    cols, regions, modes = engine_waiting_columns(engine)
    n = len(cols)
    meta = {"version": FORMAT_VERSION, "queue": queue_name,
            "saved_at": time.time(), "count": n}
    blank = np.full(n, "", object)
    _atomic_write(path, ".npz.tmp", lambda f: np.savez_compressed(
        f,
        meta=np.asarray(json.dumps(meta)),
        ids=cols.ids.astype(str),
        rating=cols.rating,
        rd=cols.rd,
        region=regions.astype(str),
        mode=modes.astype(str),
        threshold=cols.threshold,
        enqueued_at=cols.enqueued_at,
        reply_to=(cols.reply_to if cols.reply_to is not None
                  else blank).astype(str),
        correlation_id=(cols.correlation_id if cols.correlation_id
                        is not None else blank).astype(str),
        tier=(cols.tier if cols.tier is not None else np.zeros(n, np.int32)),
        deadline=(cols.deadline if cols.deadline is not None
                  else np.zeros(n, np.float64)),
    ))
    return n


def load_pool(engine, path: str, now: float | None = None) -> int:
    """Re-admit a checkpoint without matching (nobody listens for the
    outcomes of a restore). Returns the players in the file; players
    already waiting are skipped by the engine's restore."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version: {meta.get('version')}")
        n = meta["count"]
        regions = z["region"].tolist()
        modes = z["mode"].tolist()
        cols = RequestColumns(
            ids=z["ids"].astype(object),
            rating=z["rating"],
            rd=z["rd"],
            region=np.zeros(n, np.int32),
            mode=np.zeros(n, np.int32),
            threshold=z["threshold"],
            enqueued_at=z["enqueued_at"],
            reply_to=z["reply_to"].astype(object),
            correlation_id=z["correlation_id"].astype(object),
            # Files without QoS columns read as tier 0, no deadline.
            tier=z["tier"] if "tier" in z.files else np.zeros(n, np.int32),
            deadline=(z["deadline"] if "deadline" in z.files
                      else np.zeros(n, np.float64)),
        )
    t = time.time() if now is None else now
    if hasattr(engine, "restore_columns") and hasattr(engine, "intern_columns"):
        cols.region, cols.mode = engine.intern_columns(regions, modes)
        engine.restore_columns(cols, t)
        return n
    engine.restore([
        SearchRequest(
            id=cols.ids[i], rating=float(cols.rating[i]),
            rating_deviation=float(cols.rd[i]), game_mode=modes[i],
            region=regions[i],
            rating_threshold=(None if np.isnan(cols.threshold[i])
                              else float(cols.threshold[i])),
            reply_to=str(cols.reply_to[i]),
            correlation_id=str(cols.correlation_id[i]),
            enqueued_at=float(cols.enqueued_at[i]),
            tier=int(cols.tier[i]), deadline_at=float(cols.deadline[i]))
        for i in range(n)
    ], t)
    return n
