"""The request/response wire contract (the port's own copy).

Requests are JSON bodies on the matchmaking queue; responses go to the
per-request ``reply_to`` queue tagged with the request's ``correlation_id``.
The encoders here produce the same bytes as ``matchmaking_tpu``'s contract
module (tests/test_torch_service.py holds the two byte-identical on a
corpus), so clients cannot tell which package answered them.

Request payload (JSON object):

    {
      "id":               str   — player id
      "rating":           num   — ELO-style rating
      "rating_deviation": num?  — Glicko-2 RD (default 350.0)
      "game_mode":        str?  — hard filter
      "region":           str?  — hard filter
      "rating_threshold": num?  — per-request override of the queue default
      "roles":            [str]?
      "party":            [player]? — same schema, leader at top level
    }

Response payload:

    {
      "status": "matched" | "queued" | "timeout" | "error",
      "player_id": str,
      "match": {"match_id", "players", "teams", "quality"},  # matched only
      "error": {"code": str, "reason": str},                  # error only
      "latency_ms": num,
    }
"""

from __future__ import annotations

import json
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np

DEFAULT_RD = 350.0  # Glicko-2 deviation for an unrated player

# Wildcards: requests that omit region/mode match anything.
ANY = "*"


def is_wildcard(req) -> bool:
    """True if the request matches outside any one exact (region, mode)
    group."""
    return req.region == ANY or req.game_mode == ANY


class ContractError(ValueError):
    """Malformed payload, with a machine-readable code for the error
    response."""

    def __init__(self, code: str, reason: str):
        super().__init__(reason)
        self.code = code
        self.reason = reason


@dataclass(frozen=True)
class PartyMember:
    id: str
    rating: float
    rating_deviation: float = DEFAULT_RD
    roles: tuple[str, ...] = ()


@dataclass(frozen=True)
class SearchRequest:
    """One decoded, validated search request."""

    id: str
    rating: float
    rating_deviation: float = DEFAULT_RD
    game_mode: str = ANY
    region: str = ANY
    rating_threshold: float | None = None
    roles: tuple[str, ...] = ()
    party: tuple[PartyMember, ...] = ()
    # transport metadata (broker properties, not part of the JSON body)
    reply_to: str = ""
    correlation_id: str = ""
    queue: str = ""
    enqueued_at: float = 0.0
    #: QoS priority tier (``x-tier`` header); 0 when untiered.
    tier: int = 0
    #: Absolute wall-clock deadline (``x-deadline`` header; 0.0 = none).
    deadline_at: float = 0.0

    @property
    def party_size(self) -> int:
        return 1 + len(self.party)

    def all_ids(self) -> tuple[str, ...]:
        return (self.id,) + tuple(m.id for m in self.party)


@dataclass(frozen=True)
class MatchResult:
    match_id: str
    players: tuple[str, ...]
    teams: tuple[tuple[str, ...], ...]
    quality: float = 1.0


@dataclass(frozen=True)
class SearchResponse:
    status: str  # matched | queued | timeout | error | shed
    player_id: str
    match: MatchResult | None = None
    error_code: str = ""
    error_reason: str = ""
    latency_ms: float = 0.0
    #: Wait-at-match in ms; carried on ``matched`` responses only.
    waited_ms: float = 0.0
    retry_after_ms: float = 0.0
    trace_id: str = ""
    #: QoS tier; None omits the key from the wire body.
    tier: int | None = None


# ---- decode ---------------------------------------------------------------


def _require(payload: Mapping[str, Any], key: str, types: tuple[type, ...]) -> Any:
    if key not in payload:
        raise ContractError("missing_field", f"missing required field {key!r}")
    val = payload[key]
    if not isinstance(val, types) or isinstance(val, bool):
        raise ContractError("bad_type", f"field {key!r} has wrong type")
    return val


def _opt_num(payload: Mapping[str, Any], key: str, default: float | None) -> float | None:
    """Optional numeric field: missing → default; non-numeric/bool → bad_type."""
    if key not in payload:
        return default
    val = payload[key]
    if not isinstance(val, (int, float)) or isinstance(val, bool):
        raise ContractError("bad_type", f"field {key!r} must be a number")
    return float(val)


def _roles(obj: Mapping[str, Any]) -> tuple[str, ...]:
    raw = obj.get("roles", ())
    if isinstance(raw, (str, bytes)) or not isinstance(raw, Sequence):
        raise ContractError("bad_type", "roles must be an array of strings")
    if not all(isinstance(r, str) for r in raw):
        raise ContractError("bad_type", "roles must be an array of strings")
    return tuple(raw)


def _member(obj: Any) -> PartyMember:
    if not isinstance(obj, Mapping):
        raise ContractError("bad_type", "party member must be an object")
    rd = _opt_num(obj, "rating_deviation", DEFAULT_RD)
    if rd < 0:
        raise ContractError("bad_rating", "rating_deviation must be >= 0")
    return PartyMember(
        id=str(_require(obj, "id", (str,))),
        rating=float(_require(obj, "rating", (int, float))),
        rating_deviation=rd,
        roles=_roles(obj),
    )


def decode_request(body: bytes | str, *, reply_to: str = "",
                   correlation_id: str = "", queue: str = "",
                   enqueued_at: float = 0.0) -> SearchRequest:
    """bytes → validated SearchRequest. Raises ContractError."""
    try:
        payload = json.loads(body)
    except (ValueError, TypeError) as e:
        raise ContractError("bad_json", f"payload is not valid JSON: {e}") from e
    if not isinstance(payload, Mapping):
        raise ContractError("bad_json", "payload must be a JSON object")

    pid = str(_require(payload, "id", (str,)))
    rating = float(_require(payload, "rating", (int, float)))
    if not (-1e5 < rating < 1e5):
        raise ContractError("bad_rating", f"rating {rating} out of range")
    rd = _opt_num(payload, "rating_deviation", DEFAULT_RD)
    if rd < 0:
        raise ContractError("bad_rating", "rating_deviation must be >= 0")
    thr = _opt_num(payload, "rating_threshold", None)
    if thr is not None and thr <= 0:
        raise ContractError("bad_threshold", "rating_threshold must be > 0")
    party_raw = payload.get("party", ())
    if not isinstance(party_raw, Sequence) or isinstance(party_raw, (str, bytes)):
        raise ContractError("bad_type", "party must be an array")
    party = tuple(_member(m) for m in party_raw)
    if len(party) > 4:
        raise ContractError("party_too_large", "party may have at most 5 members")
    ids = [pid] + [m.id for m in party]
    if len(set(ids)) != len(ids):
        raise ContractError("duplicate_player", "duplicate player id in party")

    return SearchRequest(
        id=pid,
        rating=rating,
        rating_deviation=rd,
        game_mode=str(payload.get("game_mode", ANY) or ANY),
        region=str(payload.get("region", ANY) or ANY),
        rating_threshold=thr,
        roles=_roles(payload),
        party=party,
        reply_to=reply_to,
        correlation_id=correlation_id,
        queue=queue,
        enqueued_at=enqueued_at,
    )


# ---- encode ---------------------------------------------------------------


def encode_request(req: SearchRequest) -> bytes:
    """SearchRequest → JSON body (client side / tests)."""
    payload: dict[str, Any] = {
        "event-name": "matchmaking.search",
        "id": req.id,
        "rating": req.rating,
    }
    if req.rating_deviation != DEFAULT_RD:
        payload["rating_deviation"] = req.rating_deviation
    if req.game_mode != ANY:
        payload["game_mode"] = req.game_mode
    if req.region != ANY:
        payload["region"] = req.region
    if req.rating_threshold is not None:
        payload["rating_threshold"] = req.rating_threshold
    if req.roles:
        payload["roles"] = list(req.roles)
    if req.party:
        payload["party"] = [
            {"id": m.id, "rating": m.rating,
             "rating_deviation": m.rating_deviation, "roles": list(m.roles)}
            for m in req.party
        ]
    return json.dumps(payload, separators=(",", ":")).encode()


def encode_response(resp: SearchResponse) -> bytes:
    payload: dict[str, Any] = {
        "status": resp.status,
        "player_id": resp.player_id,
        "latency_ms": round(resp.latency_ms, 3),
    }
    if resp.match is not None:
        payload["match"] = {
            "match_id": resp.match.match_id,
            "players": list(resp.match.players),
            "teams": [list(t) for t in resp.match.teams],
            "quality": round(resp.match.quality, 6),
        }
        if resp.status == "matched":
            payload["waited_ms"] = round(resp.waited_ms, 3)
    if resp.status == "error":
        payload["error"] = {"code": resp.error_code, "reason": resp.error_reason}
    if resp.status == "shed":
        payload["retry_after_ms"] = round(resp.retry_after_ms, 3)
    if resp.trace_id:
        payload["trace_id"] = resp.trace_id
    if resp.tier is not None:
        payload["tier"] = resp.tier
    return json.dumps(payload, separators=(",", ":")).encode()


def decode_response(body: bytes | str) -> SearchResponse:
    payload = json.loads(body)
    match = None
    if "match" in payload:
        m = payload["match"]
        match = MatchResult(
            match_id=m["match_id"],
            players=tuple(m["players"]),
            teams=tuple(tuple(t) for t in m["teams"]),
            quality=float(m.get("quality", 1.0)),
        )
    err = payload.get("error", {})
    return SearchResponse(
        status=payload["status"],
        player_id=payload["player_id"],
        match=match,
        error_code=err.get("code", ""),
        error_reason=err.get("reason", ""),
        latency_ms=float(payload.get("latency_ms", 0.0)),
        waited_ms=float(payload.get("waited_ms", 0.0)),
        retry_after_ms=float(payload.get("retry_after_ms", 0.0)),
        trace_id=str(payload.get("trace_id", "")),
        tier=(int(payload["tier"]) if "tier" in payload else None),
    )


# ---- columnar requests ----------------------------------------------------


@dataclass
class RequestColumns:
    """A window of 1v1 search requests as a structure-of-arrays (host numpy;
    region/mode pre-interned to int32 codes, 0 = wildcard). The columnar
    path hands these to the engine instead of one object per request."""

    ids: "np.ndarray"          # object[N] str
    rating: "np.ndarray"       # f32[N]
    rd: "np.ndarray"           # f32[N]
    region: "np.ndarray"       # i32[N] interned
    mode: "np.ndarray"         # i32[N] interned
    threshold: "np.ndarray"    # f32[N]; NaN = queue default
    enqueued_at: "np.ndarray"  # f64[N] wall-clock seconds
    reply_to: "np.ndarray | None" = None  # object[N] str, or None (all "")
    correlation_id: "np.ndarray | None" = None
    #: QoS tier (i32; None = all 0) and absolute x-deadline (f64; 0.0 or
    #: None = none) per row, mirrored into the pool.
    tier: "np.ndarray | None" = None
    deadline: "np.ndarray | None" = None

    def __len__(self) -> int:
        return len(self.ids)

    def slice(self, start: int, stop: int) -> "RequestColumns":
        return self._apply(lambda a: a[start:stop])

    def take(self, mask_or_idx: "np.ndarray") -> "RequestColumns":
        """Row subset by boolean mask or index array."""
        return self._apply(lambda a: a[mask_or_idx])

    def _apply(self, f) -> "RequestColumns":
        return RequestColumns(
            ids=f(self.ids), rating=f(self.rating), rd=f(self.rd),
            region=f(self.region), mode=f(self.mode),
            threshold=f(self.threshold), enqueued_at=f(self.enqueued_at),
            reply_to=None if self.reply_to is None else f(self.reply_to),
            correlation_id=(None if self.correlation_id is None
                            else f(self.correlation_id)),
            tier=None if self.tier is None else f(self.tier),
            deadline=None if self.deadline is None else f(self.deadline),
        )

    @staticmethod
    def from_requests(requests: Sequence[SearchRequest],
                      region_code, mode_code) -> "RequestColumns":
        """Object → columnar. ``region_code``/``mode_code`` are the pool's
        interner functions."""
        n = len(requests)
        return RequestColumns(
            ids=np.fromiter((r.id for r in requests), object, n),
            rating=np.fromiter((r.rating for r in requests), np.float32, n),
            rd=np.fromiter((r.rating_deviation for r in requests), np.float32, n),
            region=np.fromiter((region_code(r.region) for r in requests), np.int32, n),
            mode=np.fromiter((mode_code(r.game_mode) for r in requests), np.int32, n),
            threshold=np.fromiter(
                (np.nan if r.rating_threshold is None else r.rating_threshold
                 for r in requests), np.float32, n),
            enqueued_at=np.fromiter((r.enqueued_at for r in requests), np.float64, n),
            reply_to=np.fromiter((r.reply_to for r in requests), object, n),
            correlation_id=np.fromiter((r.correlation_id for r in requests), object, n),
            tier=np.fromiter((r.tier for r in requests), np.int32, n),
            deadline=np.fromiter((r.deadline_at for r in requests),
                                 np.float64, n),
        )


_match_id_prefix = uuid.uuid4().hex[:16]
_match_id_lock = threading.Lock()
_match_id_next = 1


def _claim_match_ids(n: int) -> int:
    """Atomically claim a contiguous range of match numbers; returns its
    start (the lock keeps concurrent finalizers from minting duplicates)."""
    global _match_id_next
    with _match_id_lock:
        start = _match_id_next
        _match_id_next += n
    return start


def new_match_id() -> str:
    """Unique match id: random per-process prefix + counter."""
    return f"{_match_id_prefix}{_claim_match_ids(1):012x}"


def new_match_ids(n: int) -> "np.ndarray":
    """``n`` match ids as object[n] from one range claim: the ids
    ``new_match_id`` would give one by one."""
    out = np.empty(n, object)
    if n:
        start = _claim_match_ids(n)
        out[:] = [f"{_match_id_prefix}{k:012x}" for k in range(start, start + n)]
    return out
