"""Client helper: speaks the wire contract like an external service would.

Publishes a search request with a private reply queue and correlation id,
then awaits responses — used by tests and the demo.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any, Mapping

from matchmaking_tpu_torch.service.broker import InProcBroker, Properties
from matchmaking_tpu_torch.service.contract import SearchResponse, decode_response
from matchmaking_tpu_torch.service.overload import stamp_deadline, stamp_tier


class MatchmakingClient:
    """``auth_token`` (when set) goes out as each request's
    ``authorization`` header."""

    def __init__(self, broker: InProcBroker, request_queue: str,
                 auth_token: str = ""):
        self.broker = broker
        self.request_queue = request_queue
        self.auth_token = auth_token

    def submit(self, player: Mapping[str, Any], *, queue: str | None = None,
               deadline_s: float | None = None,
               tier: int | None = None) -> str:
        """Fire a search request; returns the private reply queue name."""
        reply_to = f"amq.gen-{uuid.uuid4().hex}"
        self.broker.declare_queue(reply_to)  # before publish: replies must route
        headers: dict[str, Any] = (
            {"authorization": self.auth_token} if self.auth_token else {})
        if deadline_s is not None:
            stamp_deadline(headers, time.time(), deadline_s)
        if tier is not None:
            stamp_tier(headers, tier)
        self.broker.publish(
            queue or self.request_queue,
            json.dumps(dict(player)).encode(),
            Properties(reply_to=reply_to, correlation_id=uuid.uuid4().hex,
                       headers=headers),
        )
        return reply_to

    async def next_response(self, reply_to: str,
                            timeout: float = 5.0) -> SearchResponse | None:
        delivery = await self.broker.get(reply_to, timeout=timeout)
        if delivery is None:
            return None
        return decode_response(delivery.body)

    async def search_until_matched(self, player: Mapping[str, Any], *,
                                   timeout: float = 5.0,
                                   queue: str | None = None,
                                   deadline_s: float | None = None,
                                   tier: int | None = None) -> SearchResponse:
        """Submit and wait through ``queued`` acks until a terminal response
        (matched / timeout / error) or the timeout."""
        reply_to = self.submit(player, queue=queue, deadline_s=deadline_s,
                               tier=tier)
        deadline = asyncio.get_running_loop().time() + timeout
        last: SearchResponse | None = None
        try:
            while True:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    return last or SearchResponse(
                        status="timeout", player_id=str(player.get("id", "")))
                resp = await self.next_response(reply_to, timeout=remaining)
                if resp is None:
                    continue
                last = resp
                if resp.status != "queued":
                    return resp
        finally:
            self.broker.delete_queue(reply_to)
