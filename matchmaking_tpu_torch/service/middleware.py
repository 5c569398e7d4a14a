"""The middleware pipeline: each delivery runs through an ordered chain
before the batcher sees it. A middleware gets the message context and a
``next`` thunk.

The port's chain is ``columnar_pipeline``: the first-receive clock stamp
only. The service decodes a whole window at once, natively, at flush time.
The port carries auth mode ``"none"`` only and refuses any other.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Sequence

from matchmaking_tpu_torch.config import AuthConfig
from matchmaking_tpu_torch.service.broker import Delivery


@dataclass
class MessageContext:
    delivery: Delivery
    queue: str
    received_at: float = field(default_factory=time.time)


Next = Callable[[], Awaitable[None]]


class Middleware:
    async def call(self, ctx: MessageContext, next: Next) -> None:  # noqa: A002
        raise NotImplementedError


class Pipeline:
    """Ordered middleware chain (``call(msg, next)``)."""

    def __init__(self, middlewares: Sequence[Middleware]):
        self._middlewares = tuple(middlewares)

    async def run(self, ctx: MessageContext) -> None:
        async def invoke(i: int) -> None:
            if i == len(self._middlewares):
                return
            await self._middlewares[i].call(ctx, lambda: invoke(i + 1))

        await invoke(0)


class StampMiddleware(Middleware):
    """Stamp the first receive time into the headers once, so a redelivered
    copy (same Properties object) keeps its wait clock, and cache it on the
    delivery (the flush reads it per row)."""

    async def call(self, ctx: MessageContext, next: Next) -> None:  # noqa: A002
        first = ctx.delivery.properties.headers.setdefault(
            "x-first-received", ctx.received_at)
        try:
            ctx.delivery.first_received = float(first)
        except (TypeError, ValueError):
            ctx.delivery.first_received = ctx.received_at
        await next()


def columnar_pipeline(auth_cfg: AuthConfig) -> Pipeline:
    """Stamp only; decoding is deferred to the window flush."""
    if auth_cfg.mode != "none":
        raise ValueError(f"auth mode {auth_cfg.mode!r} is not carried by the "
                         f"port yet (only 'none')")
    return Pipeline([StampMiddleware()])
