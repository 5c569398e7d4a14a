"""The middleware pipeline: each delivery runs through an ordered chain
before the batcher sees it. A middleware gets the message context and a
``next`` thunk; it stops the chain by raising ``MiddlewareReject``, which
the service answers with an error response.

Two chains, by queue kind (as the JAX service binds them):

- ``columnar_pipeline`` (1v1 queues): the first-receive clock stamp, then
  auth; the service decodes a whole window at once, natively, at flush
  time;
- ``default_pipeline`` (team and role queues, served by the object API):
  each delivery is stamped and decoded into a ``SearchRequest``, with its
  party and roles, on ``ctx.request``, then auth.

``AuthMiddleware`` checks the ``authorization`` header per
``AuthConfig.mode``: ``"none"`` passes, ``"static"`` wants the shared
secret as its prefix, ``"rpc"`` asks the auth service on ``rpc_queue``
through the broker and wants ``b"ok"`` back within ``rpc_timeout_ms``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Sequence

from matchmaking_tpu_torch.config import AuthConfig
from matchmaking_tpu_torch.service.broker import Delivery, InProcBroker
from matchmaking_tpu_torch.service.contract import (
    ContractError,
    SearchRequest,
    decode_request,
)


class MiddlewareReject(Exception):
    """Stop the chain and answer with an error response."""

    def __init__(self, code: str, reason: str):
        super().__init__(reason)
        self.code = code
        self.reason = reason


@dataclass
class MessageContext:
    delivery: Delivery
    queue: str
    received_at: float = field(default_factory=time.time)
    request: SearchRequest | None = None  # set by DecodeMiddleware


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
        # The trace's stage mark: the delivery cleared the whole chain (auth
        # round trips included). A reject raises past it; the app marks
        # the reject itself.
        if ctx.delivery.trace is not None:
            ctx.delivery.trace.mark("middleware")


def _stamp(ctx: MessageContext) -> None:
    """Stamp the first receive time into the headers once, so a redelivered
    copy (same Properties object) keeps its wait clock, and cache it on the
    delivery (the flush reads it per row)."""
    first = ctx.delivery.properties.headers.setdefault(
        "x-first-received", ctx.received_at)
    try:
        ctx.delivery.first_received = float(first)
    except (TypeError, ValueError):
        ctx.delivery.first_received = ctx.received_at


class StampMiddleware(Middleware):
    """The first-receive stamp only (decoding waits for the flush)."""

    async def call(self, ctx: MessageContext, next: Next) -> None:  # noqa: A002
        _stamp(ctx)
        await next()


class DecodeMiddleware(Middleware):
    """The stamp, then the payload → a validated ``SearchRequest`` on
    ``ctx.request``, enqueued at the first receive; a malformed payload is
    rejected here, before the engine."""

    async def call(self, ctx: MessageContext, next: Next) -> None:  # noqa: A002
        _stamp(ctx)
        props = ctx.delivery.properties
        try:
            ctx.request = decode_request(
                ctx.delivery.body, reply_to=props.reply_to,
                correlation_id=props.correlation_id, queue=ctx.queue,
                enqueued_at=ctx.delivery.first_received)
        except ContractError as e:
            raise MiddlewareReject(e.code, e.reason) from e
        await next()


class AuthMiddleware(Middleware):
    """The token check: an ``unauthorized`` reject for a missing or wrong
    token, ``auth_unavailable`` when the rpc auth service does not answer
    in time (or there is no broker to ask)."""

    def __init__(self, cfg: AuthConfig, broker: InProcBroker | None = None):
        self.cfg = cfg
        self.broker = broker

    async def call(self, ctx: MessageContext, next: Next) -> None:  # noqa: A002
        mode = self.cfg.mode
        if mode == "none":
            await next()
            return
        token = str(ctx.delivery.properties.headers.get("authorization", ""))
        if mode == "static":
            if not token or not token.startswith(self.cfg.static_secret):
                raise MiddlewareReject("unauthorized",
                                       "invalid or missing token")
        elif mode == "rpc":
            if self.broker is None:
                raise MiddlewareReject("auth_unavailable",
                                       "no broker for auth rpc")
            reply = await self.broker.rpc(
                self.cfg.rpc_queue, token.encode(),
                timeout=self.cfg.rpc_timeout_ms / 1000.0)
            if reply is None:
                raise MiddlewareReject("auth_unavailable",
                                       "auth service timeout")
            if reply != b"ok":
                raise MiddlewareReject("unauthorized",
                                       reply.decode(errors="replace"))
        else:
            raise MiddlewareReject("auth_misconfigured",
                                   f"unknown auth mode {mode!r}")
        await next()


def columnar_pipeline(auth_cfg: AuthConfig,
                      broker: InProcBroker | None = None) -> Pipeline:
    """Stamp and auth; decoding is deferred to the window flush."""
    return Pipeline([StampMiddleware(), AuthMiddleware(auth_cfg, broker)])


def default_pipeline(auth_cfg: AuthConfig,
                     broker: InProcBroker | None = None) -> Pipeline:
    """Stamp and decode each delivery (the object path), then auth."""
    return Pipeline([DecodeMiddleware(), AuthMiddleware(auth_cfg, broker)])
