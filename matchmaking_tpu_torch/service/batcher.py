"""Request batcher: collects a time/size window per queue, flushes once.

Deliveries accumulate until ``max_batch`` items or ``max_wait_ms`` after
the window's first item, whichever comes first, then flush as one window.
Windows are serialized — the next is not cut until the previous flush
returns — which is the atomicity guarantee: a matched player is out of the
pool before any later window can see them.

With ``sort_key`` (earliest-deadline-first cutting,
``OverloadConfig.edf``) each cut stable-sorts the whole backlog by the key
first, so a window is the ``max_batch`` smallest keys and the rest stays
ordered for the next cut. ``observe_window(size, age_s)`` is called at
each cut with the window's size and the wait of the oldest item still
pending (window and rest).

All state is event-loop-confined: call ``submit`` and ``submit_many``
from the loop only.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Generic, TypeVar

from matchmaking_tpu_torch.config import BatcherConfig

T = TypeVar("T")


class Batcher(Generic[T]):
    def __init__(self, cfg: BatcherConfig,
                 flush: Callable[[list[T]], Awaitable[None]],
                 observe_window: Callable[[int, float], None] | None = None,
                 sort_key: Callable[[T], object] | None = None):
        self.max_batch = cfg.max_batch
        self.max_wait_ms = cfg.max_wait_ms
        self._flush = flush
        #: The EDF key (a pure function of the item), or None: arrival
        #: order.
        self.sort_key = sort_key
        self._observe = observe_window
        self._pending: list[T] = []
        #: Submit times (monotonic), parallel to ``_pending``, kept only
        #: with ``observe_window``.
        self._submitted: list[float] = []
        self._first = asyncio.Event()   # first item of a window arrived
        self._full = asyncio.Event()    # size trigger
        self._closed = False
        self._task = asyncio.create_task(self._run())

    def submit(self, item: T) -> None:
        if self._closed:
            raise RuntimeError("batcher closed")
        self._pending.append(item)
        if self._observe is not None:
            self._submitted.append(time.monotonic())
        self._first.set()
        if len(self._pending) >= self.max_batch:
            self._full.set()

    def submit_many(self, items: list[T]) -> None:
        """Submit a consume burst: one extend, one clock read and one
        trigger check for the whole burst."""
        if self._closed:
            raise RuntimeError("batcher closed")
        if not items:
            return
        self._pending.extend(items)
        if self._observe is not None:
            self._submitted.extend([time.monotonic()] * len(items))
        self._first.set()
        if len(self._pending) >= self.max_batch:
            self._full.set()

    def _cut(self) -> list[T]:
        if self.sort_key is not None and len(self._pending) > 1:
            key = self.sort_key
            order = sorted(range(len(self._pending)),
                           key=lambda i: key(self._pending[i]))
            self._pending = [self._pending[i] for i in order]
            if self._observe is not None:
                self._submitted = [self._submitted[i] for i in order]
        window = self._pending[:self.max_batch]
        self._pending = self._pending[self.max_batch:]
        if self._observe is not None and window:
            age = time.monotonic() - min(self._submitted)
            self._submitted = self._submitted[len(window):]
            self._observe(len(window), max(0.0, age))
        return window

    async def _run(self) -> None:
        while not self._closed:
            if not self._pending:
                self._first.clear()
                try:
                    await asyncio.wait_for(self._first.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    continue
                if not self._pending:
                    continue
            # Window open: close after max_wait unless it fills first.
            self._full.clear()
            if len(self._pending) < self.max_batch:
                try:
                    await asyncio.wait_for(self._full.wait(),
                                           timeout=self.max_wait_ms / 1000.0)
                except asyncio.TimeoutError:
                    pass
            if not self._pending:
                continue
            try:
                await self._flush(self._cut())
            except Exception:
                # The flush owner settles its own deliveries; a crash here
                # must not stop the batching loop.
                logging.getLogger(__name__).exception("batch flush crashed")

    @property
    def depth(self) -> int:
        return len(self._pending)

    async def close(self) -> None:
        """Let an in-flight flush finish, then flush the remainder."""
        self._closed = True
        self._first.set()
        self._full.set()
        try:
            await asyncio.wait_for(self._task, timeout=5.0)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        while self._pending:
            await self._flush(self._cut())
