"""In-process message broker with AMQP work-queue semantics.

The port's own minimal copy: named queues (declared on first use),
competing consumers with a per-consumer prefetch, ack / nack(requeue) by
delivery tag, redelivery with a cap (then dead-lettered), consumer
cancellation that requeues its unacked deliveries, and ``get`` for clients
awaiting replies. Fault injection and trace propagation are not carried.
All methods are called from one event loop.
"""

from __future__ import annotations

import asyncio
import itertools
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from matchmaking_tpu_torch.config import BrokerConfig


@dataclass(frozen=True, slots=True)
class Properties:
    """AMQP basic.properties subset the contract uses."""

    reply_to: str = ""
    correlation_id: str = ""
    headers: dict[str, Any] = field(default_factory=dict)


@dataclass(slots=True)
class Delivery:
    body: bytes
    properties: Properties
    queue: str
    delivery_tag: int
    redelivered: bool = False
    redelivery_count: int = 0
    #: The ``x-first-received`` stamp as a float, cached by the ingress
    #: middleware (< 0: not read yet).
    first_received: float = -1.0


class _Queue:
    def __init__(self, name: str):
        self.name = name
        self.messages: asyncio.Queue[Delivery] = asyncio.Queue()
        self.consumers: list["_Consumer"] = []


class _Consumer:
    """Takes deliveries up to ``prefetch`` unacked and runs the callback of
    each in its own task (concurrent handlers, like a worker pool)."""

    def __init__(self, broker: "InProcBroker", queue: _Queue,
                 callback: Callable[[Delivery], Awaitable[None]], prefetch: int):
        self.broker = broker
        self.queue = queue
        self.callback = callback
        self.unacked: dict[int, Delivery] = {}
        self.tag = f"ctag-{uuid.uuid4().hex[:8]}"
        self._slots = asyncio.Semaphore(max(1, prefetch))
        self._handlers: set[asyncio.Task] = set()
        self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while True:
            await self._slots.acquire()
            try:
                delivery = await self.queue.messages.get()
            except asyncio.CancelledError:
                self._slots.release()
                raise
            self.unacked[delivery.delivery_tag] = delivery
            task = asyncio.create_task(self._handle(delivery))
            self._handlers.add(task)
            task.add_done_callback(self._handlers.discard)

    async def _handle(self, delivery: Delivery) -> None:
        try:
            await self.callback(delivery)
        except Exception:
            # A crashing callback must not lose the delivery: requeue it.
            self.broker.stats["consumer_errors"] += 1
            self.nack(delivery.delivery_tag, requeue=True)

    def ack(self, delivery_tag: int) -> None:
        if self.unacked.pop(delivery_tag, None) is not None:
            self.broker.stats["acked"] += 1
            self._slots.release()

    def nack(self, delivery_tag: int, requeue: bool = True) -> None:
        delivery = self.unacked.pop(delivery_tag, None)
        if delivery is None:
            return
        self._slots.release()
        if requeue:
            self.broker._requeue(self.queue, delivery)
        else:
            self.broker.stats["dead_lettered"] += 1

    def cancel(self) -> None:
        """Stop consuming; unacked deliveries go back to the queue (like an
        AMQP channel close)."""
        self._task.cancel()
        for task in list(self._handlers):
            task.cancel()
        for delivery in list(self.unacked.values()):
            self.broker._requeue(self.queue, delivery)
        self.unacked.clear()


class InProcBroker:
    """The broker. All methods are called from one event loop."""

    def __init__(self, cfg: BrokerConfig | None = None):
        self.cfg = cfg or BrokerConfig()
        self._queues: dict[str, _Queue] = {}
        self._tags = itertools.count(1)
        self._consumers: dict[str, _Consumer] = {}
        self.stats = {"published": 0, "acked": 0, "dead_lettered": 0,
                      "consumer_errors": 0, "unroutable": 0}

    def declare_queue(self, name: str) -> None:
        self._queues.setdefault(name, _Queue(name))

    def delete_queue(self, name: str) -> None:
        q = self._queues.pop(name, None)
        if q is not None:
            for consumer in list(q.consumers):
                self.basic_cancel(consumer.tag)

    def publish(self, queue: str, body: bytes,
                properties: Properties | None = None) -> None:
        # Default-exchange semantics: a publish to an undeclared queue is
        # dropped as unroutable (deleted reply queues must not resurrect).
        q = self._queues.get(queue)
        if q is None:
            self.stats["unroutable"] += 1
            return
        self.stats["published"] += 1
        q.messages.put_nowait(Delivery(
            body=bytes(body), properties=properties or Properties(),
            queue=queue, delivery_tag=next(self._tags)))

    def publish_batch(self, items) -> None:
        """Publish a window of messages in one call (the service's one
        response publish per window). ``items``: (queue, body,
        Properties or None); each is routed exactly as ``publish`` would."""
        for queue, body, properties in items:
            self.publish(queue, body, properties)

    def basic_consume(self, queue: str,
                      callback: Callable[[Delivery], Awaitable[None]],
                      prefetch: int | None = None) -> str:
        self.declare_queue(queue)
        consumer = _Consumer(self, self._queues[queue], callback,
                             prefetch or self.cfg.prefetch)
        self._queues[queue].consumers.append(consumer)
        self._consumers[consumer.tag] = consumer
        return consumer.tag

    def basic_cancel(self, consumer_tag: str) -> None:
        consumer = self._consumers.pop(consumer_tag, None)
        if consumer is not None:
            consumer.cancel()
            consumer.queue.consumers.remove(consumer)

    def ack(self, consumer_tag: str, delivery_tag: int) -> None:
        consumer = self._consumers.get(consumer_tag)
        if consumer is not None:
            consumer.ack(delivery_tag)

    def nack(self, consumer_tag: str, delivery_tag: int, requeue: bool = True) -> None:
        consumer = self._consumers.get(consumer_tag)
        if consumer is not None:
            consumer.nack(delivery_tag, requeue)

    async def get(self, queue: str, timeout: float | None = None) -> Delivery | None:
        """basic.get analog for clients awaiting replies (no consumer)."""
        self.declare_queue(queue)
        q = self._queues[queue]
        try:
            if timeout is None:
                return await q.messages.get()
            return await asyncio.wait_for(q.messages.get(), timeout)
        except asyncio.TimeoutError:
            return None

    def close(self) -> None:
        for tag in list(self._consumers):
            self.basic_cancel(tag)

    def _requeue(self, queue: _Queue, delivery: Delivery) -> None:
        if delivery.redelivery_count >= self.cfg.max_redelivery:
            self.stats["dead_lettered"] += 1
            return
        delivery.redelivered = True
        delivery.redelivery_count += 1
        queue.messages.put_nowait(delivery)
