"""In-process message broker with AMQP work-queue semantics.

The port's own minimal copy: named queues (declared on first use),
competing consumers with a per-consumer prefetch, ack / nack(requeue) by
delivery tag, redelivery with a cap (then dead-lettered), consumer
cancellation that requeues its unacked deliveries, burst consume (the
deliveries already buffered drain into one handler task, or into one
``batch_callback`` call: ``BrokerConfig.consume_batch``), ``get`` for
clients awaiting replies, ``rpc`` (a request over an ephemeral reply
queue: the auth middleware's round trip), and the drain's handoff
(``drain_backlog`` pops what is still buffered, ``queue_depth`` and
``handlers_idle`` say when nothing is left on the way). A request
publish (one with ``reply_to``) is stamped with a trace context
(``utils/trace.py``), every ``trace_sample_n``-th one when sampling; a
dead letter lands in ``events`` (the app's event log).

Fault injection, the JAX broker's:

- the app's ``ChaosState`` (utils/chaos.py) numbers each publish to a
  queue the script covers (``Delivery.seq``) and decides from it: a
  dropped first attempt or a seeded drop (the delivery is requeued before
  its handler runs), a storm of extra copies with seqs of their own (a
  copy is never duplicated again), and partitions (the queue's consumers
  wait at its gate from the pause publish to the resume publish, or for
  ``partition_max_s`` at most);
- ``BrokerConfig``'s probabilistic ``drop_prob``, ``dup_prob`` and
  ``delay_ms``, drawn from ``random.Random(seed)``.

While a consume-side fault is armed, a burst consumer hands each delivery
to the per-delivery handler, so a fault's identity does not depend on how
deliveries were batched. Faults are counted in ``stats`` (``dropped``,
``duplicated``, ``delayed``, ``partitions``) and logged in ``events``
(``chaos_drop``, ``chaos_dup``, ``partition_pause``,
``partition_resume``). All methods are called from one event loop.
"""

from __future__ import annotations

import asyncio
import itertools
import random
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from matchmaking_tpu_torch.config import BrokerConfig
from matchmaking_tpu_torch.utils.trace import TraceContext


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
    #: The queue's publish sequence number, the identity every chaos
    #: decision is a function of; -1 where no chaos script covers the
    #: queue (nothing is counted).
    seq: int = -1
    #: The QoS tier (service/overload.py), read from the ``x-tier`` header
    #: at admission and cached here for the EDF key and the flush; 0 is
    #: the most latency-critical tier and the untiered default.
    tier: int = 0
    #: The ``x-deadline`` header as a float, cached at admission: < 0 not
    #: read yet, 0.0 none, else the absolute wall-clock deadline.
    deadline: float = -1.0
    #: The ``x-first-received`` stamp as a float, cached by the ingress
    #: middleware (< 0: not read yet).
    first_received: float = -1.0
    #: Submit sequence at the batcher (per queue runtime, renewed at each
    #: submit): window-granular admission decides a cut window in this
    #: order, whatever order the EDF sort gave it.
    arrival: int = -1
    #: The row decoded at consume (burst consume, ``service/ingress.py``):
    #: ``(DecodedBurst, index)`` into the burst's columns, which the window
    #: flush gathers instead of decoding the body again. None: not decoded
    #: at consume (the per-delivery path).
    row: Any = None
    #: The request's trace (utils/trace.TraceContext), stamped at publish;
    #: None: untraced (tracing off, sampled out, or a response).
    trace: Any = None


class _Queue:
    def __init__(self, name: str):
        self.name = name
        self.messages: asyncio.Queue[Delivery] = asyncio.Queue()
        self.consumers: list["_Consumer"] = []
        #: The partition gate: set, consumers take deliveries; cleared,
        #: they wait (a chaos partition).
        self.gate = asyncio.Event()
        self.gate.set()
        #: The failsafe resume of the current partition (cancelled by the
        #: scripted resume, so it cannot fire into a later partition).
        self.gate_timer: asyncio.TimerHandle | None = None


class _BatchState:
    """One handler task's deliveries and progress, registered BEFORE the
    task is created, so that ``cancel()`` can requeue them even if the
    task is cancelled before its first step (a coroutine that never
    started never runs its try/finally: relying on the task body alone
    would lose the whole batch)."""

    __slots__ = ("batch", "i", "current")

    def __init__(self, batch: list[Delivery]):
        self.batch = batch
        self.i = 0                              # next index to start
        self.current: Delivery | None = None    # in-flight delivery, if any


class _Consumer:
    """Takes deliveries up to ``prefetch`` unacked. Each delivery runs in a
    handler task of its own, so callbacks run concurrently up to
    ``prefetch``; with ``batch_hint`` the deliveries already buffered on
    the queue drain into ONE handler task per sweep (up to
    ``consume_batch_max``), run one after another; with ``batch_callback``
    such a burst goes to the app as ONE ``batch_callback(burst)`` call
    instead of a callback per delivery, unless a consume-side fault is
    armed: then each delivery of the burst goes through ``_handle``."""

    def __init__(self, broker: "InProcBroker", queue: _Queue,
                 callback: Callable[[Delivery], Awaitable[None]],
                 prefetch: int, batch_hint: bool = False,
                 batch_callback: Callable[[list[Delivery]],
                                          Awaitable[None]] | None = None):
        self.broker = broker
        self.queue = queue
        self.callback = callback
        self.prefetch = max(1, prefetch)
        self.unacked: dict[int, Delivery] = {}
        self.cancelled = False
        self.tag = f"ctag-{uuid.uuid4().hex[:8]}"
        self.batch_hint = batch_hint
        self.batch_callback = batch_callback
        self._burst_max = max(1, broker.cfg.consume_batch_max)
        #: Tags the last cancel() requeued from ``unacked``.
        self._cancel_requeued: set[int] = set()
        self._batch_states: set[_BatchState] = set()
        self._free = self.prefetch
        self._free_ev = asyncio.Event()
        self._handlers: set[asyncio.Task] = set()
        self._task = asyncio.create_task(self._run())

    async def _acquire(self) -> None:
        while self._free <= 0:
            self._free_ev.clear()
            await self._free_ev.wait()
        self._free -= 1

    def _release(self) -> None:
        self._free += 1
        self._free_ev.set()

    def _try_acquire(self) -> bool:
        if self._free > 0:
            self._free -= 1
            return True
        return False

    async def _run(self) -> None:
        while not self.cancelled:
            if not self.queue.gate.is_set():
                # A partition: deliveries buffer until the gate reopens.
                await self.queue.gate.wait()
            await self._acquire()
            try:
                delivery = await self.queue.messages.get()
            except asyncio.CancelledError:
                self._release()
                raise
            if self.cancelled:
                # Closed mid-delivery: put it back and stop.
                self.queue.messages.put_nowait(delivery)
                self._release()
                return
            batch = [delivery]
            if self.batch_hint or self.batch_callback is not None:
                while (len(batch) < self._burst_max
                       and not self.queue.messages.empty()
                       and self._try_acquire()):
                    batch.append(self.queue.messages.get_nowait())
            # Registered BEFORE create_task: cancel() must see these
            # deliveries even if the task is cancelled before it runs.
            state = _BatchState(batch)
            self._batch_states.add(state)
            handler = (self._handle_burst
                       if (self.batch_callback is not None
                           and not self.broker.consume_faults_enabled)
                       else self._handle_batch)
            task = asyncio.create_task(handler(state))
            self._handlers.add(task)
            task.add_done_callback(self._handlers.discard)

    def _requeue_batch_rest(self, state: _BatchState) -> None:
        """Requeue a batch's unfinished deliveries exactly once. Called
        from the handler's finally or from cancel(), whichever runs first:
        it empties the state, so the other is a no-op. The in-flight
        delivery is requeued by cancel()'s sweep of ``unacked`` once its
        handler registered it; the ``unacked`` and ``_cancel_requeued``
        checks cover the moment before that."""
        start = state.i
        current, state.current = state.current, None
        if current is not None:
            if (current.delivery_tag not in self.unacked
                    and current.delivery_tag not in self._cancel_requeued):
                self._release()
                self.broker._requeue(self.queue, current)
            start += 1
        for j in range(start, len(state.batch)):
            self._release()
            self.broker._requeue(self.queue, state.batch[j])
        state.i = len(state.batch)
        self._batch_states.discard(state)

    async def _handle_batch(self, state: _BatchState) -> None:
        try:
            while state.i < len(state.batch):
                state.current = state.batch[state.i]
                await self._handle(state.current)
                state.current = None
                state.i += 1
        finally:
            self._requeue_batch_rest(state)

    async def _handle_burst(self, state: _BatchState) -> None:
        """One app callback for the whole drained burst. Every delivery is
        registered in ``unacked`` BEFORE the callback, so the at-least-once
        contract moves wholesale: cancel()'s sweep of ``unacked`` requeues
        them, acks and nacks settle them one by one as the app's windows
        finish, and a crashing callback nack-requeues every delivery it
        had not settled (the per-delivery crash contract, for a burst)."""
        batch = state.batch
        for delivery in batch:
            self.unacked[delivery.delivery_tag] = delivery
        # ``unacked`` owns the burst now: the sweep of batches that never
        # started (_requeue_batch_rest) must not requeue it a second time.
        state.i = len(batch)
        state.current = None
        self._batch_states.discard(state)
        try:
            await self.batch_callback(batch)
        except Exception:
            self.broker.stats["consumer_errors"] += 1
            for delivery in batch:
                if delivery.delivery_tag in self.unacked:
                    self.nack(delivery.delivery_tag, requeue=True)

    async def _handle(self, delivery: Delivery) -> None:
        broker = self.broker
        if broker.consume_faults_enabled:
            # The one consume-side fault gate: the delay, the chaos drop
            # and the seeded drop (a broker without faults skips it).
            if broker.cfg.delay_ms > 0:
                broker.stats["delayed"] += 1
                await asyncio.sleep(broker.cfg.delay_ms / 1000.0)
            chaos = broker.chaos
            if ((chaos is not None
                 and chaos.should_drop(delivery.queue, delivery.seq,
                                       delivery.redelivery_count))
                    or broker._should_drop()):
                # The consumer "crashed" before the handler ran: requeued,
                # as a channel close would.
                broker.stats["dropped"] += 1
                if delivery.trace is not None:
                    delivery.trace.mark("chaos_drop")
                if broker.events is not None:
                    broker.events.append(
                        "chaos_drop", delivery.queue,
                        f"seq {delivery.seq} attempt "
                        f"{delivery.redelivery_count}")
                self._release()
                broker._requeue(self.queue, delivery)
                return
        self.unacked[delivery.delivery_tag] = delivery
        try:
            await self.callback(delivery)
        except Exception:
            # A crashing callback must not lose the delivery: requeue it.
            self.broker.stats["consumer_errors"] += 1
            self.nack(delivery.delivery_tag, requeue=True)

    def ack(self, delivery_tag: int) -> None:
        if self.unacked.pop(delivery_tag, None) is not None:
            self.broker.stats["acked"] += 1
            self._release()

    def nack(self, delivery_tag: int, requeue: bool = True) -> None:
        delivery = self.unacked.pop(delivery_tag, None)
        if delivery is None:
            return
        self._release()
        if requeue:
            self.broker._requeue(self.queue, delivery)
        else:
            self.broker.stats["dead_lettered"] += 1

    def cancel(self) -> None:
        """Stop consuming; unacked deliveries go back to the queue (like an
        AMQP channel close), and so do the batches whose handler never
        started."""
        self.cancelled = True
        self._task.cancel()
        for task in list(self._handlers):
            task.cancel()
        self._cancel_requeued = set(self.unacked)
        for delivery in list(self.unacked.values()):
            self.broker._requeue(self.queue, delivery)
        self.unacked.clear()
        # A handler task cancelled before its first step never runs its
        # finally: sweep its registered batch here (a state empties on its
        # first sweep, so a finally that runs later is a no-op).
        for state in list(self._batch_states):
            self._requeue_batch_rest(state)


class InProcBroker:
    """The broker. All methods are called from one event loop. ``seed``
    seeds the ``BrokerConfig`` faults; ``chaos`` is the app's
    ``ChaosState`` (or None)."""

    def __init__(self, cfg: BrokerConfig | None = None, seed: int = 0,
                 chaos: Any = None):
        self.cfg = cfg or BrokerConfig()
        self.chaos = chaos
        #: A consume-side fault is armed: every delivery passes the fault
        #: gate of ``_Consumer._handle`` (and bursts take that path).
        self.consume_faults_enabled = (
            self.cfg.delay_ms > 0 or self.cfg.drop_prob > 0
            or (chaos is not None and chaos.consume_faults()))
        #: A publish-side fault is armed (duplicates, storms, partitions).
        self.publish_faults_enabled = (
            self.cfg.dup_prob > 0
            or (chaos is not None and chaos.publish_faults()))
        self._rng = random.Random(seed)
        #: Publish sequence numbers of the queues the chaos script covers.
        self._pub_seq: dict[str, int] = {}
        self._queues: dict[str, _Queue] = {}
        self._tags = itertools.count(1)
        self._consumers: dict[str, _Consumer] = {}
        self.stats = {"published": 0, "acked": 0, "dropped": 0,
                      "duplicated": 0, "delayed": 0, "dead_lettered": 0,
                      "consumer_errors": 0, "unroutable": 0, "partitions": 0}
        #: The app's event log (utils/trace.EventLog), attached by the app:
        #: dead letters land there.
        self.events: Any = None
        #: Trace stamping, set by the app (ObservabilityConfig.trace).
        self.trace_enabled = True
        #: Stamp every Nth request publish (1: every one).
        self.trace_sample_n = 1
        self._trace_count = 0

    def declare_queue(self, name: str) -> None:
        self._queues.setdefault(name, _Queue(name))

    def delete_queue(self, name: str) -> None:
        q = self._queues.pop(name, None)
        if q is not None:
            for consumer in list(q.consumers):
                self.basic_cancel(consumer.tag)

    def queue_depth(self, name: str) -> int:
        q = self._queues.get(name)
        return q.messages.qsize() if q else 0

    def drain_backlog(self, name: str) -> list[Delivery]:
        """Pop every delivery still buffered on ``name`` (the drain's
        handoff: with the queue's consumers cancelled they would die with
        the process; the app checkpoints them and a successor re-publishes
        them). Call it after cancelling the queue's consumers."""
        q = self._queues.get(name)
        out: list[Delivery] = []
        if q is None:
            return out
        while not q.messages.empty():
            out.append(q.messages.get_nowait())
        return out

    def handlers_idle(self) -> bool:
        """No consumer has a handler task outstanding (a delivery inside a
        handler that has not run yet is invisible to ``queue_depth``)."""
        return all(not c._handlers for c in self._consumers.values())

    def publish(self, queue: str, body: bytes,
                properties: Properties | None = None) -> None:
        # Default-exchange semantics: a publish to an undeclared queue is
        # dropped as unroutable (deleted reply queues must not resurrect).
        q = self._queues.get(queue)
        if q is None:
            self.stats["unroutable"] += 1
            return
        chaos = self.chaos
        seq = -1
        if chaos is not None and chaos.applies(queue):
            seq = self._pub_seq.get(queue, 0)
            self._pub_seq[queue] = seq + 1
        props = properties or Properties()
        # Only a request (reply_to set) gets a trace: a response is read by
        # a client, never settled by a runtime.
        stamp = self.trace_enabled and bool(props.reply_to)
        if stamp and self.trace_sample_n > 1:
            # Counted over stampable publishes: a uniform sample of requests.
            self._trace_count += 1
            stamp = self._trace_count % self.trace_sample_n == 1
        body = bytes(body)
        self.stats["published"] += 1
        q.messages.put_nowait(Delivery(
            body=body, properties=props, queue=queue,
            delivery_tag=next(self._tags), seq=seq,
            trace=TraceContext(queue, props.correlation_id) if stamp else None))
        if not self.publish_faults_enabled:
            return
        if self.cfg.dup_prob > 0 and self._rng.random() < self.cfg.dup_prob:
            # A duplicate delivery (no seq of its own).
            self.stats["duplicated"] += 1
            q.messages.put_nowait(Delivery(
                body=body, properties=props, queue=queue,
                delivery_tag=next(self._tags), redelivered=True,
                trace=(TraceContext(queue, props.correlation_id,
                                    redelivered=True) if stamp else None)))
        if chaos is None or seq < 0:
            return
        # A storm: each copy takes a seq of its own (a delivery of its own
        # for the drop decisions) and is never duplicated again.
        n_copies = chaos.dup_copies(queue, seq)
        if n_copies and self.events is not None:
            self.events.append("chaos_dup", queue,
                               f"seq {seq} +{n_copies} copies")
        for _ in range(n_copies):
            cseq = self._pub_seq[queue]
            self._pub_seq[queue] = cseq + 1
            self.stats["duplicated"] += 1
            q.messages.put_nowait(Delivery(
                body=body, properties=props, queue=queue,
                delivery_tag=next(self._tags), redelivered=True, seq=cseq,
                trace=(TraceContext(queue, props.correlation_id,
                                    redelivered=True) if stamp else None)))
        action = chaos.partition_action(queue, seq)
        if action == "pause":
            self._pause(q)
        elif action == "resume":
            self._resume(q)

    def publish_batch(self, items) -> None:
        """Publish a window of messages in one call (the service's one
        response publish per window). ``items``: (queue, body,
        Properties or None); each goes through ``publish``, so a queue the
        chaos script covers, or an armed publish fault, sees every item as
        a publish of its own."""
        for queue, body, properties in items:
            self.publish(queue, body, properties)

    def basic_consume(self, queue: str,
                      callback: Callable[[Delivery], Awaitable[None]],
                      prefetch: int | None = None, batch_hint: bool = False,
                      batch_callback: Callable[[list[Delivery]],
                                               Awaitable[None]] | None = None
                      ) -> str:
        """Consume ``queue``: ``callback`` per delivery, or with
        ``batch_callback`` one call per drained burst (``batch_hint``: the
        per-delivery callbacks of a burst run in one task)."""
        self.declare_queue(queue)
        consumer = _Consumer(self, self._queues[queue], callback,
                             prefetch or self.cfg.prefetch,
                             batch_hint=batch_hint,
                             batch_callback=batch_callback)
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

    async def rpc(self, queue: str, body: bytes,
                  timeout: float) -> bytes | None:
        """Publish ``body`` to ``queue`` with an ephemeral reply queue and
        await the reply that carries its correlation id (None on
        timeout). The reply queue is deleted afterwards."""
        reply_queue = f"amq.gen-{uuid.uuid4().hex}"
        corr = uuid.uuid4().hex
        self.declare_queue(reply_queue)  # before publish: replies must route
        self.publish(queue, body, Properties(reply_to=reply_queue,
                                             correlation_id=corr))
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        try:
            while True:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    return None
                reply = await self.get(reply_queue, timeout=remaining)
                if reply is None:
                    return None
                if reply.properties.correlation_id == corr:
                    return reply.body
        finally:
            self.delete_queue(reply_queue)

    def close(self) -> None:
        for tag in list(self._consumers):
            self.basic_cancel(tag)

    # ---- fault injection --------------------------------------------------

    def _should_drop(self) -> bool:
        return (self.cfg.drop_prob > 0
                and self._rng.random() < self.cfg.drop_prob)

    def _pause(self, q: _Queue) -> None:
        """A partition: the queue's consumers wait at its gate until the
        scripted resume publish, or ``partition_max_s`` later at most (a
        resume seq that never comes must not wedge a drain)."""
        if not q.gate.is_set():
            return
        q.gate.clear()
        self.stats["partitions"] += 1
        if self.events is not None:
            self.events.append("partition_pause", q.name)
        max_s = self.chaos.cfg.partition_max_s if self.chaos else 0.0
        if max_s > 0:
            try:
                q.gate_timer = asyncio.get_running_loop().call_later(
                    max_s, lambda: self._resume(q))
            except RuntimeError:  # no running loop
                pass

    def _resume(self, q: _Queue) -> None:
        if q.gate_timer is not None:
            q.gate_timer.cancel()
            q.gate_timer = None
        if not q.gate.is_set():
            q.gate.set()
            if self.events is not None:
                self.events.append("partition_resume", q.name)

    def _requeue(self, queue: _Queue, delivery: Delivery) -> None:
        if delivery.redelivery_count >= self.cfg.max_redelivery:
            self.stats["dead_lettered"] += 1
            if self.events is not None:
                self.events.append("dead_letter", queue.name,
                                   f"tag {delivery.delivery_tag}")
            return
        delivery.redelivered = True
        delivery.redelivery_count += 1
        queue.messages.put_nowait(delivery)
