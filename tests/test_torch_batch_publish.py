"""``BrokerConfig.batch_publish`` in the port's service, against the JAX
app's: the JAX rule is ``cfg.broker.batch_publish and hasattr(broker,
"publish_batch")``; when it is false a window's answers leave one
``publish`` each.

Both apps serve config #1 (its pool cut to a CPU size) on one seeded
window of 64 requests, three times: with the defaults, with
``batch_publish`` false, and on an injected broker that has no
``publish_batch``. Every publish to the reply queue is recorded as
(reply_to, body, correlation_id), the bodies with their match id and
measured times taken out (tests/test_torch_ingress.normalized). The
sequences are equal between the two apps in every run, once the JAX
window's queued acks are moved ahead of its matched answers (the port
sends a window's queued acks first: a kept difference, ROADMAP Queue 3),
and equal across the runs; ``publish_batch`` is called once a window only
in the first run, and the port raises nothing on the broker without it.
"""

import asyncio
import dataclasses
import os
import time

import numpy as np
import torch

from matchmaking_tpu.config import BatcherConfig as JaxBatcherConfig
from matchmaking_tpu.config import BrokerConfig as JaxBrokerConfig
from matchmaking_tpu.config import Config as JaxConfig
from matchmaking_tpu.config import ObservabilityConfig as JaxObservability
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import InProcBroker as JaxBroker
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu_torch.config import (
    BatcherConfig,
    BrokerConfig,
    Config,
    ObservabilityConfig,
)
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import InProcBroker, Properties

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG1 = os.path.join(ROOT, "configs", "elo_1v1.json")
REPLY = "rq.batch_publish"
N = 64


def recording(base):
    """A broker class recording every publish to the reply queue, and one
    more without ``publish_batch`` (its access raises AttributeError, so
    ``hasattr`` is false)."""

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sent = []
            self.batch_calls = 0
            self._in_batch = False

        def _record(self, queue, body, properties):
            if queue == REPLY and not self._in_batch:
                self.sent.append((queue, bytes(body),
                                  properties.correlation_id))

        def publish(self, queue, body, properties=None):
            self._record(queue, body, properties)
            return super().publish(queue, body, properties)

        def publish_batch(self, items):
            # The JAX broker may skip ``publish`` for a batch's items: the
            # batch is recorded here, its inner publishes not again.
            self.batch_calls += 1
            for queue, body, properties in items:
                self._record(queue, body, properties)
            self._in_batch = True
            try:
                return super().publish_batch(items)
            finally:
                self._in_batch = False

    class NoBatch(Recording):
        @property
        def publish_batch(self):
            raise AttributeError("publish_batch")

    return Recording, NoBatch


def configs(batch_publish):
    kw = dict(pool_capacity=1024, pool_block=256, batch_buckets=(16, 64))
    port = Config.from_json(CONFIG1, backend="gpu")
    port = dataclasses.replace(
        port, engine=dataclasses.replace(port.engine, **kw),
        batcher=BatcherConfig(max_batch=N, max_wait_ms=250.0),
        broker=BrokerConfig(batch_publish=batch_publish),
        observability=ObservabilityConfig(trace=False))
    jax = JaxConfig.from_json(CONFIG1)
    jax = dataclasses.replace(
        jax, engine=dataclasses.replace(jax.engine, **kw),
        batcher=JaxBatcherConfig(max_batch=N, max_wait_ms=250.0),
        broker=JaxBrokerConfig(batch_publish=batch_publish),
        observability=JaxObservability(trace=False))
    return port, jax


def bodies():
    rng = np.random.default_rng(13)
    return [f'{{"id":"p{i}","rating":{rng.normal(1500.0, 60.0):.2f}}}'
            .encode() for i in range(N)]


async def one_window(app, props):
    app.broker.declare_queue(REPLY)
    await app.start()
    try:
        for i, body in enumerate(bodies()):
            app.broker.publish(app.cfg.queues[0].name, body,
                               props(reply_to=REPLY, correlation_id=f"c{i}"))
        seen: set[str] = set()
        end = time.monotonic() + 60.0
        while len(seen) < N and time.monotonic() < end:
            d = await app.broker.get(REPLY, timeout=0.05)
            if d is not None:
                seen.add(d.properties.correlation_id)
        assert len(seen) == N
    finally:
        await app.stop()


def normalized(sent):
    from tests.test_torch_ingress import normalized as norm

    return [(q, norm(body), corr) for q, body, corr in sent]


def acks_first(rows):
    """A one-window sequence with its queued acks moved ahead of the rest,
    each part in its own order."""
    return ([r for r in rows if r[1]["status"] == "queued"]
            + [r for r in rows if r[1]["status"] != "queued"])


def run(app_cls, broker_cls, cfg, props, **kw):
    broker = broker_cls(cfg.broker)
    app = app_cls(cfg, broker=broker, **kw)
    asyncio.run(one_window(app, props))
    return broker, app


def test_batch_publish_off_and_a_broker_without_it_equal_the_jax_app():
    port_rec, port_nob = recording(InProcBroker)
    jax_rec, jax_nob = recording(JaxBroker)
    runs = {}
    for name, flag, pb, jb in (("batched", True, port_rec, jax_rec),
                               ("off", False, port_rec, jax_rec),
                               ("no_publish_batch", True, port_nob,
                                jax_nob)):
        pcfg, jcfg = configs(flag)
        mine, app = run(MatchmakingApp, pb, pcfg, Properties, device="cpu")
        theirs, _ = run(JaxApp, jb, jcfg, JaxProperties)
        assert app.faults() == {}
        assert normalized(mine.sent) == acks_first(
            normalized(theirs.sent)), name
        assert len(mine.sent) >= N
        if name == "batched":
            assert mine.batch_calls >= 1
        else:
            assert mine.batch_calls == theirs.batch_calls == 0, name
            assert app.runtime(app.cfg.queues[0].name).counters[
                "publish_batches"] == 0
        runs[name] = normalized(mine.sent)
    assert runs["off"] == runs["batched"] == runs["no_publish_batch"]
