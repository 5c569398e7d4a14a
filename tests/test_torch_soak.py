"""The port's twin of ``tests/test_soak.py::test_soak_faulty_broker_no_double_match``.

Sustained traffic with seeded broker chaos (drop 0.1, dup 0.15 on the
request queue), threshold widening and multi-chunk rescan ticks racing the
pipelined flushes, the online invariant checker armed
(``debug_invariants``), at ``readback_group`` 1 and 3 (wait 2 ms): the
grouped run soaks full groups sealed at dispatch, stale seals at collect
and forced seals at flush. Nobody is in two matches, nothing is dead
lettered, matched + waiting covers the submitted players. The app runs on
``device="cpu"`` under the port's own async sanitizer, every check on.
"""

import asyncio

import numpy as np
import pytest
import torch

from matchmaking_tpu_torch.config import (
    BatcherConfig,
    BrokerConfig,
    ChaosConfig,
    Config,
    EngineConfig,
    QueueConfig,
)
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from test_torch_sanitizer import port_sanitized

torch.set_num_threads(1)


@pytest.mark.chaos
@pytest.mark.parametrize("readback_group", [1, 3])
def test_soak_faulty_broker_no_double_match(readback_group):
    async def run():
        # rescan_window above the top bucket: every tick is a multi-chunk
        # rescan racing the pipelined flushes under fault injection.
        q = QueueConfig(rating_threshold=60.0, widen_per_sec=20.0,
                        max_threshold=300.0, rescan_interval_s=0.05,
                        rescan_window=1024)
        cfg = Config(
            queues=(q,),
            engine=EngineConfig(backend="gpu", pool_capacity=1024,
                                pool_block=256, batch_buckets=(16, 64, 256),
                                pipeline_depth=4,
                                readback_group=readback_group,
                                readback_group_wait_ms=2.0),
            broker=BrokerConfig(max_redelivery=30),
            chaos=ChaosConfig(seed=42, queues=(q.name,),
                              drop_prob=0.1, dup_prob=0.15),
            batcher=BatcherConfig(max_batch=256, max_wait_ms=2.0),
            debug_invariants=True,  # raises on a double match
        )
        app = MatchmakingApp(cfg, device="cpu")
        await app.start()
        rng = np.random.default_rng(42)
        reply = "soak.replies"
        app.broker.declare_queue(reply)
        n = 400
        try:
            for i in range(n):
                body = (f'{{"id":"p{i}","rating":'
                        f'{float(rng.normal(1500, 120)):.2f}}}').encode()
                app.broker.publish(q.name, body,
                                   Properties(reply_to=reply,
                                              correlation_id=f"c{i}"))
                if i % 50 == 49:
                    await asyncio.sleep(0.05)
            for _ in range(400):
                await asyncio.sleep(0.05)
                matched = app.metrics.counters.get("players_matched")
                waiting = app.runtime(q.name).engine.pool_size()
                if (app.broker.queue_depth(q.name) == 0
                        and matched + waiting >= n * 0.95
                        and matched > n * 0.5):
                    break
            matched = app.metrics.counters.get("players_matched")
            waiting = app.runtime(q.name).engine.pool_size()
            dead = app.broker.stats["dead_lettered"]
            assert dead == 0, f"lost deliveries: dead={dead}"
            assert matched + waiting >= n * 0.95, (
                f"lost players: matched={matched} waiting={waiting}")
            assert matched > n * 0.5, "the soak should mostly match"
            engine = app.runtime(q.name).engine
            assert engine._rb_k == readback_group
            assert engine.device_error is None
        finally:
            await app.stop()

    with port_sanitized():
        asyncio.run(run())
