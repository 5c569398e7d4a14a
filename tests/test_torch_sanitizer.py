"""The port's runtime async sanitizer (matchmaking_tpu_torch/testing/
sanitizer.py) held to the JAX package's.

- JAX's ``tests/test_sanitizer.py`` scripts — lock order, await under a
  lock, to_thread, loop stalls, assert_clean, consecutive loops, the hold
  histogram, the settlement twin (double ack, credit leak, clean,
  redelivery), the speculation twin (commit without validate, validate
  after mutate, clean) — run under each package's sanitizer, on each
  package's own broker, admission controller and engine: the finding
  kinds and their counts are equal, and the port's findings carry the
  same file:line attribution JAX's test asserts.
- The port's sanctioned backpressure wait is silent, on a live service
  whose pipeline fills; a sleep under ``_pool_lock`` anywhere else is
  reported.

``port_sanitized`` / ``port_sanitizer`` are the port's fixture (the JAX
package keeps its own in ``tests/conftest.py``): the other port tests
import them. The stall threshold is the JAX fixture's 2.0 s.
"""

import asyncio
import collections
import contextlib
import inspect
import time
import types

import pytest

from matchmaking_tpu import config as jax_config
from matchmaking_tpu.engine.interface import make_engine as jax_make_engine
from matchmaking_tpu.service import broker as jax_broker
from matchmaking_tpu.service import contract as jax_contract
from matchmaking_tpu.service import overload as jax_overload
from matchmaking_tpu.testing import sanitizer as jax_sanitizer
from matchmaking_tpu_torch import config as port_config
from matchmaking_tpu_torch.engine.interface import make_engine
from matchmaking_tpu_torch.service import broker as port_broker
from matchmaking_tpu_torch.service import contract as port_contract
from matchmaking_tpu_torch.service import overload as port_overload
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from matchmaking_tpu_torch.testing import sanitizer as port_san_mod
from matchmaking_tpu_torch.testing.sanitizer import AsyncSanitizer

THIS_FILE = "test_torch_sanitizer.py"

#: Each package's sanitizer and the classes its twins patch.
JAX = types.SimpleNamespace(
    sanitizer=jax_sanitizer, config=jax_config,
    broker=jax_broker, overload=jax_overload, contract=jax_contract,
    engine=lambda cfg, q: jax_make_engine(cfg, q), backend="tpu")
PORT = types.SimpleNamespace(
    sanitizer=port_san_mod, config=port_config,
    broker=port_broker, overload=port_overload, contract=port_contract,
    engine=lambda cfg, q: make_engine(cfg, q, device="cpu"), backend="gpu")


# ---- the port's fixture ------------------------------------------------------


@contextlib.contextmanager
def port_sanitized(stall_threshold_s: float = 2.0):
    """The port's sanitizer around a script, every check on; build the app
    INSIDE (its ``asyncio.Lock``s and journal are instrumented at
    construction). ``assert_clean()`` at the end."""
    san = AsyncSanitizer(stall_threshold_s=stall_threshold_s)
    with san.installed():
        yield san
    san.assert_clean()


@pytest.fixture
def port_sanitizer():
    with port_sanitized() as san:
        yield san


def _kinds(san) -> dict[str, int]:
    """Finding kinds and counts, credit leaks included (what
    ``assert_clean`` would report)."""
    san._check_settlement_leaks()
    return dict(collections.Counter(f.kind for f in san.findings))


# ---- JAX's scripts, one function each, run under either package --------------


def _lock_order(P):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)

    async def main():
        lock_a = asyncio.Lock()
        lock_b = asyncio.Lock()
        async with lock_a:
            async with lock_b:
                pass
        async with lock_b:
            async with lock_a:  # reverse order: the planted inversion
                pass

    with san.installed():
        asyncio.run(main())
    return san


def _await_under_lock(P, where=None):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)

    async def main():
        lock = asyncio.Lock()
        async with lock:
            if where is not None:
                where["n"] = inspect.currentframe().f_lineno + 1
            await asyncio.sleep(0.05)  # planted non-sanctioned suspension

    with san.installed():
        asyncio.run(main())
    return san


def _to_thread_sanctioned(P):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)

    async def main():
        lock = asyncio.Lock()
        async with lock:
            await asyncio.to_thread(time.sleep, 0.05)

    with san.installed():
        asyncio.run(main())
    return san


def _loop_stall(P):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=0.1,
                                     stall_interval_s=0.02)

    async def main():
        lock = asyncio.Lock()
        async with lock:
            pass
        await asyncio.sleep(0.05)
        time.sleep(0.3)  # planted on-loop blocking work
        await asyncio.sleep(0.05)

    with san.installed():
        asyncio.run(main())
    return san


def _clean_lock(P):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)

    async def fine():
        lock = asyncio.Lock()
        async with lock:
            pass

    with san.installed():
        asyncio.run(fine())
    return san


def _consecutive_loops(P):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=0.1,
                                     stall_interval_s=0.02)

    async def quiet():
        lock = asyncio.Lock()
        async with lock:
            pass
        await asyncio.sleep(0.05)

    async def stalling():
        lock = asyncio.Lock()
        async with lock:
            pass
        await asyncio.sleep(0.05)
        time.sleep(0.3)
        await asyncio.sleep(0.05)

    with san.installed():
        asyncio.run(quiet())     # first loop: no stall
        asyncio.run(stalling())  # second loop must still be watched
    return san


def _hold_histogram(P, where=None):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)

    async def main():
        lock = asyncio.Lock()
        for _ in range(3):
            if where is not None:
                where["n"] = inspect.currentframe().f_lineno + 1
            async with lock:
                await asyncio.to_thread(time.sleep, 0.05)  # sanctioned hold
        async with lock:
            pass  # near-zero hold at a DIFFERENT acquire site

    with san.installed():
        asyncio.run(main())
    return san


def _settle(P, double_ack: bool, leak_credit: bool):
    """One delivery through the package's own in-proc broker and admission
    controller, with the two planted bugs togglable."""
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)
    with san.installed():
        async def main():
            broker = P.broker.InProcBroker()
            ac = P.overload.AdmissionController(
                P.config.OverloadConfig(max_inflight=8), "fixture")
            done = asyncio.Event()
            state = {}

            async def on_delivery(delivery):
                ac.admit(delivery.delivery_tag)
                broker.ack(state["tag"], delivery.delivery_tag)
                if not leak_credit:
                    ac.release(delivery.delivery_tag)
                if double_ack:
                    broker.ack(state["tag"], delivery.delivery_tag)
                done.set()

            state["tag"] = broker.basic_consume("q", on_delivery)
            broker.publish("q", b"{}")
            await asyncio.wait_for(done.wait(), 5.0)
            broker.close()

        asyncio.run(main())
    return san


def _redelivery(P):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)
    with san.installed():
        async def main():
            broker = P.broker.InProcBroker()
            seen = []
            done = asyncio.Event()
            state = {}

            async def on_delivery(delivery):
                seen.append(delivery.delivery_tag)
                if len(seen) == 1:
                    broker.nack(state["tag"], delivery.delivery_tag,
                                requeue=True)
                else:
                    broker.ack(state["tag"], delivery.delivery_tag)
                    done.set()

            state["tag"] = broker.basic_consume("q", on_delivery)
            broker.publish("q", b"{}")
            await asyncio.wait_for(done.wait(), 5.0)
            broker.close()

        asyncio.run(main())
    return san


def _spec_engine(P):
    C = P.config
    q = C.QueueConfig(rating_threshold=10.0, widen_per_sec=10.0,
                      max_threshold=200.0)
    eng = P.engine(C.Config(queues=(q,), engine=C.EngineConfig(
        backend=P.backend, pool_capacity=64, pool_block=64,
        batch_buckets=(16,), spec_formation=True, spec_max_steps=1)), q)
    R = P.contract.SearchRequest
    eng.restore([R(id="a", rating=1500.0, enqueued_at=1.0, reply_to="rq.a"),
                 R(id="b", rating=1540.0, enqueued_at=1.0, reply_to="rq.b")],
                1.0)
    return eng


def _spec_unvalidated(P):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)
    with san.installed():
        eng = _spec_engine(P)
        assert eng.speculate(4.0)
        with pytest.raises(RuntimeError):
            eng.spec_commit(eng.pool_mutations, 4.0)
    return san


def _spec_after_mutate(P):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)
    with san.installed():
        eng = _spec_engine(P)
        assert eng.speculate(4.0)
        tok = eng.spec_validate(4.0)
        assert tok is not None
        eng.search_async([P.contract.SearchRequest(
            id="c", rating=9000.0, enqueued_at=4.5, reply_to="rq.c")], 4.5)
        with pytest.raises(RuntimeError):
            eng.spec_commit(tok, 5.0)
        eng.flush()
    return san


def _spec_clean(P):
    san = P.sanitizer.AsyncSanitizer(stall_threshold_s=60.0)
    with san.installed():
        eng = _spec_engine(P)
        assert eng.speculate(4.0)
        tok = eng.spec_validate(4.0)
        assert eng.spec_commit(tok, 4.0) is not None
        eng.flush()
    return san


#: name -> (script, the kinds JAX's test expects).
SCRIPTS = {
    "lock_order_inversion": (_lock_order, {"lock-order-inversion": 1}),
    "await_under_lock": (_await_under_lock, {"await-under-lock": 1}),
    "to_thread_sanctioned": (_to_thread_sanctioned, {}),
    "loop_stall": (_loop_stall, {"loop-stall": 1}),
    "clean_lock": (_clean_lock, {}),
    "consecutive_loops": (_consecutive_loops, {"loop-stall": 1}),
    "hold_histogram": (_hold_histogram, {}),
    "settle_double_ack": (lambda P: _settle(P, True, False),
                          {"double-settle": 1}),
    "settle_credit_leak": (lambda P: _settle(P, False, True),
                           {"credit-leak": 1}),
    "settle_clean": (lambda P: _settle(P, False, False), {}),
    "settle_redelivery": (_redelivery, {}),
    "spec_commit_unvalidated": (_spec_unvalidated,
                                {"spec-commit-unvalidated": 1}),
    "spec_validate_after_mutate": (_spec_after_mutate,
                                   {"spec-commit-unvalidated": 1}),
    "spec_clean": (_spec_clean, {}),
    "assert_clean_quotes_sites": (_await_under_lock, {"await-under-lock": 1}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_jax_script_gives_equal_findings_on_both_sanitizers(name):
    script, want = SCRIPTS[name]
    theirs = _kinds(script(JAX))
    mine = _kinds(script(PORT))
    assert theirs == want, theirs
    assert mine == theirs


# ---- the port's findings carry JAX's attribution -----------------------------


def test_lock_order_inversion_cites_both_orders():
    inv = [f for f in _lock_order(PORT).findings
           if f.kind == "lock-order-inversion"]
    assert len(inv) == 1
    assert inv[0].message.count(THIS_FILE) >= 3, inv[0].message
    assert "REVERSE order" in inv[0].message


def test_await_under_lock_names_the_await_site_and_the_fix():
    where = {}
    san = _await_under_lock(PORT, where)
    (f,) = [f for f in san.findings if f.kind == "await-under-lock"]
    assert f"{THIS_FILE}:{where['n']}" in f.message.replace("tests/", "")
    assert "to_thread" in f.message
    with pytest.raises(AssertionError) as e:
        san.assert_clean()
    assert "await-under-lock" in str(e.value)
    assert "slowest lock sites" in str(e.value) and THIS_FILE in str(e.value)


def test_hold_histogram_per_acquire_site():
    where = {}
    san = _hold_histogram(PORT, where)
    san.assert_clean()
    report = san.hold_report()
    site, stats = next(iter(report.items()))  # slowest max first
    assert THIS_FILE in site and str(where["n"]) in site
    assert stats["count"] == 3
    assert sum(s["count"] for s in report.values()) == 4
    assert stats["max_ms"] >= 50.0 and stats["p50_ms"] >= 25.0
    assert stats["p99_ms"] >= stats["p50_ms"]
    assert len(san.hold_report(top=1)) == 1


def test_settlement_twin_quotes_both_settle_sites_and_the_leak():
    (f,) = [f for f in _settle(PORT, True, False).findings
            if f.kind == "double-settle"]
    assert f.message.count(THIS_FILE) >= 2 and "already" in f.message
    san = _settle(PORT, False, True)
    with pytest.raises(AssertionError) as e:
        san.assert_clean()
    assert "credit-leak" in str(e.value) and THIS_FILE in str(e.value)
    assert "still held after the delivery settled" in str(e.value)
    clean = _settle(PORT, False, False)
    clean.assert_clean()
    assert clean.settlement_report()["open_credits"] == []


def test_spec_twin_quotes_the_commit_site():
    (f,) = [f for f in _spec_unvalidated(PORT).findings
            if f.kind == "spec-commit-unvalidated"]
    assert THIS_FILE in f.message
    assert "newer than the last pool mutation" in f.message


# ---- the port's sanctioned backpressure wait ---------------------------------


def _service_cfg():
    C = port_config
    return C.Config(
        queues=(C.QueueConfig(name="san.q", rating_threshold=10.0),),
        engine=C.EngineConfig(pool_capacity=256, pool_block=64,
                              batch_buckets=(16, 64), pipeline_depth=2),
        batcher=C.BatcherConfig(max_batch=16, max_wait_ms=1.0))


def test_backpressure_wait_under_pool_lock_is_silent():
    """A live service whose pipeline fills: the live depth is 1 and each
    window's results land 50 ms after its dispatch (the engine's
    ``collect_ready`` holds them back, as a busy card would), so a flush
    behind a window in flight waits in ``_backpressure_wait`` with
    ``_pool_lock`` held — the sanctioned seam. Every request is answered
    once; no finding."""
    from matchmaking_tpu_torch.service import app as app_mod

    waits = []
    real = app_mod._QueueRuntime._backpressure_wait

    async def counted(rt):
        if rt.engine.inflight() >= rt.pipeline_depth:
            waits.append(rt.engine.inflight())
        await real(rt)

    n = 96
    with port_sanitized() as san:
        async def main():
            app = MatchmakingApp(_service_cfg(), device="cpu")
            app.broker.declare_queue("san.r")
            await app.start()
            rt = app.runtime("san.q")
            rt.pipeline_depth = 1
            eng = rt.engine
            dispatch, collect = eng.search_columns_async, eng.collect_ready
            last = [0.0]

            def search_columns_async(*a, **k):
                last[0] = time.monotonic()
                return dispatch(*a, **k)

            def collect_ready():
                if time.monotonic() < last[0] + 0.05:
                    return []
                return collect()
            eng.search_columns_async = search_columns_async
            eng.collect_ready = collect_ready
            try:
                for i in range(n):
                    app.broker.publish(
                        "san.q", f'{{"id":"p{i}","rating":{1000 + 50 * i}}}'
                        .encode(), Properties(reply_to="san.r",
                                              correlation_id=f"c{i}"))
                    if i % 8 == 7:
                        await asyncio.sleep(0.002)
                got = []
                while len(got) < n:
                    d = await app.broker.get("san.r", timeout=5.0)
                    assert d is not None, len(got)
                    got.append(d)
                return len({d.properties.correlation_id for d in got})
            finally:
                await app.stop()

        app_mod._QueueRuntime._backpressure_wait = counted
        try:
            answered = asyncio.run(main())
        finally:
            app_mod._QueueRuntime._backpressure_wait = real
    assert answered == n
    assert waits, "no flush ever waited for a pipeline slot"
    assert san.findings == []
    assert any("_flush" in site for site in san.hold_report())


def test_sleep_under_pool_lock_elsewhere_is_reported():
    """The same runtime's ``_pool_lock`` held across a plain sleep (not the
    sanctioned helper): reported, with the sleeping line."""
    san = AsyncSanitizer(stall_threshold_s=60.0)
    where = {}
    with san.installed():
        app = MatchmakingApp(_service_cfg(), device="cpu")
        rt = app.runtime("san.q")

        async def main():
            async with rt._pool_lock:
                await rt._backpressure_wait()  # no engine: returns at once
            async with rt._pool_lock:
                where["n"] = inspect.currentframe().f_lineno + 1
                await asyncio.sleep(0.02)

        asyncio.run(main())
    (f,) = [f for f in san.findings if f.kind == "await-under-lock"]
    assert f"{THIS_FILE}:{where['n']}" in f.message.replace("tests/", "")
    assert len(san.findings) == 1
