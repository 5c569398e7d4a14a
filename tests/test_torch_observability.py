"""The port's HTTP observability server (``service/observability.py``)
against the JAX app's, over real HTTP on free ports.

Both apps serve the same seeded traffic, each on its own port taken from
the OS (bound to port 0, then released: the JAX tests bind fixed ports
and the tier-1 run is parallel):

- ``/metrics?format=prom`` is valid by ``tests/test_observability.py``'s
  ``parse_prom`` (one TYPE line per family, before its samples, no
  duplicate series, every value a number), and its families and each
  family's label-key sets equal the JAX app's, but for the pinned
  ``PROM_DIFFERENCES`` (none today: a new difference fails).
- ``/healthz``: its keys (and each queue entry's) and ``status`` equal the
  JAX app's when healthy, while the breaker demotes the queue (the JAX
  crash storm's configuration, its probes held back) and while draining.
- Every ``/debug/*`` route, with and without its query parameters, gives
  the JAX app's status and top-level keys; the 404 bodies are equal.
- A ``queue`` label with a quote, a backslash and a newline round-trips.
- ``/debug/profile`` on the CPU: the JAX keys, a Chrome trace file, 409
  while a capture runs, 400 for a ``secs`` that is not a number.
- ``serve`` with ``MM_METRICS_PORT`` answers ``/healthz``, and
  ``draining`` while its drain runs.
"""

import asyncio
import dataclasses
import json
import os
import socket

import aiohttp
import pytest
import torch

from matchmaking_tpu.config import OverloadConfig as JaxOverloadConfig
from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
from matchmaking_tpu.service.broker import Properties as JaxProperties
from matchmaking_tpu_torch.config import OverloadConfig
from matchmaking_tpu_torch.service import app as app_module
from matchmaking_tpu_torch.service import observability
from matchmaking_tpu_torch.service.app import MatchmakingApp
from matchmaking_tpu_torch.service.broker import Properties
from test_observability import parse_prom
from test_torch_breaker import _storm_cfgs
from test_torch_ingress import QUEUE, REPLY, jax_cfg, port_cfg, soak_bodies

torch.set_num_threads(1)

#: Prometheus families (or family/label-key pairs) in which the port's
#: exposition differs from the JAX app's on these scenarios: none.
PROM_DIFFERENCES: frozenset = frozenset()


def free_port() -> int:
    """A port the OS had free: bound to port 0, then released."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def get(port, path):
    async with aiohttp.ClientSession() as s:
        async with s.get(f"http://127.0.0.1:{port}{path}") as r:
            return r.status, await r.text()


def body_keys(text):
    body = json.loads(text)
    return sorted(body) if isinstance(body, dict) else type(body).__name__


def prom_shape(text):
    """{family: sorted label-key tuples} of a parsed exposition."""
    types, samples = parse_prom(text)
    shape: dict = {name: set() for name in types}
    for name, labels, _ in samples:
        family = next((f for f in (name, name.rsplit("_", 1)[0])
                       if f in types), name)
        shape[family].add(tuple(k for k, _ in labels))
    return {k: sorted(v) for k, v in shape.items()}


def prom_differences(mine, theirs):
    out = set()
    for fam in set(mine) | set(theirs):
        if fam not in mine or fam not in theirs:
            out.add(fam)
        elif mine[fam] != theirs[fam]:
            out |= {(fam, k) for k in set(map(tuple, mine[fam]))
                    ^ set(map(tuple, theirs[fam]))}
    return out


def healthz_shape(text):
    body = json.loads(text)
    return (body["status"], sorted(body),
            {q: sorted(e) for q, e in body["queues"].items()},
            sorted(body.get("incidents", {})))


#: Every route, with the query parameters of each (a missing id gives the
#: JAX app's 404).
ROUTES = ("/healthz", "/metrics", "/debug/traces",
          f"/debug/traces?queue={QUEUE}&n=4", "/debug/traces?id=nope%230",
          "/debug/attribution", f"/debug/attribution?queue={QUEUE}&p=50",
          "/debug/attribution?p=x", "/debug/quality",
          f"/debug/quality?queue={QUEUE}", "/debug/placement",
          "/debug/placement?n=3", "/debug/autotune", "/debug/telemetry",
          "/debug/telemetry?n=1&key=pool_size,slo", "/debug/events",
          f"/debug/events?queue={QUEUE}&n=2", "/debug/incidents",
          "/debug/incidents?bundles=1", "/debug/incidents?id=inc-999999")


async def _soak_and_scrape(app, props, port, bodies, *, breaker=False):
    """Serve ``bodies`` in bursts of 64 (each once the last is answered),
    trip a breaker trigger, sample the telemetry, then fetch every route
    and the Prometheus text."""
    app.broker.declare_queue(REPLY)
    await app.start()
    answered: set = set()
    try:
        for b in range(0, len(bodies), 64):
            corrs = [f"c{i}" for i in range(b, min(b + 64, len(bodies)))]
            for corr, body in zip(corrs, bodies[b:b + 64]):
                app.broker.publish(QUEUE, body, props(reply_to=REPLY,
                                                      correlation_id=corr))
            for _ in range(1200):
                d = await app.broker.get(REPLY, timeout=0.05)
                if d is not None:
                    answered.add(d.properties.correlation_id)
                elif all(c in answered for c in corrs):
                    break
        if breaker:
            app.events.append("breaker_trip", QUEUE, "fixture trip")
        app.sample_telemetry()
        app.sample_telemetry()
        got = {path: await get(port, path) for path in ROUTES}
        got["prom"] = await get(port, "/metrics?format=prom")
    finally:
        await app.stop()
    return got


@pytest.fixture(scope="module")
def scraped():
    """Config #1's seeded soak through both apps, every route fetched."""
    bodies = soak_bodies(seed=5)
    out = {}
    for name, make, props, cfg in (
            ("port", lambda c: MatchmakingApp(c, device="cpu"), Properties,
             port_cfg()),
            ("jax", JaxApp, JaxProperties, jax_cfg())):
        port = free_port()
        app = make(dataclasses.replace(cfg, metrics_port=port))
        out[name] = asyncio.run(_soak_and_scrape(app, props, port, bodies,
                                                 breaker=True))
    return out


def test_prom_text_is_valid_and_its_families_equal_jax(scraped):
    mine, theirs = scraped["port"]["prom"], scraped["jax"]["prom"]
    assert mine[0] == theirs[0] == 200
    shape, jshape = prom_shape(mine[1]), prom_shape(theirs[1])
    assert prom_differences(shape, jshape) == PROM_DIFFERENCES
    for family in ("matchmaking_pool_size", "matchmaking_dedup_cache_size",
                   "matchmaking_players_matched", "matchmaking_stage_seconds",
                   "matchmaking_match_quality",
                   "matchmaking_quality_disparity",
                   "matchmaking_device_busy_seconds",
                   "matchmaking_attribution_seconds",
                   "matchmaking_incidents_by_class",
                   "matchmaking_incidents_captured",
                   "matchmaking_breaker_trips",
                   "matchmaking_incident_capture_p99_ms"):
        assert family in shape, family
    types, samples = parse_prom(mine[1])
    assert types["matchmaking_stage_seconds"] == "histogram"
    pool = [v for n, labels, v in samples if n == "matchmaking_pool_size"]
    report = json.loads(scraped["port"]["/metrics"][1])
    assert pool == [str(report["pools"][QUEUE])]


@pytest.mark.parametrize("path", ROUTES)
def test_every_route_answers_like_jax(scraped, path):
    (status, text), (jstatus, jtext) = (scraped["port"][path],
                                        scraped["jax"][path])
    assert status == jstatus
    assert body_keys(text) == body_keys(jtext)
    if status == 404:
        assert json.loads(text) == json.loads(jtext)


def test_healthz_equals_jax_when_healthy(scraped):
    mine = healthz_shape(scraped["port"]["/healthz"][1])
    assert mine == healthz_shape(scraped["jax"]["/healthz"][1])
    assert mine[0] == "ok"
    body = json.loads(scraped["port"]["/healthz"][1])
    assert body["queues"][QUEUE]["engine"] == "GpuEngine"
    assert "replication" not in body["queues"][QUEUE]
    assert body["incidents"]["by_class"] == {"breaker_trip": 1}
    assert body["incidents"]["last_id"] == "inc-000001"


def test_metrics_json_has_the_jax_report_keys(scraped):
    mine = json.loads(scraped["port"]["/metrics"][1])
    theirs = json.loads(scraped["jax"]["/metrics"][1])
    assert sorted(mine) == sorted(theirs)
    for key in ("pools", "dedup_cache", "device_util", "incidents",
                "telemetry_last", "quality_engine", "attribution"):
        assert sorted(mine[key]) == sorted(theirs[key]), key
    assert mine["pools"] == theirs["pools"]
    assert mine["dedup_cache"] == theirs["dedup_cache"]


async def test_a_quote_backslash_and_newline_label_round_trips():
    port = free_port()
    cfg = dataclasses.replace(port_cfg(), metrics_port=port)
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    try:
        app.metrics.set_gauge('escape_check[we"ird\\q\nueue]', 1.0)
        status, text = await get(port, "/metrics?format=prom")
    finally:
        await app.stop()
    assert status == 200
    types, samples = parse_prom(text)
    (labels,) = [dict(l) for n, l, _ in samples
                 if n == "matchmaking_escape_check"]
    assert labels == {"queue": 'we\\"ird\\\\q\\nueue'}
    assert types["matchmaking_escape_check"] == "gauge"


# ---- /healthz degraded and draining ------------------------------------------

async def _degraded(app, props, port):
    """The crash storm's configuration with its probes held back: the
    first windows fail, the breaker trips and stays open, and the host
    oracle answers all 32 players."""
    q = "mm.chaos"
    app.broker.declare_queue(q)
    app.broker.declare_queue("chaos.replies")
    for i in range(32):
        app.broker.publish(q, f'{{"id":"p{i}","rating":1500}}'.encode(),
                           props(reply_to="chaos.replies",
                                 correlation_id=f"c{i}"))
    await app.start()
    rt = app.runtime(q)
    try:
        for _ in range(400):
            await asyncio.sleep(0.02)
            if (rt.breaker.state != "closed"
                    and app.metrics.counters.get("players_matched") >= 32):
                break
        assert rt.breaker.state != "closed"
        assert app.metrics.counters.get("players_matched") == 32
        status, text = await get(port, "/healthz")
        prom = await get(port, "/metrics?format=prom")
    finally:
        await app.stop()
    return status, text, prom


def _held_back(cfg):
    return dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, breaker_probe_initial_s=60.0, breaker_probe_max_s=60.0),
        metrics_port=free_port())


def test_healthz_equals_jax_while_the_breaker_demotes():
    port_c, jax_c = (_held_back(c) for c in _storm_cfgs())
    mine = asyncio.run(_degraded(MatchmakingApp(port_c, device="cpu"),
                                 Properties, port_c.metrics_port))
    theirs = asyncio.run(_degraded(JaxApp(jax_c), JaxProperties,
                                   jax_c.metrics_port))
    assert mine[0] == theirs[0] == 200
    assert healthz_shape(mine[1]) == healthz_shape(theirs[1])
    body = json.loads(mine[1])
    assert body["status"] == "degraded"
    assert body["degraded_queues"] == ["mm.chaos"]
    assert body["queues"]["mm.chaos"]["engine"] == "CpuEngine"
    assert body["incidents"]["by_class"] == {"breaker_trip": 1}
    assert prom_differences(prom_shape(mine[2][1]),
                            prom_shape(theirs[2][1])) == PROM_DIFFERENCES


async def _draining(app, props, port):
    """Fetch /healthz from inside the drain (its checkpoint step): the
    server is still up and every queue is draining."""
    app.broker.declare_queue(REPLY)
    await app.start()
    for i, body in enumerate(soak_bodies(seed=9, n=64)):
        app.broker.publish(QUEUE, body, props(reply_to=REPLY,
                                              correlation_id=f"c{i}"))
    await asyncio.sleep(0.3)
    seen = {}
    real_save = app.save_checkpoint

    async def save(directory):
        seen["healthz"] = await get(port, "/healthz")
        return await real_save(directory)

    app.save_checkpoint = save
    directory = app.cfg.overload.drain_checkpoint_dir
    await app.drain(directory)
    with pytest.raises(aiohttp.ClientConnectionError):
        await get(port, "/healthz")
    return seen["healthz"]


def test_healthz_equals_jax_while_draining(tmp_path):
    port_c = dataclasses.replace(
        port_cfg(), metrics_port=free_port(),
        overload=OverloadConfig(drain_checkpoint_dir=str(tmp_path / "p")))
    jax_c = dataclasses.replace(
        jax_cfg(), metrics_port=free_port(),
        overload=JaxOverloadConfig(drain_checkpoint_dir=str(tmp_path / "j")))
    mine = asyncio.run(_draining(MatchmakingApp(port_c, device="cpu"),
                                 Properties, port_c.metrics_port))
    theirs = asyncio.run(_draining(JaxApp(jax_c), JaxProperties,
                                   jax_c.metrics_port))
    assert mine[0] == theirs[0] == 200
    assert healthz_shape(mine[1]) == healthz_shape(theirs[1])
    assert json.loads(mine[1])["status"] == "draining"


# ---- /debug/profile ----------------------------------------------------------

async def test_profile_on_the_cpu_returns_the_jax_keys_and_refuses_a_second(
        tmp_path):
    port = free_port()
    cfg = dataclasses.replace(port_cfg(), metrics_port=port)
    cfg = dataclasses.replace(cfg, observability=dataclasses.replace(
        cfg.observability, profile_dir=str(tmp_path)))
    app = MatchmakingApp(cfg, device="cpu")
    await app.start()
    try:
        first = asyncio.create_task(get(port, "/debug/profile?secs=0.5"))
        for _ in range(200):
            await asyncio.sleep(0.01)
            if app._observability._profiling:
                break
        busy = await get(port, "/debug/profile?secs=0.1")
        status, text = await first
        bad = await get(port, "/debug/profile?secs=soon")
        short = await get(port, "/debug/profile?secs=0")
    finally:
        await app.stop()
    assert busy[0] == 409
    assert json.loads(busy[1]) == {
        "error": "a profile capture is already running"}
    assert status == 200
    body = json.loads(text)
    assert sorted(body) == ["secs", "trace_dir", "viewer"]
    assert body["trace_dir"] == str(tmp_path) and body["secs"] == 0.5
    assert bad == (400, json.dumps({"error": "secs must be a number"}))
    assert short[0] == 200 and json.loads(short[1])["secs"] == 0.05
    traces = sorted(os.listdir(tmp_path))
    assert len(traces) == 2 and traces[0].endswith(".json")
    assert traces[0] in body["viewer"]
    with open(tmp_path / traces[0], encoding="utf-8") as f:
        assert json.load(f)["traceEvents"]


# ---- serve -------------------------------------------------------------------

async def test_serve_answers_healthz_and_draining(tmp_path, monkeypatch):
    port = free_port()
    for k in list(os.environ):
        if k.startswith("MM_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("MM_METRICS_PORT", str(port))
    monkeypatch.setenv("MM_ENGINE_BACKEND", "gpu")
    monkeypatch.setenv("MM_ENGINE_POOL_CAPACITY", "256")
    monkeypatch.setenv("MM_ENGINE_POOL_BLOCK", "64")
    monkeypatch.setenv("MM_ENGINE_BATCH_BUCKETS", "[8, 32]")
    monkeypatch.setenv("MM_OVERLOAD_DRAIN_CHECKPOINT_DIR", str(tmp_path))
    seen = {}
    real_drain = app_module.MatchmakingApp.drain

    async def drain(self, checkpoint_dir=None):
        real_save = self.save_checkpoint

        async def save(directory):
            seen["draining"] = await get(port, "/healthz")
            return await real_save(directory)
        self.save_checkpoint = save
        return await real_drain(self, checkpoint_dir)

    monkeypatch.setattr(app_module.MatchmakingApp, "drain", drain)
    stop = asyncio.Event()
    server = asyncio.create_task(app_module.serve(stop, device="cpu"))
    for _ in range(500):
        await asyncio.sleep(0.01)
        try:
            seen["up"] = await get(port, "/healthz")
            break
        except aiohttp.ClientConnectionError:
            continue
    stop.set()
    await server
    assert seen["up"][0] == 200 and json.loads(seen["up"][1])["status"] == "ok"
    assert json.loads(seen["draining"][1])["status"] == "draining"
    assert observability.web is not None
