"""The socket transport under replication and the lease (net/) in the port
against the JAX package's, on the CPU (marker ``net``).

- The JAX package's ``tests/test_net.py`` scripts run on both packages'
  classes: the frame codec fuzz, the nemesis, the socket link's reset
  convergence, late-standby rebase and backpressure, the remote lease and
  the hub an app builds from ``cfg.net``.
- The wire is the same across packages: frames byte-equal on seeded
  messages, both decoders agree feed by feed on a seeded fuzz corpus, the
  nemesis's action sequences are equal on a grid of scripts and seeds,
  and ``backoff_delay`` is bit-equal.
- The packages interoperate over real UDS sockets, both ways: a primary's
  stream into the other package's standby gives the sender package's own
  shadow, and each lease client works against the other's service.
- The in-process and the socket fabric give the same service round trip
  and failover, apart from the RTO.
- The default send buffer drops a baseline larger than it, in both
  packages, and the stream never rebases; with the limits raised it
  crosses.
- ``/healthz`` and the Prometheus families with a socket hub equal the JAX
  app's, apart from ``REPLICATION_PROM_DIFFERENCES``.
- A 2-cycle cross-process failover soak through ``failover_proc.soak``
  with its children on the CPU meets the JAX soak's gates, and its two
  runs give one takeover-transcript digest.
"""

import asyncio
import base64
import dataclasses
import json
import os
import random
import shutil
import tempfile
import time
from types import SimpleNamespace

import pytest

from matchmaking_tpu import config as jax_config
from matchmaking_tpu.net import lease as jax_lease
from matchmaking_tpu.net import link as jax_link
from matchmaking_tpu.net import nemesis as jax_nemesis
from matchmaking_tpu.net import transport as jax_transport
from matchmaking_tpu.service import replication as jax_repl
from matchmaking_tpu.utils import journal as jax_jr
from matchmaking_tpu_torch import config
from matchmaking_tpu_torch.net import failover_proc
from matchmaking_tpu_torch.net import lease as port_lease
from matchmaking_tpu_torch.net import link as port_link
from matchmaking_tpu_torch.net import nemesis as port_nemesis
from matchmaking_tpu_torch.net import transport as port_transport
from matchmaking_tpu_torch.service import replication as port_repl
from matchmaking_tpu_torch.utils import journal as port_jr
from test_torch_observability import (
    PROM_DIFFERENCES,
    free_port,
    get,
    healthz_shape,
    prom_differences,
    prom_shape,
)
from test_torch_replication import (
    REPLICATION_PROM_DIFFERENCES,
    _app,
    _cfg,
    _collect,
    _counter,
    _jax_prom_shape,
    _publish,
    _quiesce,
    _record,
    _rto_free,
    _stream_normalized,
)
from test_torch_replication import PLAYERS as SERVICE_PLAYERS
from test_torch_replication import Q as SERVICE_Q

pytestmark = pytest.mark.net

PKGS = ("port", "jax")
#: Each package's net modules, replication, journal and config classes.
NS = {
    "port": SimpleNamespace(
        T=port_transport, N=port_nemesis, L=port_link, LS=port_lease,
        R=port_repl, J=port_jr, Chaos=config.ChaosConfig,
        Net=config.NetConfig),
    "jax": SimpleNamespace(
        T=jax_transport, N=jax_nemesis, L=jax_link, LS=jax_lease,
        R=jax_repl, J=jax_jr, Chaos=jax_config.ChaosConfig,
        Net=jax_config.NetConfig),
}
Q = "net.test"
#: Every converge loop's deadline (seconds).
CONVERGE_S = 15.0


@pytest.fixture
def sock_dir():
    """A short directory for UDS paths (at most 108 bytes)."""
    d = tempfile.mkdtemp(prefix="mmn")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _row(pid: str, rating: float = 1500.0) -> list:
    return [pid, rating, 0.0, "", "", None, 1.0, "r.q", pid, 0, 0.0]


def _admit(*pids: str) -> bytes:
    return json.dumps({"rows": [_row(p) for p in pids]}).encode()


def _terminals(*pids: str) -> bytes:
    return json.dumps({"t": [[p, base64.b64encode(
        json.dumps({"status": "matched", "player_id": p}).encode()
    ).decode("ascii"), 4e9] for p in pids]}).encode()


def _converge(deadline_s: float, step, done) -> bool:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        step()
        if done():
            return True
        time.sleep(0.01)
    return done()


# ---- the frame codec fuzz, on both packages ---------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_roundtrip_split_at_every_byte_offset(pkg):
    T = NS[pkg].T
    payloads = [T.pack_msg({"t": "rec", "seq": i, "p": "x" * i})
                for i in range(1, 4)]
    stream = b"".join(T.encode_frame(p) for p in payloads)
    for cut in range(len(stream) + 1):
        dec = T.FrameDecoder()
        got = dec.feed(stream[:cut]) + dec.feed(stream[cut:])
        assert got == payloads, f"split at {cut} corrupted the stream"


@pytest.mark.parametrize("pkg", PKGS)
def test_torn_frame_prefix_yields_nothing(pkg):
    T = NS[pkg].T
    frame = T.encode_frame(T.pack_msg({"t": "rec", "seq": 7}))
    for cut in range(len(frame)):
        assert T.FrameDecoder().feed(frame[:cut]) == []


@pytest.mark.parametrize("pkg", PKGS)
def test_hostile_length_prefix_errors(pkg):
    T = NS[pkg].T
    frame = bytearray(T.encode_frame(T.pack_msg({"t": "hb"}),
                                     max_frame=1 << 20))
    frame[2:6] = (0xFFFFFFFF).to_bytes(4, "little")
    with pytest.raises(T.FrameError):
        T.FrameDecoder(max_frame=1 << 20).feed(bytes(frame))
    with pytest.raises(T.FrameError):
        T.FrameDecoder(max_frame=64).feed(
            T.encode_frame(b"z" * 65, max_frame=1 << 20))
    with pytest.raises(T.FrameError):
        T.encode_frame(b"z" * 65, max_frame=64)


@pytest.mark.parametrize("pkg", PKGS)
def test_corruption_at_every_byte_never_decodes_wrong(pkg):
    T = NS[pkg].T
    payload = T.pack_msg({"t": "rec", "seq": 42, "p": "abcdef"})
    frame = T.encode_frame(payload)
    for i in range(len(frame)):
        mutated = bytearray(frame)
        mutated[i] ^= 0x5A
        try:
            got = T.FrameDecoder().feed(bytes(mutated))
        except T.FrameError:
            continue
        assert all(g == payload for g in got), f"byte {i} decoded wrong"


@pytest.mark.parametrize("pkg", PKGS)
def test_seeded_fuzz_corpus_random_cuts_and_noise(pkg):
    T = NS[pkg].T
    rng = random.Random(0xC0FFEE)
    for _ in range(50):
        payloads = [T.pack_msg({"t": "rec", "seq": i,
                                "p": "q" * rng.randrange(0, 200)})
                    for i in range(rng.randrange(1, 5))]
        stream = b"".join(T.encode_frame(p) for p in payloads)
        dec = T.FrameDecoder()
        got, pos = [], 0
        while pos < len(stream):
            cut = min(len(stream), pos + rng.randrange(1, 64))
            got += dec.feed(stream[pos:cut])
            pos = cut
        assert got == payloads
        noise = bytes(rng.randrange(256) for _ in range(32))
        try:
            assert dec.feed(noise) == []
        except T.FrameError:
            pass


@pytest.mark.parametrize("pkg", PKGS)
def test_interleaved_heartbeats_decode_clean(pkg):
    T = NS[pkg].T
    recs = [T.pack_msg({"t": "rec", "seq": i}) for i in range(3)]
    hb = T.pack_msg({"t": "hb"})
    for at in range(len(recs) + 1):
        seq = recs[:at] + [hb] + recs[at:]
        stream = b"".join(T.encode_frame(p) for p in seq)
        dec = T.FrameDecoder()
        out = []
        for i in range(0, len(stream), 7):
            out += dec.feed(stream[i:i + 7])
        assert out == seq
        kinds = [T.unpack_msg(p)["t"] for p in out]
        assert kinds.count("hb") == 1 and kinds.count("rec") == 3


# ---- the nemesis, on both packages ------------------------------------------


def _chaos(pkg, **kw):
    return NS[pkg].Chaos(seed=kw.pop("seed", 9), queues=(Q,), **kw)


def _flow(pkg, chaos, flow=f"repl:{Q}:fwd", seed=9):
    return NS[pkg].N.NetNemesis(chaos, seed).flow(flow, lambda k, n=1: None)


def _script(nem, seqs) -> list:
    return [(s, nem.transmit(s, b"f%d" % s)) for s in seqs]


@pytest.mark.parametrize("pkg", PKGS)
def test_nemesis_bit_identical_replay(pkg):
    chaos = _chaos(pkg, net_drop_frames=(("fwd", 2),),
                   net_dup_frames=(("fwd", 3),),
                   net_delay_frames=(("fwd", 4, 2),),
                   net_reset_frames=(("fwd", 6),))
    seqs = [1, 2, 3, 4, 5, 6, 7, 2, 6]
    assert _script(_flow(pkg, chaos), seqs) == _script(_flow(pkg, chaos),
                                                       seqs)


@pytest.mark.parametrize("pkg", PKGS)
def test_nemesis_first_transmission_only(pkg):
    nem = _flow(pkg, _chaos(pkg, net_drop_frames=(("fwd", 2),)))
    assert nem.transmit(2, b"a") == []
    assert nem.transmit(2, b"a") == [("send", b"a")]


@pytest.mark.parametrize("pkg", PKGS)
def test_nemesis_reset_consumes_frame(pkg):
    nem = _flow(pkg, _chaos(pkg, net_reset_frames=(("fwd", 3),)))
    assert nem.transmit(3, b"a") == [("reset",)]
    assert nem.transmit(3, b"a") == [("send", b"a")]


@pytest.mark.parametrize("pkg", PKGS)
def test_nemesis_partition_holds_then_flushes_in_order(pkg):
    nem = _flow(pkg, _chaos(pkg, net_partitions=(("fwd", 3, 5),)))
    assert nem.transmit(1, b"f1") == [("send", b"f1")]
    assert nem.transmit(3, b"f3") == []
    assert nem.transmit(4, b"f4") == []
    assert nem.transmit(5, b"f5") == [
        ("send", b"f3"), ("send", b"f4"), ("send", b"f5")]


@pytest.mark.parametrize("pkg", PKGS)
def test_nemesis_flow_substring_match_and_deafness(pkg):
    nn = NS[pkg].N.NetNemesis(
        _chaos(pkg, net_drop_frames=(("repl:other", 1),)), 9)
    assert nn.flow(f"repl:{Q}:fwd", lambda k, n=1: None) is None
    deaf = nn.rx_deaf(f"repl:{Q}:ack")
    assert not deaf()
    nn.deafen(f"repl:{Q}:ack")
    assert deaf()
    assert not nn.rx_deaf("lease:p1")()
    nn.undeafen()
    assert not deaf()


@pytest.mark.parametrize("pkg", PKGS)
def test_backoff_seeded_jitter_deterministic_and_capped(pkg):
    backoff = NS[pkg].T.backoff_delay
    a = backoff(7, "conn", 3, 0.02, 1.0)
    assert a == backoff(7, "conn", 3, 0.02, 1.0)
    assert a != backoff(7, "conn", 4, 0.02, 1.0)
    for attempt in range(40):
        assert 0.0 < backoff(7, "conn", attempt, 0.02, 1.0) <= 1.0


# ---- the socket link over UDS, on both packages ------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_socket_stream_converges_after_scripted_reset(pkg, sock_dir):
    """``QueueReplication`` and ``StandbyApplier`` unchanged over the
    socket halves: a scripted mid-stream reset tears the connection, and
    the redial and the tail's retransmission converge with no gap and no
    record applied twice; a takeover fences the ex-primary over the
    wire."""
    P = NS[pkg]
    hub = P.L.SocketReplicationHub(
        chaos=_chaos(pkg, net_reset_frames=((f"repl:{Q}:fwd", 3),)),
        seed=9, base_dir=sock_dir, lease_s=60.0)
    try:
        ep = hub.authority.acquire(Q, "p1", time.monotonic())
        sap = hub.standby(Q, owner="s1")
        repl = P.R.QueueReplication(Q, "p1", ep, hub.authority, hub.link(Q))
        pids = ["a", "b", "c", "d", "e"]
        for seq, pid in enumerate(pids, start=1):
            repl.on_record(seq, P.J.RT_ADMIT, _admit(pid))

        def step():
            repl.pump(time.monotonic())
            sap.pump()

        assert _converge(CONVERGE_S, step, lambda: repl.quiescent and
                         sap.applied_seq == len(pids))
        assert sorted(sap.shadow.waiting) == pids
        assert hub.link(Q).counters["nemesis_resets"] == 1
        assert sap.counters["applied"] == len(pids)
        assert repl.may_publish()
        sap.takeover(time.monotonic() + 61.0)
        assert not repl.may_publish()
        assert repl.role == "fenced"
        assert not repl.may_write()
    finally:
        hub.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_socket_baseline_replay_rebases_late_standby(pkg, sock_dir):
    P = NS[pkg]
    hub = P.L.SocketReplicationHub(seed=9, base_dir=sock_dir, lease_s=60.0)
    try:
        ep = hub.authority.acquire(Q, "p1", time.monotonic())
        repl = P.R.QueueReplication(Q, "p1", ep, hub.authority, hub.link(Q))
        repl.send_baseline(1, json.dumps({"rows": [_row("base")],
                                          "recent": []}).encode())
        repl.on_record(2, P.J.RT_ADMIT, _admit("tail"))
        sap = hub.standby(Q, owner="s1")  # attaches late

        def step():
            repl.pump(time.monotonic())
            sap.pump()

        assert _converge(CONVERGE_S, step, lambda: sap.applied_seq >= 2)
        assert sorted(sap.shadow.waiting) == ["base", "tail"]
    finally:
        hub.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_socket_backpressure_drops_and_counts(pkg, sock_dir):
    P = NS[pkg]
    hub = P.L.SocketReplicationHub(
        net=P.Net(transport="socket", send_buffer_bytes=64), seed=9,
        base_dir=sock_dir, lease_s=60.0)
    try:
        lk = hub.link(Q)
        for seq in range(1, 20):
            lk.send(seq, P.J.RT_ADMIT, b"z" * 200)
        assert lk.counters["backpressure_dropped"] == 19
        assert lk.counters["sent"] == 19
    finally:
        hub.close()


def test_a_retransmission_written_on_the_live_connection_is_elided(sock_dir):
    """The port's link writes a seq once per connection: a retransmission
    of a seq already written on the live connection is elided (counted
    ``retransmits_elided``), while a reconnect clears the set and the seq
    is written again. The JAX package's link writes every retransmission
    (the difference is pinned here)."""
    got = {}
    for pkg in PKGS:
        P = NS[pkg]
        listen = f"unix:{sock_dir}/{pkg}.sock"
        slink = P.L.SocketStandbyLink(Q, listen)
        link = P.L.SocketReplicationLink(Q, listen, seed=9)
        try:
            assert _converge(CONVERGE_S, lambda: None,
                             lambda: link._client.conn is not None)
            rx = []
            link.send(1, P.J.RT_ADMIT, _admit("a"))
            assert _converge(CONVERGE_S, lambda: rx.extend(slink.recv()),
                             lambda: len(rx) == 1)
            link.send(1, P.J.RT_ADMIT, _admit("a"))  # a retransmission
            link.send(2, P.J.RT_ADMIT, _admit("b"))
            assert _converge(CONVERGE_S, lambda: rx.extend(slink.recv()),
                             lambda: rx and rx[-1][0] == 2)
            seqs_live = [r[0] for r in rx]
            conn = link._client.conn
            P.T.run_io(conn.close("test"), timeout=5.0)
            assert _converge(CONVERGE_S, lambda: None, lambda: (
                link._client.conn is not None
                and link._client.conn is not conn))
            link.send(1, P.J.RT_ADMIT, _admit("a"))
            assert _converge(CONVERGE_S, lambda: rx.extend(slink.recv()),
                             lambda: rx[-1][0] == 1)
            got[pkg] = (seqs_live, link.counters["retransmits_elided"],
                        link.counters["reconnects"])
        finally:
            link.close()
            slink.close()
    assert got["port"] == ([1, 2], 1, 1)
    assert got["jax"] == ([1, 1, 2], 0, 1)


# ---- the remote lease, on both packages -------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_remote_lease_acquire_renew_held_takeover(pkg, sock_dir):
    P = NS[pkg]
    hub = P.L.SocketReplicationHub(seed=9, base_dir=sock_dir, lease_s=0.5)
    try:
        auth = hub.authority
        ep = auth.acquire(Q, "p1", time.monotonic())
        assert ep == 1
        assert auth.renew(Q, "p1", ep, time.monotonic())
        with pytest.raises(P.R.LeaseHeldError):
            auth.acquire(Q, "p2", time.monotonic())
        with pytest.raises(P.R.LeaseHeldError):
            auth.takeover(Q, "p2", time.monotonic())
        ep2 = auth.takeover(Q, "p2", time.monotonic() + 1.0)
        assert ep2 == 2
        assert not auth.is_current(Q, "p1", ep)
        assert auth.is_current(Q, "p2", ep2)
        assert auth.epoch_of(Q) == 2
    finally:
        hub.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_renewal_in_flight_at_expiry_does_not_count(pkg, sock_dir):
    """A renewal still in flight when the budgeted deadline passes does
    not count: the client fences, and only a confirmed blocking renewal
    (once the authority is reachable and the epoch unsuperseded) makes it
    current again."""
    hub = NS[pkg].L.SocketReplicationHub(seed=9, base_dir=sock_dir,
                                         lease_s=0.6)
    try:
        auth = hub.authority
        ep = auth.acquire(Q, "p1", time.monotonic())
        assert auth.is_current(Q, "p1", ep)
        hub.nemesis.deafen("lease:")
        assert auth.renew(Q, "p1", ep, time.monotonic())
        time.sleep(0.7)
        assert not auth.is_current(Q, "p1", ep)
        assert not auth.renew(Q, "p1", ep, time.monotonic())
        hub.nemesis.undeafen()
        assert auth.renew(Q, "p1", ep, time.monotonic())
        assert auth.is_current(Q, "p1", ep)
    finally:
        hub.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_confirmed_renewal_extends_validity(pkg, sock_dir):
    hub = NS[pkg].L.SocketReplicationHub(seed=9, base_dir=sock_dir,
                                         lease_s=0.6)
    try:
        auth = hub.authority
        ep = auth.acquire(Q, "p1", time.monotonic())
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            assert auth.renew(Q, "p1", ep, time.monotonic())
            time.sleep(0.05)
        assert auth.is_current(Q, "p1", ep)
    finally:
        hub.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_scripted_renewal_fault_does_not_self_fence(pkg, sock_dir):
    P = NS[pkg]
    hub = P.L.SocketReplicationHub(
        seed=9, base_dir=sock_dir, lease_s=0.6,
        chaos=P.Chaos(seed=9, queues=(Q,), repl_fail_renewals=(0,)))
    try:
        auth = hub.authority
        ep = auth.acquire(Q, "p1", time.monotonic())
        assert auth.renew(Q, "p1", ep, time.monotonic())
        time.sleep(0.7)
        assert not auth.is_current(Q, "p1", ep)
        assert auth.renew(Q, "p1", ep, time.monotonic())
        assert auth.is_current(Q, "p1", ep)
    finally:
        hub.close()


# ---- the hub an app builds from cfg.net, on both packages -------------------


def _net_app_cfg(pkg, sock_dir, lease_addr):
    C = jax_config if pkg == "jax" else config
    return C.Config(
        queues=(C.QueueConfig(name=Q, rating_threshold=50.0),),
        engine=C.EngineConfig(backend="tpu" if pkg == "jax" else "gpu",
                              pool_capacity=256, pool_block=64,
                              batch_buckets=(8, 32), top_k=4),
        batcher=C.BatcherConfig(max_batch=8, max_wait_ms=5.0),
        durability=C.DurabilityConfig(journal_dir=f"{sock_dir}/j",
                                      fsync="window"),
        replication=C.ReplicationConfig(role="primary", owner="hostA"),
        net=C.NetConfig(transport="socket", lease_addr=lease_addr,
                        repl_target=f"unix:{sock_dir}/deadend.sock"))


@pytest.mark.parametrize("pkg", PKGS)
async def test_app_auto_builds_and_closes_socket_hub(pkg, sock_dir):
    """``cfg.net`` names the fabric: the app builds and owns its
    ``SocketReplicationHub`` (the stream goes to the configured target,
    the lease rides the remote client), and ``stop`` closes it."""
    from matchmaking_tpu.service.app import MatchmakingApp as JaxApp
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    lease_addr = f"unix:{sock_dir}/lease.sock"
    svc = NS[pkg].LS.LeaseService(lease_addr, lease_s=60.0)
    svc.start()
    cfg = _net_app_cfg(pkg, sock_dir, lease_addr)
    app = JaxApp(cfg) if pkg == "jax" else MatchmakingApp(cfg, device="cpu")
    try:
        await app.start()
        hub = app.replication_hub
        assert hub is not None and app._owns_net_hub
        assert isinstance(hub, NS[pkg].L.SocketReplicationHub)
        repl = app.runtime(Q).replication
        assert repl is not None and repl.role == "primary"
        assert repl.epoch == 1
        await app.stop()
        assert app.replication_hub is None
    finally:
        if app.replication_hub is not None:
            await app.crash()
        svc.close()


async def test_crash_and_drain_close_the_owned_hub(sock_dir):
    """``crash`` and ``drain`` close an owned hub as ``stop`` does; a hub
    passed in stays open."""
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    lease_addr = f"unix:{sock_dir}/lease.sock"
    svc = port_lease.LeaseService(lease_addr, lease_s=60.0)
    svc.start()
    try:
        cfg = _net_app_cfg("port", sock_dir, lease_addr)
        for end in ("crash", "drain"):
            app = MatchmakingApp(dataclasses.replace(
                cfg, durability=config.DurabilityConfig(
                    journal_dir=f"{sock_dir}/{end}", fsync="window")),
                device="cpu")
            await app.start()
            hub = app.replication_hub
            assert app._owns_net_hub
            await getattr(app, end)()
            assert app.replication_hub is None and not app._owns_net_hub
            assert hub.authority._conn._closed
        passed = port_link.SocketReplicationHub(
            net=cfg.net, seed=0, owner="hostA")
        app = MatchmakingApp(dataclasses.replace(
            cfg, durability=config.DurabilityConfig(
                journal_dir=f"{sock_dir}/passed", fsync="window")),
            device="cpu", replication_hub=passed)
        await app.start()
        await app.stop()
        assert app.replication_hub is passed and not app._owns_net_hub
        assert not passed.authority._conn._closed
        passed.close()
    finally:
        svc.close()


async def test_app_with_socket_transport_refuses_no_lease_service(sock_dir):
    """A socket that cannot be reached raises: the lease acquire at start
    times out (no answer is no grant), and nothing drops back to an
    in-process hub."""
    from matchmaking_tpu_torch.service.app import MatchmakingApp

    cfg = _net_app_cfg("port", sock_dir, f"unix:{sock_dir}/nobody.sock")
    app = MatchmakingApp(cfg, device="cpu")
    with pytest.raises(TimeoutError, match="no answer is not a grant"):
        await app.start()
    assert app._owns_net_hub
    await app.crash()
    assert app.replication_hub is None
    tcp = MatchmakingApp(dataclasses.replace(
        cfg, net=config.NetConfig(transport="tcp")), device="cpu")
    with pytest.raises(ValueError, match="unknown net transport"):
        await tcp.start()
    assert tcp.replication_hub is None


# ---- the wire is the same across packages -------------------------------------


def _messages(seed: int, n: int) -> list[dict]:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind = rng.choice(["rec", "ack", "hb", "lr", "lr.r"])
        m = {"t": kind}
        if kind == "rec":
            m.update(q=rng.choice([Q, "matchmaking.search", "q é"]),
                     seq=rng.randrange(1 << 40), rt=rng.choice([1, 2, 5, 100]),
                     p=base64.b64encode(rng.randbytes(rng.randrange(300))
                                        ).decode("ascii"))
        elif kind == "ack":
            m.update(q=Q, seq=rng.randrange(1 << 31))
        elif kind in ("lr", "lr.r"):
            m.update(rid=i, op=rng.choice(["acquire", "renew", "takeover"]),
                     now=rng.random() * 1e6, ok=rng.random() < 0.5,
                     owner="höst" + str(rng.randrange(9)),
                     lease_s=rng.choice([0.5, 2.0, 60.0]), epoch=None)
        out.append(m)
    return out


def test_frames_are_byte_equal_across_packages():
    for m in _messages(14, 400):
        mine = port_transport.encode_frame(port_transport.pack_msg(m))
        theirs = jax_transport.encode_frame(jax_transport.pack_msg(m))
        assert mine == theirs, m
        assert port_transport.unpack_msg(mine[port_transport.HEADER_LEN:]) \
            == jax_transport.unpack_msg(theirs[jax_transport.HEADER_LEN:])


def _decode_trace(T, chunks, max_frame):
    dec, out = T.FrameDecoder(max_frame), []
    for i, c in enumerate(chunks):
        try:
            out.append(dec.feed(c))
        except T.FrameError:
            out.append(("error", i))
            break
    return out


def test_decoders_agree_feed_by_feed_on_the_fuzz_corpus():
    """Seeded streams (valid frames, then a flipped byte, a hostile length
    or garbage, cut at random points): both decoders hand back the same
    payloads at every feed, or raise ``FrameError`` at the same feed."""
    rng = random.Random(0xC0FFEE)
    errors = 0
    for trial in range(300):
        msgs = _messages(trial, rng.randrange(1, 6))
        stream = bytearray(b"".join(
            jax_transport.encode_frame(jax_transport.pack_msg(m))
            for m in msgs))
        damage = trial % 4
        if damage == 1:
            i = rng.randrange(len(stream))
            stream[i] ^= 1 << rng.randrange(8)
        elif damage == 2:
            stream += (0x4D4E).to_bytes(2, "little") + rng.randbytes(8)
        elif damage == 3:
            stream += rng.randbytes(rng.randrange(1, 40))
        chunks, pos = [], 0
        while pos < len(stream):
            cut = min(len(stream), pos + rng.randrange(1, 96))
            chunks.append(bytes(stream[pos:cut]))
            pos = cut
        max_frame = rng.choice([1 << 20, 256])
        mine = _decode_trace(port_transport, chunks, max_frame)
        assert mine == _decode_trace(jax_transport, chunks, max_frame), trial
        errors += bool(mine and isinstance(mine[-1], tuple))
    assert errors > 50


#: Fault scripts (flows by substring) for the nemesis grid.
NEMESIS_SCRIPTS = [
    dict(net_drop_frames=(("fwd", 2), ("ack", 1))),
    dict(net_dup_frames=(("fwd", 3),), net_delay_frames=(("fwd", 4, 2),)),
    dict(net_reset_frames=(("fwd", 6),), net_partitions=(("fwd", 8, 12),)),
    dict(net_drop_frames=(("fwd", 2),), net_dup_frames=(("fwd", 3),),
         net_delay_frames=(("fwd", 4, 2), ("fwd", 9, 5)),
         net_reset_frames=(("fwd", 6),), net_partitions=(("fwd", 11, 15),)),
    dict(net_drop_prob=0.2),
    dict(net_drop_prob=0.05, net_delay_frames=(("repl", 5, 1),),
         net_bandwidth_caps=(("fwd", 1 << 20),)),
    dict(net_deaf_flows=("lease:",)),
]


@pytest.mark.parametrize("script", range(len(NEMESIS_SCRIPTS)))
def test_nemesis_actions_equal_across_packages(script):
    """On every flow, seed and transmission sequence (first transmissions
    and retransmissions mixed), both pipelines return the same actions and
    count the same faults, ``net_drop_prob`` through ``hash01`` included."""
    kw = NEMESIS_SCRIPTS[script]
    for seed in (0, 9, 29, 1234567):
        for flow in (f"repl:{Q}:fwd", f"repl:{Q}:ack", "lease:hostA"):
            rng = random.Random(seed * 31 + script)
            seqs = []
            for s in range(1, 41):
                seqs.append(s)
                if rng.random() < 0.3:
                    seqs.append(rng.randrange(1, s + 1))
            got = {}
            for pkg in PKGS:
                counts = {}
                nem = NS[pkg].N.NetNemesis(
                    NS[pkg].Chaos(seed=seed, queues=(Q,), **kw), seed).flow(
                        flow, lambda k, n=1, c=counts: c.__setitem__(
                            k, c.get(k, 0) + n))
                if nem is None:
                    got[pkg] = None
                    continue
                trace = [nem.transmit(s, b"f%d" % s) for s in seqs]
                got[pkg] = (trace, counts, nem.bandwidth_bps)
            assert got["port"] == got["jax"], (seed, flow)


def test_backoff_is_bit_equal_across_packages():
    rng = random.Random(5)
    for _ in range(2000):
        args = (rng.randrange(1 << 40), rng.choice(["lease:a", "repl:q:fwd",
                                                    "x" * rng.randrange(30)]),
                rng.randrange(-2, 40), rng.choice([0.02, 0.1, 0.5]),
                rng.choice([1.0, 0.3, 5.0]))
        assert (port_transport.backoff_delay(*args).hex()
                == jax_transport.backoff_delay(*args).hex()), args


# ---- the two packages interoperate over real sockets ---------------------------


def _stream_script(P):
    """A stream: a baseline, admits, terminals, an admission checkpoint and
    the clean marker, as (seq, type, payload)."""
    out = [(1, P.R.RT_REPL_SNAPSHOT, P.R.baseline_payload(
        [_row(f"b{i}", 1000.0 + i) for i in range(20)],
        [("old", b'{"status":"matched"}', 4e9)], {"credits": 3}))]
    for k in range(24):
        out.append((len(out) + 1, P.J.RT_ADMIT, _admit(f"a{k}", f"c{k}")))
        if k % 5 == 4:
            out.append((len(out) + 1, P.J.RT_TERMINALS,
                        _terminals(f"a{k}", "b3")))
    out.append((len(out) + 1, P.J.RT_ADMISSION, json.dumps({"k": 1}).encode()))
    out.append((len(out) + 1, P.J.RT_CLEAN, b""))
    return out


def _stream_across(sender, receiver, sock_dir, tag):
    """``sender``'s QueueReplication over its SocketReplicationLink (a
    scripted reset on the fwd flow) into ``receiver``'s SocketStandbyLink
    and StandbyApplier; returns the applier's shadow."""
    S, R = NS[sender], NS[receiver]
    listen = f"unix:{sock_dir}/{tag}.sock"
    slink = R.L.SocketStandbyLink(Q, listen)
    applier = R.R.StandbyApplier(Q, slink)
    auth = S.R.LeaseAuthority(lease_s=60.0)
    link = S.L.SocketReplicationLink(
        Q, listen, seed=9, nemesis=S.N.NetNemesis(S.Chaos(
            seed=9, net_reset_frames=((f"repl:{Q}:fwd", 4),)), 9))
    try:
        # Connected before the first record: the scripted reset then tears
        # a live connection.
        assert _converge(CONVERGE_S, lambda: None,
                         lambda: link._client.conn is not None)
        repl = S.R.QueueReplication(Q, "p", auth.acquire(Q, "p", 0.0), auth,
                                    link)
        for seq, rtype, payload in _stream_script(S):
            if rtype == S.R.RT_REPL_SNAPSHOT:
                repl.send_baseline(seq, payload)
            else:
                repl.on_record(seq, rtype, payload)

        def step():
            applier.pump()
            repl.pump(time.monotonic())

        assert _converge(CONVERGE_S, step, lambda: repl.quiescent)
        applier.pump()
        sh = applier.shadow
        return (applier.applied_seq, sh.transcript(), sh.recent, sh.waiting,
                sh.admission, sh.last_seq, sh.clean,
                applier.counters["applied"] >= applier.applied_seq - 1,
                link.counters["nemesis_resets"],
                link.counters["reconnects"] >= 1)
    finally:
        link.close()
        slink.close()


@pytest.mark.parametrize("sender,receiver", [("jax", "port"),
                                             ("port", "jax")])
def test_a_primary_streams_into_the_other_packages_standby(sender, receiver,
                                                           sock_dir):
    """A primary of one package streams over a real UDS socket into the
    other package's standby, through a scripted reset: the standby's
    shadow is the one the sender's own standby gets."""
    got = _stream_across(sender, receiver, sock_dir, "x")
    want = _stream_across(sender, sender, sock_dir, "y")
    assert got == want
    assert got[3] and got[6] is True and got[7] and got[8] == 1 and got[9]


def _lease_transcript(client_pkg, service_pkg, sock_dir, tag):
    addr = f"unix:{sock_dir}/{tag}.sock"
    svc = NS[service_pkg].LS.LeaseService(addr, lease_s=0.5,
                                          trust_caller_now=True)
    svc.start()
    auth = NS[client_pkg].LS.RemoteLeaseAuthority(addr, seed=3, client="c")
    out = []

    def attempt(fn, *a):
        try:
            out.append(fn(*a))
        except NS[client_pkg].R.LeaseHeldError:
            out.append("held")

    try:
        t = time.monotonic()
        attempt(auth.acquire, Q, "p1", t)
        out.append(auth.renew(Q, "p1", 1, time.monotonic()))
        attempt(auth.acquire, Q, "p2", time.monotonic())
        attempt(auth.takeover, Q, "p2", time.monotonic())
        out.append(auth.expired(Q, time.monotonic()))
        out.append(auth.expired(Q, time.monotonic() + 1.0))
        attempt(auth.takeover, Q, "p2", time.monotonic() + 1.0)
        attempt(auth.takeover, Q, "p2", time.monotonic() + 1.0)  # a retry
        out.append((auth.is_current(Q, "p1", 1), auth.is_current(Q, "p2", 2),
                    auth.epoch_of(Q)))
        out.append(auth.renew(Q, "p1", 1, time.monotonic() + 5.0))
        auth.release(Q, "p2", 2, time.monotonic() + 1.0)
        out.append(auth.expired(Q, time.monotonic() + 1.0))
        attempt(auth.takeover, Q, "p3", time.monotonic() + 1.0)
        attempt(auth.acquire, "other", "p1", time.monotonic())
        out.append(svc.authority.epoch_of(Q))
        return out
    finally:
        auth.close()
        svc.close()


@pytest.mark.parametrize("client,service", [("port", "jax"), ("jax", "port")])
def test_a_lease_client_works_against_the_other_packages_service(
        client, service, sock_dir):
    got = _lease_transcript(client, service, sock_dir, "x")
    assert got == _lease_transcript(client, client, sock_dir, "y")
    assert got == _lease_transcript(service, service, sock_dir, "z")
    assert got[:4] == [1, True, "held", "held"]
    assert got[6:8] == [2, 2] and got[8] == (False, True, 2)


# ---- the in-process fabric equals the socket fabric ----------------------------


def _port_hub(fabric, sock_dir, lease_s):
    if fabric == "socket":
        return port_link.SocketReplicationHub(lease_s=lease_s,
                                              base_dir=sock_dir)
    return port_repl.ReplicationHub(lease_s=lease_s)


async def _roundtrip_on(fabric, tmp, sock_dir):
    hub = _port_hub(fabric, sock_dir, 60.0)
    sent = _record(hub)
    app = _app("port", _cfg("port", tmp / f"{fabric}.j1"), hub)
    await app.start()
    rt = app.runtime(SERVICE_Q)
    standby = hub.standby(SERVICE_Q)
    stopped = False
    try:
        replies: dict = {}
        _collect(app, "repl.replies", replies)
        for pid, rating in SERVICE_PLAYERS:
            _publish("port", app, pid, rating, "repl.replies")
        assert await _quiesce("port", app, rt, matched=4, standby=standby)
        standby.pump()
        out = {
            "waiting": sorted(standby.shadow.waiting),
            "recent": sorted(standby.shadow.recent),
            "applied": standby.applied_seq, "journal_seq": rt.journal.seq,
            "quiescent": rt.replication.quiescent,
            "gauges": (app.metrics.gauges.get(
                f"replication_lag[{SERVICE_Q}]"), app.metrics.gauges.get(
                f"replication_epoch[{SERVICE_Q}]")),
            "events": [e["kind"] for e in app.events.snapshot()
                       if e.get("component") == "replication"],
            "replies": {p: [json.loads(b)["status"] for b in bodies]
                        for p, bodies in sorted(replies.items())},
        }
        await app.stop()
        stopped = True
        end = time.monotonic() + CONVERGE_S
        while not standby.shadow.clean and time.monotonic() < end:
            standby.pump()
            await asyncio.sleep(0.01)
        out["clean"] = standby.shadow.clean
        out["released"] = hub.authority.expired(SERVICE_Q, time.monotonic())
        out["stream"] = _stream_normalized(sent, port_jr.RT_TERMINALS)
        out["link_errors"] = rt.replication.send_errors
        return out
    finally:
        if not stopped:
            await app.stop()
        if fabric == "socket":
            hub.close()


async def _failover_on(fabric, tmp, sock_dir):
    """The failover script of the in-process tests on either fabric, with
    a lease of 60 s and a scripted takeover time past it."""
    hub = _port_hub(fabric, sock_dir, 60.0)
    app = _app("port", _cfg("port", tmp / f"{fabric}.f1", owner="hostA"),
               hub)
    await app.start()
    rt = app.runtime(SERVICE_Q)
    standby = hub.standby(SERVICE_Q, owner="hostB")
    before: dict = {}
    _collect(app, "fo.replies", before)
    try:
        for pid, rating in (("p0", 1500.0), ("p1", 1501.0), ("s0", 4000.0)):
            _publish("port", app, pid, rating, "fo.replies")
        assert await _quiesce("port", app, rt, matched=2, standby=standby)
        await app.crash()
        out = {"epoch": standby.takeover(time.monotonic() + 60.0 + 0.05),
               "superseded": rt.replication.superseded()}
        handoff = dict(hub.adopted[SERVICE_Q])
        with pytest.raises(port_jr.FencedError):
            rt.journal.append_admits([_row("zz")])
        refused = _counter(app, "fenced_publish_refused")
        rt._publish("fo.replies", "zz", b"{}")
        out["refused"] = _counter(app, "fenced_publish_refused") - refused
        out["role"] = rt.replication.role
        if fabric == "socket":
            hub.cycle_reset(SERVICE_Q)  # a new host generation
        app2 = _app("port", _cfg("port", tmp / f"{fabric}.f2",
                                 owner="hostB"), hub)
        await app2.start()
        rt2 = app2.runtime(SERVICE_Q)
        try:
            out["waiting"] = sorted(r.id for r in rt2.engine.waiting())
            out["rto"] = app2.metrics.gauges.get(
                f"failover_rto_ms[{SERVICE_Q}]")
            out["takeovers"] = _counter(app2, "failover_takeovers")
            rec = rt2.last_recovery
            out["recovery"] = {k: rec[k] for k in (
                "source", "epoch", "tail_players", "snapshot_players",
                "dedup_entries", "transcript")}
            out["events"] = [(e["kind"], e.get("detail", ""))
                             for e in app2.events.snapshot()
                             if e["kind"] in ("lease_expired", "epoch_bump",
                                              "replay_window",
                                              "failover_takeover",
                                              "replication_attached")]
            after: dict = {}
            _collect(app2, "fo.again", after)
            _publish("port", app2, "p0", 1500.0, "fo.again")
            assert await _quiesce("port", app2, rt2, replication=False)
            out["replayed_equal"] = after["p0"] == [
                b for b in before["p0"]
                if json.loads(b)["status"] == "matched"]
            body = json.loads(after["p0"][0])
            body["match"].pop("match_id")
            for key in ("latency_ms", "waited_ms", "trace_id"):
                body.pop(key, None)
            out["replayed"] = body
        finally:
            await app2.stop()
        out["handoff"] = (handoff["epoch"], handoff["owner"],
                          handoff["applied_seq"],
                          handoff["state"].transcript())
        return out
    finally:
        if fabric == "socket":
            hub.close()


@pytest.fixture(scope="module")
def fabrics(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fabric")
    out = {}
    for fabric in ("inproc", "socket"):
        d = tempfile.mkdtemp(prefix="mmn")
        try:
            out[fabric] = (asyncio.run(_roundtrip_on(fabric, tmp, d)),
                           asyncio.run(_failover_on(fabric, tmp, d)))
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return out


def test_inproc_and_socket_fabrics_give_the_same_round_trip(fabrics):
    mine, theirs = fabrics["socket"][0], fabrics["inproc"][0]
    assert mine == theirs
    assert mine["waiting"] == ["s0"] and mine["clean"] and mine["released"]
    assert mine["applied"] == mine["journal_seq"] and mine["quiescent"]


def test_inproc_and_socket_fabrics_give_the_same_failover(fabrics):
    mine, theirs = fabrics["socket"][1], fabrics["inproc"][1]
    assert mine["rto"] > 0 and theirs["rto"] > 0
    for key in ("epoch", "superseded", "refused", "role", "waiting",
                "takeovers", "recovery", "replayed", "replayed_equal",
                "handoff"):
        assert mine[key] == theirs[key], key
    assert _rto_free(mine["events"]) == _rto_free(theirs["events"])
    assert mine["epoch"] == 2 and mine["refused"] == 1
    assert mine["waiting"] == ["s0"] and mine["replayed_equal"]


# ---- the default send buffer and a large baseline ------------------------------


def _subdir(parent, name):
    d = os.path.join(parent, name)
    os.makedirs(d, exist_ok=True)
    return d


def _big_baseline(P, n):
    rows = [_row(f"player-{i:07d}", 1000.0 + (i % 997)) for i in range(n)]
    return P.R.baseline_payload(rows, [], None)


def test_a_baseline_past_the_default_send_buffer_never_crosses(sock_dir):
    """A baseline larger than ``send_buffer_bytes`` (4 MiB by default) is
    dropped and counted the same by both packages: the records after it
    arrive, wait behind the gap and are never acked, and each
    retransmission of the baseline is dropped again."""
    got = {}
    for pkg in PKGS:
        P = NS[pkg]
        net = P.Net(transport="socket")
        hub = P.L.SocketReplicationHub(net=net, seed=9, lease_s=60.0,
                                       base_dir=_subdir(sock_dir, pkg))
        try:
            base = _big_baseline(P, 64_000)
            assert len(base) > net.send_buffer_bytes
            ep = hub.authority.acquire(Q, "p1", time.monotonic())
            sap = hub.standby(Q, owner="s1")
            link = hub.link(Q)
            assert _converge(CONVERGE_S, lambda: None,
                             lambda: link._client.conn is not None)
            repl = P.R.QueueReplication(Q, "p1", ep, hub.authority, link)
            repl.send_baseline(1, base)
            for seq in range(2, 6):
                repl.on_record(seq, P.J.RT_ADMIT, _admit(f"t{seq}"))
            assert _converge(CONVERGE_S, sap.pump,
                             lambda: sap.counters["buffered"] == 4)
            first = (dict(link.counters)["sent"],
                     dict(link.counters)["backpressure_dropped"],
                     sap.applied_seq, dict(sap.counters))
            for _ in range(20):  # the pump retransmits; it never fits
                repl.pump(time.monotonic())
                sap.pump()
                time.sleep(0.01)
            got[pkg] = (first, sap.applied_seq, repl.acked_seq,
                        len(sap.shadow.waiting),
                        link.counters["backpressure_dropped"] > 1,
                        link.counters.get("send_errors", 0))
        finally:
            hub.close()
    assert got["port"] == got["jax"]
    assert got["port"] == ((5, 1, 0, {"buffered": 4}), 0, 0, 0, True, 0)


@pytest.mark.parametrize("base_seq", [0, 1])
def test_a_baseline_crosses_with_the_limits_raised(sock_dir, base_seq):
    """With ``max_frame_bytes`` and ``send_buffer_bytes`` raised on both
    sides (32 MiB), the same baseline crosses and the standby rebases
    onto it. At seq 0 (a recovered journal's baseline: not kept in the
    unacked tail) in both packages, equally; at seq 1 (kept, and re-sent
    every two stalled pumps) in the port, whose link writes it once per
    connection: JAX's re-encodes and re-sends every copy, which a loaded
    host may never get through (ROADMAP Queue 3)."""
    got = {}
    for pkg in (PKGS if base_seq == 0 else ("port",)):
        P = NS[pkg]
        net = P.Net(transport="socket", max_frame_bytes=32 << 20,
                    send_buffer_bytes=32 << 20)
        hub = P.L.SocketReplicationHub(net=net, seed=9, lease_s=60.0,
                                       base_dir=_subdir(sock_dir, pkg))
        try:
            ep = hub.authority.acquire(Q, "p1", time.monotonic())
            sap = hub.standby(Q, owner="s1")
            repl = P.R.QueueReplication(Q, "p1", ep, hub.authority,
                                        hub.link(Q))
            repl.send_baseline(base_seq, _big_baseline(P, 64_000))
            for seq in range(base_seq + 1, base_seq + 5):
                repl.on_record(seq, P.J.RT_ADMIT, _admit(f"t{seq}"))

            def step():
                repl.pump(time.monotonic())
                sap.pump()

            assert _converge(60.0, step, lambda: repl.quiescent)
            lk = hub.link(Q).counters
            got[pkg] = (sap.applied_seq, len(sap.shadow.waiting),
                        repl.acked_seq, sap.counters["snapshots"] >= 1,
                        lk.get("send_errors", 0), lk.get("frame_errors", 0))
        finally:
            hub.close()
    want = (base_seq + 4, 64_004, base_seq + 4, True, 0, 0)
    assert all(g == want for g in got.values()), got


# ---- /healthz and prom with a socket hub ------------------------------------


async def _scrape_socket(pkg, tmp, fence, sock_dir):
    port = free_port()
    hub = NS[pkg].L.SocketReplicationHub(
        lease_s=60.0, base_dir=_subdir(sock_dir, f"{pkg}{int(fence)}"))
    app = _app(pkg, _cfg(pkg, tmp / f"{pkg}.{fence}", metrics_port=port), hub)
    await app.start()
    rt = app.runtime(SERVICE_Q)
    standby = hub.standby(SERVICE_Q)
    try:
        replies: dict = {}
        _collect(app, "h.replies", replies)
        for pid, rating in SERVICE_PLAYERS:
            _publish(pkg, app, pid, rating, "h.replies")
        assert await _quiesce(pkg, app, rt, matched=4, standby=standby)
        rt.replication.pump(time.monotonic())
        if fence:
            hub.authority.takeover(SERVICE_Q, "standby", time.monotonic(),
                                   force=True)
            assert not rt.replication.may_publish()
        report = await get(port, "/metrics")
        return (await get(port, "/healthz"),
                await get(port, "/metrics?format=prom"), report)
    finally:
        if not fence:
            await app.stop()
        else:
            await app.crash()
        hub.close()


@pytest.mark.parametrize("fence", [False, True])
def test_healthz_and_prom_with_a_socket_hub_equal_jax(tmp_path, fence,
                                                      sock_dir):
    mine = asyncio.run(_scrape_socket("port", tmp_path, fence, sock_dir))
    theirs = asyncio.run(_scrape_socket("jax", tmp_path, fence, sock_dir))
    assert mine[0][0] == theirs[0][0] == 200
    assert healthz_shape(mine[0][1]) == healthz_shape(theirs[0][1])
    body = json.loads(mine[0][1])
    entry = body["queues"][SERVICE_Q]["replication"]
    assert entry == json.loads(theirs[0][1])["queues"][SERVICE_Q][
        "replication"]
    assert body["status"] == ("degraded" if fence else "ok")
    assert prom_differences(prom_shape(mine[1][1]),
                            _jax_prom_shape(theirs[1][1])
                            ) == PROM_DIFFERENCES | REPLICATION_PROM_DIFFERENCES
    link = json.loads(mine[2][1])["replication"][SERVICE_Q]["link"]
    assert link["frames_tx"] > 0 and link["connects"] >= 1
    assert link.get("send_errors", 0) == link.get("frame_errors", 0) == 0


# ---- the cross-process soak ----------------------------------------------------


def test_cross_process_failover_soak_meets_the_gates():
    """``failover_proc.soak`` at 2 cycles, twice, with its host children
    on the CPU: no double match, losses within the unacked-tail bound,
    both fences refused at the superseded ex-primary, a reconnect after
    the scripted reset in every run, no heartbeat false positive, the
    serving epoch the takeover's, and one takeover-transcript digest."""
    res = failover_proc.soak(runs=2, cycles=2, device="cpu",
                             env={"OMP_NUM_THREADS": "1"})
    assert res["socket_failover_dup"] == 0
    assert res["socket_failover_lost_over_bound"] == 0
    assert res["socket_fenced_probe_failures"] == 0
    assert res["socket_link_reconnects"] >= 2
    assert res["heartbeat_false_positive_count"] == 0
    assert res["socket_failover_recoveries"] == 4
    assert res["socket_failover_transcript_identical"] is True
    assert res["socket_failover_matched_players"] == 2 * 6 * 2
    for run in res["socket_failover_epochs"]:
        assert run == [(2, 2), (3, 3)]
