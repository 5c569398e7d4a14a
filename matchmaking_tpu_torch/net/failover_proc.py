"""The cross-process failover soak: its child processes and the soak.

The soak (``soak``) starts one ``lease`` child (the shared
``LeaseService``, the part of a deployment that outlives every host) and a
chain of ``host`` children. Each host attaches as the warm standby of the
current primary (a real socket stream and real lease requests) and, on
command, takes the queue over after the lease really expired and serves
it, adopting its shadow. The soak then kills the old primary with
SIGKILL; the gates read only what crossed the wire.

    python -m matchmaking_tpu_torch.net.failover_proc lease --lease-addr unix:/tmp/x/lease.sock
    python -m matchmaking_tpu_torch.net.failover_proc host --name host0 --lease-addr ... [--device cpu]

Protocol: JSON lines, commands on stdin and events on stdout (stdout
carries protocol lines only; logging goes to stderr). Every command gets
one reply carrying its ``id``. Host commands: ``standby`` (attach and run
the pump thread), ``takeover`` (retry until the lease expires), ``serve``
(boot the app streaming to ``target``), ``publish`` (load into the local
broker; the answers fill ``match_of``), ``quiesce`` (poll
``fully_drained``), ``deafen`` (arm an asymmetric partition on the local
nemesis), ``probe`` (drive both fences and report the refusals),
``kernels`` (the hand kernels against their plain versions on the live
pool), ``report`` (watermarks, the waiting set and the standby's shadow,
or their digests, ``match_of``, counters, kernel launches) and ``stop``.

A host's engine runs on ``--device`` (``cuda`` unless told otherwise); it
never falls back to the CPU on its own.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import logging
import os
import queue as queue_mod
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable

log = logging.getLogger(__name__)

_Q_RATE_BURST = 4  # publish pacing: a sleep after every 4th row
_SOAK_QUEUE = "failover.soak"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _emit(ev: dict[str, Any]) -> None:
    sys.stdout.write(json.dumps(ev, sort_keys=True) + "\n")
    sys.stdout.flush()


def _digest(ids) -> str:
    return hashlib.sha256("\n".join(sorted(ids)).encode()).hexdigest()


def _chaos_from_json(blob: str):
    from matchmaking_tpu_torch.config import ChaosConfig

    d = json.loads(blob) if blob else {}

    def tt(v):  # JSON lists back to ChaosConfig's tuples of tuples
        return tuple(tuple(e) if isinstance(e, list) else e for e in (v or ()))

    return ChaosConfig(
        seed=int(d.get("seed", 0)), queues=tuple(d.get("queues", ())),
        net_drop_frames=tt(d.get("net_drop_frames")),
        net_dup_frames=tt(d.get("net_dup_frames")),
        net_delay_frames=tt(d.get("net_delay_frames")),
        net_reset_frames=tt(d.get("net_reset_frames")),
        net_partitions=tt(d.get("net_partitions")),
        net_deaf_flows=tuple(d.get("net_deaf_flows", ())),
        net_drop_prob=float(d.get("net_drop_prob", 0.0)),
        net_bandwidth_caps=tt(d.get("net_bandwidth_caps")))


def _net(args):
    from matchmaking_tpu_torch.config import NetConfig

    return NetConfig(
        transport="socket", lease_addr=args.lease_addr,
        heartbeat_timeout_s=float(args.heartbeat_timeout_s),
        max_frame_bytes=int(args.max_frame_bytes),
        send_buffer_bytes=int(args.send_buffer_bytes))


async def _run_lease(args) -> None:
    from matchmaking_tpu_torch.net.lease import LeaseService

    svc = LeaseService(args.lease_addr, lease_s=float(args.lease_s),
                       net=_net(args))
    svc.start()
    _emit({"ev": "ready", "role": "lease", "addr": args.lease_addr})
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()

    def _reader() -> None:
        for line in sys.stdin:
            if line.strip() and json.loads(line).get("cmd") == "stop":
                break
        loop.call_soon_threadsafe(stop.set)

    threading.Thread(target=_reader, daemon=True).start()
    await stop.wait()
    svc.close()
    _emit({"ev": "stopped", "role": "lease"})


def _kernel_check(eng, rows: int) -> dict[str, Any]:
    """``block_best`` and ``quality_accum`` on the engine's live pool
    against their plain versions: a window of the first ``rows`` waiting
    players (each lane is its player, so it never picks itself) at a time
    past every enqueue. Candidate slots and values bit-equal; quality
    histograms and counts equal, sums within 1e-5 of the plain version's
    (every addend is >= 0)."""
    import torch

    from matchmaking_tpu_torch.engine import cuda_kernels as ck
    from matchmaking_tpu_torch.engine import scoring

    ks, qk = eng.kernels, eng._quality
    pool = {k: eng.dev_pool[k] for k in ("rating", "rd", "region", "mode",
                                        "threshold", "enqueue_t", "active")}
    slots = torch.nonzero(pool["active"]).flatten()[:rows]
    idx = slots.long()
    batch = {"slot": slots.to(torch.int32), "rating": pool["rating"][idx],
             "rd": pool["rd"][idx], "region": pool["region"][idx],
             "mode": pool["mode"][idx],
             "valid": torch.ones(idx.numel(), dtype=torch.bool,
                                 device=idx.device)}
    q_thr = pool["threshold"][idx].clone()
    now = (pool["enqueue_t"].max() + 1.0).reshape(1)
    kw = dict(pool_block=ks.pool_block, glicko2=ks.glicko2, filters=True,
              widen_per_sec=ks.widen_per_sec, max_threshold=ks.max_threshold,
              g_coeff=scoring.G_COEFF_F32)
    kv, ki = ck.block_best(pool, batch, q_thr, now, **kw)
    rv, ri = ck.block_best_reference(pool, batch, q_thr, now, **kw)
    if not torch.equal(ki, ri) or not torch.equal(kv.view(torch.int32),
                                                  rv.view(torch.int32)):
        raise AssertionError(f"block_best differs from its plain version in "
                             f"{int((ki != ri).sum())} slots")
    finite = torch.isfinite(rv)
    bb_err = (float((kv[finite] - rv[finite]).abs().max())
              if bool(finite.any()) else 0.0)
    capacity = pool["rating"].shape[0]
    cand = ki[:, 0]
    hit = cand < capacity
    c_idx = cand.clamp_max(capacity - 1).long()
    out = torch.stack([
        torch.where(hit, slots.float(), float(capacity)),
        cand.float(),
        torch.where(hit, (pool["rating"][c_idx] - batch["rating"]).abs(),
                    float("inf"))]).contiguous()
    got, want = qk.init_state(out.device), qk.init_state(out.device)
    cols = (pool["rating"], pool["enqueue_t"], pool["threshold"])
    qkw = dict(widen_per_sec=qk.widen_per_sec,
               max_threshold=qk.max_threshold, rating_edges=qk.rating_edges,
               n_quality=qk.n_quality, wait_edges=qk.wait_edges)
    ck.QualityAccum(got, *cols, capacity=capacity, **qkw)(out, now)
    ck.quality_accum_reference(want, *cols, out, float(now[0]), **qkw)
    q_err = 0.0
    for name in ("q_hist", "w_hist", "count"):
        if not torch.equal(got[name], want[name]):
            raise AssertionError(f"quality_accum: {name} differs from the "
                                 f"plain version's")
    for name in ("q_sum", "w_sum", "d_sum"):
        err = (got[name] - want[name]).abs()
        if bool((err > 1e-5 * want[name].abs()).any()):
            raise AssertionError(f"quality_accum: {name} off by "
                                 f"{float(err.max())}")
        q_err = max(q_err, float(err.max()))
    return {"rows": int(idx.numel()), "block_best_max_abs_err": bb_err,
            "quality_accum_max_abs_err": q_err,
            "matched_lanes": int(hit.sum()), "device": str(out.device)}


class _HostChild:
    """One host generation: standby → (takeover) → primary → killed."""

    def __init__(self, args):
        from matchmaking_tpu_torch.net.link import SocketReplicationHub

        self.q = args.queue
        self.name = args.name
        self.seed = int(args.seed)
        self.lease_s = float(args.lease_s)
        self.device = args.device
        self.chaos = _chaos_from_json(args.chaos)
        self.net = _net(args)
        self.hub = SocketReplicationHub(
            net=self.net, chaos=self.chaos, seed=self.seed, owner=self.name)
        self.app = None
        self.rt = None
        self.sap = None
        self._pump = True
        self._pump_thread: threading.Thread | None = None
        self.match_of: dict[str, list[str]] = {}
        self.reply_q = f"failover.replies.{self.name}"

    # ---- commands --------------------------------------------------------------

    def cmd_standby(self, msg) -> dict:
        self.sap = self.hub.standby(self.q, owner=self.name,
                                    listen=msg["listen"])

        def pump_loop() -> None:
            while self._pump:
                try:
                    self.sap.pump()
                except Exception:
                    log.exception("standby pump")
                time.sleep(0.005)

        self._pump_thread = threading.Thread(target=pump_loop, daemon=True)
        self._pump_thread.start()
        return {"ev": "standby_up"}

    def cmd_takeover(self, msg) -> dict:
        from matchmaking_tpu_torch.service.replication import LeaseHeldError

        deadline = time.monotonic() + float(msg.get("timeout_s", 30.0))
        self._pump = False
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5.0)
        # Real expiry: no clock can be scripted across processes, so retry
        # until the authority sees no live holder (``force`` stays False:
        # promoting past a live lease is split-brain).
        while True:
            try:
                epoch = self.sap.takeover(time.monotonic())
                return {"ev": "took_over", "epoch": epoch,
                        "applied_seq": self.sap.applied_seq}
            except LeaseHeldError:
                if time.monotonic() >= deadline:
                    return {"ev": "error", "error": "takeover timeout: "
                            "lease never expired"}
                time.sleep(0.02)

    def _soak_cfg(self, jdir: str):
        from matchmaking_tpu_torch.config import (
            BatcherConfig,
            Config,
            DurabilityConfig,
            EngineConfig,
            QueueConfig,
            ReplicationConfig,
        )

        return Config(
            queues=(QueueConfig(name=self.q, rating_threshold=50.0,
                                dedup_ttl_s=3600.0,
                                send_queued_ack=False),),
            engine=EngineConfig(backend="gpu", pool_capacity=4096,
                                pool_block=512, batch_buckets=(16, 64),
                                top_k=8, warm_start=True),
            batcher=BatcherConfig(max_batch=64, max_wait_ms=2.0),
            durability=DurabilityConfig(journal_dir=jdir, fsync="window"),
            replication=ReplicationConfig(role="primary", owner=self.name),
            chaos=self.chaos)

    def _file_cfg(self, path: str, jdir: str, fsync: str):
        """A configuration file's service (``backend`` "gpu") as this
        host's primary: the journal at ``jdir``, this host's chaos."""
        import dataclasses

        from matchmaking_tpu_torch.config import (
            Config,
            DurabilityConfig,
            ReplicationConfig,
        )

        cfg = Config.from_json(path, backend="gpu")
        return dataclasses.replace(
            cfg, durability=DurabilityConfig(journal_dir=jdir, fsync=fsync),
            replication=ReplicationConfig(role="primary", owner=self.name),
            chaos=self.chaos)

    async def cmd_serve(self, msg) -> dict:
        from matchmaking_tpu_torch.service.app import MatchmakingApp

        self.hub.set_target(self.q, msg["target"])
        cfg = (self._file_cfg(msg["config"], msg["jdir"],
                              msg.get("fsync", "window"))
               if msg.get("config") else self._soak_cfg(msg["jdir"]))
        self.app = MatchmakingApp(cfg, device=self.device,
                                  replication_hub=self.hub)
        await self.app.start()
        self.rt = self.app.runtime(self.q)
        self.app.broker.declare_queue(self.reply_q)

        async def on_reply(delivery) -> None:
            # Every player of the match, the partner too: a partner whose
            # answer goes to another reply queue (an adopted player's) is
            # still seen matched here.
            d = json.loads(delivery.body)
            if d.get("status") == "matched":
                match = d.get("match") or {}
                mid = match.get("match_id")
                pids = {str(d.get("player_id", "")),
                        *map(str, match.get("players") or ())}
                for pid in pids:
                    if pid and mid:
                        ids = self.match_of.setdefault(pid, [])
                        if mid not in ids:
                            ids.append(mid)

        self.app.broker.basic_consume(self.reply_q, on_reply,
                                      prefetch=1_000_000)
        rto = self.app.metrics.gauges.get(f"failover_rto_ms[{self.q}]")
        rec = self.rt.last_recovery
        recovered = [r.id for r in self.rt.engine.waiting()]
        out = {"ev": "serving", "rto_ms": rto,
               "transcript": rec["transcript"] if rec else None,
               "split_ms": rec.get("split_ms") if rec else None,
               "epoch": self.rt.replication.epoch}
        if msg.get("digest"):
            out["recovered_n"] = len(recovered)
            out["recovered_digest"] = _digest(recovered)
        else:
            out["recovered"] = sorted(recovered)
        return out

    async def cmd_publish(self, msg) -> dict:
        from matchmaking_tpu_torch.service.broker import Properties

        gap = 1.0 / max(1.0, float(msg.get("rate", 500.0)))
        for k, (pid, rating) in enumerate(msg["rows"]):
            self.app.broker.publish(
                self.q, f'{{"id":"{pid}","rating":{rating}}}'.encode(),
                Properties(reply_to=self.reply_q, correlation_id=pid))
            if k % _Q_RATE_BURST == _Q_RATE_BURST - 1:
                await asyncio.sleep(gap * _Q_RATE_BURST)
        return {"ev": "published", "n": len(msg["rows"])}

    async def cmd_quiesce(self, msg) -> dict:
        from matchmaking_tpu_torch.testing.drain import fully_drained

        deadline = time.monotonic() + float(msg.get("timeout_s", 30.0))
        ok = False
        while time.monotonic() < deadline:
            await asyncio.sleep(0.005)
            if fully_drained(self.app, self.rt, self.q,
                             int(msg.get("matched_at_least", 0)),
                             replication=bool(msg.get("replication", True))):
                ok = True
                break
        return {"ev": "quiesced", "ok": ok}

    def cmd_deafen(self, msg) -> dict:
        self.hub.nemesis.deafen(msg["pattern"])
        return {"ev": "deafened", "pattern": msg["pattern"]}

    async def cmd_probe(self, msg) -> dict:
        """Drive both fences of this (presumably superseded) primary and
        report what they did, once its role flipped: the remote fence is
        asynchronous (a budgeted lease deadline has to lapse)."""
        from matchmaking_tpu_torch.utils.journal import FencedError

        deadline = time.monotonic() + float(msg.get("timeout_s", 10.0))
        repl = self.rt.replication
        while (repl.role != "fenced" and not repl.superseded()
               and time.monotonic() < deadline):
            await asyncio.sleep(0.01)
        before = self.app.metrics.counters.get("fenced_publish_refused")
        pubs_before = self.app.broker.stats.get("published", 0)
        self.rt._publish(self.reply_q, "fence-probe", b"{}")
        refused = (self.app.metrics.counters.get("fenced_publish_refused")
                   > before)
        pubs_after = self.app.broker.stats.get("published", 0)
        append_fenced = False
        try:
            self.rt.journal.append_terminal("fence-probe", b"{}",
                                            time.time() + 60.0)
        except FencedError:
            append_fenced = True
        return {"ev": "probe", "role": repl.role,
                "publish_refused": bool(refused),
                "publish_leaked": pubs_after > pubs_before,
                "append_fenced": append_fenced}

    def cmd_kernels(self, msg) -> dict:
        return {"ev": "kernels",
                **_kernel_check(self.rt.engine, int(msg.get("rows", 1024)))}

    def cmd_report(self, msg) -> dict:
        out: dict[str, Any] = {"ev": "report", "name": self.name}
        digest = bool(msg.get("digest"))
        if self.sap is not None:
            out["applied_seq"] = self.sap.applied_seq
            out["standby_link"] = dict(self.sap.link.counters)
            out["applier"] = dict(self.sap.counters)
            shadow = list(self.sap.shadow.waiting)
            out["shadow_n"] = len(shadow)
            out["shadow_digest"] = _digest(shadow)
            if msg.get("shadow"):
                out["shadow"] = sorted(shadow)
        if self.rt is not None:
            # Only a serving host has imported the kernels (and torch).
            from matchmaking_tpu_torch.engine import cuda_kernels as ck

            out["launches"] = dict(ck.LAUNCHES)
            repl = self.rt.replication
            link = self.hub._links.get(self.q)
            waiting = [r.id for r in self.rt.engine.waiting()]
            out.update({
                "role": repl.role, "epoch": repl.epoch,
                "sent_seq": repl.sent_seq, "acked_seq": repl.acked_seq,
                "kill_bound": repl.unacked_admit_players(),
                "matched": self.app.metrics.counters.get("players_matched"),
                "link": dict(link.counters) if link is not None else {},
                "lease": dict(self.hub.authority.counters),
                "errors": {
                    "tap_errors": self.rt.journal.tap_errors,
                    "send_errors": repl.send_errors,
                    "replication_pump_errors":
                        self.rt.counters["replication_pump_errors"]},
                "faults": self.app.faults(),
            })
            if digest:
                out["waiting_n"] = len(waiting)
                out["waiting_digest"] = _digest(waiting)
            else:
                out["waiting"] = sorted(waiting)
        out["match_of"] = self.match_of
        return out

    async def cmd_stop(self, msg) -> dict:
        self._pump = False
        if self.app is not None:
            await self.app.stop()
        self.hub.close()
        return {"ev": "stopped", "name": self.name}


async def _run_host(args) -> None:
    child = _HostChild(args)
    _emit({"ev": "ready", "role": "host", "name": args.name})
    loop = asyncio.get_running_loop()
    inbox: asyncio.Queue[dict | None] = asyncio.Queue()

    def _reader() -> None:
        for line in sys.stdin:
            line = line.strip()
            if line:
                loop.call_soon_threadsafe(inbox.put_nowait, json.loads(line))
        loop.call_soon_threadsafe(inbox.put_nowait, None)

    threading.Thread(target=_reader, daemon=True).start()
    while True:
        msg = await inbox.get()
        if msg is None:
            return
        cmd = msg.get("cmd", "")
        try:
            reply = getattr(child, f"cmd_{cmd}")(msg)
            if asyncio.iscoroutine(reply):
                reply = await reply
        except Exception as exc:  # answered, not fatal: the caller gates
            log.exception("cmd %r failed", cmd)
            reply = {"ev": "error", "cmd": cmd, "error": repr(exc)}
        reply["id"] = msg.get("id")
        _emit(reply)
        if reply.get("ev") == "stopped":
            return


def main(argv: list[str] | None = None) -> None:
    from matchmaking_tpu_torch.config import NetConfig

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("role", choices=("lease", "host"))
    p.add_argument("--name", default="host")
    p.add_argument("--queue", default=_SOAK_QUEUE)
    p.add_argument("--lease-addr", default="")
    p.add_argument("--lease-s", default="2.0")
    p.add_argument("--heartbeat-timeout-s",
                   default=str(NetConfig.heartbeat_timeout_s))
    p.add_argument("--max-frame-bytes", default=str(NetConfig.max_frame_bytes))
    p.add_argument("--send-buffer-bytes",
                   default=str(NetConfig.send_buffer_bytes))
    p.add_argument("--seed", default="0")
    p.add_argument("--chaos", default="",
                   help="JSON ChaosConfig subset (the net_* script)")
    p.add_argument("--device", default="cuda",
                   help="the host's engine device (cuda unless told)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    if args.role == "lease":
        asyncio.run(_run_lease(args))
    else:
        asyncio.run(_run_host(args))


# ---- the soak -----------------------------------------------------------------


class Child:
    """One child process and its JSON-line protocol (commands on stdin,
    events from stdout through a reader thread)."""

    def __init__(self, name: str, argv: list[str],
                 env: dict[str, str] | None = None):
        self.name = name
        path = os.environ.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "matchmaking_tpu_torch.net.failover_proc",
             *argv],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env={**os.environ, **(env or {}),
                 "PYTHONPATH": _ROOT + (os.pathsep + path if path else "")})
        self.events: queue_mod.Queue = queue_mod.Queue()
        self._rid = 0
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if line:
                try:
                    self.events.put(json.loads(line))
                except ValueError:
                    pass
        self.events.put(None)

    def _next(self, deadline: float) -> dict | None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"{self.name}: protocol timeout")
        try:
            return self.events.get(timeout=remaining)
        except queue_mod.Empty:
            raise TimeoutError(f"{self.name}: protocol timeout") from None

    def wait_ev(self, ev: str, timeout: float = 120.0) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            got = self._next(deadline)
            if got is None:
                raise RuntimeError(f"{self.name}: exited before {ev!r}")
            if got.get("ev") == ev:
                return got

    def rpc(self, cmd: str, timeout: float = 120.0, **kw) -> dict:
        """Send one command and wait for its reply; an ``error`` reply or
        a child that dies raises."""
        self._rid += 1
        self.proc.stdin.write(
            json.dumps({"cmd": cmd, "id": self._rid, **kw}) + "\n")
        self.proc.stdin.flush()
        deadline = time.monotonic() + timeout
        while True:
            got = self._next(deadline)
            if got is None:
                raise RuntimeError(f"{self.name}: died during {cmd!r}")
            if got.get("id") != self._rid:
                continue
            if got.get("ev") == "error":
                raise RuntimeError(
                    f"{self.name}: {cmd} failed: {got.get('error')}")
            return got

    def kill(self) -> None:
        self.proc.kill()  # SIGKILL: the crash under test

    def reap(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except Exception:
            pass
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except Exception:
                pass


def host_argv(name: str, *, queue: str, lease_addr: str, lease_s: float,
              seed: int, device: str, chaos: str | None = None,
              net: Any = None) -> list[str]:
    """A host child's arguments (``net``: a NetConfig whose frame and send
    buffer limits the child takes)."""
    argv = ["host", "--name", name, "--queue", queue, "--lease-addr",
            lease_addr, "--lease-s", str(lease_s), "--seed", str(seed),
            "--device", device]
    if net is not None:
        argv += ["--max-frame-bytes", str(net.max_frame_bytes),
                 "--send-buffer-bytes", str(net.send_buffer_bytes),
                 "--heartbeat-timeout-s", str(net.heartbeat_timeout_s)]
    if chaos:
        argv += ["--chaos", chaos]
    return argv


def soak(*, runs: int = 2, cycles: int = 3, pairs: int = 6, singles: int = 3,
         late_singles: int = 2, seed: int = 29, rate: float = 800.0,
         lease_s: float = 2.0, device: str = "cuda", keep_dirs: bool = False,
         env: dict[str, str] | None = None,
         log_fn: Callable[[str], None] | None = None) -> dict[str, Any]:
    """The cross-process failover soak: the replication invariants over
    real process and socket boundaries, ``runs`` times.

    Each run starts a lease child and a chain of host children on
    ``device``; each host attaches as the standby of the current primary
    over a UDS stream and remote lease requests, then the soak kills
    the primary with SIGKILL mid-tenure and the standby takes over after
    the real lease expiry. Nemesis schedule: cycle 0's primary runs a
    scripted fault script on its fwd flow (a drop, a duplicate, a delay
    and one mid-stream connection reset: the link must redial and
    converge by retransmission); the middle cycles are clean (any
    ``liveness_lost`` there is a heartbeat false positive); the last
    cycle arms an asymmetric partition before the kill (the primary still
    streams but hears no acks or lease answers), and the primary must
    fence itself within the lease, both fences refused, while the
    standby catches up.

    Gates, all in the result: no double match across the merged reply
    logs, losses within the unacked-tail bound at each kill, the fenced
    probes refused at both seams, at least one reconnect after the
    scripted reset, no heartbeat false positive in a clean tenure, and
    the runs' takeover transcripts equal by digest. The lease is at least
    2 s, above a host's start-up stalls."""
    import numpy as np

    say = log_fn or log.info
    q = _SOAK_QUEUE
    n_cycles = max(2, int(cycles))
    lease_s = max(float(lease_s), 2.0)

    def cycle_load(cycle: int) -> list[list[Any]]:
        rows: list[list[Any]] = []
        for i in range(pairs):
            base = 1000.0 + i * 200.0
            rows.append([f"f{cycle}p{2 * i}", base])
            rows.append([f"f{cycle}p{2 * i + 1}", base + 1.0])
        for i in range(singles):
            rows.append([f"f{cycle}s{i}", 50_000.0 + cycle * 10_000.0
                         + i * 1_000.0])
        rng = np.random.default_rng(seed + cycle)
        rng.shuffle(rows)
        return rows

    def merge_match_of(into: dict[str, set], rep: dict) -> None:
        for pid, mids in (rep.get("match_of") or {}).items():
            into.setdefault(pid, set()).update(mids)

    def add_launches(into: dict[str, int], rep: dict) -> None:
        # A primary's last report: its process's kernel launches.
        for k in into:
            into[k] += int(rep.get("launches", {}).get(k, 0))

    def one_run(run_idx: int) -> dict:
        base = tempfile.mkdtemp(prefix=f"mm_nf{run_idx}_")
        lease_addr = f"unix:{base}/lease.sock"
        fwd = f"repl:{q}:fwd"
        c0_chaos = json.dumps({
            "seed": seed, "queues": [q],
            "net_drop_frames": [[fwd, 2]], "net_dup_frames": [[fwd, 3]],
            "net_delay_frames": [[fwd, 4, 2]],
            "net_reset_frames": [[fwd, 6]]})

        def spawn_host(idx: int, chaos: str | None = None) -> Child:
            c = Child(f"host{idx}", host_argv(
                f"host{idx}", queue=q, lease_addr=lease_addr,
                lease_s=lease_s, seed=seed, device=device, chaos=chaos),
                env=env)
            children.append(c)
            c.wait_ev("ready", timeout=180.0)
            return c

        children: list[Child] = []
        lease = Child("lease", ["lease", "--lease-addr", lease_addr,
                                "--lease-s", str(lease_s)], env=env)
        res: dict[str, Any] = {
            "lost": 0, "lost_bound": 0, "over_bound": 0, "reconnects": 0,
            "hb_false_positives": 0, "fenced_probe_failures": 0,
            "rtos": [], "transcripts": [], "epochs": [],
            "launches": {"block_best": 0, "quality_accum": 0}}
        match_of: dict[str, set] = {}
        try:
            lease.wait_ev("ready", timeout=180.0)
            primary = spawn_host(0, chaos=c0_chaos)
            standby = spawn_host(1)
            standby.rpc("standby", listen=f"unix:{base}/repl1.sock")
            primary.rpc("serve", target=f"unix:{base}/repl1.sock",
                        jdir=f"{base}/host0", timeout=300.0)
            prev_rows: list[list[Any]] = []
            for cycle in range(n_cycles):
                if prev_rows:
                    # A redelivery storm: matched players replay their
                    # cached match on the new host.
                    primary.rpc("publish", rows=prev_rows, rate=rate)
                rows = cycle_load(cycle)
                primary.rpc("publish", rows=rows, rate=rate)
                qq = primary.rpc("quiesce", matched_at_least=2 * pairs,
                                 replication=True, timeout_s=60.0,
                                 timeout=90.0)
                if not qq.get("ok"):
                    say(f"[netfo r{run_idx} c{cycle}] WARNING: quiesce "
                        f"timed out")
                asym = cycle == n_cycles - 1 and late_singles > 0
                if asym:
                    primary.rpc("deafen", pattern=f"repl:{q}:ack")
                    primary.rpc("deafen", pattern="lease:")
                    late_rows = [[f"f{cycle}L{i}", 90_000.0 + i * 1_000.0]
                                 for i in range(late_singles)]
                    primary.rpc("publish", rows=late_rows, rate=rate)
                    primary.rpc("quiesce", matched_at_least=2 * pairs,
                                replication=False, timeout_s=30.0,
                                timeout=60.0)
                    # The fwd direction still works: the standby catches
                    # up while the primary hears no acks.
                    prep = primary.rpc("report")
                    deadline = time.monotonic() + 30.0
                    while True:
                        srep = standby.rpc("report")
                        if (srep.get("applied_seq", 0)
                                >= prep.get("sent_seq", 0)):
                            break
                        if time.monotonic() > deadline:
                            say(f"[netfo r{run_idx}] WARNING: the standby "
                                f"never caught up under the partition")
                            break
                        time.sleep(0.05)
                    # With renewals unconfirmable the primary must fence
                    # itself within the lease: both fences refused.
                    probe = primary.rpc("probe",
                                        timeout_s=4 * lease_s + 10.0,
                                        timeout=4 * lease_s + 30.0)
                    if not (probe.get("publish_refused")
                            and probe.get("append_fenced")
                            and not probe.get("publish_leaked")):
                        res["fenced_probe_failures"] += 1
                        say(f"[netfo r{run_idx}] GATE: fenced probe leaked: "
                            f"{probe}")
                rep = primary.rpc("report")
                kill_bound = int(rep.get("kill_bound", 0))
                pre_waiting = set(rep.get("waiting", ()))
                merge_match_of(match_of, rep)
                add_launches(res["launches"], rep)
                link = rep.get("link", {})
                res["reconnects"] += int(link.get("reconnects", 0))
                if cycle != 0 and not asym:
                    # A clean tenure: any liveness_lost is a heartbeat
                    # false positive.
                    srep = standby.rpc("report")
                    res["hb_false_positives"] += (
                        int(link.get("liveness_lost", 0))
                        + int(srep.get("standby_link", {})
                              .get("liveness_lost", 0)))
                say(f"[netfo r{run_idx} c{cycle}] matched="
                    f"{rep.get('matched')} waiting={len(pre_waiting)} "
                    f"bound={kill_bound} epoch={rep.get('epoch')} "
                    f"reconnects={link.get('reconnects', 0)}")
                primary.kill()
                to = standby.rpc("takeover", timeout_s=4 * lease_s + 30.0,
                                 timeout=4 * lease_s + 60.0)
                if cycle < n_cycles - 1:
                    nxt = spawn_host(cycle + 2)
                    target = f"unix:{base}/repl{cycle + 2}.sock"
                    nxt.rpc("standby", listen=target)
                else:
                    # The last successor streams to an address no listener
                    # ever binds, and must still stop cleanly.
                    target = f"unix:{base}/deadend.sock"
                sv = standby.rpc("serve", target=target,
                                 jdir=f"{base}/host{cycle + 1}",
                                 timeout=300.0)
                recovered = set(sv.get("recovered", ()))
                cycle_lost = len(pre_waiting - recovered)
                res["lost"] += cycle_lost
                res["lost_bound"] += kill_bound
                res["over_bound"] += max(0, cycle_lost - kill_bound)
                if cycle_lost > kill_bound:
                    say(f"[netfo r{run_idx} c{cycle}] GATE: lost "
                        f"{cycle_lost} > unacked-tail bound {kill_bound}")
                if sv.get("rto_ms") is not None:
                    res["rtos"].append(float(sv["rto_ms"]))
                if sv.get("transcript") is not None:
                    res["transcripts"].append(sv["transcript"])
                res["epochs"].append((to.get("epoch"), sv.get("epoch")))
                say(f"[netfo r{run_idx} c{cycle}] takeover epoch="
                    f"{to.get('epoch')} lost={cycle_lost} "
                    f"rto_ms={sv.get('rto_ms')}")
                primary, standby = standby, None
                if cycle < n_cycles - 1:
                    standby = children[-1]
                prev_rows = rows
            frep = primary.rpc("report")
            merge_match_of(match_of, frep)
            add_launches(res["launches"], frep)
            primary.rpc("stop", timeout=120.0)
            lease.proc.stdin.write(json.dumps({"cmd": "stop"}) + "\n")
            lease.proc.stdin.flush()
            lease.wait_ev("stopped", timeout=30.0)
        finally:
            for c in children:
                c.reap()
            lease.reap()
            if not keep_dirs:
                shutil.rmtree(base, ignore_errors=True)
        res["dup"] = sum(1 for ids in match_of.values() if len(ids) > 1)
        res["matched_players"] = len(match_of)
        res["digest"] = hashlib.sha256(
            json.dumps(res["transcripts"], sort_keys=True).encode()
        ).hexdigest()
        return res

    all_runs = [one_run(i) for i in range(max(1, int(runs)))]
    first = all_runs[0]
    identical = None
    if len(all_runs) >= 2:
        identical = all(r["digest"] == first["digest"] for r in all_runs[1:])
    rtos = [x for r in all_runs for x in r["rtos"]]
    return {
        "failover_transport": "socket",
        "socket_failover_cycles": n_cycles,
        "socket_failover_runs": len(all_runs),
        "socket_failover_lease_s": lease_s,
        "socket_failover_lost": sum(r["lost"] for r in all_runs),
        "socket_failover_lost_bound": sum(r["lost_bound"] for r in all_runs),
        "socket_failover_lost_over_bound": sum(
            r["over_bound"] for r in all_runs),
        "socket_failover_dup": sum(r["dup"] for r in all_runs),
        "socket_failover_rto_ms": max(rtos) if rtos else None,
        "socket_failover_rto_ms_mean": (sum(rtos) / len(rtos)
                                        if rtos else None),
        "socket_failover_recoveries": len(rtos),
        "socket_failover_matched_players": first["matched_players"],
        "socket_failover_epochs": [r["epochs"] for r in all_runs],
        "socket_link_reconnects": sum(r["reconnects"] for r in all_runs),
        "heartbeat_false_positive_count": sum(
            r["hb_false_positives"] for r in all_runs),
        "socket_fenced_probe_failures": sum(
            r["fenced_probe_failures"] for r in all_runs),
        "socket_failover_transcript_identical": identical,
        "failover_transcript_digest": first["digest"],
        "failover_transcript_digests": [r["digest"] for r in all_runs],
        "launches": {k: sum(r["launches"][k] for r in all_runs)
                     for k in first["launches"]},
    }


if __name__ == "__main__":
    main()
