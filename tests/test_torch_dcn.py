"""The multi-host runtime (engine/distributed.py) on the CPU: two real OS
processes join one gloo group through ``init_distributed`` (the
``MM_DCN_*`` variables) and run the sharded steps over the mesh of the two
ranks (``global_pool_mesh``), one shard each; the twin of
tests/test_dcn.py's script.

Each rank runs, on a seeded pool and window made alike in both:

- the 1v1 sharded step with the all-gather and with the ring merge (its
  collectives ``all_gather_into_tensor`` and ``batch_isend_irecv``), the
  gated rescan and the bucket frontier;
- the team step's replicated fallback and its ring;
- a ``GpuEngine`` with ``mesh_pool_axis`` 2, whose kernel set takes the
  process mesh, over a short request stream; and the same stream
  pipelined (dispatched, then flushed) at ``readback_group`` 1 and 3.

Both ranks' results must be equal, and equal to the same steps over the
in-process mesh of two CPU entries in this process, and each rank's pool
must be its slice of that mesh's pool. That mesh's results and pools are
held to the JAX package's sharded sets and engine on two of its virtual
CPU devices, on the same inputs (``jax_steps``). The two processes have a time
limit of their own (``WORKER_TIMEOUT_S``).

Also: ``serve`` joins a group of one when ``MM_DCN_*`` names it and
answers requests, and the refusals (``MM_DCN_AUTO`` with no launcher's
environment, an incomplete topology, a mesh that is not one shard per
rank). ``MM_DCN_AUTO``'s detection (``detect_cluster``) resolves the same
coordinator, world size, rank and local rank as the installed JAX's
cluster classes on the same Slurm and Open MPI environments, and two
processes join one gloo group through a scripted Slurm environment on
localhost.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import uuid

import numpy as np
import pytest
import torch

from matchmaking_tpu_torch.config import Config, EngineConfig, QueueConfig
from matchmaking_tpu_torch.engine import distributed, sharded, teams
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.service import app as port_app
from matchmaking_tpu_torch.service.amqp_transport import AmqpBroker
from matchmaking_tpu_torch.service.client import MatchmakingClient
from matchmaking_tpu_torch.service.contract import SearchRequest
from matchmaking_tpu_torch.testing import fake_pika

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 180


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def seeded_inputs():
    """A 1v1 pool of 256 slots (a third active), a window of 48 arrivals
    into free slots and a rescan window of 40 waiting players; a team pool
    of 64 slots with 24 waiting. Made from seeds, alike in every process."""
    rng = np.random.default_rng(17)
    cap = 256
    pool = {
        "rating": np.sort(rng.normal(1500, 200, cap)).astype(np.float32),
        "rd": rng.uniform(0, 300, cap).astype(np.float32),
        "region": rng.integers(0, 3, cap).astype(np.int32),
        "mode": rng.integers(0, 2, cap).astype(np.int32),
        "threshold": rng.uniform(60, 140, cap).astype(np.float32),
        "enqueue_t": rng.uniform(0, 5, cap).astype(np.float32),
        "active": rng.random(cap) < 0.1,
    }
    free = np.sort(rng.choice(np.where(~pool["active"])[0], 48,
                              replace=False))
    packed = np.zeros((9, 64), np.float32)
    packed[0] = cap
    packed[0, :48] = free
    packed[1, :48] = pool["rating"][free] + rng.normal(0, 20, 48)
    packed[2, :48] = rng.uniform(0, 300, 48)
    packed[3, :48] = rng.integers(0, 3, 48)
    packed[4, :48] = rng.integers(0, 2, 48)
    packed[5, :48] = rng.uniform(60, 140, 48)
    packed[6, :48] = rng.uniform(0, 5, 48)
    packed[7, :48] = 1.0
    packed[8] = 7.5
    live = np.sort(rng.choice(np.where(pool["active"])[0], 20,
                              replace=False))
    rescan = np.zeros((9, 64), np.float32)
    rescan[0] = cap
    rescan[0, :20] = live
    for i, f in enumerate(("rating", "rd", "region", "mode", "threshold",
                           "enqueue_t"), start=1):
        rescan[i, :20] = pool[f][live]
    rescan[7, :20] = 1.0
    rescan[8] = 30.0
    tcap = 64
    team = {
        "rating": np.zeros(tcap, np.float32), "rd": np.zeros(tcap, np.float32),
        "region": np.ones(tcap, np.int32), "mode": np.ones(tcap, np.int32),
        "threshold": np.full(tcap, 50.0, np.float32),
        "enqueue_t": np.zeros(tcap, np.float32),
        "active": np.zeros(tcap, bool),
    }
    idx = rng.choice(tcap, 24, replace=False)
    team["rating"][idx] = 1500.0 + rng.permutation(24) * 7.0
    team["active"][idx] = True
    tpacked = np.zeros((9, 16), np.float32)
    tpacked[0] = tcap
    tpacked[8] = 1.0
    return pool, packed, rescan, team, tpacked


GEO = dict(capacity=256, top_k=4, pool_block=32, glicko2=False,
           widen_per_sec=3.0, max_threshold=250.0)
TEAM = dict(capacity=64, team_size=2, widen_per_sec=0.0,
            max_threshold=400.0, max_matches=8)


def engine_cfg(**engine):
    return Config(engine=EngineConfig(backend="gpu", pool_capacity=256,
                                      pool_block=32, batch_buckets=(8, 32),
                                      mesh_pool_axis=2, **engine))


def engine_stream():
    rng = np.random.default_rng(23)
    pid = 0
    for w in range(6):
        yield [dict(id=f"p{pid + i}", rating=float(rng.normal(1500, 60)))
               for i in range(10)], float(w)
        pid += 10


def run_steps(mesh):
    """Every step of the module docstring over ``mesh``: {name: result
    (list)} and {name: the pool slices this process holds (lists)}."""
    pool, packed, rescan, team, tpacked = seeded_inputs()
    outs, pools = {}, {}
    for ring in (False, True):
        ks = sharded.ShardedKernelSet(mesh=mesh, ring=ring,
                                      bucket_frontier_k=32, **GEO)
        p = ks.place_pool(pool)
        name = "ring" if ring else "all_gather"
        outs[name] = ks.search_step_packed(
            p, torch.from_numpy(packed)).tolist()
        pools[name] = [lp["active"].tolist() for lp in p.shards]
        outs[name + "_rescan"] = ks.search_step_packed_rescan(
            p, torch.from_numpy(rescan)).tolist()
        pools[name + "_rescan"] = [lp["active"].tolist() for lp in p.shards]
        if not ring:
            p = ks.place_pool(pool)
            outs["frontier"] = ks.bucket_step(32)(
                p, torch.from_numpy(packed)).tolist()
            pools["frontier"] = [lp["active"].tolist() for lp in p.shards]
    tks = teams.ShardedTeamKernelSet(mesh=mesh, frontier_k=16, **TEAM)
    for fn in ("search_step_packed", "search_step_packed_ring"):
        p = tks.place_pool(team)
        outs["team_" + fn] = getattr(tks, fn)(
            p, torch.from_numpy(tpacked)).tolist()
        pools["team_" + fn] = [lp["active"].tolist() for lp in p.shards]
    eng = GpuEngine(engine_cfg(), QueueConfig(rating_threshold=80.0),
                    device="cpu")
    outs["engine"] = []
    for rows, now in engine_stream():
        out = eng.search([SearchRequest(**r) for r in rows], now)
        outs["engine"].append(sorted(
            sorted(p.id for t in m.teams for p in t) for m in out.matches))
    outs["engine_process_mesh"] = eng.kernels.mesh.process
    # Pipelined: every window dispatched, then one flush, with each
    # window read back alone and in groups of three (the group buffer
    # on the merged result's device): the same matches.
    for k in (1, 3):
        eng = GpuEngine(engine_cfg(readback_group=k,
                                   readback_group_wait_ms=10_000.0),
                        QueueConfig(rating_threshold=80.0), device="cpu")
        for rows, now in engine_stream():
            eng.search_async([SearchRequest(**r) for r in rows], now)
        outs[f"engine_grouped_{k}"] = [sorted(
            sorted(p.id for t in m.teams for p in t) for m in out.matches)
            for _, out in eng.flush()]
    assert outs["engine_grouped_3"] == outs["engine_grouped_1"]
    return outs, pools


def jax_steps():
    """``run_steps``'s steps through the JAX package's sharded kernel sets
    and engine on two of its virtual CPU devices (the reference), with the
    same inputs: the same names (the gated rescan, which the JAX package
    has no sharded form of, left out) and each shard's pool slices. JAX is
    imported here, not at the top, so the worker processes need none."""
    import jax.numpy as jnp

    from matchmaking_tpu.config import Config as JaxConfig
    from matchmaking_tpu.config import EngineConfig as JaxEngineConfig
    from matchmaking_tpu.config import QueueConfig as JaxQueueConfig
    from matchmaking_tpu.engine import sharded as jax_sharded
    from matchmaking_tpu.engine import teams as jax_teams
    from matchmaking_tpu.engine.tpu import TpuEngine
    from matchmaking_tpu.service.contract import SearchRequest as JaxRequest

    pool, packed, _, team, tpacked = seeded_inputs()
    mesh = jax_sharded.pool_mesh(2)
    outs, pools = {}, {}

    def slices(jp):
        return [a.tolist() for a in np.split(np.asarray(jp["active"]), 2)]
    for ring in (False, True):
        ks = jax_sharded.ShardedKernelSet(mesh=mesh, ring=ring,
                                          bucket_frontier_k=32, **GEO)
        name = "ring" if ring else "all_gather"
        jp, out = ks.search_step_packed(ks.place_pool(pool),
                                        jnp.asarray(packed))
        outs[name], pools[name] = np.asarray(out).tolist(), slices(jp)
        if not ring:
            jp, out = ks.bucket_step(32)(ks.place_pool(pool),
                                         jnp.asarray(packed))
            outs["frontier"] = np.asarray(out).tolist()
            pools["frontier"] = slices(jp)
    tks = jax_teams.ShardedTeamKernelSet(mesh=mesh, frontier_k=16, **TEAM)
    for fn in ("search_step_packed", "search_step_packed_ring"):
        jp, out = getattr(tks, fn)(tks.place_pool(dict(team)),
                                   jnp.asarray(tpacked))
        outs["team_" + fn] = np.asarray(out).tolist()
        pools["team_" + fn] = slices(jp)
    eng = TpuEngine(JaxConfig(engine=JaxEngineConfig(
        backend="tpu", pool_capacity=256, pool_block=32, batch_buckets=(8, 32),
        mesh_pool_axis=2)), JaxQueueConfig(rating_threshold=80.0))
    outs["engine"] = []
    for rows, now in engine_stream():
        out = eng.search([JaxRequest(**r) for r in rows], now)
        outs["engine"].append(sorted(
            sorted(p.id for t in m.teams for p in t) for m in out.matches))
    return outs, pools


WORKER = r"""
import json, sys
import torch
from matchmaking_tpu_torch.engine import distributed
sys.path.insert(0, sys.argv[1])
from test_torch_dcn import run_steps

assert distributed.dcn_configured()
rank, world = distributed.init_distributed(device="cpu")
assert world == 2, world
mesh = distributed.global_pool_mesh("cpu")
assert mesh.process and mesh.local_shards == (rank,)
outs, pools = run_steps(mesh)
print("DCN_RESULT " + json.dumps({"rank": rank, "outs": outs,
                                   "pools": pools}), flush=True)
distributed.shutdown_distributed()
"""


def test_two_process_gloo_sharded_steps_equal_the_in_process_mesh():
    port = free_port()
    env = dict(os.environ)
    env.update(MM_DCN_COORDINATOR=f"127.0.0.1:{port}",
               MM_DCN_NUM_PROCESSES="2",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.pop("MM_DCN_AUTO", None)
    procs = []
    for rank in range(2):
        penv = dict(env, MM_DCN_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, os.path.join(REPO, "tests")],
            env=penv, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f"rank {rank}:\n{err[-3000:]}"
            line = next(x for x in out.splitlines()
                        if x.startswith("DCN_RESULT "))
            results.append(json.loads(line[len("DCN_RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want, want_pools = run_steps(sharded.pool_mesh(2, device="cpu"))
    assert want.pop("engine_process_mesh") is False
    # The in-process mesh against the JAX package on the same inputs
    # (ELO: bit for bit), so the process mesh is held to the reference.
    theirs, their_pools = jax_steps()
    for name, out in theirs.items():
        if name == "engine":
            assert want[name] == out
        else:
            np.testing.assert_array_equal(np.asarray(want[name], np.float32),
                                          np.asarray(out, np.float32),
                                          err_msg=name)
        if name in their_pools:
            assert want_pools[name] == their_pools[name], name
    for rank, res in enumerate(results):
        outs, pools = res["outs"], res["pools"]
        assert res["rank"] == rank
        assert outs.pop("engine_process_mesh") is True
        assert outs == want, rank
        for name, slices in pools.items():
            assert slices == [want_pools[name][rank]], (name, rank)
    assert sum(q < 256 for q in want["all_gather"][0]) >= 10
    assert sum(q < 64 for q in want["team_search_step_packed"][0]) >= 2
    assert sum(len(w) for w in want["engine"]) >= 10
    assert sum(len(w) for w in want["engine_grouped_1"]) >= 10


def test_from_env_leaves_the_topology_to_the_runtime(monkeypatch, caplog):
    """``MM_DCN_*`` are the runtime's variables: ``Config.from_env`` reads
    none of them into the tree and warns about none."""
    import logging

    from matchmaking_tpu_torch import config

    for k, v in (("MM_DCN_COORDINATOR", "127.0.0.1:1"),
                 ("MM_DCN_NUM_PROCESSES", "2"), ("MM_DCN_PROCESS_ID", "1")):
        monkeypatch.setenv(k, v)
    with caplog.at_level(logging.WARNING, logger=config.__name__):
        cfg = Config.from_env()
    assert "dcn" not in " ".join(r.getMessage() for r in caplog.records)
    assert cfg == Config.from_env(prefix="MM_UNSET_")


def test_refusals():
    """``MM_DCN_AUTO`` with neither a Slurm nor an Open MPI environment is
    refused; a topology without its size or rank is refused; a sharded set
    whose mesh is not one shard per rank of the joined group is
    refused."""
    assert distributed.cpu_collectives_supported()
    assert not distributed.process_group_active()
    env = {"MM_DCN_AUTO": "1"}
    old = {k: os.environ.pop(k, None) for k in
           ("MM_DCN_AUTO", "MM_DCN_COORDINATOR", "MM_DCN_NUM_PROCESSES",
            "MM_DCN_PROCESS_ID", *LAUNCHER_VARS)}
    try:
        os.environ.update(env)
        assert distributed.dcn_configured()
        with pytest.raises(ValueError, match="no launcher's environment"):
            distributed.init_distributed(device="cpu")
        del os.environ["MM_DCN_AUTO"]
        os.environ["MM_DCN_COORDINATOR"] = "127.0.0.1:1"
        with pytest.raises(ValueError, match="MM_DCN_NUM_PROCESSES"):
            distributed.init_distributed(device="cpu")
        with pytest.raises(RuntimeError, match="process group"):
            distributed.global_pool_mesh("cpu")
        os.environ["MM_DCN_COORDINATOR"] = f"127.0.0.1:{free_port()}"
        os.environ["MM_DCN_NUM_PROCESSES"] = "1"
        os.environ["MM_DCN_PROCESS_ID"] = "0"
        try:
            assert distributed.init_distributed(device="cpu") == (0, 1)
            assert distributed.init_distributed(device="cpu") == (0, 1)
            with pytest.raises(ValueError, match="one shard per rank"):
                sharded.resolve_mesh(2, device="cpu")
            mesh = sharded.resolve_mesh(1, device="cpu")
            assert mesh.process and mesh.n_shards == 1
        finally:
            distributed.shutdown_distributed()
        assert not distributed.process_group_active()
    finally:
        for k in ("MM_DCN_AUTO", "MM_DCN_COORDINATOR",
                  "MM_DCN_NUM_PROCESSES", "MM_DCN_PROCESS_ID"):
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in old.items() if v is not None})


# ---- MM_DCN_AUTO: the topology from a Slurm or Open MPI launcher ------------

#: Every variable the detection reads (cleared around each case).
LAUNCHER_VARS = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
                 "SLURM_PROCID", "SLURM_LOCALID", "OMPI_MCA_orte_hnp_uri",
                 "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_LOCAL_RANK", "JAX_COORDINATOR_PORT")


def slurm_env(nodes, job=12345, ntasks=4, procid=2, localid=1):
    return {"SLURM_JOB_ID": str(job), "SLURM_STEP_NODELIST": nodes,
            "SLURM_NTASKS": str(ntasks), "SLURM_PROCID": str(procid),
            "SLURM_LOCALID": str(localid)}


def ompi_env(uri, size=8, rank=5, local=3):
    return {"OMPI_MCA_orte_hnp_uri": uri, "OMPI_COMM_WORLD_SIZE": str(size),
            "OMPI_COMM_WORLD_RANK": str(rank),
            "OMPI_COMM_WORLD_LOCAL_RANK": str(local)}


CLUSTER_CASES = {
    "slurm_range": slurm_env("node[001-004]"),
    "slurm_list": slurm_env("a,b", job=987654),
    "slurm_one": slurm_env("node001", job=61440),
    "slurm_mixed": slurm_env("node[001,007-015],host2", job=4095),
    "slurm_port_override": dict(slurm_env("gpu[17-18]"),
                                JAX_COORDINATOR_PORT="29500"),
    "ompi_tcp": ompi_env("1531576320.0;tcp://10.96.0.1,10.148.0.1,"
                         "10.108.0.1:34911"),
    "ompi_tcp6": ompi_env("1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,"
                          "2620:10d:c083:150e::3000:2]:43370"),
    "ompi_inside_slurm": dict(slurm_env("node[001-004]"),
                              **ompi_env("4096.0;tcp://192.168.1.7:1000")),
    "slurm_incomplete": {k: v for k, v in slurm_env("n1").items()
                         if k != "SLURM_LOCALID"},
    "neither": {},
}


@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_detection_equals_jax_cluster_classes(case, monkeypatch):
    """The port's ``detect_cluster`` against the installed JAX's
    ``ClusterEnv.auto_detect_unset_distributed_params`` (its Open MPI and
    Slurm classes, in its order) on the same environment: the same
    coordinator, world size, rank and local rank (JAX: the local device
    id), or nothing from either."""
    from jax._src.clusters import ClusterEnv

    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in CLUSTER_CASES[case].items():
        monkeypatch.setenv(k, v)
    coord, n, pid, local = ClusterEnv.auto_detect_unset_distributed_params(
        None, None, None, None, None, None)
    got = distributed.detect_cluster()
    if coord is None:
        assert got is None
        return
    assert (got.coordinator, got.num_processes, got.process_id,
            [got.local_rank]) == (coord, n, pid, list(local))
    assert got.name == ("ompi" if "OMPI_MCA_orte_hnp_uri" in os.environ
                        else "slurm")


def test_detection_gives_the_topology(monkeypatch):
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    assert distributed.detect_cluster() is None
    for k, v in slurm_env("node[001-004]", job=4096, ntasks=2, procid=1,
                          localid=0).items():
        monkeypatch.setenv(k, v)
    assert distributed.detect_cluster() == distributed.ClusterTopology(
        "slurm", "node001:61440", 2, 1, 0)


def test_the_launchers_local_rank_picks_the_card(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert distributed.local_card(5, 4, 3) == 3
    with pytest.raises(ValueError, match="launcher's local rank=3"):
        distributed.local_card(5, 2, 3)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.local_card(5, 4, 3) == 1


def test_auto_refusal_names_both_environments(monkeypatch):
    for k in LAUNCHER_VARS + ("MM_DCN_COORDINATOR", "MM_DCN_NUM_PROCESSES",
                              "MM_DCN_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MM_DCN_AUTO", "1")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    with pytest.raises(ValueError) as err:
        distributed.init_distributed(device="cpu")
    msg = str(err.value)
    for name in ("Open MPI", "OMPI_MCA_orte_hnp_uri", "Slurm",
                 "SLURM_STEP_NODELIST", "mpi4py", "Kubernetes",
                 "MM_DCN_COORDINATOR"):
        assert name in msg, name
    assert not distributed.process_group_active()


def slurm_job_with_a_free_port():
    """A Slurm job id whose coordinator port (job % 4096 + 61440) is free
    on localhost now."""
    for job in range(int(uuid.uuid4().int % 4096), 4096 * 2):
        port = job % 4096 + 61440
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port))
        except OSError:
            continue
        return job, port
    raise RuntimeError("no free port in the Slurm job range")


SLURM_WORKER = r"""
import json, os
import torch
import torch.distributed as dist
from matchmaking_tpu_torch.engine import distributed

assert distributed.dcn_configured()
found = distributed.detect_cluster()
rank, world = distributed.init_distributed(device="cpu")
got = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
dist.all_gather(got, torch.tensor([100 + rank]))
mesh = distributed.global_pool_mesh("cpu")
print("SLURM_RESULT " + json.dumps({
    "rank": rank, "world": world, "found": list(found),
    "gathered": [int(t) for t in got], "shards": list(mesh.local_shards)}),
    flush=True)
distributed.shutdown_distributed()
"""


def test_two_processes_join_through_a_scripted_slurm_environment():
    """``MM_DCN_AUTO`` and a Slurm step's variables on localhost, no
    ``MM_DCN_COORDINATOR``: both ranks find the coordinator at the job
    id's port, join one gloo group, all-gather their ranks and hold one
    shard each of the process mesh."""
    job, port = slurm_job_with_a_free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in LAUNCHER_VARS and not k.startswith("MM_DCN_")
           and k != "LOCAL_RANK"}
    env.update(MM_DCN_AUTO="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = []
    for rank in range(2):
        penv = dict(env, **slurm_env("localhost", job=job, ntasks=2,
                                     procid=rank, localid=rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SLURM_WORKER], env=penv, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f"rank {rank}:\n{err[-3000:]}"
            line = next(x for x in out.splitlines()
                        if x.startswith("SLURM_RESULT "))
            results.append(json.loads(line[len("SLURM_RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, res in enumerate(results):
        assert res["rank"] == rank and res["world"] == 2
        assert res["found"] == ["slurm", f"localhost:{port}", 2, rank, rank]
        assert res["gathered"] == [100, 101]
        assert res["shards"] == [rank]


async def test_serve_joins_a_group_of_one_and_answers(monkeypatch):
    """``serve`` with ``MM_DCN_*`` naming a world of one joins the gloo
    group at start and serves: two players matched over the fake AMQP
    broker, as the serve entry point's own test does without a group."""
    for k in list(os.environ):
        if k.startswith("MM_"):
            monkeypatch.delenv(k)
    url = f"amqp://dcn-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("MM_BROKER_URL", url)
    monkeypatch.setenv("MM_ENGINE_BACKEND", "cpu")
    monkeypatch.setenv("MM_BATCHER_MAX_WAIT_MS", "1")
    monkeypatch.setenv("MM_DCN_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("MM_DCN_NUM_PROCESSES", "1")
    monkeypatch.setenv("MM_DCN_PROCESS_ID", "0")
    stop = asyncio.Event()
    task = asyncio.create_task(port_app.serve(stop, pika_module=fake_pika,
                                              device="cpu"))
    try:
        server = fake_pika.FakeServer.for_url(url)
        q = Config().queues[0].name
        for _ in range(500):
            if q in server.queues or task.done():
                break
            await asyncio.sleep(0.01)
        assert q in server.queues
        assert distributed.process_group_active()
        client = AmqpBroker(url, pika_module=fake_pika,
                            reconnect_base_s=0.01)
        mm = MatchmakingClient(client, q)
        r1, r2 = await asyncio.gather(
            mm.search_until_matched({"id": "alice", "rating": 1500},
                                    timeout=10.0),
            mm.search_until_matched({"id": "bob", "rating": 1503},
                                    timeout=10.0))
        assert r1.status == "matched" and r2.status == "matched"
        client.close()
    finally:
        stop.set()
        await task
        distributed.shutdown_distributed()


def test_each_rank_takes_its_own_card(monkeypatch):
    """On CUDA ``init_distributed`` makes the rank's own card current
    before it joins (``LOCAL_RANK``, else the rank modulo the cards), and
    ``global_pool_mesh`` puts the shard on that card; the CPU stays the
    CPU. The CUDA calls are stood in for here (this test needs no card)."""
    import torch.distributed as dist

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert distributed.local_card(5, 4) == 1
    assert distributed.local_card(0, 1) == 0
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert distributed.local_card(5, 4) == 2
    with pytest.raises(ValueError, match="LOCAL_RANK=2"):
        distributed.local_card(5, 2)
    with pytest.raises(RuntimeError, match="visible card"):
        distributed.local_card(0, 0)
    monkeypatch.delenv("LOCAL_RANK")

    joined, made_current = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", made_current.append)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: made_current[-1])
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 6)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    assert distributed.init_distributed("127.0.0.1:1", 8, 6) == (6, 8)
    assert made_current == [2]
    assert joined[0][0] == "nccl" and joined[0][1]["rank"] == 6
    assert distributed.rank_device("cuda") == torch.device("cuda", 2)
    assert distributed.rank_device("cuda:3") == torch.device("cuda", 3)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(distributed, "process_group_active", lambda: True)
    mesh = distributed.global_pool_mesh("cuda")
    assert mesh.home == torch.device("cuda", 2)
    assert mesh.devices == (torch.device("cuda", 2),)
    assert distributed.global_pool_mesh("cpu").devices == (
        torch.device("cpu"),)
