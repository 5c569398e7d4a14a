"""The multi-host runtime: ``torch.distributed`` and the mesh over processes.

Port of ``matchmaking_tpu/engine/distributed.py``. Each host process calls
:func:`init_distributed` once at boot; :func:`global_pool_mesh` then gives
the pool mesh over every process of the group, one shard per rank, and the
same sharded kernel sets (engine/sharded.py, teams.py, role_kernels.py)
run on it unchanged: their merges become collectives of the group
(``all_gather_into_tensor`` for the all-gather, ``batch_isend_irecv`` to
the right neighbour for the ring). NCCL joins the cards, gloo the CPUs.

Every process runs the same program: the service runs the identical
engine step per window on each rank, with the request window replicated
(a few KB) and the pool sharded. A step over a process group runs eagerly
(no CUDA graph: a collective of the group is not captured).

The topology comes from the environment, as the JAX package reads it:

- ``MM_DCN_COORDINATOR``   host:port of rank 0 (e.g. ``10.0.0.1:8476``)
- ``MM_DCN_NUM_PROCESSES`` the world size
- ``MM_DCN_PROCESS_ID``    this process's rank

On CUDA each rank takes its own card of its host (:func:`local_card`):
``LOCAL_RANK`` when set (as ``torchrun`` sets it), else the rank modulo
the cards visible, and :func:`global_pool_mesh` puts the rank's shard
there. Ranks that share a host must see at least as many cards as there
are ranks on it, or be given ``LOCAL_RANK`` (or ``CUDA_VISIBLE_DEVICES``)
each.

``MM_DCN_AUTO`` with no coordinator named asks the launcher's environment
for the topology, as ``jax.distributed.initialize()`` does when the JAX
package calls it bare (:func:`detect_cluster`, the port's own copy of the
rules of JAX's ``ompi_cluster.py`` and ``slurm_cluster.py``, checked in
JAX's order):

- Open MPI (``mpirun``): ``OMPI_MCA_orte_hnp_uri`` names the launcher's
  address and job; ``OMPI_COMM_WORLD_SIZE``, ``_RANK`` and ``_LOCAL_RANK``
  the world size, the rank and the local rank;
- Slurm (``srun``): the first host of ``SLURM_STEP_NODELIST``,
  ``SLURM_NTASKS``, ``SLURM_PROCID`` and ``SLURM_LOCALID``;

the coordinator's port is the job id's in ``[61440, 65535]`` unless
``JAX_COORDINATOR_PORT`` names one (the variable JAX reads). An
``MM_DCN_*`` variable that is set wins over what is detected, and the
local rank picks the rank's card. Neither environment present: refused.
The JAX package's other detectors (mpi4py, Kubernetes, the TPU metadata
server) have no counterpart here and are refused by name.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple, Sequence

import torch


def _auto_requested() -> bool:
    return os.environ.get("MM_DCN_AUTO", "").strip().lower() in (
        "1", "true", "yes", "on")


def dcn_configured() -> bool:
    """True when the environment names a multi-host topology: a
    coordinator (``MM_DCN_COORDINATOR``) or ``MM_DCN_AUTO`` (the topology
    detected from the launcher's environment: :func:`detect_cluster`)."""
    return bool(os.environ.get("MM_DCN_COORDINATOR") or _auto_requested())


class ClusterTopology(NamedTuple):
    """What a launcher's environment says of the process group."""

    #: "ompi" or "slurm" (JAX's cluster names).
    name: str
    #: host:port of rank 0.
    coordinator: str
    num_processes: int
    process_id: int
    local_rank: int


#: Variables whose presence selects each environment (JAX's
#: ``is_env_present``): Open MPI's launcher URI, Slurm's step variables.
OMPI_URI = "OMPI_MCA_orte_hnp_uri"
SLURM_VARS = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
              "SLURM_PROCID", "SLURM_LOCALID")


def _job_port(job_id: int) -> str:
    """JAX_COORDINATOR_PORT, else the job id's port in the ephemeral range
    [65535 - 2^12 + 1, 65535]."""
    return os.environ.get("JAX_COORDINATOR_PORT") or str(
        job_id % 2**12 + (65535 - 2**12 + 1))


def _ompi_topology() -> ClusterTopology:
    """``mpirun``'s variables. The URI reads like
    ``1531576320.0;tcp://10.96.0.1,10.148.0.1:34911`` (or ``tcp6://[..]``):
    the first address is the launcher's; the job id, a multiple of 2^12,
    is divided by 2^12 before it picks the port."""
    env = os.environ
    uri = env[OMPI_URI]
    port = _job_port(int(uri.split(".", maxsplit=1)[0]) // 2**12)
    ip = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if ip is None:
        raise RuntimeError("could not parse the coordinator's address from "
                           f"{OMPI_URI}={uri!r}")
    host = next(g for g in ip.groups() if g is not None)
    return ClusterTopology(
        "ompi", f"{host}:{port}", int(env["OMPI_COMM_WORLD_SIZE"]),
        int(env["OMPI_COMM_WORLD_RANK"]),
        int(env["OMPI_COMM_WORLD_LOCAL_RANK"]))


def _slurm_topology() -> ClusterTopology:
    """``srun``'s variables. The coordinator is the first host of the node
    list, whose forms are ``node001``, ``node001,host2``,
    ``node[001-015],host2`` and ``node[001,007-015],host2``."""
    env = os.environ
    port = _job_port(int(env["SLURM_JOB_ID"]))
    nodes = env["SLURM_STEP_NODELIST"]
    i = next((j for j, ch in enumerate(nodes) if ch in ",["), len(nodes))
    if i == len(nodes) or nodes[i] == ",":
        host = nodes[:i]
    else:
        rest = nodes[i + 1:]
        j = next((j for j, ch in enumerate(rest) if ch in ",-"), None)
        host = nodes[:i] + rest[:j]
    return ClusterTopology(
        "slurm", f"{host}:{port}", int(env["SLURM_NTASKS"]),
        int(env["SLURM_PROCID"]), int(env["SLURM_LOCALID"]))


def detect_cluster() -> ClusterTopology | None:
    """The topology the launcher's environment names: Open MPI's first,
    then Slurm's (JAX's order: an ``mpirun`` inside a Slurm allocation
    sees both, and its ranks are Open MPI's); None when neither is
    present."""
    if OMPI_URI in os.environ:
        return _ompi_topology()
    if all(k in os.environ for k in SLURM_VARS):
        return _slurm_topology()
    return None


def cpu_collectives_supported() -> bool:
    """True when this PyTorch carries gloo, the CPU collectives a process
    group over CPU processes needs."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_gloo_available()


def process_group_active() -> bool:
    """A process group has been joined (and not torn down)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def local_card(rank: int, n_cards: int, local_rank: int | None = None
               ) -> int:
    """The CUDA index of ``rank``'s card on its host: ``LOCAL_RANK`` when
    set, else ``local_rank`` (the launcher's, from :func:`detect_cluster`)
    when given, else ``rank`` modulo the ``n_cards`` visible. Raises when
    no card is visible or the local rank names one past them."""
    if n_cards < 1:
        raise RuntimeError("a process group over CUDA needs a visible card")
    local = os.environ.get("LOCAL_RANK")
    name = "LOCAL_RANK"
    if local is None and local_rank is not None:
        local, name = local_rank, "the launcher's local rank"
    if local is None:
        return rank % n_cards
    if not 0 <= int(local) < n_cards:
        raise ValueError(f"{name}={local} but {n_cards} cards are "
                         f"visible to this process")
    return int(local)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     *, device="cuda") -> tuple[int, int]:
    """Join the process group; returns (rank, world size). Explicit
    arguments win over the ``MM_DCN_*`` variables, and these over what
    ``MM_DCN_AUTO`` detects (:func:`detect_cluster`, asked when no
    coordinator is named). The backend is NCCL on CUDA and gloo on the
    CPU (``device``); on CUDA the process's current card becomes the
    rank's own (:func:`local_card`) before it joins. A second call
    returns the group already joined."""
    import torch.distributed as dist

    if process_group_active():
        return dist.get_rank(), dist.get_world_size()
    coordinator_address = coordinator_address or os.environ.get(
        "MM_DCN_COORDINATOR")
    if num_processes is None and os.environ.get("MM_DCN_NUM_PROCESSES"):
        num_processes = int(os.environ["MM_DCN_NUM_PROCESSES"])
    if process_id is None and os.environ.get("MM_DCN_PROCESS_ID"):
        process_id = int(os.environ["MM_DCN_PROCESS_ID"])
    local_rank = None
    if _auto_requested() and not coordinator_address:
        found = detect_cluster()
        if found is None:
            raise ValueError(
                "MM_DCN_AUTO found no launcher's environment: neither Open "
                f"MPI's ({OMPI_URI}) nor Slurm's ({', '.join(SLURM_VARS)}). "
                "mpi4py, Kubernetes and TPU-metadata detection have no "
                "counterpart in this package: name the topology with "
                "MM_DCN_COORDINATOR, MM_DCN_NUM_PROCESSES and "
                "MM_DCN_PROCESS_ID")
        coordinator_address = found.coordinator
        if num_processes is None:
            num_processes = found.num_processes
        if process_id is None:
            process_id = found.process_id
        local_rank = found.local_rank
    if not coordinator_address or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the world size "
            "and this process's rank (MM_DCN_COORDINATOR, "
            "MM_DCN_NUM_PROCESSES, MM_DCN_PROCESS_ID)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a process group over CUDA needs "
                               "torch.cuda.is_available(); pass "
                               "device='cpu' for gloo")
        torch.cuda.set_device(local_card(process_id,
                                         torch.cuda.device_count(),
                                         local_rank))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed() -> None:
    """Leave the process group (tests and the smoke tear theirs down)."""
    import torch.distributed as dist

    if process_group_active():
        dist.destroy_process_group()


def _gather_dtype(x: torch.Tensor) -> torch.Tensor:
    """Bool tensors travel as uint8 (not every backend takes bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


class ProcessMesh:
    """The pool mesh over a process group: one shard per rank, this
    process holding shard ``rank`` on ``device``. The collectives of
    ``sharded.PoolMesh`` as the group's: every rank receives every
    shard's tensors, in canonical (rank) order."""

    process = True
    single_device = True
    #: The last ring gather's hops, as ``sharded.PoolMesh.ring_hops``.
    ring_hops: tuple = ()

    def __init__(self, device):
        import torch.distributed as dist

        self._dist = dist
        self.rank = dist.get_rank()
        self.n_shards = dist.get_world_size()
        self.home = torch.device(device)
        self.devices = (self.home,)
        self.local_shards = (self.rank,)

    def all_gather(self, parts: Sequence[tuple[torch.Tensor, ...]]
                   ) -> tuple[torch.Tensor, ...]:
        """``all_gather_into_tensor`` of each of this rank's tensors."""
        (p,) = parts
        dist = self._dist
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        out = []
        for x in p:
            send = _gather_dtype(x).contiguous()
            buf = torch.empty((self.n_shards,) + tuple(x.shape),
                              dtype=send.dtype, device=send.device)
            gather(buf.view(-1), send.view(-1))
            out.append(buf.to(x.dtype) if x.dtype == torch.bool else buf)
        return tuple(out)

    def ring_all_gather(self, parts: Sequence[tuple[torch.Tensor, ...]]
                        ) -> tuple[torch.Tensor, ...]:
        """D − 1 hops: each rank sends the tensors it holds to rank + 1
        and receives rank − 1's (``batch_isend_irecv``), writing each into
        its source's row."""
        from matchmaking_tpu_torch.engine.sharded import ring_perm

        (p,) = parts
        dist = self._dist
        n, r = self.n_shards, self.rank
        perm = ring_perm(n)
        to = dict(perm)[r]
        frm = next(s for s, d in perm if d == r)
        rots = [_gather_dtype(x).contiguous() for x in p]
        outs = []
        for x in rots:
            b = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device)
            b[r].copy_(x)
            outs.append(b)
        # origin: the rank whose original tensors this rank now holds
        # (every rank follows the same permutation, so each can tell).
        origin = list(range(n))
        hops = []
        for _ in range(1, n):
            recv = [torch.empty_like(x) for x in rots]
            ops = ([dist.P2POp(dist.isend, x, to) for x in rots]
                   + [dist.P2POp(dist.irecv, v, frm) for v in recv])
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            rots = recv
            held = list(origin)
            for s, d in perm:
                held[d] = origin[s]
            origin = held
            hops.append(perm)
            for b, x in zip(outs, rots):
                b[origin[r]].copy_(x)
        self.ring_hops = tuple(hops)
        return tuple(b.to(torch.bool) if x.dtype == torch.bool else b
                     for b, x in zip(outs, p))

    def gather(self, parts, ring: bool = False) -> tuple[torch.Tensor, ...]:
        return self.ring_all_gather(parts) if ring else self.all_gather(parts)


def rank_device(device="cuda") -> torch.device:
    """The device of this rank's shard: ``device`` itself when it names
    an index or the CPU, else the current card, which
    :func:`init_distributed` made the rank's own."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def global_pool_mesh(device="cuda") -> ProcessMesh:
    """The pool mesh over every rank of the joined group (call after
    :func:`init_distributed`); this rank's shard lives on
    ``rank_device(device)``: on CUDA the rank's own card."""
    if not process_group_active():
        raise RuntimeError("global_pool_mesh needs a joined process group "
                           "(init_distributed)")
    return ProcessMesh(rank_device(device))
