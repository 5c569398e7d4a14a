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

``MM_DCN_AUTO`` (the JAX package's TPU-pod auto-detection from the TPU
metadata server) has no CUDA counterpart and is refused.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch


def _auto_requested() -> bool:
    return os.environ.get("MM_DCN_AUTO", "").strip().lower() in (
        "1", "true", "yes", "on")


def dcn_configured() -> bool:
    """True when the environment names a multi-host topology: a
    coordinator (``MM_DCN_COORDINATOR``) or the TPU-pod opt-in
    ``MM_DCN_AUTO`` (which ``init_distributed`` refuses)."""
    return bool(os.environ.get("MM_DCN_COORDINATOR") or _auto_requested())


def cpu_collectives_supported() -> bool:
    """True when this PyTorch carries gloo, the CPU collectives a process
    group over CPU processes needs."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_gloo_available()


def process_group_active() -> bool:
    """A process group has been joined (and not torn down)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def local_card(rank: int, n_cards: int) -> int:
    """The CUDA index of ``rank``'s card on its host: ``LOCAL_RANK`` when
    set, else ``rank`` modulo the ``n_cards`` visible. Raises when no card
    is visible or ``LOCAL_RANK`` names one past them."""
    if n_cards < 1:
        raise RuntimeError("a process group over CUDA needs a visible card")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return rank % n_cards
    if not 0 <= int(local) < n_cards:
        raise ValueError(f"LOCAL_RANK={local} but {n_cards} cards are "
                         f"visible to this process")
    return int(local)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     *, device="cuda") -> tuple[int, int]:
    """Join the process group; returns (rank, world size). Explicit
    arguments win over the ``MM_DCN_*`` variables. The backend is NCCL on
    CUDA and gloo on the CPU (``device``); on CUDA the process's current
    card becomes the rank's own (:func:`local_card`) before it joins. A
    second call returns the group already joined."""
    import torch.distributed as dist

    if process_group_active():
        return dist.get_rank(), dist.get_world_size()
    if _auto_requested() and not (coordinator_address
                                  or os.environ.get("MM_DCN_COORDINATOR")):
        raise ValueError(
            "MM_DCN_AUTO asks for TPU-pod auto-detection from the TPU "
            "metadata server, which has no CUDA counterpart: name the "
            "topology with MM_DCN_COORDINATOR, MM_DCN_NUM_PROCESSES and "
            "MM_DCN_PROCESS_ID")
    coordinator_address = coordinator_address or os.environ.get(
        "MM_DCN_COORDINATOR")
    if num_processes is None and os.environ.get("MM_DCN_NUM_PROCESSES"):
        num_processes = int(os.environ["MM_DCN_NUM_PROCESSES"])
    if process_id is None and os.environ.get("MM_DCN_PROCESS_ID"):
        process_id = int(os.environ["MM_DCN_PROCESS_ID"])
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
                                         torch.cuda.device_count()))
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
