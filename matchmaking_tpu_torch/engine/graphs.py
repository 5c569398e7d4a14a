"""The window step as one CUDA graph per (step variant, bucket).

The JAX package jits each packed step variant once per batch bucket
(``KernelSet.search_step_packed``, ``_nofilter`` and ``_rescan``; the team
and role ``search_step_packed``) and runs a window as one call of that
executable. The port's counterpart is a captured ``torch.cuda.CUDAGraph``
per (variant, bucket): the step's few hundred kernels, ``block_best`` and
``quality_accum`` among them, are queued once at capture, and a window is
one copy of its packed rows into the graph's static input, one replay and
one copy of the static output. Each capture is counted, with its host
seconds, in ``utils/metrics.CompileCounter``.

``StepGraphs`` keeps an engine's graphs. A graph is captured on its first
use, as JAX compiles on first use, or by ``GpuEngine.warmup`` for every
(variant, bucket) ahead of traffic. A failed capture raises: there is no
eager fallback on the card.

A replay sees nothing of the host, so what a step would otherwise do or
read there is carried by hand:

- **The window's time** is read on the device, from the packed window's
  last row (``kernels.packed_now``), by every stage of the step.
- **The static output** is copied out right after each replay, before
  anything else is queued: the engine queues its copy to the host there
  and then, since the next replay of the same graph (a later chunk of one
  window) writes the same memory.
- **Host counters.** A capture runs the step's Python once without running
  its kernels: the kernel launch counts (``cuda_kernels.LAUNCHES``) and the
  pruned step's ``pruned_steps`` it adds are taken back, and each replay
  adds them again, since each replay launches those kernels and runs that
  step. The warm-up before it counts as no pruned window either
  (``uncounted``).
- **Lazy device state** (the pruned step's ``span_steps`` counter, the role
  step's constant tables, each kernel library) is made by one eager run of
  the step before its capture, on a side stream, as PyTorch's graph rules
  ask. That run reads an all-padding window; for team and role steps, which
  form matches pool-wide, it runs on a scratch pool of the same geometry.
- **Addresses.** A graph holds the addresses of the pool's columns and of
  the quality state. Admission and eviction write them in place, so they
  hold; ``GpuEngine`` drops every graph when it replaces its device pool.

Each graph keeps its own private memory pool (its intermediates and its
static output); ``report()`` gives each graph's capture time and memory.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from matchmaking_tpu_torch.engine import cuda_kernels
from matchmaking_tpu_torch.utils.metrics import CompileCounter

#: A step as a graph runs it: (device pool, packed window) → the result.
StepFn = Callable[[dict, torch.Tensor], torch.Tensor]


def uncounted(ks):
    """``ks.uncounted()`` (the 1v1 kernel set's: steps run inside count as
    no pruned window), or nothing for a kernel set without counters."""
    return ks.uncounted() if hasattr(ks, "uncounted") else contextlib.nullcontext()


@dataclass
class StepGraph:
    """One captured step: its graph, static input and output, and what each
    replay adds to the host counters."""

    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    #: Kernel launches per replay, by kernel name (cuda_kernels.LAUNCHES).
    launches: dict[str, int]
    #: The kernel set's ``pruned_steps`` per replay (1 for a pruned step).
    pruned_steps: int
    #: Host ms of the eager run before the capture, and of the capture.
    warm_ms: float
    capture_ms: float
    #: Bytes the capture added to the device's reserved memory: the
    #: graph's private pool.
    memory_bytes: int
    replays: int = 0


@dataclass
class StepGraphs:
    """The captured steps of one engine, by (variant, bucket)."""

    kernels: object
    device: torch.device
    graphs: dict[tuple[str, int], StepGraph] = field(default_factory=dict)
    #: Captures made since the engine was built (graphs dropped included).
    captures: int = 0

    def get(self, variant: str, bucket: int) -> StepGraph | None:
        return self.graphs.get((variant, bucket))

    def clear(self) -> None:
        """Drop every graph (the pool they read is being replaced)."""
        self.graphs.clear()

    def capture(self, variant: str, bucket: int, fn: StepFn, pool: dict,
                empty: torch.Tensor, warm_pool: dict) -> StepGraph:
        """Capture ``fn(pool, static_in)`` for one (variant, bucket).
        ``empty`` is the bucket's all-padding packed window (a pinned host
        tensor): it fills the static input for one eager run of ``fn`` on
        ``warm_pool`` before the capture. Raises if the capture fails."""
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        ks = self.kernels
        static_in = torch.empty(empty.shape, dtype=empty.dtype, device=dev)
        with torch.cuda.stream(side), uncounted(ks):
            t = time.perf_counter()
            static_in.copy_(empty, non_blocking=True)
            fn(warm_pool, static_in)
            warm_ms = (time.perf_counter() - t) * 1e3
            launches0 = dict(cuda_kernels.LAUNCHES)
            pruned0 = getattr(ks, "pruned_steps", 0)
            graph = torch.cuda.CUDAGraph()
            reserved0 = torch.cuda.memory_reserved(dev)
            t = time.perf_counter()
            # No cyclic collection during the capture: one that frees an
            # older engine's graphs destroys them (a CUDA call a capturing
            # stream forbids), which invalidates this capture.
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin()
                try:
                    static_out = fn(pool, static_in)
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            capture_ms = (time.perf_counter() - t) * 1e3
            memory = torch.cuda.memory_reserved(dev) - reserved0
            # The capture ran the step's Python but none of its kernels:
            # take its launch counts back (``uncounted`` takes back the
            # pruned counts); each replay adds them.
            launches = {k: v - launches0[k]
                        for k, v in cuda_kernels.LAUNCHES.items()}
            cuda_kernels.LAUNCHES.update(launches0)
            pruned = getattr(ks, "pruned_steps", 0) - pruned0
        cur.wait_stream(side)
        g = StepGraph(graph, static_in, static_out,
                      {k: n for k, n in launches.items() if n}, pruned,
                      warm_ms, capture_ms, memory)
        self.graphs[(variant, bucket)] = g
        self.captures += 1
        # The port's compile count (metrics' ``xla_compiles``), outside the
        # capture: the warm run and the capture, in seconds.
        CompileCounter.record((warm_ms + capture_ms) / 1e3)
        return g

    def replay(self, g: StepGraph) -> torch.Tensor:
        """Replay ``g`` on the current stream (its static input already
        holds the window) and return its static output, which the next
        replay of ``g`` overwrites: copy it out before then, on this
        stream."""
        g.graph.replay()
        for name, n in g.launches.items():
            cuda_kernels.LAUNCHES[name] += n
        if g.pruned_steps:
            self.kernels.pruned_steps += g.pruned_steps
        g.replays += 1
        return g.static_out

    def report(self) -> dict:
        """Per graph ("variant/bucket"): capture and warm-up host ms,
        private memory in bytes, replays; and the captures made."""
        return {"captures": self.captures, "graphs": {
            f"{v}/{b}": {"capture_ms": g.capture_ms, "warm_ms": g.warm_ms,
                         "memory_bytes": g.memory_bytes,
                         "replays": g.replays, "launches": g.launches}
            for (v, b), g in sorted(self.graphs.items())}}
