"""The traced slice: ``torch.profiler`` over a short run of windows after
the timed window, read into what the device did and when it sat idle.

The harness marks what it is doing with ``record_function`` ranges named
``mm.<phase>`` (dispatch, collect, refill, rescan) inside one ``mm.slice``
range; the profiler puts them on the clock of the device's records, so
each idle gap of the device is labelled with the phase that overlaps it
most ("loop" where none does).
"""

from __future__ import annotations

import contextlib

#: Kernels of ``csrc/block_best.cu``, as the profiler names them.
BLOCK_BEST_KERNELS = ("prep_kernel", "block_best_kernel")


def _is_device(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def _span(ev) -> tuple[float, float]:
    tr = ev.time_range
    return float(tr.start), float(tr.end)


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events, steps: int) -> dict | None:
    """What the slice's profiler records say (times in seconds), or None
    when they hold no device operation or no ``mm.slice`` range."""
    slice_span = None
    phases: list[tuple[float, float, str]] = []
    device: list[tuple[float, float, str]] = []
    for ev in events:
        name = ev.name
        if _is_device(ev) and not name.startswith("mm."):
            # (the profiler also draws each mm.* range on the device's
            # timeline: that is no device work)
            a, b = _span(ev)
            if b > a:
                device.append((a, b, name))
        elif _is_device(ev):
            continue
        elif name == "mm.slice":
            slice_span = _span(ev)
        elif name.startswith("mm."):
            a, b = _span(ev)
            phases.append((a, b, name[3:]))
    if slice_span is None or not device:
        return None
    s0, s1 = slice_span
    device = [(max(a, s0), min(b, s1), n) for a, b, n in device
              if b > s0 and a < s1]
    busy = _union([(a, b) for a, b, _ in device])
    busy_us = sum(b - a for a, b in busy)
    kernel_us = sum(b - a for a, b, n in device
                    if not n.startswith(("Memcpy", "Memset")))
    by_name: dict[str, float] = {}
    for a, b, n in device:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    bb = {k: [0.0, 0] for k in BLOCK_BEST_KERNELS}
    for a, b, n in device:
        for k in BLOCK_BEST_KERNELS:
            if k in n:
                bb[k][0] += b - a
                bb[k][1] += 1
    gaps = []
    edges = [s0] + [x for span in busy for x in span] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        best, label = 0.0, "loop"
        for pa, pb, pname in phases:
            ov = min(b, pb) - max(a, pa)
            if ov > best:
                best, label = ov, pname
        gaps.append((b - a, label))
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (s1 - s0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": kernel_us / 1e6,
        "steps": steps,
        "block_best": {k: {"s": v[0] / 1e6, "count": v[1]}
                       for k, v in bb.items()},
        "device_ops": [[n[:64], s / 1e6] for n, s in top],
        "idle_gaps": [[label, s / 1e6] for s, label in gaps[:10]],
    }


class Tracer:
    """The profiler over the slice; ``phase(name)`` marks the harness's
    work inside it (a no-op before ``start`` and after ``stop``)."""

    def __init__(self) -> None:
        self.prof = None
        self._slice = None
        self.on = False

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._slice = torch.profiler.record_function("mm.slice")
        self._slice.__enter__()
        self.on = True

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.on = False
        self._slice.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def phase(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"mm.{name}")

    def summary(self, steps: int) -> dict | None:
        return summarize(self.prof.events(), steps)
