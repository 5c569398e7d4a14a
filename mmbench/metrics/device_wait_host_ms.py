"""``GpuEngine.spans["wait_s"]``, the host's wait for the device (from the
``collect_ready`` that first finds the oldest window not ready to the call
that finalizes it, and the blocking reads inside ``flush``), gained over the
timed window, divided by the windows it finalized in that time
(``spans["windows"]``; ms). Nothing where the program has no such span."""


def read(rec):
    w = rec.spans.get("windows", 0)
    s = rec.spans.get("wait_s")
    return s / w * 1e3 if w and s is not None else None
