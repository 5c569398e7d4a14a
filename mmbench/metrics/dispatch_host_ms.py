"""``GpuEngine.spans["dispatch_s"]`` gained over the timed window, divided
by the windows it finalized in that time (``spans["windows"]``; ms)."""


def read(rec):
    w = rec.spans.get("windows", 0)
    return rec.spans["dispatch_s"] / w * 1e3 if w else None
