"""``GpuEngine.spans["restore_s"]``, all of ``restore_columns`` (the refills:
dedupe, allocation, packing, admission), gained over the timed window,
divided by the windows it finalized in that time (``spans["windows"]``; ms).
Nothing where the program has no such span."""


def read(rec):
    w = rec.spans.get("windows", 0)
    s = rec.spans.get("restore_s")
    return s / w * 1e3 if w and s is not None else None
