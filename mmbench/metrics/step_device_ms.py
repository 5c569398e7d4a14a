"""Kernel time on the device in the traced slice (torch.profiler, the
replayed steps' kernels and the refills' admissions), per step handed over
in the slice (a window chunk or a rescan chunk; ms)."""


def read(rec):
    sl = rec.slice
    if sl is None or not sl["steps"] or sl["kernel_s"] <= 0:
        return None
    return sl["kernel_s"] / sl["steps"] * 1e3
