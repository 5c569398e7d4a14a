"""The share of the traced slice's wall time in which no kernel, copy or
fill ran on the device (%): 1 - (union of the device's records) / (the
slice's length)."""


def read(rec):
    sl = rec.slice
    if sl is None or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
