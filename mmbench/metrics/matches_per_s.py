"""Matches formed in the timed window (windows and rescan ticks), per second
of the window: from the first hand-off to the last answer."""


def read(rec):
    return rec.matches / rec.window_s if rec.window_s > 0 else None
