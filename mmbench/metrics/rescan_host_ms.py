"""The harness's clock around each ``rescan_async`` call of the timed
window, the mean per tick (ms); nothing where no tick ran."""


def read(rec):
    if not rec.rescan_s:
        return None
    return sum(rec.rescan_s) / len(rec.rescan_s) * 1e3
