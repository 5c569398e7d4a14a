"""Mean over every request answered in the timed window of the time from
its window's hand-off to ``search_columns_async`` to its answer in the
harness's hands (ms)."""


def read(rec):
    n = sum(k for k, _ in rec.latency_s)
    if not n:
        return None
    return sum(k * s for k, s in rec.latency_s) / n * 1e3
