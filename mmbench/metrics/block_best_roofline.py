"""``block_best``'s share of its roofline in the traced slice (%): the
least time the work of a step needs at the H100's peaks (``roofline.py``:
the admissible pairs the reference counts on its own pool, the columns
read once, the outputs written once), over the time the profiler gives a
launch of ``prep_kernel`` plus ``block_best_kernel``. Which of the two
bounds it goes into the run's notes."""

from mmbench import roofline


def read(rec):
    sl = rec.slice
    if sl is None or not rec.work:
        return None
    kernels = sl["block_best"].values()
    if any(k["count"] == 0 for k in kernels):
        return None
    per_launch = sum(k["s"] / k["count"] for k in kernels)
    g = rec.geometry
    least = [roofline.least_time(*roofline.step_work(
        pairs, lanes, g["capacity"], g["n_blocks"], glicko2=g["glicko2"],
        widen=g["widen"])) for _, pairs, lanes in rec.work]
    by = [b for _, b in least]
    rec.notes["block_best_bound"] = max(set(by), key=by.count)
    rec.notes["block_best_least_us"] = sum(t for t, _ in least) / len(least) * 1e6
    rec.notes["block_best_launch_us"] = per_launch * 1e6
    return 100.0 * (sum(t for t, _ in least) / len(least)) / per_launch
