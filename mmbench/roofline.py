"""The least time ``block_best`` could take on a window, from the work the
window's inputs need (not from the kernel's launch shape).

Work: for each valid lane, the waiting players it may match (active, not
its own slot, within both effective thresholds), each scored once. The
count comes from the reference's replay of the run (``reference.admissible``
on the reference's own pool at that window), so it reads the same whatever
kernel does the scoring: a kernel that skips blocks does no less work
than this.

Bytes: the window's lane columns and the pool's columns read once each,
each output (a score and a slot per lane and pool block) written once.

Peaks are the H100 SXM's published dense rates (NVIDIA's data sheet, at
700 W): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_S = 3.35e12

#: Operations per admissible (lane, slot) pair: the distance (sub, abs),
#: the two threshold tests, and the running best (compare, select).
OPS_PAIR_ELO = 6
#: Glicko-2 adds the factor: two squares, add, mul, add, sqrt, div, mul.
OPS_PAIR_GLICKO2 = 8
#: The widened threshold of one lane or slot: sub, max, mul, add, min.
OPS_WIDEN = 5

#: Bytes a lane reads: slot, rating, threshold, enqueue time (4 each) and
#: its valid flag (1); Glicko-2 adds the deviation.
LANE_BYTES = 17
#: Bytes a pool slot reads: rating, threshold, enqueue time, active.
SLOT_BYTES = 13
RD_BYTES = 4
#: Bytes written per lane and pool block: a score and a slot.
OUT_BYTES = 8


def step_work(pairs: int, lanes: int, slots: int, n_blocks: int, *,
              glicko2: bool, widen: bool) -> tuple[float, float]:
    """(operations, bytes) one step needs: ``pairs`` admissible pairs of
    ``lanes`` valid lanes against a pool of ``slots`` slots in
    ``n_blocks`` blocks."""
    ops = pairs * (OPS_PAIR_ELO + (OPS_PAIR_GLICKO2 if glicko2 else 0))
    if widen:
        ops += (lanes + slots) * OPS_WIDEN
    rd = RD_BYTES if glicko2 else 0
    nbytes = (lanes * (LANE_BYTES + rd) + slots * (SLOT_BYTES + rd)
              + lanes * n_blocks * OUT_BYTES)
    return float(ops), float(nbytes)


def least_time(ops: float, nbytes: float) -> tuple[float, str]:
    """The least seconds at the peaks, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
