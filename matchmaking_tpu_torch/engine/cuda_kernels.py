"""The hand-written Hopper kernel of the window step, and its plain twin.

``block_best`` is the candidate stage of the 1v1 window step: for every
request row and every ``pool_block``-wide pool block, the best valid
candidate's score (``-distance``) and slot. It replaces the JAX package's
Pallas kernel ``pallas_kernels.pallas_block_best``; the CUDA source is
``csrc/block_best.cu`` (see its header for the design and what bounds it).

- ``block_best_reference`` is the plain PyTorch version: the same
  arithmetic, one op at a time, then ``max``/``argmax`` per block. The CPU
  tests use it, ``chip_smoke.py`` holds the kernel bit-equal to it on the
  card, and the wrapper takes it only for tensors that lie on the CPU.
- ``block_best`` is the wrapper: it checks devices, dtypes, shapes and
  contiguity, and for CUDA tensors launches the kernel on the current
  stream (or raises). Each launch adds one to ``LAUNCHES["block_best"]``.
- ``plan_grid`` chooses the launch from the window: rows per CTA and the
  thread block cluster that splits each pool block's slots. It is plain
  Python so that the CPU tests reach it; the SM count comes from the card.
- The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
  ``build/torch_kernels/<hash of source and flags>/`` under the repository
  root (``MM_KERNEL_BUILD_DIR`` overrides), and loaded with ``ctypes``.

The pool is passed as its SoA columns (``POOL_FIELDS``, active as bool);
the window as its own columns plus the pre-widened request thresholds.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import struct
import subprocess
import tempfile
import threading
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

#: Kernel launches by kernel name (only real launches count: the plain
#: version and CPU calls never touch this).
LAUNCHES: dict[str, int] = {"block_best": 0}

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "block_best.cu"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
_lib = None
_lib_lock = threading.Lock()

_POOL_COLS = (("rating", torch.float32), ("rd", torch.float32),
              ("region", torch.int32), ("mode", torch.int32),
              ("threshold", torch.float32), ("enqueue_t", torch.float32),
              ("active", torch.bool))
_BATCH_COLS = (("slot", torch.int32), ("rating", torch.float32),
               ("rd", torch.float32), ("region", torch.int32),
               ("mode", torch.int32), ("valid", torch.bool))

#: Arithmetic operations per evaluated (row, slot) pair, as the kernel does
#: them (|Δ|: sub, abs; limit: min; tests: ≤, ≠ self, two ands; score: neg;
#: running best: >, and, two selects) — the count behind the bound that
#: ``chip_smoke.py`` reports. Filters add three compares and two ors per
#: axis plus two ands; Glicko-2 adds add, mul, add, sqrt, div, mul.
OPS_PER_PAIR_BASE = 11
OPS_PER_PAIR_FILTERS = 12
OPS_PER_PAIR_GLICKO2 = 6


def ops_per_pair(*, glicko2: bool, filters: bool) -> int:
    return (OPS_PER_PAIR_BASE + (OPS_PER_PAIR_FILTERS if filters else 0)
            + (OPS_PER_PAIR_GLICKO2 if glicko2 else 0))


#: The kernel's CTA (csrc/block_best.cu) is 8 warps of 8 request rows each;
#: a CTA holds one of ROWS_PER_CTA rows, and the warps that hold no rows of
#: their own split the candidates.
ROWS_PER_CTA = (8, 16, 32, 64)
#: Each pool block's records start on a multiple of this many slots in the
#: scratch (the bulk copies need 16-B aligned addresses); kAlign in the .cu.
RECORD_ALIGN = 16


class GridPlan(NamedTuple):
    rows_per_cta: int       # request rows per CTA
    cluster: int            # CTAs that split one pool block's slots
    grid: tuple[int, int]   # (n_blocks * cluster, row groups)


def record_stride(pool_block: int) -> int:
    """Slots per pool block in the record scratch."""
    return -(-pool_block // RECORD_ALIGN) * RECORD_ALIGN


def _can_split(pool_block: int, cluster: int) -> bool:
    return (pool_block % cluster == 0
            and (pool_block // cluster) % RECORD_ALIGN == 0)


#: plan_grid's moves, in order: one cluster split first (it keeps 64 rows
#: of reuse per staged record), then fewer rows per CTA down to 16, then
#: larger clusters (8 CTAs is the portable limit), then 8 rows. The order
#: comes from timing every plan of every variant on the card
#: (``chip_smoke.py --plan-sweep``).
PLAN_MOVES = (("cluster", 2), ("rows", 32), ("rows", 16), ("cluster", 4),
              ("cluster", 8), ("rows", 8))


@lru_cache(maxsize=None)
def plan_grid(n_rows: int, n_blocks: int, pool_block: int,
              sm_count: int) -> GridPlan:
    """The launch for one window. Start from the fewest rows per CTA that
    hold the window (no more than 64) and no cluster; while the grid has
    fewer than two CTAs per SM, take the next of ``PLAN_MOVES`` that
    applies (a cluster split only while every slice stays a multiple of
    ``RECORD_ALIGN`` slots). Below two CTAs per SM, where they land on
    the SMs decides the time: on the H100 a 256-CTA grid ran up to 1.9x
    slower than a 512-CTA one at B = 1,024."""
    rows = ROWS_PER_CTA[0]
    while rows < ROWS_PER_CTA[-1] and rows < n_rows:
        rows *= 2
    cluster = 1

    def groups() -> int:
        return -(-n_rows // rows)

    for kind, value in PLAN_MOVES:
        if n_blocks * cluster * groups() >= 2 * sm_count:
            break
        if kind == "rows":
            rows = min(rows, value)
        elif _can_split(pool_block, value):
            cluster = max(cluster, value)
    return GridPlan(rows, cluster, (n_blocks * cluster, groups()))


@lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def build_dir() -> Path:
    override = os.environ.get("MM_KERNEL_BUILD_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the block_best kernel is built "
                           "from csrc/ at first use and needs the CUDA toolkit")
    return found


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/block_best.cu`` (once per source/flags hash) and
    return the shared library's path. ``verbose`` adds ``-Xptxas -v`` and
    returns after printing the compiler's register/shared-memory report."""
    src = _SRC.read_bytes()
    flags = _NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = build_dir() / key
    so = out_dir / "libblock_best.so"
    if so.exists() and not verbose:
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *flags, "-o", tmp, str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.block_best_launch
            fn.argtypes = ([ctypes.c_void_p] * 18
                           + [ctypes.c_int] * 6 + [ctypes.c_float]
                           + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


_F32 = struct.Struct("f")


def _f32(x: float) -> float:
    """Round a Python float to the nearest f32 (what the kernel receives),
    as a cast to torch.float32 does, without making a tensor."""
    try:
        return _F32.unpack(_F32.pack(x))[0]
    except OverflowError:  # rounds past the largest finite f32
        return math.copysign(math.inf, x)


def effective_threshold(thr, enqueue_t, now: float, widen_per_sec: float,
                        max_threshold: float):
    """Threshold widening by wait time, one rounded f32 op at a time:
    ``min(max_thr, thr + widen · max(0, now − enqueue_t))``."""
    if widen_per_sec <= 0.0:
        return thr
    waited = (_f32(now) - enqueue_t).clamp_min(0.0)
    return (thr + _f32(widen_per_sec) * waited).clamp_max(_f32(max_threshold))


def block_best_reference(pool: dict, batch: dict, q_thr_eff, now: float, *,
                         pool_block: int, glicko2: bool, filters: bool,
                         widen_per_sec: float, max_threshold: float,
                         g_coeff: float):
    """Plain PyTorch version of the kernel: (vals f32[B, n_blocks],
    idx i32[B, n_blocks]), one (B, pool_block) score tile per block."""
    capacity = pool["rating"].shape[0]
    n_blocks = capacity // pool_block
    c_thr = effective_threshold(pool["threshold"], pool["enqueue_t"], now,
                                widen_per_sec, max_threshold)
    g = _f32(g_coeff)
    q_rating = batch["rating"][:, None]
    q_rd2 = (batch["rd"] * batch["rd"])[:, None]
    q_thr = q_thr_eff[:, None]
    q_ok = batch["valid"][:, None]
    q_slot = batch["slot"][:, None]
    q_reg, q_mode = batch["region"][:, None], batch["mode"][:, None]
    vals, idxs = [], []
    for j in range(n_blocks):
        sl = slice(j * pool_block, (j + 1) * pool_block)
        d = (q_rating - pool["rating"][None, sl]).abs()
        if glicko2:
            c_rd = pool["rd"][sl]
            rd2 = q_rd2 + (c_rd * c_rd)[None, :]
            d = d * (1.0 / torch.sqrt(1.0 + g * rd2))
        gidx = torch.arange(j * pool_block, (j + 1) * pool_block,
                            dtype=torch.int32, device=d.device)
        valid = (pool["active"][None, sl] & q_ok & (q_slot != gidx[None, :])
                 & (d <= torch.minimum(q_thr, c_thr[None, sl])))
        if filters:
            c_reg, c_mode = pool["region"][None, sl], pool["mode"][None, sl]
            valid = (valid & ((q_reg == 0) | (c_reg == 0) | (q_reg == c_reg))
                     & ((q_mode == 0) | (c_mode == 0) | (q_mode == c_mode)))
        scores = torch.where(valid, -d, torch.full_like(d, float("-inf")))
        a = scores.argmax(dim=1)
        v = scores.gather(1, a[:, None])[:, 0]
        vals.append(v)
        idxs.append(torch.where(v > float("-inf"),
                                (a + j * pool_block).to(torch.int32),
                                torch.full_like(a, capacity, dtype=torch.int32)))
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _check(pool: dict, batch: dict, q_thr_eff, pool_block: int):
    capacity = pool["rating"].shape[0]
    if pool_block <= 0 or capacity % pool_block != 0:
        raise ValueError(f"pool_block {pool_block} must divide the capacity "
                         f"{capacity}")
    device = pool["rating"].device
    n_rows = batch["rating"].shape[0]
    for what, src, cols, n in (("pool", pool, _POOL_COLS, capacity),
                               ("batch", batch, _BATCH_COLS, n_rows)):
        for name, dtype in cols:
            t = src[name]
            if t.device != device or t.dtype != dtype or t.shape != (n,) \
                    or not t.is_contiguous():
                raise ValueError(
                    f"{what}[{name!r}] must be a contiguous {dtype} tensor of "
                    f"shape ({n},) on {device}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    if q_thr_eff.device != device or q_thr_eff.dtype != torch.float32 \
            or q_thr_eff.shape != (n_rows,) or not q_thr_eff.is_contiguous():
        raise ValueError("q_thr_eff must be a contiguous f32 tensor shaped "
                         "like the batch, on the pool's device")
    return device, capacity, n_rows


def block_best(pool: dict, batch: dict, q_thr_eff, now: float, *,
               pool_block: int, glicko2: bool, filters: bool,
               widen_per_sec: float, max_threshold: float, g_coeff: float):
    """Best candidate per pool block: (vals f32[B, n_blocks], idx
    i32[B, n_blocks]); -inf / ``capacity`` where a block has none.

    CUDA tensors launch the ``csrc/block_best.cu`` kernels (record prep,
    then the scorer, planned by ``plan_grid``) on the current stream; CPU
    tensors take ``block_best_reference``. Nothing falls back: a kernel that
    cannot build or launch raises."""
    device, capacity, n_rows = _check(pool, batch, q_thr_eff, pool_block)
    kw = dict(pool_block=pool_block, glicko2=glicko2, filters=filters,
              widen_per_sec=widen_per_sec, max_threshold=max_threshold,
              g_coeff=g_coeff)
    if device.type == "cpu":
        return block_best_reference(pool, batch, q_thr_eff, now, **kw)
    if device.type != "cuda":
        raise ValueError(f"block_best runs on cuda or cpu tensors, not {device}")
    n_blocks = capacity // pool_block
    plan = plan_grid(n_rows, n_blocks, pool_block,
                     sm_count(device.index if device.index is not None
                              else torch.cuda.current_device()))
    return _launch(plan, pool, batch, q_thr_eff, now, **kw)


def _launch(plan: GridPlan, pool: dict, batch: dict, q_thr_eff, now: float,
            *, pool_block: int, glicko2: bool, filters: bool,
            widen_per_sec: float, max_threshold: float, g_coeff: float):
    """Launch the kernels with the given plan on inputs that ``_check``
    passed, all on one CUDA device (``block_best``'s launch; ``chip_smoke.py
    --plan-sweep`` times every plan through it)."""
    lib = _load()
    device = pool["rating"].device
    capacity, n_rows = pool["rating"].shape[0], batch["rating"].shape[0]
    n_blocks = capacity // pool_block
    out_v = torch.empty((n_rows, n_blocks), dtype=torch.float32, device=device)
    out_i = torch.empty((n_rows, n_blocks), dtype=torch.int32, device=device)
    # Per-slot records, in one scratch: (rating, threshold) as 8 B a slot,
    # then, for the Glicko-2 and filter instances, 16 B of (rd², region,
    # mode). n_rec is a multiple of RECORD_ALIGN, so the second part starts
    # 128-B aligned.
    n_rec = n_blocks * record_stride(pool_block)
    extra = glicko2 or filters
    rec = torch.empty(n_rec * (24 if extra else 8), dtype=torch.uint8,
                      device=device)
    with torch.cuda.device(device):  # the launch targets the current device
        rc = lib.block_best_launch(
            pool["rating"].data_ptr(), pool["rd"].data_ptr(),
            pool["region"].data_ptr(), pool["mode"].data_ptr(),
            pool["threshold"].data_ptr(), pool["enqueue_t"].data_ptr(),
            pool["active"].data_ptr(),
            batch["slot"].data_ptr(), batch["rating"].data_ptr(),
            batch["rd"].data_ptr(), q_thr_eff.data_ptr(),
            batch["region"].data_ptr(), batch["mode"].data_ptr(),
            batch["valid"].data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), rec.data_ptr(),
            rec.data_ptr() + 8 * n_rec if extra else None,
            n_rows, n_blocks, pool_block, capacity, plan.rows_per_cta,
            plan.cluster, _f32(now),
            int(glicko2), int(filters), _f32(widen_per_sec),
            _f32(max_threshold), _f32(g_coeff),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_best launch failed: CUDA error {rc}")
    LAUNCHES["block_best"] += 1
    return out_v, out_i
