"""The hand-written Hopper kernels of the port, and their plain twins.

``block_best`` is the candidate stage of the 1v1 window step: for every
request row and every ``pool_block``-wide pool block, the best valid
candidate's score (``-distance``) and slot. It replaces the JAX package's
Pallas kernel ``pallas_kernels.pallas_block_best``; the CUDA source is
``csrc/block_best.cu`` (see its header for the design and what bounds it).
Its span launch serves the rating-banded pruned step: each chunk of
``chunk_rows`` rating-sorted rows scores only its chunk's span of
``span_blocks`` blocks while the window is feasible (a device flag), and
every block otherwise.

``quality_accum`` folds one window's matches into the engine's
device-resident quality state (``csrc/quality_accum.cu``); it replaces the
XLA step ``kernels.QualityAccumKernel._accum`` of the JAX package. It reads
the window's time from the device (the packed window's ``now`` row).

- ``block_best_reference``, ``block_best_span_reference`` and
  ``quality_accum_reference`` are the plain PyTorch versions: the same
  arithmetic, one op at a time. The CPU tests use them, ``chip_smoke.py``
  holds the kernels to them on the card, and the wrappers take them only
  for tensors that lie on the CPU.
- ``block_best`` and ``QualityAccum`` are the wrappers: they check
  devices, dtypes, shapes and contiguity and call the kernel's operator,
  ``torch.ops.mm_torch.block_best`` (the span launch included) or
  ``torch.ops.mm_torch.quality_accum`` (which mutates the state): one node
  in a ``make_fx`` trace on either device. The operator's CUDA kernel
  launches the kernel on the current stream (or raises), its CPU kernel
  is the plain version, no other device has one. ``QualityAccum`` is
  bound to one state and pool: it checks them once, and per call checks
  only the window's result; the operator's CUDA kernel takes their
  pointers once (``_bind``). Each launch adds one to ``LAUNCHES[name]``.
- ``plan_grid`` chooses ``block_best``'s launch from the window: rows per
  CTA and the thread block cluster that splits each pool block's slots. It
  is plain Python so that the CPU tests reach it; the SM count comes from
  the card.
- Each kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
  ``build/torch_kernels/<hash of source and flags>/`` under the repository
  root (``MM_KERNEL_BUILD_DIR`` overrides), one library per source, and
  loaded with ``ctypes``.

The pool is passed as its SoA columns (``POOL_FIELDS``, active as bool);
the window as its own columns plus the pre-widened request thresholds, and
its time as a one-element f32 tensor on the card, which both kernels read
there (a launch captured into a CUDA graph reads each replay's own).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
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
#: versions and CPU calls never touch this).
LAUNCHES: dict[str, int] = {"block_best": 0, "quality_accum": 0}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: The kernel sources: name → file under csrc/ (one library each).
SOURCES = {"block_best": "block_best.cu", "quality_accum": "quality_accum.cu"}
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
#: The libraries' launch functions by symbol, loaded at first use.
_launchers: dict[str, ctypes._CFuncPtr] = {}
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
              sm_count: int, chunk_rows: int = 0) -> GridPlan:
    """The launch for one window. Start from the fewest rows per CTA that
    hold the window (no more than 64, and for a span launch dividing its
    ``chunk_rows`` where it can, so that a CTA's rows share one span) and
    no cluster; while the grid has
    fewer than two CTAs per SM, take the next of ``PLAN_MOVES`` that
    applies (a cluster split only while every slice stays a multiple of
    ``RECORD_ALIGN`` slots). Below two CTAs per SM, where they land on
    the SMs decides the time: on the H100 a 256-CTA grid ran up to 1.9x
    slower than a 512-CTA one at B = 1,024."""
    rows = ROWS_PER_CTA[0]
    while rows < ROWS_PER_CTA[-1] and rows < n_rows:
        rows *= 2
    while chunk_rows and rows > ROWS_PER_CTA[0] and chunk_rows % rows:
        rows //= 2
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
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ at first use and need the CUDA toolkit")
    return found


def build(name: str = "block_best") -> Path:
    """Compile ``csrc/<SOURCES[name]>`` (once per source/flags hash) and
    return the shared library's path."""
    return _compile(name, False)[0]


def compile_report(name: str) -> tuple[Path, str]:
    """Compile kernel ``name`` with ``-Xptxas -v`` into its usual library
    path: (the library, the compiler's register/shared-memory report).
    Safe to run for several kernels side by side (one nvcc each)."""
    return _compile(name, True)


def _compile(name: str, report: bool) -> tuple[Path, str]:
    src_path = _CSRC / SOURCES[name]
    src = src_path.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir() / key
    so = out_dir / f"lib{name}.so"
    if so.exists() and not report:
        return so, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    flags = _NVCC_FLAGS + (("-Xptxas", "-v") if report else ())
    cmd = [_nvcc(), *flags, "-o", tmp, str(src_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src_path.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so, proc.stderr


#: ctypes argument types of each library's launch function.
_ARGTYPES = {
    "block_best": ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    # (out, b, now, the parameter block, stream); the empty kernel's too
    "quality_accum": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p],
}


def _load(name: str, symbol: str | None = None):
    """The launch function ``symbol`` (default ``<name>_launch``) of kernel
    ``name``'s library, built at first use."""
    symbol = symbol or f"{name}_launch"
    fn = _launchers.get(symbol)
    if fn is None:
        with _lib_lock:
            if symbol not in _launchers:
                fn = getattr(ctypes.CDLL(str(build(name))), symbol)
                fn.argtypes = _ARGTYPES[name]
                fn.restype = ctypes.c_int
                _launchers[symbol] = fn
            fn = _launchers[symbol]
    return fn


_F32 = struct.Struct("f")


def _f32(x: float) -> float:
    """Round a Python float to the nearest f32 (what the kernel receives),
    as a cast to torch.float32 does, without making a tensor."""
    try:
        return _F32.unpack(_F32.pack(x))[0]
    except OverflowError:  # rounds past the largest finite f32
        return math.copysign(math.inf, x)


def effective_threshold(thr, enqueue_t, now, widen_per_sec: float,
                        max_threshold: float):
    """Threshold widening by wait time, one rounded f32 op at a time:
    ``min(max_thr, thr + widen · max(0, now − enqueue_t))``. ``now`` is the
    window's time as a one-element f32 tensor on the columns' device (the
    packed window's now row), so that nothing is read on the host."""
    if widen_per_sec <= 0.0:
        return thr
    waited = (now - enqueue_t).clamp_min(0.0)
    return (thr + _f32(widen_per_sec) * waited).clamp_max(_f32(max_threshold))


def _block_scores(pool: dict, c_thr, batch: dict, q_thr_eff, j: int, *,
                  pool_block: int, glicko2: bool, filters: bool,
                  g_coeff: float):
    """The best candidate of ``batch``'s rows in pool block ``j``: (vals
    f32[rows], idx i32[rows]), -inf / ``capacity`` where none is valid —
    one (rows, pool_block) score tile, one f32 op at a time."""
    capacity = pool["rating"].shape[0]
    g = _f32(g_coeff)
    sl = slice(j * pool_block, (j + 1) * pool_block)
    d = (batch["rating"][:, None] - pool["rating"][None, sl]).abs()
    if glicko2:
        c_rd = pool["rd"][sl]
        rd2 = (batch["rd"] * batch["rd"])[:, None] + (c_rd * c_rd)[None, :]
        d = d * (1.0 / torch.sqrt(1.0 + g * rd2))
    gidx = torch.arange(j * pool_block, (j + 1) * pool_block,
                        dtype=torch.int32, device=d.device)
    valid = (pool["active"][None, sl] & batch["valid"][:, None]
             & (batch["slot"][:, None] != gidx[None, :])
             & (d <= torch.minimum(q_thr_eff[:, None], c_thr[None, sl])))
    if filters:
        q_reg, q_mode = batch["region"][:, None], batch["mode"][:, None]
        c_reg, c_mode = pool["region"][None, sl], pool["mode"][None, sl]
        valid = (valid & ((q_reg == 0) | (c_reg == 0) | (q_reg == c_reg))
                 & ((q_mode == 0) | (c_mode == 0) | (q_mode == c_mode)))
    scores = torch.where(valid, -d, torch.full_like(d, float("-inf")))
    a = scores.argmax(dim=1)
    v = scores.gather(1, a[:, None])[:, 0]
    return v, torch.where(v > float("-inf"),
                          (a + j * pool_block).to(torch.int32),
                          torch.full_like(a, capacity, dtype=torch.int32))


def block_best_reference(pool: dict, batch: dict, q_thr_eff, now, *,
                         pool_block: int, glicko2: bool, filters: bool,
                         widen_per_sec: float, max_threshold: float,
                         g_coeff: float):
    """Plain PyTorch version of the kernel: (vals f32[B, n_blocks],
    idx i32[B, n_blocks]), one (B, pool_block) score tile per block;
    ``now`` as ``block_best`` takes it."""
    n_blocks = pool["rating"].shape[0] // pool_block
    c_thr = effective_threshold(pool["threshold"], pool["enqueue_t"], now,
                                widen_per_sec, max_threshold)
    kw = dict(pool_block=pool_block, glicko2=glicko2, filters=filters,
              g_coeff=g_coeff)
    best = [_block_scores(pool, c_thr, batch, q_thr_eff, j, **kw)
            for j in range(n_blocks)]
    return (torch.stack([v for v, _ in best], dim=1),
            torch.stack([i for _, i in best], dim=1))


class Span(NamedTuple):
    """The span launch's arguments (the pruned step's candidate stage):
    rows ``[c·chunk_rows, (c+1)·chunk_rows)`` of the window score only
    blocks ``[span_start[c], span_start[c] + span_blocks)`` while
    ``feasible`` (a one-element bool tensor on the device) is set, and
    every block otherwise."""

    span_start: torch.Tensor  # i32[n_rows // chunk_rows]
    chunk_rows: int
    span_blocks: int
    feasible: torch.Tensor    # bool[1]


def block_best_span_reference(pool: dict, batch: dict, q_thr_eff,
                              now, span: Span, **kw):
    """Plain version of the span launch: ``block_best_reference``'s tiles
    for each chunk's span of blocks, -inf / ``capacity`` elsewhere; the
    dense result when ``span.feasible`` is unset (a host read: CPU
    tensors, or a comparison on the card)."""
    if not bool(span.feasible.reshape(())):
        return block_best_reference(pool, batch, q_thr_eff, now, **kw)
    capacity = pool["rating"].shape[0]
    pool_block = kw["pool_block"]
    n_rows = batch["rating"].shape[0]
    vals = torch.full((n_rows, capacity // pool_block), float("-inf"),
                      dtype=torch.float32, device=q_thr_eff.device)
    idxs = torch.full(vals.shape, capacity, dtype=torch.int32,
                      device=q_thr_eff.device)
    c_thr = effective_threshold(pool["threshold"], pool["enqueue_t"], now,
                                kw["widen_per_sec"], kw["max_threshold"])
    tile_kw = {k: kw[k] for k in ("pool_block", "glicko2", "filters",
                                  "g_coeff")}
    c = span.chunk_rows
    # The op's CPU kernel only, where no trace enters: the card kernel
    # reads span_start on the device.
    # matchlint: ignore[device] the CPU version's loop bounds
    for ci, start in enumerate(span.span_start.tolist()):
        rows = slice(ci * c, (ci + 1) * c)
        chunk = {k: batch[k][rows] for k in _BATCH_NAMES}
        for j in range(start, start + span.span_blocks):
            vals[rows, j], idxs[rows, j] = _block_scores(
                pool, c_thr, chunk, q_thr_eff[rows], j, **tile_kw)
    return vals, idxs


_POOL_NAMES = tuple(name for name, _ in _POOL_COLS)
_BATCH_NAMES = tuple(name for name, _ in _BATCH_COLS)
#: The operator's column arguments: the pool's, then the window's.
_N_COLS = len(_POOL_NAMES) + len(_BATCH_NAMES)


def _check(pool: dict, batch: dict, q_thr_eff, now, pool_block: int):
    capacity = pool["rating"].shape[0]
    if pool_block <= 0 or capacity % pool_block != 0:
        raise ValueError(f"pool_block {pool_block} must divide the capacity "
                         f"{capacity}")
    device = pool["rating"].device
    n_rows = batch["rating"].shape[0]
    for what, src, cols, n in (("pool", pool, _POOL_COLS, capacity),
                               ("batch", batch, _BATCH_COLS, n_rows)):
        for name, dtype in cols:
            _check_tensor(f"{what}[{name!r}]", src[name], dtype, (n,), device)
    _check_tensor("q_thr_eff", q_thr_eff, torch.float32, (n_rows,), device)
    _check_tensor("now", now, torch.float32, (1,), device)
    return device, capacity, n_rows


def _check_tensor(what: str, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}; got {type(t).__name__}")
    if t.device != device or t.dtype != dtype or t.shape != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_span(span: Span, n_rows: int, n_blocks: int, device) -> None:
    if span.chunk_rows <= 0 or n_rows % span.chunk_rows:
        raise ValueError(f"chunk_rows {span.chunk_rows} must divide the "
                         f"window's {n_rows} rows")
    if not 1 <= span.span_blocks <= n_blocks:
        raise ValueError(f"span_blocks {span.span_blocks} must lie in "
                         f"[1, {n_blocks}]")
    _check_tensor("span_start", span.span_start, torch.int32,
                  (n_rows // span.chunk_rows,), device)
    _check_tensor("feasible", span.feasible, torch.bool, (1,), device)


def block_best(pool: dict, batch: dict, q_thr_eff, now, *,
               pool_block: int, glicko2: bool, filters: bool,
               widen_per_sec: float, max_threshold: float, g_coeff: float,
               span: Span | None = None):
    """Best candidate per pool block: (vals f32[B, n_blocks], idx
    i32[B, n_blocks]); -inf / ``capacity`` where a block has none (or,
    with ``span``, lies outside the row's chunk span of a feasible
    window). ``now`` is the window's time as a one-element f32 tensor on
    the pool's device (the packed window's now row): the kernel reads it
    there, so a launch captured into a CUDA graph reads each replay's own.

    The call is one operator, ``torch.ops.mm_torch.block_best`` (one node
    in a trace). CUDA tensors launch the ``csrc/block_best.cu`` kernels
    (record prep, then the scorer, planned by ``plan_grid``) on the
    current stream; CPU tensors take ``block_best_reference``
    (``block_best_span_reference`` with ``span``). Nothing falls back: a
    kernel that cannot build or launch raises. The span launch reads
    ``span.feasible`` on the device: no host sync."""
    device, capacity, n_rows = _check(pool, batch, q_thr_eff, now, pool_block)
    n_blocks = capacity // pool_block
    if span is not None:
        _check_span(span, n_rows, n_blocks, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_best runs on cuda or cpu tensors, not {device}")
    return ops().block_best(*_op_args(
        pool, batch, q_thr_eff, now, span, pool_block, glicko2, filters,
        widen_per_sec, max_threshold, g_coeff))


def _op_args(pool: dict, batch: dict, q_thr_eff, now, span: Span | None,
             *flags) -> tuple:
    """``block_best``'s arguments in the operator's order: the pool's
    ``_POOL_COLS``, the window's ``_BATCH_COLS``, the widened thresholds
    and ``now``, the span launch's (None, None, 0, 0 for the dense
    launch), then ``flags`` (pool_block, glicko2, filters, widen_per_sec,
    max_threshold, g_coeff)."""
    return (*(pool[name] for name in _POOL_NAMES),
            *(batch[name] for name in _BATCH_NAMES), q_thr_eff, now,
            *((None, None, 0, 0) if span is None else
              (span.span_start, span.feasible, span.chunk_rows,
               span.span_blocks)), *flags)


def _launch(plan: GridPlan, pool: dict, batch: dict, q_thr_eff, now,
            *, pool_block: int, glicko2: bool, filters: bool,
            widen_per_sec: float, max_threshold: float, g_coeff: float,
            span: Span | None = None):
    """Launch the kernels with the given plan on inputs that ``_check``
    passed, all on one CUDA device (``chip_smoke.py --plan-sweep`` times
    every plan through it; the operator's CUDA kernel is
    ``_launch_cols``)."""
    args = _op_args(pool, batch, q_thr_eff, now, span, pool_block, glicko2,
                    filters, widen_per_sec, max_threshold, g_coeff)
    return _launch_cols(plan, args[:_N_COLS], *args[_N_COLS:])


def _launch_cols(plan: GridPlan, cols: tuple, q_thr_eff, now, span_start,
                 feasible, chunk_rows: int, span_blocks: int,
                 pool_block: int, glicko2: bool, filters: bool,
                 widen_per_sec: float, max_threshold: float,
                 g_coeff: float):
    """``_launch`` on the operator's arguments as they come (the pool's
    ``_POOL_COLS`` then the window's ``_BATCH_COLS`` in ``cols``; no span
    when ``span_start`` is None): no dict is built per call."""
    (rating, rd, region, mode, threshold, enqueue_t, active,
     slot, b_rating, b_rd, b_region, b_mode, valid) = cols
    launch = _load("block_best")
    device = rating.device
    capacity, n_rows = rating.shape[0], slot.shape[0]
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
    spanned = span_start is not None
    with torch.cuda.device(device):  # the launch targets the current device
        rc = launch(
            rating.data_ptr(), rd.data_ptr(), region.data_ptr(),
            mode.data_ptr(), threshold.data_ptr(), enqueue_t.data_ptr(),
            active.data_ptr(),
            slot.data_ptr(), b_rating.data_ptr(), b_rd.data_ptr(),
            q_thr_eff.data_ptr(), b_region.data_ptr(), b_mode.data_ptr(),
            valid.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), rec.data_ptr(),
            rec.data_ptr() + 8 * n_rec if extra else None,
            n_rows, n_blocks, pool_block, capacity, plan.rows_per_cta,
            plan.cluster, now.data_ptr(),
            int(glicko2), int(filters), _f32(widen_per_sec),
            _f32(max_threshold), _f32(g_coeff),
            span_start.data_ptr() if spanned else None,
            feasible.data_ptr() if spanned else None,
            chunk_rows if spanned else 0, span_blocks if spanned else 0,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_best launch failed: CUDA error {rc}")
    LAUNCHES["block_best"] += 1
    return out_v, out_i


# ---- block_best as an operator ----------------------------------------------

#: The namespace of the kernels' operators, ``torch.ops.mm_torch``. A copy
#: of this module loaded under another name (``chip_smoke.py
#: --baseline-tree``, another checkout's module) registers its own, so two
#: trees' operators live side by side in one process.
OP_NAMESPACE = (
    "mm_torch" if __name__ == "matchmaking_tpu_torch.engine.cuda_kernels"
    else "mm_torch_" + re.sub(r"\W", "_", __name__))
#: The operators' library (``torch.library``): a registration lives as long
#: as it. Its kernels are plain Python functions registered per dispatch
#: key, which the first call does not wrap (``torch.library.custom_op``'s
#: kernels import the compiler stack, ~2 s, at their first call).
_LIB = torch.library.Library(OP_NAMESPACE, "DEF")
#: ``block_best`` as one operator a tracer records as one node: the pool's
#: ``_POOL_COLS``, the window's ``_BATCH_COLS``, the widened thresholds and
#: ``now``; the span launch's arguments (None, None, 0, 0 for the dense
#: launch); the flags. Its CUDA kernel is the launch, its CPU kernel the
#: plain version; no other device has one.
_LIB.define(
    "block_best(Tensor rating, Tensor rd, Tensor region, Tensor mode, "
    "Tensor threshold, Tensor enqueue_t, Tensor active, Tensor slot, "
    "Tensor b_rating, Tensor b_rd, Tensor b_region, Tensor b_mode, "
    "Tensor valid, Tensor q_thr_eff, Tensor now, Tensor? span_start, "
    "Tensor? feasible, int chunk_rows, int span_blocks, int pool_block, "
    "bool glicko2, bool filters, float widen_per_sec, float max_threshold, "
    "float g_coeff) -> (Tensor, Tensor)")
#: ``quality_accum`` as one operator that mutates ``state``, the flat
#: buffer of a ``QualityAccum``'s state: its CUDA kernel is the launch
#: (bound once per state and pool, ``_bind``), its CPU kernel the plain
#: version; no other device has one.
_LIB.define(
    "quality_accum(Tensor(a!) state, Tensor rating, Tensor enqueue_t, "
    "Tensor threshold, Tensor out, Tensor now, float widen_per_sec, "
    "float max_threshold, float[] rating_edges, int n_quality, "
    "float[] wait_edges) -> ()")


def ops():
    """The operators of this module's namespace (``torch.ops.mm_torch``)."""
    return getattr(torch.ops, OP_NAMESPACE)


def _block_best_cpu(*args):
    cols = args[:_N_COLS]
    (q_thr_eff, now, span_start, feasible, chunk_rows, span_blocks,
     pool_block, glicko2, filters, widen_per_sec, max_threshold,
     g_coeff) = args[_N_COLS:]
    pool = dict(zip(_POOL_NAMES, cols))
    batch = dict(zip(_BATCH_NAMES, cols[len(_POOL_NAMES):]))
    kw = dict(pool_block=pool_block, glicko2=glicko2, filters=filters,
              widen_per_sec=widen_per_sec, max_threshold=max_threshold,
              g_coeff=g_coeff)
    if span_start is not None:
        return block_best_span_reference(
            pool, batch, q_thr_eff, now,
            Span(span_start, chunk_rows, span_blocks, feasible), **kw)
    return block_best_reference(pool, batch, q_thr_eff, now, **kw)


def _block_best_cuda(*args):
    # The eager path's per-call Python: the arguments go to the launch as
    # they come (no dict, no Span).
    cols, rest = args[:_N_COLS], args[_N_COLS:]
    q_thr_eff, now, span_start, _, chunk_rows, _, pool_block = rest[:7]
    plan = plan_grid(q_thr_eff.shape[0], cols[0].shape[0] // pool_block,
                     pool_block, sm_count(now.device.index),
                     chunk_rows if span_start is not None else 0)
    return _launch_cols(plan, cols, *rest)


def _block_best_fake(*args):
    q_thr_eff, pool_block = args[_N_COLS], args[_N_COLS + 6]
    shape = (q_thr_eff.shape[0], args[0].shape[0] // pool_block)
    return (q_thr_eff.new_empty(shape, dtype=torch.float32),
            q_thr_eff.new_empty(shape, dtype=torch.int32))


_LIB.impl("block_best", _block_best_cpu, "CPU")
_LIB.impl("block_best", _block_best_cuda, "CUDA")
torch.library.register_fake(f"{OP_NAMESPACE}::block_best", _block_best_fake,
                            lib=_LIB)


# ---- quality_accum ----------------------------------------------------------

#: The state's arrays, in the JAX package's layout: i32 histograms and
#: counts, f32 sums (engine/quality.empty_arrays names).
QUALITY_FIELDS = (("q_hist", torch.int32), ("w_hist", torch.int32),
                  ("count", torch.int32), ("q_sum", torch.float32),
                  ("w_sum", torch.float32), ("d_sum", torch.float32))
#: Most edges the kernel takes per axis (its parameter block's arrays).
MAX_QUALITY_EDGES = 32


def quality_accum_reference(state: dict, rating, enqueue_t, threshold, out,
                            now: float, *, widen_per_sec: float,
                            max_threshold: float, rating_edges, n_quality: int,
                            wait_edges) -> None:
    """Plain PyTorch version of ``quality_accum``: the JAX step's formulas
    one f32 op at a time; each window's sums per bucket are added to the
    state's sums once (as the JAX step adds its window sum)."""
    capacity = rating.shape[0]
    b = out.shape[1]
    q_slot, c_slot, dist = out[0].to(torch.int32), out[1].to(torch.int32), out[2]
    hit = q_slot < capacity
    idx = torch.cat([q_slot.clamp(0, capacity - 1),
                     c_slot.clamp(0, capacity - 1)]).long()
    valid = torch.cat([hit, hit])
    r, enq = rating[idx], enqueue_t[idx]
    eff = effective_threshold(threshold[idx], enq, now, widen_per_sec,
                              max_threshold)
    limit = torch.minimum(eff[:b], eff[b:])
    limit2 = torch.cat([limit, limit])
    zero = torch.zeros((), dtype=torch.float32, device=out.device)
    d2 = torch.where(valid, torch.cat([dist, dist]), zero)
    quality = torch.where(
        valid & (limit2 > 0.0),
        (1.0 - d2 / limit2.clamp_min(_f32(1e-30))).clamp(0.0, 1.0), zero)
    now32 = _f32(now)
    wait = torch.where(valid, (now32 - enq).clamp_min(0.0), zero)
    r_edges = torch.tensor(rating_edges, dtype=torch.float32, device=out.device)
    w_edges = torch.tensor(wait_edges, dtype=torch.float32, device=out.device)
    rb = torch.searchsorted(r_edges, r, right=True)
    qb = (quality * float(n_quality)).to(torch.int32).clamp(0, n_quality - 1)
    wb = torch.searchsorted(w_edges, wait, right=True)
    ones = valid.to(torch.int32)
    n_wait = len(wait_edges) + 1
    state["q_hist"].view(-1).index_add_(0, rb * n_quality + qb, ones)
    state["w_hist"].view(-1).index_add_(0, rb * n_wait + wb, ones)
    state["count"].index_add_(0, rb, ones)
    n_rating = len(rating_edges) + 1
    for name, x in (("q_sum", quality), ("w_sum", wait), ("d_sum", d2)):
        window = torch.zeros(n_rating, dtype=torch.float32, device=out.device)
        state[name] += window.index_add_(0, rb, x)


class QualityAccumParams(ctypes.Structure):
    """``QualityAccumParams`` of ``csrc/quality_accum.cu``: what stays fixed
    for one state and one pool (pointers, sizes, constants, edges)."""

    _fields_ = [("rating", ctypes.c_void_p), ("enq", ctypes.c_void_p),
                ("thr", ctypes.c_void_p), ("state", ctypes.c_void_p),
                ("capacity", ctypes.c_int), ("n_quality", ctypes.c_int),
                ("n_rating_edges", ctypes.c_int),
                ("n_wait_edges", ctypes.c_int),
                ("widen", ctypes.c_float), ("max_thr", ctypes.c_float),
                ("rating_edges", ctypes.c_float * MAX_QUALITY_EDGES),
                ("wait_edges", ctypes.c_float * MAX_QUALITY_EDGES)]


#: Most bytes of the kernel's shared histograms (q_hist, w_hist, count).
MAX_QUALITY_HIST_BYTES = 32 * 1024


class QualityAccum:
    """``quality_accum`` bound to one state and one pool's three columns
    (each of ``capacity`` slots).

    Construction checks everything that stays fixed (the state's fields and
    its one flat buffer, the columns, the edges); the operator's CUDA
    kernel keeps their pointers in the kernel's parameter block at its
    first call (``_bind``). Each call then checks only the window result
    ``out`` and ``now`` and launches: fold
    ``out`` (f32[3, B]: q_slot, c_slot, dist) into the state, in place, two
    samples per matched lane, at the window's device time ``now`` (a f32
    tensor whose first element is it: the packed window's ``now`` row).

    The state is a ``kernels.QualityState``: each call is one operator,
    ``torch.ops.mm_torch.quality_accum``, mutating its flat buffer. CUDA
    tensors launch ``csrc/quality_accum.cu`` on the current stream (one
    launch, no host sync, no host time value); CPU tensors take
    ``quality_accum_reference`` (``now`` may then be a float). A kernel that
    cannot build or launch raises. Rebind (build a new one) when the pool
    or the state tensors change: the checks run once."""

    def __init__(self, state, rating, enqueue_t, threshold, *, capacity: int,
                 widen_per_sec: float, max_threshold: float, rating_edges,
                 n_quality: int, wait_edges):
        n_rating, n_wait = len(rating_edges) + 1, len(wait_edges) + 1
        self.device = device = rating.device
        for name, t in (("rating", rating), ("enqueue_t", enqueue_t),
                        ("threshold", threshold)):
            _check_tensor(name, t, torch.float32, (capacity,), device)
        shapes = {"q_hist": (n_rating, n_quality),
                  "w_hist": (n_rating, n_wait)}
        for name, dtype in QUALITY_FIELDS:
            _check_tensor(f"state[{name!r}]", state[name], dtype,
                          shapes.get(name, (n_rating,)), device)
        self.state = state
        #: The state's one flat buffer, which the operator mutates.
        self.flat = getattr(state, "flat", None)
        if self.flat is None:
            raise ValueError("quality_accum needs the state's flat buffer "
                             "(kernels.QualityState)")
        self.columns = (rating, enqueue_t, threshold)
        self.kw = dict(widen_per_sec=widen_per_sec,
                       max_threshold=max_threshold, rating_edges=rating_edges,
                       n_quality=n_quality, wait_edges=wait_edges)
        if device.type == "cpu":
            return
        if device.type != "cuda":
            raise ValueError(f"quality_accum runs on cuda or cpu tensors, "
                             f"not {device}")
        if max(len(rating_edges), len(wait_edges)) > MAX_QUALITY_EDGES:
            raise ValueError(f"quality_accum takes at most "
                             f"{MAX_QUALITY_EDGES} rating and wait edges")
        for what, edges in (("rating", rating_edges), ("wait", wait_edges)):
            if any(a > b for a, b in zip(edges, edges[1:])):
                raise ValueError(f"quality_accum: the {what} edges must "
                                 f"ascend")
        if 4 * n_rating * (n_quality + n_wait + 1) > MAX_QUALITY_HIST_BYTES:
            raise ValueError(f"quality_accum: histograms of {n_rating} x "
                             f"({n_quality} + {n_wait} + 1) cells exceed "
                             f"{MAX_QUALITY_HIST_BYTES} bytes of shared memory")
        # The kernel writes the flat buffer at offsets it derives from the
        # sizes: the fields must be its views, in QUALITY_FIELDS order.
        flat = self.flat
        size = n_rating * (n_quality + n_wait + 4)
        _check_tensor("state.flat", flat, torch.int32, (size,), device)
        at = flat.data_ptr()
        for name, _ in QUALITY_FIELDS:
            if state[name].data_ptr() != at:
                raise ValueError(f"state[{name!r}] is not its view of the "
                                 f"flat buffer")
            at += 4 * state[name].numel()

    def __call__(self, out, now) -> None:
        device = self.device
        if out.device != device or out.dtype != torch.float32 \
                or out.dim() != 2 or out.shape[0] != 3 \
                or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous f32[3, B] tensor on "
                             f"{device}; got {out.dtype} {tuple(out.shape)} "
                             f"on {out.device}")
        if device.type == "cpu":
            if not isinstance(now, torch.Tensor):
                now = torch.full((1,), now, dtype=torch.float32)
        elif not isinstance(now, torch.Tensor) or now.device != device \
                or now.dtype != torch.float32:
            raise ValueError(f"now must be a f32 tensor on {device} (the "
                             f"packed window's now row)")
        kw = self.kw
        ops().quality_accum(
            self.flat, *self.columns, out, now, kw["widen_per_sec"],
            kw["max_threshold"], kw["rating_edges"], kw["n_quality"],
            kw["wait_edges"])

    def launch_empty(self, out, now) -> None:
        """An empty kernel launched as ``__call__`` launches the kernel (the
        same CTAs and arguments): the launch-latency floor that
        ``chip_smoke.py`` times beside it. Not counted."""
        kw = self.kw
        _quality_launch("quality_accum_empty_launch", _bind(
            self.flat, *self.columns, kw["widen_per_sec"],
            kw["max_threshold"], kw["rating_edges"], kw["n_quality"],
            kw["wait_edges"]), out, now)


#: The parameter blocks of the bound (state, pool columns) pairs, keyed by
#: their addresses and constants: the launch's binding, made once per
#: state and pool by the operator's CUDA kernel and found again by every
#: later call (and by ``QualityAccum.launch_empty``). It holds no tensor,
#: so a dropped pool's memory is freed; an address reused by another
#: tensor of the same role gives the same block. Addresses are unique
#: across the process's cards (unified addressing). The oldest binding
#: goes past ``_MAX_BINDINGS``: a process binds one per engine that folds
#: quality on the card, and again for each new pool or state.
_BINDINGS: dict[tuple, QualityAccumParams] = {}
_MAX_BINDINGS = 64


def _bind(flat, rating, enqueue_t, threshold, widen_per_sec, max_threshold,
          rating_edges, n_quality, wait_edges) -> QualityAccumParams:
    key = (flat.data_ptr(), rating.data_ptr(), enqueue_t.data_ptr(),
           threshold.data_ptr(), rating.shape[0], widen_per_sec,
           max_threshold, n_quality, *rating_edges, None, *wait_edges)
    params = _BINDINGS.get(key)
    if params is None:
        while len(_BINDINGS) >= _MAX_BINDINGS:
            _BINDINGS.pop(next(iter(_BINDINGS)))
        params = _BINDINGS[key] = QualityAccumParams(
            rating.data_ptr(), enqueue_t.data_ptr(), threshold.data_ptr(),
            flat.data_ptr(), rating.shape[0], n_quality, len(rating_edges),
            len(wait_edges), _f32(widen_per_sec), _f32(max_threshold),
            (ctypes.c_float * MAX_QUALITY_EDGES)(*rating_edges),
            (ctypes.c_float * MAX_QUALITY_EDGES)(*wait_edges))
    return params


def _quality_launch(symbol: str, params, out, now) -> None:
    index = out.device.index
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            return _quality_launch(symbol, params, out, now)
    rc = _load("quality_accum", symbol)(
        out.data_ptr(), out.shape[1], now.data_ptr(), ctypes.byref(params),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quality_accum launch failed: CUDA error {rc}")


def quality_views(flat, n_rating: int, n_quality: int, n_wait: int) -> dict:
    """The state's fields as views of its flat i32 buffer, in
    ``QUALITY_FIELDS`` order (the sums as f32 views of theirs)."""
    shapes = {"q_hist": (n_rating, n_quality), "w_hist": (n_rating, n_wait)}
    views, at = {}, 0
    for name, dtype in QUALITY_FIELDS:
        shape = shapes.get(name, (n_rating,))
        n = math.prod(shape)
        views[name] = flat[at:at + n].view(dtype).view(shape)
        at += n
    return views


def _quality_accum_cpu(state, rating, enqueue_t, threshold, out, now,
                       widen_per_sec, max_threshold, rating_edges, n_quality,
                       wait_edges):
    views = quality_views(state, len(rating_edges) + 1, n_quality,
                          len(wait_edges) + 1)
    quality_accum_reference(
        views, rating, enqueue_t, threshold, out, float(now.reshape(-1)[0]),
        widen_per_sec=widen_per_sec, max_threshold=max_threshold,
        rating_edges=rating_edges, n_quality=n_quality,
        wait_edges=wait_edges)


def _quality_accum_cuda(state, rating, enqueue_t, threshold, out, now,
                        widen_per_sec, max_threshold, rating_edges, n_quality,
                        wait_edges):
    _quality_launch("quality_accum_launch", _bind(
        state, rating, enqueue_t, threshold, widen_per_sec, max_threshold,
        rating_edges, n_quality, wait_edges), out, now)
    LAUNCHES["quality_accum"] += 1


def _quality_accum_fake(state, *rest) -> None:
    return None


_LIB.impl("quality_accum", _quality_accum_cpu, "CPU")
_LIB.impl("quality_accum", _quality_accum_cuda, "CUDA")
torch.library.register_fake(f"{OP_NAMESPACE}::quality_accum",
                            _quality_accum_fake, lib=_LIB)
