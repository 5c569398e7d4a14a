"""ctypes binding of the batch wire codec (``csrc/codec.cc``).

Ingress: one C call decodes a window of JSON request bodies into the
columns of ``contract.RequestColumns``: from a list of bodies
(``decode_batch``), or from one buffer of bodies packed back to back and
their offsets (``decode_batch_concat``, a consume burst's layout). Rows flagged ``NEEDS_PYTHON``
(parties, roles, string escapes) re-decode through
``contract.decode_request``, the semantic source of truth whose validation
the C++ mirrors; other statuses are contract errors (``error_code``).

Egress: one C call encodes a window of response bodies — matched pairs
(``encode_matched_batch``) and queued/timeout/shed rows
(``encode_simple_batch``) — byte-identical to ``contract.encode_response``.
Rows the C encoder cannot express exactly (non-ASCII ids, non-finite
floats, embedded NULs) come back as ``None``, and the caller re-encodes just
those through the contract module.

The library is built with ``g++`` at first use into
``build/torch_kernels/<hash of source and flags>/`` beside the CUDA kernels
(``MM_KERNEL_BUILD_DIR`` overrides). A build or load failure raises: there
is no silent pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from matchmaking_tpu_torch.engine.cuda_kernels import build_dir

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "codec.cc"
_FLAGS = ("-O2", "-shared", "-fPIC")
#: The host C++ compiler (a name on PATH or a path).
CXX = "g++"

# Status codes (as in codec.cc).
OK = 0
NEEDS_PYTHON = 1
_ERROR_CODES = {
    2: "bad_json",
    3: "missing_field",
    4: "bad_type",
    5: "bad_rating",
    6: "bad_threshold",
}

#: Row kinds of the simple-response encoder (as in codec.cc).
KIND_QUEUED = 0
KIND_TIMEOUT = 1
KIND_SHED = 2

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile ``csrc/codec.cc`` (once per source/flags hash) and return
    the shared library's path; raises when the compiler fails."""
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir() / key
    so = out_dir / "libmmcodec.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *_FLAGS, "-o", tmp, str(_SRC)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build the wire codec with {CXX!r}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{CXX} failed ({proc.returncode}) building "
                           f"{_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Build (once) and load the library; raises if either fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        f32 = np.ctypeslib.ndpointer(np.float32)
        f64 = np.ctypeslib.ndpointer(np.float64)
        i32 = np.ctypeslib.ndpointer(np.int32)
        i64 = np.ctypeslib.ndpointer(np.int64)
        strs = ctypes.POINTER(ctypes.c_char_p)
        lib.mm_decode_requests.restype = ctypes.c_int64
        lib.mm_decode_requests.argtypes = [
            strs, i32, ctypes.c_int32,                 # bufs, lens, n
            f32, f32, f32, i32,                        # rating, rd, thr, status
            ctypes.c_char_p, ctypes.c_int64,           # arena, cap
            i64, i64, i64,                             # id/region/mode offsets
        ]
        lib.mm_decode_requests_concat.restype = ctypes.c_int64
        lib.mm_decode_requests_concat.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i64,      # buf, len, offsets
            ctypes.c_int32,                            # n
            f32, f32, f32, i32,                        # rating, rd, thr, status
            ctypes.c_char_p, ctypes.c_int64,           # arena, cap
            i64, i64, i64,                             # id/region/mode offsets
        ]
        lib.mm_encode_matched.restype = ctypes.c_int64
        lib.mm_encode_matched.argtypes = [
            strs, strs, strs, ctypes.c_int32,          # id_a, id_b, match_id, n
            f64, f64, f64, f64, f64,                   # lat a/b, quality, waited a/b
            strs, strs,                                # trace a/b (or None)
            ctypes.c_char_p, ctypes.c_int64, i64, i32,  # arena, cap, off, status
        ]
        lib.mm_encode_simple.restype = ctypes.c_int64
        lib.mm_encode_simple.argtypes = [
            i32, strs, f64, f64, strs, i32,            # kind, id, lat, retry, trace, tier
            ctypes.c_int32,                            # n
            ctypes.c_char_p, ctypes.c_int64, i64, i32,  # arena, cap, off, status
        ]
        _lib = lib
        return lib


def error_code(status: int) -> str:
    return _ERROR_CODES.get(int(status), "bad_json")


def decode_batch(bodies: list[bytes]):
    """Decode a window of JSON bodies: (ids, rating, rd, threshold,
    region_names, mode_names, status). String columns are object arrays
    ("" region/mode = wildcard); ``status`` is int32 per row (OK,
    NEEDS_PYTHON or an error code for ``error_code``); rows that are not OK
    carry "" and unspecified numbers."""
    lib = load()
    n = len(bodies)
    lens = np.fromiter((len(b) for b in bodies), np.int32, n)
    bufs = (ctypes.c_char_p * n)(*bodies)
    rating = np.empty(n, np.float32)
    rd = np.empty(n, np.float32)
    threshold = np.empty(n, np.float32)
    status = np.empty(n, np.int32)
    id_off = np.empty(n + 1, np.int64)
    region_off = np.empty(n + 1, np.int64)
    mode_off = np.empty(n + 1, np.int64)
    cap = int(lens.sum()) + 16  # every decoded string is a slice of a body
    arena = ctypes.create_string_buffer(cap)
    used = lib.mm_decode_requests(bufs, lens, n, rating, rd, threshold, status,
                                  arena, cap, id_off, region_off, mode_off)
    if used < 0:
        raise RuntimeError("wire codec: decode arena overflow")
    return _columns(arena.raw, n, rating, rd, threshold, status, id_off,
                    region_off, mode_off)


def decode_batch_concat(buf: bytes, offsets):
    """Decode a consume burst: ``buf`` holds n bodies back to back, body i
    spanning ``offsets[i]:offsets[i + 1]`` (``offsets``: n + 1 int64).
    The same return as ``decode_batch``; a row whose offsets are inverted
    or out of the buffer's range comes back as ``bad_json``."""
    lib = load()
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    rating = np.empty(n, np.float32)
    rd = np.empty(n, np.float32)
    threshold = np.empty(n, np.float32)
    status = np.empty(n, np.int32)
    id_off = np.empty(n + 1, np.int64)
    region_off = np.empty(n + 1, np.int64)
    mode_off = np.empty(n + 1, np.int64)
    cap = len(buf) + 16  # every decoded string is a slice of a body
    arena = ctypes.create_string_buffer(cap)
    used = lib.mm_decode_requests_concat(buf, len(buf), offsets, n, rating,
                                         rd, threshold, status, arena, cap,
                                         id_off, region_off, mode_off)
    if used < 0:
        raise RuntimeError("wire codec: decode arena overflow")
    return _columns(arena.raw, n, rating, rd, threshold, status, id_off,
                    region_off, mode_off)


def _columns(raw: bytes, n: int, rating, rd, threshold, status, id_off,
             region_off, mode_off):
    """The decoders' string columns from their arena: object arrays of the
    OK rows' ids, regions and modes ("" elsewhere)."""
    ids = np.empty(n, object)
    regions = np.empty(n, object)
    modes = np.empty(n, object)
    for i in range(n):
        if status[i] == OK:
            ids[i] = raw[id_off[i]:region_off[i]].decode()
            regions[i] = raw[region_off[i]:mode_off[i]].decode()
            modes[i] = raw[mode_off[i]:id_off[i + 1]].decode()
        else:
            ids[i] = regions[i] = modes[i] = ""
    return ids, rating, rd, threshold, regions, modes, status


def _cstr_array(strings, n: int):
    """str sequence → (c_char_p array, rows needing Python): a string with
    an embedded NUL would be cut short by c_char_p, so its row takes the
    Python encoder."""
    out = (ctypes.c_char_p * n)()
    bad: list[int] = []
    for i, s in enumerate(strings):
        b = s.encode()
        if b"\x00" in b:
            bad.append(i)
            b = b""
        out[i] = b
    return out, bad


def _slice_bodies(raw: bytes, off: np.ndarray, status: np.ndarray,
                  n: int) -> list[bytes | None]:
    return [raw[off[j]:off[j + 1]] if status[j] == OK else None
            for j in range(n)]


def encode_matched_batch(ids_a, ids_b, match_ids, lat_a_ms, lat_b_ms,
                         quality, waited_a_ms, waited_b_ms,
                         trace_a=None, trace_b=None) -> list[bytes | None]:
    """2n matched-response bodies (a0, b0, a1, b1, ...), byte-identical to
    ``contract.encode_response`` (``waited_ms`` and the optional per-side
    ``trace_id`` included); ``None`` entries need the Python encoder."""
    lib = load()
    n = len(match_ids)
    if n == 0:
        return []
    lat_a_ms = np.ascontiguousarray(lat_a_ms, np.float64)
    lat_b_ms = np.ascontiguousarray(lat_b_ms, np.float64)
    quality = np.ascontiguousarray(quality, np.float64)
    waited_a_ms = np.ascontiguousarray(waited_a_ms, np.float64)
    waited_b_ms = np.ascontiguousarray(waited_b_ms, np.float64)
    a_ptrs, bad_a = _cstr_array(ids_a, n)
    b_ptrs, bad_b = _cstr_array(ids_b, n)
    m_ptrs, bad_m = _cstr_array(match_ids, n)
    tr_a = tr_b = None
    bad_ta: list[int] = []
    bad_tb: list[int] = []
    if trace_a is not None:
        tr_a, bad_ta = _cstr_array(trace_a, n)
    if trace_b is not None:
        tr_b, bad_tb = _cstr_array(trace_b, n)
    off = np.empty(2 * n + 1, np.int64)
    status = np.empty(2 * n, np.int32)
    # ~160 B of fixed text a response, plus the strings; escapes can at
    # worst grow a string 6x, hence the margin (and one retry, 4x larger).
    cap = 320 * 2 * n + 8 * sum(
        len(a_ptrs[i] or b"") + len(b_ptrs[i] or b"") + len(m_ptrs[i] or b"")
        for i in range(n))
    if tr_a is not None:
        cap += 8 * sum(len(tr_a[i] or b"") for i in range(n))
    if tr_b is not None:
        cap += 8 * sum(len(tr_b[i] or b"") for i in range(n))
    for _ in range(2):
        arena = ctypes.create_string_buffer(cap)
        used = lib.mm_encode_matched(
            a_ptrs, b_ptrs, m_ptrs, n, lat_a_ms, lat_b_ms, quality,
            waited_a_ms, waited_b_ms, tr_a, tr_b, arena, cap, off, status)
        if used >= 0:
            bodies = _slice_bodies(arena.raw, off, status, 2 * n)
            # A bad player or match id spoils both sides (each body holds
            # the whole pair); a bad trace id only its own side.
            for i in bad_a + bad_b + bad_m:
                bodies[2 * i] = None
                bodies[2 * i + 1] = None
            for i in bad_ta:
                bodies[2 * i] = None
            for i in bad_tb:
                bodies[2 * i + 1] = None
            return bodies
        cap *= 4
    raise RuntimeError("wire codec: matched-encode arena overflow")


def encode_simple_batch(kinds, player_ids, lat_ms, retry_ms=None,
                        trace_ids=None, tiers=None) -> list[bytes | None]:
    """n queued/timeout/shed bodies (``kinds`` of KIND_*), byte-identical
    to ``contract.encode_response``. ``tiers`` entries < 0 (or None) leave
    the tier key out. ``None`` entries need the Python encoder."""
    lib = load()
    n = len(player_ids)
    if n == 0:
        return []
    kinds = np.ascontiguousarray(kinds, np.int32)
    lat_ms = np.ascontiguousarray(lat_ms, np.float64)
    retry_ms = (np.zeros(n, np.float64) if retry_ms is None
                else np.ascontiguousarray(retry_ms, np.float64))
    tiers = (np.full(n, -1, np.int32) if tiers is None
             else np.ascontiguousarray(tiers, np.int32))
    p_ptrs, bad_p = _cstr_array(player_ids, n)
    tr = None
    bad_t: list[int] = []
    if trace_ids is not None:
        tr, bad_t = _cstr_array(trace_ids, n)
    off = np.empty(n + 1, np.int64)
    status = np.empty(n, np.int32)
    cap = 256 * n + 8 * sum(len(p_ptrs[i] or b"") for i in range(n))
    if tr is not None:
        cap += 8 * sum(len(tr[i] or b"") for i in range(n))
    for _ in range(2):
        arena = ctypes.create_string_buffer(cap)
        used = lib.mm_encode_simple(kinds, p_ptrs, lat_ms, retry_ms, tr,
                                    tiers, n, arena, cap, off, status)
        if used >= 0:
            bodies = _slice_bodies(arena.raw, off, status, n)
            for i in bad_p + bad_t:
                bodies[i] = None
            return bodies
        cap *= 4
    raise RuntimeError("wire codec: simple-encode arena overflow")
