"""The port's wire codec (``matchmaking_tpu_torch/csrc/codec.cc`` and its
own ctypes binding) against the JAX package's (``native/codec.cc``), both
built with g++, on a seeded corpus: equal decode columns and statuses,
byte-identical matched and simple bodies — and those bodies equal to the
contract module's ``encode_response``. A codec that cannot build raises.
"""

import json
import math
import random

import numpy as np
import pytest

from matchmaking_tpu.native import codec as jax_codec
from matchmaking_tpu_torch.native import codec
from matchmaking_tpu_torch.service.contract import (
    MatchResult,
    SearchResponse,
    encode_response,
)

N = 1200


def rand_float(rng: random.Random) -> float:
    """Floats across the formats ``repr`` produces (fixed, integral,
    tiny, huge/scientific, negative, decimal ties, binary fractions)."""
    k = rng.random()
    if k < 0.2:
        return rng.uniform(0.0, 1.0)
    if k < 0.4:
        return rng.uniform(0.0, 1e5)
    if k < 0.5:
        return float(rng.randint(0, 10**6))
    if k < 0.6:
        return rng.uniform(0.0, 1e-4)
    if k < 0.7:
        return rng.uniform(1e10, 1e18)
    if k < 0.8:
        return -rng.uniform(0.0, 1e4)
    if k < 0.9:
        return rng.randint(0, 10**6) / 2.0 ** rng.randint(0, 12)
    return rng.choice([0.0, -0.0, 2.675, 0.1 + 0.2, 1e16, 1e-5, 1.0005])


def rand_id(rng: random.Random) -> str:
    odd = ("plain", 'quo"te', "back\\slash", "tab\there", "nl\ninside",
           "ctl\x01\x1f", "sp ace", "unicode-é", "emoji-🎮", "nul\x00in", "")
    if rng.random() < 0.7:
        return f"p{rng.randrange(10**6)}"
    return rng.choice(odd) + str(rng.randrange(100))


def request_corpus(seed: int) -> list[bytes]:
    rng = random.Random(seed)
    bodies = []
    for _ in range(N):
        if rng.random() < 0.08:
            bodies.append(rng.choice([
                b"not json", b"[1,2]", b'{"rating":1}', b'{"id":"x"}',
                b'{"id":"x","rating":"hi"}', b'{"id":7,"rating":1}',
                b'{"id":"x","rating":1e7}', b"",
                b'{"id":"x","rating":1,"rating_deviation":-2}',
                b'{"id":"x","rating":1,"rating_threshold":0}']))
            continue
        payload = {"id": rand_id(rng), "rating": rand_float(rng) % 9e4}
        if rng.random() < 0.5:
            payload["rating_deviation"] = rng.uniform(0.0, 350.0)
        if rng.random() < 0.4:
            payload["region"] = rng.choice(["eu", "na", "apac", "*", ""])
        if rng.random() < 0.4:
            payload["game_mode"] = rng.choice(["ranked", "casual"])
        if rng.random() < 0.3:
            payload["rating_threshold"] = rng.uniform(0.5, 400.0)
        if rng.random() < 0.1:
            payload["roles"] = ["tank", "dps"]
        if rng.random() < 0.1:
            payload["party"] = [{"id": f"q{rng.randrange(9)}", "rating": 1500}]
        if rng.random() < 0.1:
            payload["junk"] = {"nested": [1, None, {"a": "b"}]}
        bodies.append(json.dumps(payload, ensure_ascii=rng.random() < 0.5)
                      .encode())
    return bodies


@pytest.mark.parametrize("seed", [3, 20260803])
def test_decode_equals_jax_codec(seed):
    bodies = request_corpus(seed)
    got = codec.decode_batch(bodies)
    want = jax_codec.decode_batch(bodies)
    assert want is not None
    status, want_status = got[-1], want[-1]
    np.testing.assert_array_equal(status, want_status)
    ok = status == codec.OK
    assert ok.sum() > N // 2  # the fast path carries the bulk
    assert (status == codec.NEEDS_PYTHON).sum() > 0
    for g, w in zip(got[:-1], want[:-1]):
        if g.dtype == object:
            assert g.tolist() == w.tolist()
        else:  # numbers are unspecified on rows that are not OK
            np.testing.assert_array_equal(g[ok], w[ok])
    assert ({codec.error_code(s) for s in status[status > 1].tolist()}
            == {jax_codec.error_code(s) for s in want_status[want_status > 1]
                .tolist()})


@pytest.mark.parametrize("with_traces", [False, True])
def test_matched_bodies_byte_identical(with_traces):
    rng = random.Random(99 + with_traces)
    ids_a = [rand_id(rng) for _ in range(N)]
    ids_b = [rand_id(rng) for _ in range(N)]
    mids = [f"m{rng.randrange(16**12):012x}" for _ in range(N)]
    lat_a = np.array([rand_float(rng) for _ in range(N)])
    lat_b = np.array([rand_float(rng) for _ in range(N)])
    qual = np.array([rng.uniform(0.0, 1.0) for _ in range(N)])
    wa = np.array([rand_float(rng) for _ in range(N)])
    wb = np.array([rand_float(rng) for _ in range(N)])
    for j in rng.sample(range(N), 20):  # non-finite: those sides are None
        lat_a[j] = rng.choice([float("nan"), float("inf"), -float("inf")])
    tr = ([("" if rng.random() < 0.5 else f"tr{j}") for j in range(N)]
          if with_traces else None)
    args = (ids_a, ids_b, mids, lat_a, lat_b, qual, wa, wb, tr, None)
    got = codec.encode_matched_batch(*args)
    assert got == jax_codec.encode_matched_batch(*args)
    n_native = 0
    for j in range(N):
        result = MatchResult(match_id=mids[j], players=(ids_a[j], ids_b[j]),
                             teams=((ids_a[j],), (ids_b[j],)),
                             quality=float(qual[j]))
        for side, (pid, lat, w) in enumerate(((ids_a[j], lat_a[j], wa[j]),
                                              (ids_b[j], lat_b[j], wb[j]))):
            body = got[2 * j + side]
            if body is None:
                continue
            assert math.isfinite(lat)
            n_native += 1
            assert body == encode_response(SearchResponse(
                status="matched", player_id=pid, match=result,
                latency_ms=float(lat), waited_ms=float(w),
                trace_id=tr[j] if tr and side == 0 else ""))
    assert n_native > N


def test_simple_bodies_byte_identical():
    rng = random.Random(7)
    kinds = [rng.randrange(3) for _ in range(N)]
    pids = [rand_id(rng) for _ in range(N)]
    lat = np.array([rand_float(rng) for _ in range(N)])
    retry = np.array([abs(rand_float(rng)) for _ in range(N)])
    traces = ["" if rng.random() < 0.5 else f"t{j}" for j in range(N)]
    tiers = np.array([-1 if rng.random() < 0.5 else rng.randrange(4)
                      for _ in range(N)], np.int32)
    args = (kinds, pids, lat, retry, traces, tiers)
    got = codec.encode_simple_batch(*args)
    assert got == jax_codec.encode_simple_batch(*args)
    statuses = {codec.KIND_QUEUED: "queued", codec.KIND_TIMEOUT: "timeout",
                codec.KIND_SHED: "shed"}
    n_native = 0
    for j, body in enumerate(got):
        if body is None:
            continue
        n_native += 1
        assert body == encode_response(SearchResponse(
            status=statuses[kinds[j]], player_id=pids[j],
            latency_ms=float(lat[j]), retry_after_ms=float(retry[j]),
            trace_id=traces[j],
            tier=None if tiers[j] < 0 else int(tiers[j])))
    assert n_native > N // 2
    assert codec.encode_simple_batch([], [], np.empty(0)) == []
    assert codec.encode_matched_batch([], [], [], *[np.empty(0)] * 5) == []


def test_codec_raises_when_it_cannot_build(monkeypatch, tmp_path):
    """No silent fallback: a missing compiler is an error at load, and at
    every entry point."""
    monkeypatch.setenv("MM_KERNEL_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(codec, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(codec, "_lib", None)
    with pytest.raises(RuntimeError, match="cannot build the wire codec"):
        codec.load()
    with pytest.raises(RuntimeError):
        codec.decode_batch([b'{"id":"a","rating":1}'])
    with pytest.raises(RuntimeError):
        codec.encode_simple_batch([codec.KIND_QUEUED], ["a"], np.zeros(1))
    assert not any(tmp_path.rglob("*.so"))  # nothing half-built is left


def test_codec_builds_under_the_build_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("MM_KERNEL_BUILD_DIR", str(tmp_path))
    so = codec.build()
    assert so.is_file() and tmp_path in so.parents
    assert so.name == "libmmcodec.so"
    assert codec.build() == so  # cached by source hash
