"""The port's host stage spans and their profiler ranges
(``GpuEngine._span``): the spans inside finalize and refill, the host's
wait for the device, the ``mm.engine.*`` ranges under ``torch.profiler``
(nested, each inside its parent) and no range at all while no
profiler runs. The port alone, on the CPU (``device="cpu"``); no JAX."""

import dataclasses
import importlib.util
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matchmaking_tpu_torch.config import Config
from matchmaking_tpu_torch.engine import gpu
from matchmaking_tpu_torch.engine.gpu import GpuEngine
from matchmaking_tpu_torch.service.contract import RequestColumns, SearchRequest

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
NEW = ("restore_s", "restore_admit_s", "release_s", "match_ids_s", "wait_s")


def engine(name="elo_1v1", **engine_kw):
    cfg = Config.from_json(os.path.join(ROOT, "configs", f"{name}.json"),
                           backend="gpu")
    kw = dict(pool_capacity=1024, pool_block=256, **engine_kw)
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine,
                                                              **kw))
    return GpuEngine(cfg, cfg.queues[0], device="cpu")


def columns(rng, n, start):
    """``n`` fresh 1v1 rows, ids ``p<start>``...: ratings close enough
    that most of a window matches."""
    return RequestColumns(
        ids=np.array([f"p{i}" for i in range(start, start + n)], object),
        rating=rng.normal(1500, 30, n).astype(np.float32),
        rd=np.full(n, 100.0, np.float32),
        region=np.zeros(n, np.int32), mode=np.zeros(n, np.int32),
        threshold=np.full(n, np.nan, np.float32),
        enqueued_at=T0 - rng.uniform(0, 5, n))


def window_and_refill(eng, rng, start, collect=GpuEngine.flush):
    """A refill of 200, one window of 64, its collection; returns the
    window's token and the next free id."""
    eng.restore_columns(columns(rng, 200, start), T0)
    tok = eng.search_columns_async(columns(rng, 64, start + 200), T0 + 1)
    done = collect(eng)
    assert [t for t, _ in done] == [tok] and done[0][1].n_matches > 0
    return tok, start + 264


def test_a_columnar_run_fills_the_new_spans_inside_their_parents():
    eng = engine()
    rng = np.random.default_rng(1)
    start = 0
    for _ in range(3):
        _, start = window_and_refill(eng, rng, start)
    s = eng.spans
    assert all(s[k] > 0.0 for k in NEW), {k: s[k] for k in NEW}
    assert s["restore_admit_s"] <= s["restore_s"]
    assert s["release_s"] + s["match_ids_s"] <= s["finalize_s"]
    assert (s["dedupe_s"] + s["alloc_s"] + s["pack_s"] + s["h2d_s"]
            + s["step_s"]) <= s["dispatch_s"]
    rep = eng.span_report()
    assert rep["windows"] == 3
    for k in NEW:
        assert rep[k[:-2] + "_ms_avg"] == pytest.approx(s[k] / 3 * 1e3)
    # Numbers only: a reader subtracts two reads key by key.
    assert all(isinstance(v, (int, float)) for v in s.values())


def test_the_object_path_times_release_inside_finalize():
    eng = engine()
    reqs = [SearchRequest(id=f"o{i}", rating=1500.0 + i % 7,
                          enqueued_at=T0) for i in range(40)]
    tok, _ = eng.search_async(reqs, T0)
    (got, out), = eng.flush()
    assert got == tok and out.matches
    s = eng.spans
    assert 0.0 < s["release_s"] <= s["finalize_s"]
    assert s["match_ids_s"] == 0.0  # minted one by one on this path
    assert s["restore_s"] == 0.0


def test_the_team_path_times_release_inside_finalize():
    eng = engine("team_5v5")
    reqs = [SearchRequest(id=f"t{i}", rating=1500.0 + i % 5, region="eu",
                          game_mode="ranked", enqueued_at=T0)
            for i in range(40)]
    tok, _ = eng.search_async(reqs, T0)
    (got, out), = eng.flush()
    assert got == tok and out.matches
    assert 0.0 < eng.spans["release_s"] <= eng.spans["finalize_s"]


class _Recording(torch.profiler.record_function):
    """``record_function`` that keeps (name, args) of every range made."""

    made: list = []

    def __init__(self, name, args=None):
        _Recording.made.append((name, args))
        super().__init__(name, args)


def test_ranges_nest_under_a_profiler(monkeypatch):
    eng = engine()
    rng = np.random.default_rng(2)
    _, start = window_and_refill(eng, rng, 0)  # first-use costs out
    monkeypatch.setattr(_Recording, "made", [])
    monkeypatch.setattr(torch.profiler, "record_function", _Recording)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        window_and_refill(eng, rng, start)
    made = _Recording.made
    # Every span opens its range once, named mm.engine.<name>, with no args.
    assert sorted(made) == sorted((f"mm.engine.{n}", None)
                                  for n in gpu.SPAN_NAMES)
    parents = {}
    for ev in prof.events():
        if ev.name.startswith("mm.engine."):
            parent = ev.cpu_parent.name if ev.cpu_parent is not None else None
            parents.setdefault(ev.name, set()).add(parent)
    assert parents["mm.engine.release"] == {"mm.engine.finalize"}
    assert parents["mm.engine.match_ids"] == {"mm.engine.finalize"}
    assert parents["mm.engine.restore_admit"] == {"mm.engine.restore"}
    for child in ("dedupe", "alloc", "pack", "h2d", "step"):
        assert parents[f"mm.engine.{child}"] == {"mm.engine.dispatch"}
    for top in ("dispatch", "finalize", "restore", "wait"):
        assert parents[f"mm.engine.{top}"] == {None}


def test_no_range_is_made_without_a_profiler(monkeypatch):
    eng = engine()
    rng = np.random.default_rng(3)

    def refuse(*a, **k):
        raise AssertionError("a range was made with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not gpu._profiling()
    start = 0
    for collect in (GpuEngine.collect_ready, GpuEngine.flush):
        _, start = window_and_refill(eng, rng, start, collect)
    assert all(eng.spans[k] > 0.0 for k in NEW if k != "wait_s")


@pytest.mark.parametrize("release", ["collect_ready", "flush"])
def test_a_window_held_not_ready_grows_the_wait(monkeypatch, release):
    """From the ``collect_ready`` that first finds the oldest window not
    ready to the call that finalizes it, the host waits: ``wait_s`` grows
    by that time, and the span closes at that call."""
    eng = engine()
    rng = np.random.default_rng(4)
    eng.restore_columns(columns(rng, 200, 0), T0)
    tok = eng.search_columns_async(columns(rng, 64, 200), T0 + 1)
    monkeypatch.setattr(eng, "_is_ready", lambda pending: False)
    assert eng.collect_ready() == []
    assert eng._waiting
    time.sleep(0.03)
    assert eng.collect_ready() == []  # still the same wait
    assert eng.spans["wait_s"] == 0.0
    monkeypatch.undo()
    done = getattr(eng, release)()
    assert [t for t, _ in done] == [tok] and not eng._waiting
    assert eng.spans["wait_s"] >= 0.03
    assert eng.spans["wait_s"] < eng.spans["turnaround_s"]


@pytest.mark.parametrize("opened_under", ["none", "capture"])
def test_a_wait_across_the_start_or_stop_of_a_capture(monkeypatch,
                                                      opened_under):
    """The gate is read when a span opens: a wait opened before a capture
    starts closes with no range, and one opened inside a capture that
    stops before it closes still closes its range, without an error."""
    eng = engine()
    rng = np.random.default_rng(5)
    eng.restore_columns(columns(rng, 200, 0), T0)
    tok = eng.search_columns_async(columns(rng, 64, 200), T0 + 1)
    monkeypatch.setattr(eng, "_is_ready", lambda pending: False)
    prof = profile(activities=[ProfilerActivity.CPU])
    if opened_under == "capture":
        prof.start()
    assert eng.collect_ready() == []
    if opened_under == "capture":
        prof.stop()
    else:
        prof.start()
    monkeypatch.undo()
    try:
        assert [t for t, _ in eng.collect_ready()] == [tok]
    finally:
        if opened_under == "none":
            prof.stop()
    assert eng.spans["wait_s"] > 0.0
    assert eng._spans_by_name["wait"].rf is None
    waits = [e for e in prof.events() if e.name == "mm.engine.wait"]
    assert len(waits) == (1 if opened_under == "capture" else 0)


def test_close_ends_an_open_wait(monkeypatch):
    eng = engine()
    rng = np.random.default_rng(6)
    eng.restore_columns(columns(rng, 200, 0), T0)
    eng.search_columns_async(columns(rng, 64, 200), T0 + 1)
    monkeypatch.setattr(eng, "_is_ready", lambda pending: False)
    assert eng.collect_ready() == []
    eng.close()
    assert not eng._waiting and eng.spans["wait_s"] > 0.0


def test_chip_smoke_counts_no_mm_range_as_device_work():
    """The card draws a device-track twin of each ``mm.*`` range that
    launches or copies; ``chip_smoke.device_work`` (what its kernel counts
    and device ms read, and ``scripts/torch_profiler_records.py`` too)
    keeps the kernels and copies and leaves the twins out."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def entry(key, device):
        return SimpleNamespace(key=key, count=2,
                               device_type=f"DeviceType.{device}")

    prof = SimpleNamespace(key_averages=lambda: [
        entry("block_best_kernel", "CUDA"), entry("Memcpy DtoH", "CUDA"),
        entry("mm.engine.step", "CUDA"), entry("mm.collect", "CUDA"),
        entry("mm.engine.step", "CPU"), entry("aten::copy_", "CPU")])
    assert ([e.key for e in smoke.device_work(prof)]
            == ["block_best_kernel", "Memcpy DtoH"])
