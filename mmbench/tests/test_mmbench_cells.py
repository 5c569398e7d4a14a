"""Whole runs of tiny cells on the CPU: each cell of the manifest, a cell
that exists only as files of a test, the control, and the faults that
``correct`` must catch."""

import json

import pytest

from mmbench import manifest
from tinycells import run_tiny, tiny_cell

from matchmaking_tpu_torch.engine import kernels
from matchmaking_tpu_torch.engine.gpu import GpuEngine


@pytest.mark.parametrize("name,rescan_s", [("elo_1v1.w1024", None),
                                           ("glicko2.w1024", 0.1)])
def test_each_cell_runs_tiny_and_is_correct(name, rescan_s, glicko_root):
    result, notes = run_tiny(tiny_cell(name, root=glicko_root,
                                       rescan_s=rescan_s))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"matches_per_s", "latency_mean_ms",
                                      "setup_s"}
    assert result["metrics"]["matches_per_s"]["value"] > 0
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"answers_wrong": {"value": 0, "limit": 0},
                                "pool_wrong": {"value": 0, "limit": 0}}
    assert not any(notes["check_details"].values())


def test_a_cell_added_as_files_only_runs(tmp_path):
    """A configuration, a traffic mix and a per-layer metric that exist
    only in the test's directory: the harness finds each by its name."""
    man = manifest.load()
    (tmp_path / "mmbench" / "configs").mkdir(parents=True)
    (tmp_path / "mmbench" / "traffic").mkdir()
    (tmp_path / "mmbench" / "metrics").mkdir()
    cfg = json.loads((manifest.REPO / "mmbench/configs/glicko2.json")
                     .read_text())
    cfg["config"]["queues"][0].update(rating_threshold=60.0,
                                      widen_per_sec=20.0)
    (tmp_path / "mmbench/configs/slow_widen.json").write_text(json.dumps(cfg))
    traffic = manifest.traffic_file("w1024")
    traffic["wait_s"] = {"dist": "uniform", "lo": 0.0, "hi": 5.0}
    (tmp_path / "mmbench/traffic/fresh.json").write_text(json.dumps(traffic))
    (tmp_path / "mmbench/metrics/windows_seen.py").write_text(
        "def read(rec):\n    return float(rec.windows)\n")
    man["configs"].append({"name": "slow_widen", "source": "a test",
                           "file": "mmbench/configs/slow_widen.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "slow_widen.fresh",
                             "config": "slow_widen", "traffic": "fresh",
                             "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "windows_seen", "unit": "windows",
                             "better": "higher", "source": "host_clock",
                             "layer": "client pipeline",
                             "moves": "matches_per_s",
                             "workloads": ["slow_widen.fresh"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = tiny_cell("slow_widen.fresh", trace=True, root=tmp_path,
                     rescan_s=0.1)
    result, _ = run_tiny(cell)
    assert result["correct"], result["checks"]
    # The shipped per-layer metrics name their cells; the new one is the
    # new cell's own.
    assert set(result["metrics"]) == {"windows_seen"}
    assert result["metrics"]["windows_seen"]["value"] > 0
    # With ``--trace 0`` the shipped end-to-end readers, found beside the
    # test's files, read the new cell too.
    result, _ = run_tiny(tiny_cell("slow_widen.fresh", root=tmp_path,
                                   rescan_s=0.1))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"matches_per_s", "latency_mean_ms",
                                      "setup_s"}


def test_the_control_fails_the_comparison(glicko_root):
    """The reference in bfloat16, put in the program's place, fails the
    numbers that the program passes."""
    for name, rescan_s in (("elo_1v1.w1024", None), ("glicko2.w1024", 0.1)):
        result, notes = run_tiny(tiny_cell(name, root=glicko_root,
                                           rescan_s=rescan_s), control=True)
        assert result["correct"], result["checks"]
        ctrl = notes["control"]
        assert all(ctrl[k] > c["limit"] for k, c in result["checks"].items())


def _faulty(monkeypatch, fault):
    if fault == "state_unchanged":
        # The step leaves the pool as it was: no matched slot is emptied.
        monkeypatch.setattr(kernels, "evict", lambda pool, slots: None)
    elif fault == "half_batch":
        unpack = kernels.unpack_batch

        def half(packed):
            b = unpack(packed)
            valid = b["valid"].clone()
            valid[valid.shape[0] // 2:] = False
            return dict(b, valid=valid)
        monkeypatch.setattr(kernels, "unpack_batch", half)
    elif fault == "answer_altered":
        pair = kernels.greedy_pair

        def altered(*a, **k):
            q, c, d = pair(*a, **k)
            d = d.clone()
            d[0] += 1.0
            return q, c, d
        monkeypatch.setattr(kernels, "greedy_pair", altered)
    elif fault == "answer_lost":
        collect = GpuEngine.collect_ready
        lost = []

        def losing(self):
            done = collect(self)
            if done and not lost:
                lost.append(done.pop(0))
            return done
        monkeypatch.setattr(GpuEngine, "collect_ready", losing)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "answer_lost"])
@pytest.mark.parametrize("name,rescan_s", [("elo_1v1.w1024", None),
                                           ("glicko2.w1024", 0.1)])
def test_a_broken_step_is_not_correct(monkeypatch, fault, name, rescan_s,
                                     glicko_root):
    """The rest of a run with the timed path broken underneath: each fault
    a one-chip cell can have (there is no exchange between chips to leave
    out) turns ``correct`` false."""
    _faulty(monkeypatch, fault)
    result, _ = run_tiny(tiny_cell(name, root=glicko_root,
                                   rescan_s=rescan_s))
    assert not result["correct"]
