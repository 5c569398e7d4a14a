"""BENCHMARK.json against the benchmark's contract, and every piece of it
found by its name."""

import json
import re

from mmbench import manifest

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    man = manifest.load()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in man["command"])
    assert man["paths"] == ["mmbench"]
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    man = manifest.load()
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metrics_follow_the_contract():
    man = manifest.load()
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"] for m in man["end_to_end"]}
    assert e2e == {"matches_per_s", "latency_mean_ms", "setup_s"}
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["unit"] == "%":
            assert m["better"] in ("lower", "higher")
    # ``rescan_host_ms`` reads only what ``glicko2.w1024`` does: it is out
    # with that cell, and comes back with it.
    assert "rescan_host_ms" not in {m["name"] for m in man["per_layer"]}


def test_every_configuration_traffic_and_metric_is_found_by_name():
    man = manifest.load()
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("mmbench/")
        body = manifest.config_file(man, c["name"])
        assert body["reduced"] == c["reduced"] == []
        assert {"queues", "engine", "batcher"} <= set(body["config"])
    for w in man["workloads"]:
        assert manifest.traffic_file(w["traffic"])["kind"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_which_metrics_a_run_reports(glicko_root):
    man = manifest.load(glicko_root)
    e2e = [m["name"] for m in manifest.metrics_for(man, "elo_1v1.w1024",
                                                   False)]
    assert e2e == ["matches_per_s", "latency_mean_ms", "setup_s"]
    elo = {m["name"] for m in manifest.metrics_for(man, "elo_1v1.w1024",
                                                   True)}
    gl = {m["name"] for m in manifest.metrics_for(man, "glicko2.w1024",
                                                  True)}
    assert gl - elo == {"rescan_host_ms"} and len(elo) == 6


def test_each_configuration_is_what_the_repo_file_gives():
    """Every value a configuration file states, which the reference reads,
    is the value ``Config.from_json`` of the repo file it names gives the
    engine; a stated value the repo file no longer gives stops the run."""
    import copy

    import pytest

    from mmbench.harness import engine_config

    man = manifest.load()
    for c in man["configs"]:
        file = manifest.config_file(man, c["name"])
        assert (manifest.REPO / file["repo_config"]).is_file()
        cfg = engine_config(file)
        assert cfg.queues[0].rating_threshold == (
            file["config"]["queues"][0]["rating_threshold"])
        drifted = copy.deepcopy(file)
        drifted["config"]["engine"]["pool_block"] += 1
        with pytest.raises(ValueError, match="pool_block"):
            engine_config(drifted)
