"""Tiny cells for the CPU tests: a configuration of the manifest cut to a
pool of 2,048 slots and windows of 64, on the CPU; and the cell
``glicko2.w1024``, whose files are in the repo but whose entries are not
in ``BENCHMARK.json``, put back as entries only."""

import copy
import json
import shutil
from pathlib import Path

from mmbench import manifest
from mmbench.harness import Cell, run_cell

#: The entries that put ``glicko2.w1024`` in a manifest: its configuration,
#: the cell, its own metric, and the cell in the list of every per-layer
#: metric the ELO cell reports.
GLICKO2 = {
    "config": {"name": "glicko2",
               "source": "https://github.com/OpenMatchmaking/"
                         "microservice-matchmaking BASELINE.json config #4: "
                         "Glicko-2 rating-deviation-weighted search",
               "file": "mmbench/configs/glicko2.json", "reduced": [],
               "why": "the Glicko-2 scorer in block_best, thresholds widening "
                      "5/s from 80 to 250, a rescan tick every second"},
    "workload": {"name": "glicko2.w1024", "config": "glicko2",
                 "traffic": "w1024", "chips": 1,
                 "why": "the same windows through config #4: block_best's "
                        "Glicko-2 path and the 1 s rescan tick's pick"},
    "metric": {"name": "rescan_host_ms", "unit": "ms", "better": "lower",
               "source": "host_clock", "layer": "rescan tick",
               "moves": "matches_per_s", "workloads": ["glicko2.w1024"]},
}


def with_glicko2(root: Path) -> Path:
    """``root`` holding the repo's manifest with ``glicko2.w1024`` added as
    entries, and the configuration files; returns ``root``."""
    man = manifest.load()
    man["configs"].append(GLICKO2["config"])
    man["workloads"].append(GLICKO2["workload"])
    for m in man["per_layer"]:
        if "elo_1v1.w1024" in m.get("workloads", ()):
            m["workloads"].append("glicko2.w1024")
    man["per_layer"].append(GLICKO2["metric"])
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    (root / "mmbench" / "configs").mkdir(parents=True, exist_ok=True)
    for c in man["configs"]:
        shutil.copy(manifest.REPO / c["file"], root / c["file"])
    return root


def shrink(config: dict, traffic: dict, rescan_s: float | None = None):
    c = copy.deepcopy(config)
    c.pop("repo_config", None)  # the shrunk values are the configuration
    c["config"]["engine"].update(pool_capacity=2048, pool_block=256,
                                 batch_buckets=[16, 64])
    c["config"]["batcher"]["max_batch"] = 64
    if rescan_s:
        c["config"]["queues"][0]["rescan_interval_s"] = rescan_s
    t = dict(traffic, window=64, pool_waiting=1500, warm_windows=3,
             trace_windows=4, bank_windows_per_s=400)
    return c, t


def tiny_cell(name: str, trace: bool = False, root=None, rescan_s=None):
    """Cell ``name`` of the manifest at ``root``, shrunk, with the metrics
    a run of it reports."""
    man = manifest.load(root)
    w = manifest.workload(man, name)
    config, traffic = shrink(manifest.config_file(man, w["config"], root),
                             manifest.traffic_file(w["traffic"], root),
                             rescan_s)
    entries = manifest.metrics_for(man, name, trace)
    return Cell(name, config, traffic,
                [(m, manifest.reader(m["name"], root)) for m in entries])


def run_tiny(cell: Cell, seed: int = 7, seconds: float = 0.4, **kw):
    return run_cell(cell, seed, seconds, False, device="cpu", **kw)
