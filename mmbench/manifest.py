"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them.

- a configuration: the file its ``configs`` entry names;
- a traffic mix ``<t>``: ``traffic/<t>.json``;
- a metric ``<m>``: ``metrics/<m>.py``, whose ``read(record)`` returns its
  value or None (nothing to read in this run).

Each is looked for first under ``<root>/mmbench`` (the directory that holds
the manifest: a test's temporary directory adds its own there), then
beside this file.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load(root: Path | None = None) -> dict:
    root = Path(root or REPO)
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _find(root: Path, *parts: str) -> Path:
    for base in (Path(root) / "mmbench", HERE):
        p = base.joinpath(*parts)
        if p.is_file():
            return p
    raise FileNotFoundError("/".join(parts))


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(manifest: dict, name: str, root: Path | None = None) -> dict:
    root = Path(root or REPO)
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, root: Path | None = None) -> dict:
    with open(_find(Path(root or REPO), "traffic", f"{name}.json")) as f:
        return json.load(f)


def reader(name: str, root: Path | None = None):
    """The ``read`` function of metric ``name``."""
    path = _find(Path(root or REPO), "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "mmbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``. A metric
    without ``workloads`` belongs to every cell; a per-layer one, to every
    cell that reports the end-to-end metric it ``moves``."""
    def mine(m: dict) -> bool:
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in manifest["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if mine(m) and m["moves"] in names]
