"""One run of one cell: set-up, the timed window, the traced slice and the
check of every answer against the reference.

The engine is ``matchmaking_tpu_torch``'s, built by ``make_engine`` from
the repo's configuration file that the cell's file names
(``engine_config``). Set-up restores the traffic's
``pool_waiting`` players with ``restore_columns``, calls ``warmup()`` and
runs ``warm_windows`` windows (and a rescan tick, where the configuration
rescans) through the same loop as the window, then ``gc.collect()``.

The loop is closed at the configuration's ``pipeline_depth``: hand a
window to ``search_columns_async``; while ``pipeline_depth`` windows are in
flight, take answers from ``collect_ready``; after each answered window,
restore as many fresh players as it took out of the pool, so that the
backlog stays where it was; every ``rescan_interval_s`` of the window, a
``rescan_async`` tick. At the close no window is handed over any more and
``flush`` takes the rest. A request's latency runs from the hand-off of
its window to its answer in the harness's hands.

Every call and every answer goes into a log, which ``reference.py``
replays after the window to work out every answer again.

Beside the result, the notes on standard error say what the host did in
the window: windows per ``collect_ready``, the collector's passes and
their time, the main thread's CPU time, and the matches in each fifth of
the window.
"""

from __future__ import annotations

import collections
import gc
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from mmbench import compare, manifest, traffic as traffic_mod
from mmbench.trace import Tracer


def _plain(v):
    return [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v


def config_differences(stated: dict, got: dict) -> list[str]:
    """The values of ``stated`` (a configuration file's ``config``) that
    ``got`` (``Config.to_dict()``) does not hold."""
    out = []
    for section, want in stated.items():
        have = got.get(section)
        if section == "queues":
            if len(want) != len(have):
                out.append(f"queues: {len(have)} queues, not {len(want)}")
                continue
            pairs = [(f"queues[{i}]", w, h)
                     for i, (w, h) in enumerate(zip(want, have))]
        else:
            pairs = [(section, want, have)]
        for where, w, h in pairs:
            out += [f"{where}.{k}: {_plain(h.get(k))!r}, not {v!r}"
                    for k, v in w.items() if _plain(h.get(k)) != _plain(v)]
    return out


def engine_config(file: dict, root=None):
    """The ``Config`` the engine runs. Where the configuration file names
    the repo's own file (``repo_config``), that file, by
    ``Config.from_json``; every value the configuration file states under
    ``config`` (what the reference reads) has to be what the engine gets,
    or the run stops here. Without ``repo_config`` (the CPU tests' shrunk
    cells), ``config`` itself."""
    from matchmaking_tpu_torch.config import Config

    src = file.get("repo_config")
    if src is None:
        return Config.from_dict(file["config"], backend="gpu")
    cfg = Config.from_json(str(Path(root or manifest.REPO) / src),
                           backend="gpu")
    bad = config_differences(file["config"], cfg.to_dict())
    if bad:
        raise ValueError(f"{src} no longer gives what the benchmark's "
                         f"configuration states: {'; '.join(bad)}")
    return cfg


class _HostClock:
    """What the host did over the window: the collector's passes and their
    seconds (``gc.callbacks``) and the main thread's CPU seconds."""

    def __init__(self):
        self.gc_passes = [0, 0, 0]
        self.gc_s = 0.0
        self._t = 0.0

    def _gc(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_passes[info["generation"]] += 1
            self.gc_s += time.perf_counter() - self._t

    def start(self) -> None:
        self._thread = time.thread_time()
        gc.callbacks.append(self._gc)

    def stop(self) -> dict:
        gc.callbacks.remove(self._gc)
        return {"gc_passes": self.gc_passes, "gc_s": round(self.gc_s, 4),
                "thread_cpu_s": round(time.thread_time() - self._thread, 3)}


@dataclass
class Cell:
    """A cell as the manifest and its files give it."""

    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    metrics: list         # (entry, reader) of the metrics this run reports


@dataclass
class Record:
    """What one run saw: the metric readers read this."""

    cell: str
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: int = 0
    matches: int = 0
    windows: int = 0
    latency_s: list = field(default_factory=list)   # (requests, seconds)
    rescan_s: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    slice: dict | None = None
    work: list = field(default_factory=list)        # (kind, pairs, lanes)
    geometry: dict = field(default_factory=dict)
    power_limit_w: float | None = None
    notes: dict = field(default_factory=dict)       # printed beside the line


class Loop:
    """The closed loop over one engine, with its log."""

    def __init__(self, eng, traffic, depth: int, rescan_every: float,
                 rescan_rows: int, columns):
        self.eng = eng
        self.traffic = traffic
        self.depth = depth
        self.rescan_every = rescan_every
        self.rescan_rows = rescan_rows
        self.columns = columns
        self.tracer = Tracer()
        self.log: list[tuple] = []
        #: Each answer as the check reads it (``compare.Answer``: the rest
        #: of the engine's outcome is let go at once), and the requests
        #: each window had refused.
        self.answers: dict[int, object] = {}
        self.refused: dict[int, int] = {}
        self.kind: dict[int, str] = {}
        self.sent_at: dict[int, float] = {}
        self.size: dict[int, int] = {}
        self.next_window = 0
        self.measuring = False
        self.measured: set[int] = set()
        self.latency: list[tuple[int, float]] = []
        self.matches = 0
        self.requests = 0
        #: Windows per ``collect_ready`` that answered, and (time, matches)
        #: of each answer, in the window.
        self.per_collect: collections.Counter = collections.Counter()
        self.answered_at: list[tuple[float, int]] = []
        self.rescan_s: list[float] = []
        self.steps = 0  # window and rescan chunks handed over

    # -- calls --------------------------------------------------------------

    def _cols(self, rows, now: float):
        n = len(rows)
        return self.columns(
            ids=rows.ids, rating=rows.rating, rd=rows.rd,
            region=np.zeros(n, np.int32), mode=np.zeros(n, np.int32),
            threshold=np.full(n, np.nan, np.float32),
            enqueued_at=now - rows.wait)

    def restore(self, rows) -> None:
        now = time.time()
        cols = self._cols(rows, now)
        self.log.append(("restore", rows.ids, rows.rating, rows.rd,
                         cols.enqueued_at, now))
        self.eng.restore_columns(cols, now)

    def dispatch(self) -> None:
        rows = self.traffic.window(self.next_window)
        self.next_window += 1
        now = time.time()
        cols = self._cols(rows, now)
        with self.tracer.phase("dispatch"):
            t = time.perf_counter()
            tok = self.eng.search_columns_async(cols, now)
        self.log.append(("dispatch", tok, rows.ids, rows.rating, rows.rd,
                         cols.enqueued_at, now))
        self.sent_at[tok], self.size[tok] = t, len(rows)
        self.kind[tok] = "window"
        self.steps += -(-len(rows) // self.eng.buckets[-1])
        if self.measuring:
            self.measured.add(tok)
            self.requests += len(rows)

    def rescan(self) -> None:
        now = time.time()
        with self.tracer.phase("rescan"):
            t = time.perf_counter()
            tok = self.eng.rescan_async(self.rescan_rows, now)
            took = time.perf_counter() - t
        if self.measuring:
            self.rescan_s.append(took)
        if tok is None:
            return
        self.log.append(("rescan", tok, now, self.rescan_rows))
        self.kind[tok] = "rescan"
        top = self.eng.buckets[-1]
        self.steps += -(-min(self.rescan_rows, self.depth * top) // top)
        if self.measuring:
            self.measured.add(tok)

    def _answered(self, done, refill: bool) -> None:
        t = time.perf_counter()
        gone = []
        for tok, out in done:
            self.log.append(("collect", tok))
            self.answers[tok] = compare.as_answer(out)
            self.refused[tok] = len(out.rejected)
            n = out.n_matches
            if tok in self.measured:
                self.matches += n
                self.answered_at.append((t, n))
                if self.kind[tok] == "window":
                    self.latency.append((self.size[tok],
                                         t - self.sent_at[tok]))
            if self.kind[tok] == "window":
                gone.append(max(0, 2 * n - (self.size[tok]
                                            - len(out.rejected))))
            else:
                gone.append(2 * n)
        self.log.append(("pool", self.eng.pool_size()))
        if refill:
            with self.tracer.phase("refill"):
                for n in gone:
                    if n:
                        self.restore(self.traffic.refill(n))

    def wait(self) -> None:
        """Collect until fewer than ``depth`` windows are in flight."""
        eng = self.eng
        while eng.inflight() >= self.depth:
            with self.tracer.phase("collect"):
                done = eng.collect_ready()
                while not done:
                    done = eng.collect_ready()
            if self.measuring:
                self.per_collect[len(done)] += 1
            self._answered(done, refill=True)

    def drain(self) -> None:
        with self.tracer.phase("collect"):
            done = self.eng.flush()
        if done:
            self._answered(done, refill=False)

    def run(self, *, until: float | None = None, count: int | None = None,
            next_rescan: float | None = None) -> None:
        """Windows back to back until ``until`` (perf_counter) or for
        ``count`` windows, a rescan tick at each ``rescan_every``."""
        sent = 0
        while True:
            now = time.perf_counter()
            if until is not None and now >= until:
                break
            if count is not None and sent >= count:
                break
            if next_rescan is not None and now >= next_rescan:
                self.rescan()
                next_rescan += self.rescan_every
            self.dispatch()
            sent += 1
            self.wait()


def _power_limit() -> float | None:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", marks: list | None = None,
             control: bool = False, root=None) -> tuple[dict, dict]:
    """Run ``cell`` once: (the result object, notes for standard error).
    ``control`` adds the control's numbers to the notes; ``root`` is the
    checkout that holds the repo's configuration files."""
    import torch

    from matchmaking_tpu_torch.engine.interface import make_engine
    from matchmaking_tpu_torch.service.contract import RequestColumns

    marks = list(marks or [("start", time.perf_counter())])
    on_card = device != "cpu"
    cfg = engine_config(cell.config, root)
    queue = cfg.queues[0]
    depth = cfg.engine.pipeline_depth
    params = cell.traffic
    rescan_every = (queue.rescan_interval_s
                    if params.get("rescan") and queue.rescan_interval_s > 0
                    else 0.0)
    rescan_rows = queue.rescan_window or cfg.batcher.max_batch
    ticks = (math.ceil(seconds / rescan_every) + 2) if rescan_every else 0
    rec = Record(cell=cell.name)
    marks.append(("import_port", time.perf_counter()))
    traffic = traffic_mod.Traffic(params, seed, seconds, trace, ticks,
                                  rescan_rows)
    marks.append(("inputs", time.perf_counter()))
    eng = make_engine(cfg, queue, device=device)
    marks.append(("make_engine", time.perf_counter()))
    drv = Loop(eng, traffic, depth, rescan_every, rescan_rows, RequestColumns)
    drv.restore(traffic.fill)
    if on_card:
        torch.cuda.synchronize()
    marks.append(("restore", time.perf_counter()))
    eng.warmup()
    marks.append(("warmup", time.perf_counter()))
    drv.run(count=params["warm_windows"])
    if rescan_every:
        drv.rescan()
        drv.wait()
    drv.drain()
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    marks.append(("warm_windows", time.perf_counter()))
    rec.notes["setup_split_s"] = {b[0]: round(b[1] - a[1], 4)
                                  for a, b in zip(marks, marks[1:])}
    spans0 = dict(eng.spans)
    t_start = time.perf_counter()
    rec.setup_s = t_start - marks[0][1]
    host = _HostClock()
    host.start()
    drv.measuring = True
    drv.run(until=t_start + seconds,
            next_rescan=(t_start + rescan_every) if rescan_every else None)
    drv.drain()
    t_end = time.perf_counter()
    drv.measuring = False
    rec.notes["host"] = host.stop()
    fifth = (t_end - t_start) / 5
    rec.notes["host"]["matches_by_fifth"] = [
        sum(n for t, n in drv.answered_at
            if t_start + i * fifth <= t < t_start + (i + 1) * fifth)
        for i in range(5)]
    rec.notes["host"]["windows_per_collect"] = dict(sorted(
        drv.per_collect.items()))
    rec.window_s = t_end - t_start
    rec.spans = {k: eng.spans[k] - spans0[k] for k in spans0}
    rec.requests, rec.matches = drv.requests, drv.matches
    rec.windows = sum(1 for t in drv.measured if drv.kind[t] == "window")
    rec.latency_s, rec.rescan_s = drv.latency, drv.rescan_s
    if trace and on_card:
        steps0 = drv.steps
        drv.log.append(("traced",))  # the reference counts the slice's work
        drv.tracer.start()
        drv.run(count=params["trace_windows"])
        drv.drain()
        drv.tracer.stop()
        rec.slice = drv.tracer.summary(drv.steps - steps0)
        drv.log.append(("untraced",))
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(0))
                                         if on_card else 0)}
    if rec.slice is not None:
        device_info["busy_s"] = rec.slice["busy_s"]
        device_info["window_s"] = rec.slice["window_s"]
    rec.geometry = {"capacity": eng.kernels.capacity,
                    "n_blocks": eng.kernels.n_blocks,
                    "glicko2": bool(queue.glicko2),
                    "widen": queue.widen_per_sec > 0.0}
    if on_card:
        rec.power_limit_w = _power_limit()
    # The program's state goes before the reference runs on the same card.
    eng.close()
    del eng, drv.eng
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, found, ctrl = compare.check(
        drv.log, drv.answers, cell.config["config"],
        device=device,
        on_work=lambda *w: rec.work.append(w), control=control)
    rec.notes["check_s"] = time.perf_counter() - t_check
    rec.notes["check_details"] = found
    if ctrl is not None:
        rec.notes["control"] = ctrl
    failed = sum(drv.refused.get(t, drv.size[t]) for t in drv.measured
                 if drv.kind[t] == "window")
    metrics = {}
    for entry, reader in cell.metrics:
        value = reader(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {"correct": compare.correct(checks),
              "attempted": rec.requests, "failed": failed,
              "metrics": metrics, "device": device_info}
    if rec.slice is not None:
        result["breakdown"] = {"device_ops": rec.slice["device_ops"],
                               "idle_gaps": rec.slice["idle_gaps"]}
    rec.notes.update(bank_cycles=traffic.bank_cycles, windows=rec.windows,
                     card_power_limit_w=rec.power_limit_w)
    result["checks"] = checks
    return result, rec.notes
