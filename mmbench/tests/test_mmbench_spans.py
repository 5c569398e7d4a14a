"""The readers of the program's spans inside finalize and refill
(``restore_host_ms``, ``restore_admit_host_ms``, ``release_host_ms``,
``match_ids_host_ms``, ``device_wait_host_ms``): nothing from a program
without the span, a number from a tiny run of the port on the CPU."""

import pytest

from mmbench import manifest
from mmbench.harness import Record
from tinycells import run_tiny, tiny_cell

#: Each new reader and the ``GpuEngine.spans`` key it reads.
NEW = {"restore_host_ms": "restore_s",
       "restore_admit_host_ms": "restore_admit_s",
       "release_host_ms": "release_s",
       "match_ids_host_ms": "match_ids_s",
       "device_wait_host_ms": "wait_s"}

#: The spans of a program that has none of the new keys.
OLDER = {"windows": 40, "requests": 40_000, "matches": 20_000,
         "dispatch_s": 0.08, "turnaround_s": 0.5, "dedupe_s": 0.01,
         "alloc_s": 0.01, "pack_s": 0.01, "h2d_s": 0.01, "step_s": 0.01,
         "finalize_s": 0.2}


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_reader_reads_nothing_without_its_span(name):
    read = manifest.reader(name)
    assert read(Record(cell="elo_1v1.w1024", spans=dict(OLDER))) is None
    assert read(Record(cell="elo_1v1.w1024", spans={})) is None
    spans = dict(OLDER, **{NEW[name]: 0.02})
    assert read(Record(cell="elo_1v1.w1024", spans=spans)) == pytest.approx(
        0.02 / 40 * 1e3)
    spans["windows"] = 0
    assert read(Record(cell="elo_1v1.w1024", spans=spans)) is None


def test_a_tiny_traced_run_reads_every_new_span():
    result, _ = run_tiny(tiny_cell("elo_1v1.w1024", trace=True))
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    for name in NEW:
        assert result["metrics"][name]["unit"] == "ms"
        assert isinstance(m[name], float) and m[name] >= 0.0
    assert m["restore_host_ms"] > 0.0 and m["release_host_ms"] > 0.0
    assert m["release_host_ms"] + m["match_ids_host_ms"] <= m["finalize_host_ms"]
    assert m["restore_admit_host_ms"] <= m["restore_host_ms"]


def test_elo_reports_eleven_per_layer_metrics():
    man = manifest.load()
    names = [m["name"] for m in manifest.metrics_for(man, "elo_1v1.w1024",
                                                     True)]
    assert len(names) == 11 and set(NEW) <= set(names)
    assert {m["layer"] for m in man["per_layer"] if m["name"] in NEW} == {
        "engine host"}
