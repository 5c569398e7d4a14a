"""A cell and its control on the card (marker ``gpu``; skips where no card
is found). Run there with ``python3 -m pytest mmbench/tests -m gpu``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def _card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")


def _last_json(*args):
    out = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card_and_is_correct():
    _card()
    result = _last_json("mmbench.run", "--workload", "elo_1v1.w1024",
                        "--seed", str(2**31 + 3), "--seconds", "3",
                        "--trace", "1")[-1]
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["block_best_roofline"]["value"] <= 100


@pytest.mark.gpu
def test_the_control_fails_on_the_card():
    _card()
    for line in _last_json("mmbench.control", "--workload", "elo_1v1.w1024",
                           "--seeds", str(2**31 + 4), "--seconds", "3"):
        assert line["program_correct"] and line["control_fails"], line
