"""The benchmark's CPU tests (``python3 -m pytest mmbench/tests``) and the
one that needs a card (marker ``gpu``: it skips where none is found)."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where none is found")


import pytest  # noqa: E402


@pytest.fixture
def glicko_root(tmp_path):
    """A manifest with ``glicko2.w1024`` put back as entries only."""
    from tinycells import with_glicko2

    return with_glicko2(tmp_path)
