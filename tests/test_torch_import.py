"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back from the card to the CPU on their own."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import matchmaking_tpu_torch
from matchmaking_tpu_torch.config import Config
from matchmaking_tpu_torch.engine.interface import make_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "matchmaking_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        matchmaking_tpu_torch.__path__, "matchmaking_tpu_torch."))


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "torch_service_ab.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "matchmaking_tpu" or name.startswith("matchmaking_tpu."))


def test_every_submodule_is_listed():
    mods = _modules()
    for must in ("matchmaking_tpu_torch.config",
                 "matchmaking_tpu_torch.core.pool",
                 "matchmaking_tpu_torch.engine.gpu",
                 "matchmaking_tpu_torch.engine.interface",
                 "matchmaking_tpu_torch.engine.kernels",
                 "matchmaking_tpu_torch.engine.quality",
                 "matchmaking_tpu_torch.engine.cuda_kernels",
                 "matchmaking_tpu_torch.engine.cpu",
                 "matchmaking_tpu_torch.engine.roles",
                 "matchmaking_tpu_torch.engine.role_kernels",
                 "matchmaking_tpu_torch.engine.scoring",
                 "matchmaking_tpu_torch.engine.teams",
                 "matchmaking_tpu_torch.native",
                 "matchmaking_tpu_torch.native.codec",
                 "matchmaking_tpu_torch.net",
                 "matchmaking_tpu_torch.net.transport",
                 "matchmaking_tpu_torch.net.nemesis",
                 "matchmaking_tpu_torch.net.lease",
                 "matchmaking_tpu_torch.net.link",
                 "matchmaking_tpu_torch.net.failover_proc",
                 "matchmaking_tpu_torch.testing.drain",
                 "matchmaking_tpu_torch.service.app",
                 "matchmaking_tpu_torch.service.broker",
                 "matchmaking_tpu_torch.service.contract",
                 "matchmaking_tpu_torch.service.middleware",
                 "matchmaking_tpu_torch.service.quality",
                 "matchmaking_tpu_torch.service.overload",
                 "matchmaking_tpu_torch.service.breaker",
                 "matchmaking_tpu_torch.service.batcher",
                 "matchmaking_tpu_torch.service.attribution",
                 "matchmaking_tpu_torch.service.observability",
                 "matchmaking_tpu_torch.service.replication",
                 "matchmaking_tpu_torch.utils.chaos",
                 "matchmaking_tpu_torch.utils.checkpoint",
                 "matchmaking_tpu_torch.utils.forensics",
                 "matchmaking_tpu_torch.utils.invariants",
                 "matchmaking_tpu_torch.utils.journal",
                 "matchmaking_tpu_torch.utils.metrics",
                 "matchmaking_tpu_torch.utils.timeseries",
                 "matchmaking_tpu_torch.utils.trace"):
        assert must in mods


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'matchmaking_tpu' "
        "or m.startswith('matchmaking_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    assert os.path.isfile(path), path
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, ROOT)}:{node.lineno} {bad}"


def test_gpu_backend_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    assert cfg.engine.backend == "gpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(cfg, cfg.queues[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(cfg, cfg.queues[0], device="cuda")
