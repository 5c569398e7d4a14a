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
           os.path.join(ROOT, "scripts", "torch_service_ab.py"),
           os.path.join(ROOT, "scripts", "torch_profiler_records.py"),
           *(os.path.join(ROOT, "scripts", f) for f in OPERATOR_TOOLS),
           *(os.path.join(ROOT, "scripts", f) for f in PROFILERS)]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "matchmaking_tpu" or name.startswith("matchmaking_tpu."))


#: The port's own analyzer (its trace-time recompile and device rules
#: too), sanitizer and model checker, and its entry points: tools that
#: check or drive the port, importing neither jax nor anything of the JAX
#: package.
NEW_TOOL_MODULES = (
    "matchmaking_tpu_torch.analysis",
    "matchmaking_tpu_torch.analysis.__main__",
    "matchmaking_tpu_torch.analysis.blocking",
    "matchmaking_tpu_torch.analysis.core",
    "matchmaking_tpu_torch.analysis.dataflow",
    "matchmaking_tpu_torch.analysis.determinism",
    "matchmaking_tpu_torch.analysis.device_audit",
    "matchmaking_tpu_torch.analysis.engine",
    "matchmaking_tpu_torch.analysis.lifecycle",
    "matchmaking_tpu_torch.analysis.locks",
    "matchmaking_tpu_torch.analysis.modelcheck",
    "matchmaking_tpu_torch.analysis.perf",
    "matchmaking_tpu_torch.analysis.protocol",
    "matchmaking_tpu_torch.analysis.recompile",
    "matchmaking_tpu_torch.analysis.speculation",
    "matchmaking_tpu_torch.entry",
    "matchmaking_tpu_torch.testing.sanitizer",
    "matchmaking_tpu_torch.testing.scheduler",
)

#: The port's offline operator tools under scripts/.
OPERATOR_TOOLS = ("torch_journal_dump.py", "torch_postmortem.py",
                  "torch_trace_dump.py")

#: The port's stage profilers under scripts/ (the JAX ``profile_*.py``'s
#: counterparts): they import neither jax, the JAX package nor ``bench``.
PROFILERS = ("torch_profile_step.py", "torch_profile_stages.py",
             "torch_profile_engine.py")


def test_every_submodule_is_listed():
    mods = _modules()
    for must in ("matchmaking_tpu_torch.config",
                 "matchmaking_tpu_torch.core.pool",
                 "matchmaking_tpu_torch.engine.gpu",
                 "matchmaking_tpu_torch.engine.interface",
                 "matchmaking_tpu_torch.engine.kernels",
                 "matchmaking_tpu_torch.engine.quality",
                 "matchmaking_tpu_torch.engine.cuda_kernels",
                 "matchmaking_tpu_torch.engine.sharded",
                 "matchmaking_tpu_torch.engine.distributed",
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
                 "matchmaking_tpu_torch.testing.fake_pika",
                 *NEW_TOOL_MODULES,
                 "matchmaking_tpu_torch.scenario",
                 "matchmaking_tpu_torch.control",
                 "matchmaking_tpu_torch.control.autotune",
                 "matchmaking_tpu_torch.service.amqp_transport",
                 "matchmaking_tpu_torch.service.loadgen",
                 "matchmaking_tpu_torch.service.multiproc",
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


@pytest.mark.parametrize("module", ["matchmaking_tpu_torch.engine.sharded",
                                    "matchmaking_tpu_torch.engine.distributed"])
def test_the_sharded_modules_import_no_jax(module):
    """The sharded pool and the multi-host runtime import neither jax nor
    the JAX package (whose twins of them are jax's ``shard_map`` and
    ``jax.distributed``), in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'matchmaking_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("module", NEW_TOOL_MODULES)
def test_the_tool_modules_import_no_jax(module):
    """Each of the port's tools alone, in a fresh interpreter, loads
    neither jax nor the JAX package (the sanitizer's twins patch the
    port's own classes; the model checker drives the port's objects)."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'matchmaking_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("script", OPERATOR_TOOLS)
def test_the_operator_tools_import_no_jax(script):
    """Each offline operator tool, loaded as its own module in a fresh
    interpreter (its lazy imports too: the gap classifier, the postmortem
    analyzer), loads neither jax nor the JAX package."""
    code = (
        "import importlib.util, os, sys\n"
        f"path = os.path.join('scripts', {script!r})\n"
        "sys.path.insert(0, 'scripts')\n"
        "spec = importlib.util.spec_from_file_location('tool', path)\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "import matchmaking_tpu_torch.service.attribution\n"
        "import torch_postmortem\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'matchmaking_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("script", PROFILERS)
def test_the_profilers_import_no_jax_nor_bench(script):
    """Each stage profiler, loaded as its own module in a fresh interpreter
    and driven through its lazy imports (the engine, its kernels, the
    graphs), loads neither jax, the JAX package nor ``bench.py``; nor
    does its source name them."""
    path = os.path.join(ROOT, "scripts", script)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not [n for n in names if _forbidden(n)
                        or n.split(".")[0] == "bench"], (script, node.lineno)
    code = (
        "import importlib.util, os, sys\n"
        f"path = os.path.join('scripts', {script!r})\n"
        "spec = importlib.util.spec_from_file_location('prof', path)\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "import matchmaking_tpu_torch.engine.gpu\n"
        "import matchmaking_tpu_torch.engine.graphs\n"
        "import matchmaking_tpu_torch.engine.interface\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'matchmaking_tpu', 'bench'))\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr
