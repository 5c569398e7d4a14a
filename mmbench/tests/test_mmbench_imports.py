"""No module the benchmark imports is JAX's or the JAX package's, compared
by whole top-level names (the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from mmbench import run

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "matchmaking_tpu"}
#: The modules that work out ``correct``: nothing of the program.
REFERENCE = ("reference.py", "compare.py", "roofline.py")


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_check_compares_whole_top_level_names():
    assert run.banned_modules(["matchmaking_tpu_torch",
                               "matchmaking_tpu_torch.engine.gpu",
                               "jaxtyping", "flaxen"]) == []
    assert run.banned_modules(["matchmaking_tpu.engine.tpu", "jax._src.core",
                               "jaxlib", "flax.linen", "numpy"]) == [
        "flax", "jax", "jaxlib", "matchmaking_tpu"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _top_level_imports(f) & BANNED, f


def test_the_reference_imports_nothing_of_the_port():
    for name in REFERENCE:
        names = _top_level_imports(HERE / name)
        assert "matchmaking_tpu_torch" not in names, name
        assert not names & BANNED, name


def _fresh_python(code: str) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'mmbench/tests')\n"
        "import tempfile\n"
        "from pathlib import Path\n"
        "from tinycells import run_tiny, tiny_cell, with_glicko2\n"
        "from mmbench import run\n"
        "root = with_glicko2(Path(tempfile.mkdtemp()))\n"
        "for name in ('elo_1v1.w1024', 'glicko2.w1024'):\n"
        "    result, _ = run_tiny(tiny_cell(name, root=root, rescan_s=0.1))\n"
        "    assert result['correct'], result['checks']\n"
        "print(run.banned_modules(sys.modules))\n")
    assert _fresh_python(code) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys\n"
            "import mmbench.compare, mmbench.reference, mmbench.roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'matchmaking_tpu_torch', 'matchmaking_tpu', 'jax'}))\n")
    assert _fresh_python(code) == "[]"
