"""The port's ``recompile`` rule (matchmaking_tpu_torch/analysis/recompile.py)
and the kernels as operators a tracer sees.

- The twins of JAX's trace-time cases (``tests/test_matchlint.py``'s
  ``test_recompile_dynamic_catches_jaxpr_drift``): a step whose trace
  reads a Python counter drifts, a stable one does not; a step that
  cannot be traced is a finding.
- Every step the port captures traces on the CPU, twice, to equal graph
  code, with its ``mm_torch::block_best`` / ``quality_accum`` nodes (D of
  them on the sharded steps): the pruned, bucketed, bucketed-rescan,
  frontier and sharded steps too, whose CPU kernels read the span on the
  host where no trace enters. The role step's first trace differs from
  later ones (its constant tables are built lazily), so the drift check
  warms each step once.
- The operators on the CPU equal the plain versions they dispatch to.
- The static closure scan over capture sites: a capture's ``fn`` made by
  a factory that returns a closure over a rebound name is flagged; bound
  once it is clean (``GpuEngine._step_fn``'s form).
- ``trace_families`` leaves the process's default device, dtype and
  deterministic-algorithms switch as they were.

Everything runs on the CPU, at the JAX package's canonical geometry
(capacity 64, windows of 16).
"""

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from matchmaking_tpu_torch.analysis import recompile
from matchmaking_tpu_torch.analysis.engine import analyze_source
from matchmaking_tpu_torch.engine import cuda_kernels, kernels, scoring
from matchmaking_tpu_torch.engine.role_kernels import RoleKernelSet

#: Each captured family and its kernel operator nodes (block_best,
#: quality_accum) in one trace.
FAMILY_NODES = {
    "kernels.1v1.search_step_packed": (1, 0),
    "kernels.1v1.search_step_packed_nofilter": (1, 0),
    "kernels.1v1.search_step_packed_rescan": (1, 0),
    "kernels.1v1.admit_packed": (0, 0),
    "kernels.1v1.evict": (0, 0),
    "kernels.1v1-glicko2.search_step_packed": (1, 0),
    "kernels.1v1-glicko2.search_step_packed_nofilter": (1, 0),
    "kernels.1v1-glicko2.search_step_packed_rescan": (1, 0),
    "kernels.1v1-glicko2.admit_packed": (0, 0),
    "kernels.1v1-glicko2.evict": (0, 0),
    "gpu.GpuEngine._step_fn(dense)": (1, 1),
    "kernels.pruned.search_step_packed": (1, 0),
    "kernels.bucketed.search_step_packed": (1, 0),
    "kernels.bucketed.search_step_packed_nofilter": (1, 0),
    "kernels.bucketed.search_step_packed_rescan": (1, 0),
    "sharded.bucket_step(8)": (1, 0),
    "sharded.search_step_packed(all-gather)": (4, 0),
    "sharded.search_step_packed(ring)": (4, 0),
    "teams.search_step_packed": (0, 0),
    "role_kernels.search_step_packed": (0, 0),
    "role_kernels.admit_packed": (0, 0),
    "cuda_kernels.block_best": (1, 0),
}


@pytest.fixture(scope="module")
def traces():
    return recompile.trace_families("cpu")


def test_drift_on_a_counter_and_none_on_a_stable_step():
    calls = {"n": 0}

    def drifting(x):
        calls["n"] += 1
        return x + calls["n"]

    out = []
    recompile._drift(drifting, lambda v: (torch.zeros(4),), "drifting",
                     "fixture", out)
    assert len(out) == 1 and "trace drift" in out[0].message

    def stable(x):
        return x * 2.0

    out = []
    recompile._drift(stable, lambda v: (torch.full((4,), float(v)),),
                     "stable", "fixture", out)
    assert out == []


def test_a_step_that_cannot_be_traced_is_a_finding():
    def broken(x):
        raise RuntimeError("no")

    out = []
    recompile._drift(broken, lambda v: (torch.zeros(4),), "broken",
                     "fixture", out)
    assert len(out) == 1 and "could not trace broken" in out[0].message


@pytest.mark.parametrize("name", sorted(FAMILY_NODES))
def test_every_captured_step_traces_stable_with_its_kernel_nodes(
        traces, name):
    (t,) = [t for t in traces if t.family.name == name]
    assert t.error is None, t.error
    assert t.code[0] == t.code[1]
    assert recompile.drift_findings(t) == []
    bb, qa = FAMILY_NODES[name]
    assert recompile.kernel_nodes(t.graph) == {"block_best": bb,
                                               "quality_accum": qa}
    assert (t.family.block_best, t.family.quality_accum) == (bb, qa)


def test_the_families_are_every_captured_step(traces):
    assert sorted(t.family.name for t in traces) == sorted(FAMILY_NODES)
    assert recompile.check_dynamic(traces=traces) == []


def test_the_role_step_warms_before_its_drift_check():
    # A fresh role set builds its constant tables at its first step: a
    # cold trace records their creation, a later one does not.
    rks = RoleKernelSet(capacity=32, team_size=2, role_slots=("tank", "dps"),
                        widen_per_sec=5.0, max_threshold=400.0,
                        max_matches=8, rounds=4)

    def args(v):
        return (recompile.canonical_pool(rks, v),
                recompile.canonical_packed(rks, 16, v))

    cold = recompile.trace(rks.search_step_packed, args(0)).code
    warm = recompile.trace(rks.search_step_packed, args(1)).code
    assert cold != warm
    again = RoleKernelSet(capacity=32, team_size=2,
                          role_slots=("tank", "dps"), widen_per_sec=5.0,
                          max_threshold=400.0, max_matches=8, rounds=4)
    res = recompile.run_family(recompile.Family(
        "role", "ctx", again.search_step_packed, args))
    assert res.error is None and res.code[0] == res.code[1]


def _block_best_inputs(seed, capacity=128, rows=16, pool_block=32):
    rng = np.random.default_rng(seed)
    pool = kernels.fresh_pool(capacity, "cpu")
    n = capacity // 2
    pool["rating"][:n] = torch.from_numpy(
        rng.normal(1500, 200, n).astype(np.float32))
    pool["rd"][:n] = torch.from_numpy(
        rng.uniform(30, 200, n).astype(np.float32))
    pool["threshold"][:n] = 150.0
    pool["active"][:n] = True
    batch = {"slot": torch.arange(rows, dtype=torch.int32),
             "rating": torch.from_numpy(
                 rng.normal(1500, 200, rows).astype(np.float32)),
             "rd": torch.from_numpy(
                 rng.uniform(30, 200, rows).astype(np.float32)),
             "region": torch.zeros(rows, dtype=torch.int32),
             "mode": torch.zeros(rows, dtype=torch.int32),
             "valid": torch.ones(rows, dtype=torch.bool)}
    q = torch.full((rows,), 150.0)
    now = torch.full((1,), 2.0)
    kw = dict(pool_block=pool_block, glicko2=True, filters=True,
              widen_per_sec=5.0, max_threshold=400.0,
              g_coeff=scoring.G_COEFF_F32)
    return pool, batch, q, now, kw


@pytest.mark.parametrize("span", [False, True])
def test_block_best_op_equals_the_plain_version_on_the_cpu(span):
    pool, batch, q, now, kw = _block_best_inputs(3)
    sp = (cuda_kernels.Span(torch.tensor([0, 1], dtype=torch.int32), 8, 2,
                            torch.tensor([True]))
          if span else None)
    got = cuda_kernels.block_best(pool, batch, q, now, span=sp, **kw)
    want = (cuda_kernels.block_best_span_reference(pool, batch, q, now, sp,
                                                   **kw)
            if span else cuda_kernels.block_best_reference(pool, batch, q,
                                                           now, **kw))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    # One node in a trace, whatever the CPU kernel reads on the host.
    gm = make_fx(lambda *a: cuda_kernels.block_best(
        pool, batch, q, now, span=sp, **kw))()
    assert recompile.kernel_nodes(gm) == {"block_best": 1,
                                          "quality_accum": 0}


def test_kernel_nodes_reads_the_operators_own_namespace(monkeypatch):
    """A copy of ``cuda_kernels`` loaded under another module name
    registers its operators in a namespace of its own; the node count
    follows the module the engine uses, not the literal ``mm_torch``."""
    import importlib.util

    from matchmaking_tpu_torch import engine

    spec = importlib.util.spec_from_file_location(
        "copy_of_cuda_kernels", cuda_kernels.__file__)
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    assert copy.OP_NAMESPACE != cuda_kernels.OP_NAMESPACE
    pool, batch, q, now, kw = _block_best_inputs(3)
    gm = make_fx(lambda: copy.block_best(pool, batch, q, now, **kw))()
    monkeypatch.setattr(engine, "cuda_kernels", copy)
    assert recompile.kernel_nodes(gm) == {"block_best": 1,
                                          "quality_accum": 0}


def test_quality_accum_op_mutates_the_state_as_the_plain_version():
    from matchmaking_tpu_torch.engine.quality import QualitySpec

    spec = QualitySpec()
    qk = kernels.QualityAccumKernel(
        capacity=64, widen_per_sec=5.0, max_threshold=400.0,
        rating_edges=spec.rating_edges, n_quality=spec.n_quality,
        wait_edges=spec.wait_edges)
    rng = np.random.default_rng(8)
    pool = {c: torch.from_numpy(rng.uniform(0, 2000, 64).astype(np.float32))
            for c in ("rating", "enqueue_t", "threshold")}
    out = torch.stack([torch.arange(16, dtype=torch.float32),
                       torch.arange(16, 32, dtype=torch.float32),
                       torch.from_numpy(rng.uniform(0, 90, 16)
                                        .astype(np.float32))])
    out[0, 12:] = 64.0  # padding lanes
    out[2, 12:] = float("inf")
    got, want = qk.init_state("cpu"), qk.init_state("cpu")
    qk.accum(got, pool, out, torch.full((1,), 2500.0))
    cuda_kernels.quality_accum_reference(
        want, pool["rating"], pool["enqueue_t"], pool["threshold"], out,
        2500.0, widen_per_sec=5.0, max_threshold=400.0,
        rating_edges=qk.rating_edges, n_quality=qk.n_quality,
        wait_edges=qk.wait_edges)
    assert torch.equal(got.flat, want.flat)
    gm = make_fx(lambda flat, o: qk.accum(
        kernels.QualityState(flat, qk.shapes), pool, o,
        torch.full((1,), 1.0)))(got.flat.clone(), out)
    assert recompile.kernel_nodes(gm) == {"block_best": 0,
                                          "quality_accum": 1}


_FACTORY = '''
class Engine:
    def _step_fn(self, variant):
        step = self.kernels.dense
        if variant == "rescan":
            step = self.kernels.rescan
        state = self.state

        def run(pool, packed):
            return step(pool, packed), state
        return run

    def _step_graph(self, variant, bucket):
        return self._graphs.capture(variant, bucket, self._step_fn(variant),
                                    self.pool, None, self.pool)
'''


def test_a_capture_of_a_closure_over_a_rebound_name_is_flagged():
    findings = analyze_source(_FACTORY,
                              path="matchmaking_tpu_torch/engine/gpu.py")
    rc = [f for f in findings if f.rule == "recompile"]
    assert len(rc) == 1 and rc[0].line == 9, findings
    assert "'step'" in rc[0].message and "more than once" in rc[0].message
    once = _FACTORY.replace(
        '''        step = self.kernels.dense
        if variant == "rescan":
            step = self.kernels.rescan
''', '''        step = self._variant_step(variant)
''')
    assert [f for f in analyze_source(
        once, path="matchmaking_tpu_torch/engine/gpu.py")
        if f.rule == "recompile"] == []


def test_freezers_and_loop_captures():
    findings = analyze_source('''
import torch

def build():
    fns = []
    for k in range(3):
        fns.append(torch.cuda.make_graphed_callables(lambda x: x * k, (1,)))
    n = 0
    n += 1

    @torch.compile
    def f(x):
        return x + n
    return fns, f
''', path="matchmaking_tpu_torch/engine/kernels.py")
    rc = sorted((f.line, f.message.split(" captures ")[0])
                for f in findings if f.rule == "recompile")
    assert rc == [(7, "jitted lambda@7"), (12, "jitted f")], findings


def test_tracing_changes_no_process_global_state():
    dev, dt = torch.empty(0).device, torch.get_default_dtype()
    det = torch.are_deterministic_algorithms_enabled()
    recompile.trace_families("cpu")
    assert torch.empty(0).device == dev
    assert torch.get_default_dtype() == dt
    assert torch.are_deterministic_algorithms_enabled() == det


def test_the_first_operator_call_loads_no_compiler_stack():
    """The operators' kernels are registered as plain functions: their
    first call (a service's first window) imports nothing more. A
    ``torch.library.custom_op`` kernel imports ``torch._dynamo`` there,
    ~2 s under the pool lock."""
    import os
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "from matchmaking_tpu_torch.analysis import recompile\n"
        "fam = [f for f in recompile.families('cpu')\n"
        "       if f.name == 'gpu.GpuEngine._step_fn(dense)'][0]\n"
        "fam.fn(*fam.make_args(0))\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith('torch._dynamo')))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
