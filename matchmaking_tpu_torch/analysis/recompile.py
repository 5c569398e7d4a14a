"""``recompile``: the trace-time gate of the port's captured steps.

The port replays each window step as a captured CUDA graph
(``engine/graphs.py``): the capture runs the step's Python once and the
card replays its kernels from then on. A step whose Python depends on
mutable state (a module counter, a rebound closure scalar, a value read
on the host at capture time) does not fail a replay: it replays stale
work, silently. Two hazards this rule catches before a soak does:

- **trace drift** — every step the port captures is traced twice with
  ``make_fx``, after one warm-up call, on the SAME canonical shapes with
  different values; the two traces' graph code must be equal. Drift means
  the step's Python reads values (a host read baked into the trace as a
  constant) or state that changes between calls — the capture would
  freeze one of them. A step that cannot be traced is a finding too.
- **closure captures** — a function that a capture freezes and that
  closes over a loop variable or a rebound local: the late-binding bug
  (``for k: fns.append(torch.compile(lambda x: x * k))`` traces every
  entry with the LAST k). Detected statically. A capture freezes the
  functions handed to ``torch.compile``, ``torch.jit.script`` /
  ``trace`` and ``torch.cuda.make_graphed_callables``, the ``fn`` of a
  ``.capture(variant, bucket, fn, ...)`` call, and a closure a function
  defines and returns when that result is handed to such a capture
  (``GpuEngine._step_fn`` returns ``run``).

Port of ``matchmaking_tpu/analysis/recompile.py``: make_fx stands for
``jax.make_jaxpr``, graph code for the jaxpr's text. The traces run on
the CPU unless asked otherwise (``--trace-device cuda``), where the
kernels are the custom operators ``mm_torch::block_best`` and
``mm_torch::quality_accum``: one node each in a trace, whose plain CPU
versions (and their host reads) run where no trace enters. Nothing
process-global changes: no default device, seed or algorithm switch;
inputs come from explicit numpy generators with the JAX package's seeds.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
from typing import Any, Callable

from matchmaking_tpu_torch.analysis.core import Finding, SourceFile, dotted_name

RULE = "recompile"

_ENGINE = "matchmaking_tpu_torch/engine/"

#: The kernel modules (host syncs are audited there; ``cuda_kernels.py``
#: is the counterpart of the JAX ``pallas_kernels.py``).
KERNEL_MODULES = tuple(_ENGINE + name for name in (
    "kernels.py", "role_kernels.py", "teams.py", "sharded.py",
    "cuda_kernels.py"))

#: Modules whose capture sites get the static closure scan: the kernel
#: modules, and the engine and graph cache that capture their steps.
CAPTURE_MODULES = KERNEL_MODULES + (_ENGINE + "gpu.py", _ENGINE + "graphs.py")

#: What a capture freezes when handed a function (first argument).
_FREEZERS = frozenset({
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.make_graphed_callables", "make_graphed_callables"})


# ---- static: closure captures ----------------------------------------------

def _is_jit_expr(node: ast.AST) -> bool:
    """True for a freezer (``torch.compile`` ...) or a
    ``(functools.)partial`` of one."""
    name = dotted_name(node)
    if name in _FREEZERS:
        return True
    if isinstance(node, ast.Call) and dotted_name(node.func).endswith(
            "partial") and node.args:
        return _is_jit_expr(node.args[0])
    return False


def _capture_fn_arg(call: ast.Call) -> ast.AST | None:
    """The function a call freezes: a freezer's first argument, or the
    ``fn`` of a ``.capture(variant, bucket, fn, ...)`` call."""
    if _is_jit_expr(call.func) and call.args:
        return call.args[0]
    if isinstance(call.func, ast.Attribute) and call.func.attr == "capture":
        if len(call.args) > 2:
            return call.args[2]
        for kw in call.keywords:
            if kw.arg == "fn":
                return kw.value
    return None


def _bound_names(fn: ast.AST) -> set[str]:
    bound: set[str] = set()
    args = fn.args
    for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
        bound.add(a.arg)
    if args.vararg:
        bound.add(args.vararg.arg)
    if args.kwarg:
        bound.add(args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                bound.add((alias.asname or alias.name).split(".")[0])
    return bound


def _loaded_names(fn: ast.AST) -> set[str]:
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    loads: set[str] = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                loads.add(node.id)
    return loads


def _module_level_names(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and isinstance(sub.ctx,
                                                            ast.Store):
                    names.add(sub.id)
    return names


def _capture_hazard(name: str, stack: list[ast.AST]) -> str | None:
    """Why capturing ``name`` from an enclosing scope is dangerous (None
    when it is bound exactly once: effectively a constant)."""
    for fn in reversed(stack):
        binds = 0
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                for t in ast.walk(node.target):
                    if isinstance(t, ast.Name) and t.id == name:
                        return "bound by a for-loop (late binding: " \
                               "every trace sees the LAST value)"
            if isinstance(node, ast.AugAssign) and isinstance(
                    node.target, ast.Name) and node.target.id == name:
                return "mutated with augmented assignment in the " \
                       "enclosing scope"
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    for t in ast.walk(tgt):
                        if isinstance(t, ast.Name) and t.id == name:
                            binds += 1
        if binds > 1:
            return "rebound more than once in the enclosing scope"
        if binds == 1 or name in {
                a.arg for a in (*fn.args.posonlyargs, *fn.args.args,
                                *fn.args.kwonlyargs)}:
            return None  # bound once here: a per-factory constant
    return None


class _JitSiteScanner(ast.NodeVisitor):
    """Finds the functions a capture freezes and checks their free
    variables against the enclosing function scopes."""

    def __init__(self, sf: SourceFile):
        import builtins

        self.sf = sf
        self.findings: list[Finding] = []
        self._outer = _module_level_names(sf.tree) | set(dir(builtins)) \
            | {"self"}
        self._fn_stack: list[ast.AST] = []
        self._seen: set[tuple[int, str]] = set()
        #: Every def of the module by name: the factories a capture's
        #: ``fn`` may be the result of.
        self._defs: dict[str, list[ast.AST]] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._defs.setdefault(node.name, []).append(node)

    def _check(self, fn: ast.AST, stack: list[ast.AST], site_line: int,
               label: str) -> None:
        for name in sorted(_loaded_names(fn) - _bound_names(fn)
                           - self._outer):
            hazard = _capture_hazard(name, stack)
            if hazard and (site_line, name) not in self._seen:
                self._seen.add((site_line, name))
                self.findings.append(Finding(
                    RULE, self.sf.path, site_line,
                    f"jitted {label} captures Python variable {name!r} "
                    f"{hazard}: bind it via functools.partial / a default "
                    f"arg, or pass it as a traced argument",
                    label))

    def _returned_closures(self, factory: ast.AST):
        """The nested defs (or lambdas) ``factory`` returns."""
        nested = {n.name: n for n in factory.body
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for node in ast.walk(factory):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            if isinstance(node.value, ast.Lambda):
                yield node.value, f"lambda@{node.value.lineno}"
            elif isinstance(node.value, ast.Name) \
                    and node.value.id in nested:
                fn = nested[node.value.id]
                yield fn, fn.name

    def _frozen(self, target: ast.AST, call: ast.Call) -> None:
        if isinstance(target, ast.Lambda):
            self._check(target, self._fn_stack, call.lineno,
                        f"lambda@{call.lineno}")
        elif isinstance(target, ast.Name):
            for fn in reversed(self._fn_stack):
                for sub in fn.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)) \
                            and sub.name == target.id:
                        self._check(sub, self._fn_stack, sub.lineno,
                                    sub.name)
                        return
        elif isinstance(target, ast.Call):
            leaf = dotted_name(target.func).rsplit(".", 1)[-1]
            for factory in self._defs.get(leaf, ()):
                for fn, label in self._returned_closures(factory):
                    self._check(fn, [factory], fn.lineno, label)
        # An attribute (a bound method): nothing lexical closes over.

    def _enter_fn(self, node):
        for deco in getattr(node, "decorator_list", ()):
            if _is_jit_expr(deco):
                self._check(node, self._fn_stack, node.lineno, node.name)
        self._fn_stack.append(node)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _enter_fn
    visit_AsyncFunctionDef = _enter_fn

    def visit_Call(self, node: ast.Call) -> None:
        target = _capture_fn_arg(node)
        if target is not None:
            self._frozen(target, node)
        self.generic_visit(node)


def check_static(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in sources:
        if sf.path in CAPTURE_MODULES:
            v = _JitSiteScanner(sf)
            v.visit(sf.tree)
            findings.extend(v.findings)
    return findings


# ---- dynamic: trace drift under canonical configs --------------------------

def _canonical_arrays(ks, variant: int) -> dict:
    """The JAX ``_canonical_pool``'s arrays (its seeds): half the slots
    active, N(1500, 150) ratings, thresholds 90 + variant."""
    import numpy as np

    from matchmaking_tpu_torch.core.pool import PlayerPool

    capacity = ks.capacity
    init = PlayerPool.empty_device_arrays(capacity)
    for name, spec in getattr(ks, "extra_pool_fields", {}).items():
        dt, n = spec if isinstance(spec, tuple) else (spec, capacity)
        init[name] = np.zeros(n, dt)
    rng = np.random.default_rng(101 + variant)
    n = max(1, capacity // 2)
    for col, vals in (
        ("rating", rng.normal(1500, 150, n)),
        ("rd", rng.uniform(30, 200, n)),
        ("threshold", np.full(n, 90.0 + variant)),
        ("enqueue_t", rng.uniform(0, 3, n)),
    ):
        init[col][:n] = vals.astype(init[col].dtype)
    init["active"][:n] = True
    return init


def canonical_pool(ks, variant: int, device="cpu"):
    """A kernel set's canonical pool on ``device``: a ``DevicePool`` (a
    ``ShardedPool`` for a sharded set, placed on its mesh); a bucketed
    set's index rebuilt exact."""
    from matchmaking_tpu_torch.engine import kernels

    arrays = _canonical_arrays(ks, variant)
    if hasattr(ks, "place_pool"):
        return ks.place_pool(arrays)
    pool = kernels.pool_from_reference(arrays, device,
                                       getattr(ks, "extra_pool_fields", {}))
    if getattr(ks, "bucketed", False):
        ks.index_rebuild(pool)
    return pool


def canonical_packed(ks, b: int, variant: int, device="cpu"):
    """The JAX ``_canonical_packed``: U(0, 1) rows (one more for a role
    set), every lane's slot the padding sentinel."""
    import numpy as np
    import torch

    rng = np.random.default_rng(33 + variant)
    rows = 9 + (1 if getattr(ks, "is_role", False) else 0)
    packed = rng.uniform(0.0, 1.0, (rows, b)).astype(np.float32)
    packed[0] = ks.capacity
    return torch.from_numpy(packed).to(device)


def _flatten(args) -> tuple[list, Callable]:
    """The tensors of a step's arguments (a device pool's full columns, a
    sharded pool's shards' columns, a dict's values, tensors as they are)
    and the function that rebuilds the arguments from them, inside a
    trace."""
    import torch

    from matchmaking_tpu_torch.engine.kernels import DevicePool
    from matchmaking_tpu_torch.engine.sharded import ShardedPool

    flat: list = []
    builders = []
    for a in args:
        if isinstance(a, ShardedPool):
            names = [list(p.full) for p in a.shards]
            start = len(flat)
            for p in a.shards:
                flat.extend(p.full.values())

            def build(ts, a=a, names=names, start=start):
                at, shards = start, []
                for ns in names:
                    shards.append(DevicePool(dict(zip(ns,
                                                      ts[at:at + len(ns)]))))
                    at += len(ns)
                return ShardedPool(shards, a.local_shards, a.local_capacity)
        elif isinstance(a, DevicePool):
            ns, start = list(a.full), len(flat)
            flat.extend(a.full.values())

            def build(ts, ns=ns, start=start):
                return DevicePool(dict(zip(ns, ts[start:start + len(ns)])))
        elif isinstance(a, dict):
            ks_, start = list(a), len(flat)
            flat.extend(a.values())

            def build(ts, ks_=ks_, start=start):
                return dict(zip(ks_, ts[start:start + len(ks_)]))
        elif isinstance(a, torch.Tensor):
            start = len(flat)
            flat.append(a)

            def build(ts, start=start):
                return ts[start]
        else:
            def build(ts, a=a):
                return a
        builders.append(build)
    return flat, lambda ts: [b(ts) for b in builders]


def trace(fn, args, mode: str = "real"):
    """One fresh ``make_fx`` trace of ``fn(*args)``. ``real``: the step
    runs as it traces (the custom operators are one node each, their
    kernels run where no trace enters); ``symbolic``: nothing runs, and a
    host read of a traced value (``.item()``) is recorded as a node where
    a real trace refuses it."""
    from torch.fx.experimental.proxy_tensor import make_fx

    flat, rebuild = _flatten(args)
    return make_fx(lambda *ts: fn(*rebuild(list(ts))),
                   tracing_mode=mode)(*flat)


@dataclasses.dataclass
class Family:
    """One step the port captures, under the canonical config: its name,
    its module, the callable and its arguments' maker (``make_args(v)``:
    fresh arguments, values varied by ``v``), and how many of each kernel
    operator its trace holds."""

    name: str
    ctx: str
    fn: Callable
    make_args: Callable[[int], tuple]
    block_best: int = 0
    quality_accum: int = 0
    #: The set whose pool dtypes stand for the family across families
    #: (device audit), or "".
    dtype_label: str = ""
    #: The mesh whose ring hops the step records, or None.
    ring_mesh: Any = None


@dataclasses.dataclass
class Traced:
    """A family's traces: the two traces' graph code and the second
    graph, or the error that stopped it; what the warm-up call did to the
    pool (``pool_changes``: (field, what, before, after)) and the pool's
    dtypes after it; the ring hops it recorded."""

    family: Family
    code: tuple[str, str] | None = None
    graph: Any = None
    error: str | None = None
    pool_changes: list = dataclasses.field(default_factory=list)
    dtypes: dict = dataclasses.field(default_factory=dict)
    ring_hops: tuple = ()
    #: How the two traces were made: "real", or "symbolic" for a step
    #: that reads a traced value on the host.
    mode: str = "real"


def _columns(pool) -> dict:
    """A pool's columns by name (a sharded pool's by shard and name);
    nothing for an argument that is not a pool."""
    from matchmaking_tpu_torch.engine.sharded import ShardedPool

    if isinstance(pool, ShardedPool):
        return {f"shard{i}.{k}": v for i, p in enumerate(pool.shards)
                for k, v in p.items()}
    return dict(pool.items()) if isinstance(pool, dict) else {}


def _layout(t) -> tuple:
    return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def pool_changes(pool, before: dict) -> list:
    """Each column of ``pool`` that is not the tensor ``before`` recorded
    (its address, dtype, shape or strides changed, or it went)."""
    out = []
    after = _columns(pool)
    for name, want in before.items():
        got = after.get(name)
        got_l = None if got is None else _layout(got)
        if got_l != want:
            out.append((name, want, got_l))
    return out


def run_family(fam: Family) -> Traced:
    """Warm ``fam`` once (recording what the call did to its pool), then
    trace it twice on value-varied arguments of the same shapes."""
    res = Traced(fam)
    try:
        args = fam.make_args(0)
        pool = args[0]
        before = {k: _layout(v) for k, v in _columns(pool).items()}
        if fam.ring_mesh is not None:
            fam.ring_mesh.ring_hops = ()
        fam.fn(*args)
        res.pool_changes = pool_changes(pool, before)
        res.dtypes = {k.split(".")[-1]: v.dtype
                      for k, v in _columns(pool).items()}
        if fam.ring_mesh is not None:
            res.ring_hops = tuple(fam.ring_mesh.ring_hops)
        try:
            g0 = trace(fam.fn, fam.make_args(0))
            g1 = trace(fam.fn, fam.make_args(1))
        except RuntimeError as e:
            if "_local_scalar_dense" not in str(e):
                raise
            # The step reads a traced value on the host: trace it
            # symbolically, where the read is a node the device audit
            # reports (a host round trip), not an error.
            res.mode = "symbolic"
            g0 = trace(fam.fn, fam.make_args(0), "symbolic")
            g1 = trace(fam.fn, fam.make_args(1), "symbolic")
    except Exception as e:  # a trace that raises is a finding
        res.error = f"{type(e).__name__}: {e}"
        return res
    res.code = (g0.code, g1.code)
    res.graph = g1
    return res


def kernel_nodes(graph) -> dict[str, int]:
    """Nodes of the port's kernel operators in a traced graph, by kernel
    name (``StepGraph.launches``' keys), in the operators' namespace
    (``cuda_kernels.OP_NAMESPACE``)."""
    from matchmaking_tpu_torch.engine import cuda_kernels

    out = {"block_best": 0, "quality_accum": 0}
    for node in graph.graph.nodes:
        if node.op != "call_function":
            continue
        target = str(node.target)
        for name in out:
            if target.startswith(f"{cuda_kernels.OP_NAMESPACE}.{name}."):
                out[name] += 1
    return out


def _small_engine(device, **engine_kw):
    from matchmaking_tpu_torch.config import Config, EngineConfig
    from matchmaking_tpu_torch.engine.gpu import GpuEngine

    ec = EngineConfig(backend="gpu", pool_capacity=64, pool_block=32,
                      top_k=4, pair_rounds=4, batch_buckets=(16,),
                      **engine_kw)
    cfg = Config(engine=ec)
    return GpuEngine(cfg, cfg.queues[0], device=device)


def families(device="cpu") -> list[Family]:
    """Every step the port captures, at the JAX package's canonical
    geometry (capacity 64, top_k 4, pool_block 32, 4 pair rounds; windows
    of 16; the role set at 32) plus the port's own captured variants."""
    import torch

    from matchmaking_tpu_torch.engine import cuda_kernels, kernels, scoring
    from matchmaking_tpu_torch.engine.role_kernels import role_kernel_set
    from matchmaking_tpu_torch.engine.sharded import sharded_kernel_set
    from matchmaking_tpu_torch.engine.teams import team_kernel_set

    dev = torch.device(device)
    b = 16
    out: list[Family] = []
    ctx = _ENGINE + "kernels.py"

    def step_args(ks):
        return lambda v: (canonical_pool(ks, v, dev),
                          canonical_packed(ks, b, v, dev))

    def evict_args(ks):
        def make(v):
            ev = torch.full((b,), ks.capacity, dtype=torch.int32, device=dev)
            ev[0] = v  # vary content, not shape
            return canonical_pool(ks, v, dev), ev
        return make

    for label, kw in (("1v1", dict(glicko2=False, widen_per_sec=5.0)),
                      ("1v1-glicko2", dict(glicko2=True, widen_per_sec=0.0))):
        ks = kernels.KernelSet(capacity=64, top_k=4, pool_block=32,
                               max_threshold=400.0, pair_rounds=4, **kw)
        for name, fn, n_bb in (
                ("search_step_packed", ks.search_step_packed, 1),
                ("search_step_packed_nofilter",
                 functools.partial(ks.search_step_packed, skip_filters=True),
                 1),
                ("search_step_packed_rescan", ks.search_step_packed_rescan, 1),
                ("admit_packed", ks.admit_packed, 0)):
            out.append(Family(
                f"kernels.{label}.{name}", ctx, fn, step_args(ks), n_bb,
                dtype_label=label if name == "search_step_packed" else ""))
        out.append(Family(f"kernels.{label}.evict", ctx, ks.evict,
                          evict_args(ks)))

    # The engine's captured form: the step with its quality fold behind it.
    eng = _small_engine(dev)
    out.append(Family("gpu.GpuEngine._step_fn(dense)", _ENGINE + "gpu.py",
                      eng._step_fn("dense"), step_args(eng.kernels), 1, 1))
    # The port's own captured variants: pruned, bucketed (traffic, no
    # filter, rescan), the bucket frontier at one k.
    pks = kernels.KernelSet(capacity=64, top_k=4, pool_block=16,
                            glicko2=False, widen_per_sec=5.0,
                            max_threshold=400.0, pair_rounds=4,
                            prune_window_blocks=2, prune_chunk=8)
    out.append(Family("kernels.pruned.search_step_packed", ctx,
                      pks.search_step_packed, step_args(pks), 1))
    bks = kernels.KernelSet(capacity=64, top_k=4, pool_block=16,
                            glicko2=False, widen_per_sec=5.0,
                            max_threshold=400.0, pair_rounds=4,
                            bucketed=True, prune_chunk=8)
    for name, fn in (
            ("search_step_packed", bks.search_step_packed),
            ("search_step_packed_nofilter",
             functools.partial(bks.search_step_packed, skip_filters=True)),
            ("search_step_packed_rescan", bks.search_step_packed_rescan)):
        out.append(Family(f"kernels.bucketed.{name}", ctx, fn,
                          step_args(bks), 1))
    mesh_ids = None if dev.type == "cpu" else (dev.index or 0,) * 4
    fks = sharded_kernel_set(64, 4, 16, False, 5.0, 400.0, 4, False,
                             pair_rounds=4, device_ids=mesh_ids,
                             bucket_frontier_k=8, device=dev.type)
    out.append(Family("sharded.bucket_step(8)", _ENGINE + "sharded.py",
                      fks.bucket_step(8), step_args(fks), 1,
                      ring_mesh=fks.mesh))
    for ring in (False, True):
        sks = sharded_kernel_set(64, 4, 16, False, 5.0, 400.0, 4, ring,
                                 pair_rounds=4, device_ids=mesh_ids,
                                 device=dev.type)
        out.append(Family(
            f"sharded.search_step_packed({'ring' if ring else 'all-gather'})",
            _ENGINE + "sharded.py", sks.search_step_packed, step_args(sks),
            sks.n_shards, ring_mesh=sks.mesh if ring else None))

    tks = team_kernel_set(capacity=64, team_size=2, widen_per_sec=5.0,
                          max_threshold=400.0, max_matches=8, rounds=4)
    out.append(Family("teams.search_step_packed", _ENGINE + "teams.py",
                      tks.search_step_packed, step_args(tks),
                      dtype_label="team"))
    rks = role_kernel_set(capacity=32, team_size=2,
                          role_slots=("tank", "dps"), widen_per_sec=5.0,
                          max_threshold=400.0, max_matches=8, rounds=4)
    for name in ("search_step_packed", "admit_packed"):
        out.append(Family(
            f"role_kernels.{name}", _ENGINE + "role_kernels.py",
            getattr(rks, name), step_args(rks),
            dtype_label="role" if name == "search_step_packed" else ""))

    # The kernel itself, in place of the JAX Pallas trace: P = 1,024,
    # B = 64, blocks of 256, filters on.
    def block_best_args(v):
        import numpy as np

        from matchmaking_tpu_torch.core.pool import PlayerPool

        p_, b_ = 1024, 64
        rng = np.random.default_rng(55 + v)
        arrs = PlayerPool.empty_device_arrays(p_)
        n = p_ // 2
        arrs["rating"][:n] = rng.normal(1500, 200, n).astype(np.float32)
        arrs["rd"][:n] = rng.uniform(30, 200, n).astype(np.float32)
        arrs["threshold"][:n] = 100.0 + v
        arrs["active"][:n] = True
        pool = kernels.pool_from_reference(arrs, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        batch = {
            "slot": torch.arange(b_, dtype=torch.int32, device=dev),
            "rating": torch.from_numpy(
                rng.normal(1500, 200, b_).astype(np.float32)).to(dev),
            "rd": torch.from_numpy(
                rng.uniform(30, 200, b_).astype(np.float32)).to(dev),
            "region": torch.zeros(b_, dtype=torch.int32, device=dev),
            "mode": torch.zeros(b_, dtype=torch.int32, device=dev),
            "valid": torch.ones(b_, dtype=torch.bool, device=dev)}
        return (pool, batch, torch.full((b_,), 100.0 + v, **f32),
                torch.full((1,), 1.5, **f32))

    def block_best_fn(pool, batch, q_thr_eff, now):
        return cuda_kernels.block_best(
            pool, batch, q_thr_eff, now, pool_block=256, glicko2=False,
            filters=True, widen_per_sec=5.0, max_threshold=400.0,
            g_coeff=scoring.G_COEFF_F32)

    out.append(Family("cuda_kernels.block_best", _ENGINE + "cuda_kernels.py",
                      block_best_fn, block_best_args, 1))
    return out


_TRACES: dict[str, list[Traced]] = {}


def trace_families(device="cpu", fresh: bool = False) -> list[Traced]:
    """Every family of ``families(device)`` warmed and traced twice,
    once per process and device (``fresh`` traces again)."""
    key = str(device)
    if fresh or key not in _TRACES:
        _TRACES[key] = [run_family(fam) for fam in families(device)]
    return _TRACES[key]


def drift_findings(traced: Traced) -> list[Finding]:
    fam = traced.family
    if traced.error is not None:
        return [Finding(RULE, fam.ctx, 0,
                        f"could not trace {fam.name}: {traced.error}",
                        fam.name)]
    if traced.code[0] != traced.code[1]:
        return [Finding(
            RULE, fam.ctx, 0,
            f"trace drift in {fam.name}: two same-shape traces under the "
            f"canonical config differ — the step's trace depends on "
            f"mutable Python state or host-read values (a capture would "
            f"freeze one of them)", fam.name)]
    return []


def _drift(fn, make_args, name: str, context: str,
           findings: list[Finding]) -> None:
    """JAX's ``_drift``: warm ``fn`` once, trace it twice, report drift
    (or a failed trace) into ``findings``."""
    findings.extend(drift_findings(run_family(
        Family(name, context, fn, make_args))))


def check_dynamic(device="cpu", traces: list[Traced] | None = None
                  ) -> list[Finding]:
    """Drift and trace failures of every captured step."""
    findings: list[Finding] = []
    for t in (traces if traces is not None else trace_families(device)):
        findings.extend(drift_findings(t))
    return findings
