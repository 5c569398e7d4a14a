"""``device``: the device-path audit of the port's captured steps.

The recompile rule (recompile.py) proves each captured step's TRACE is
stable; this rule audits what the trace DOES, and what the engine does
to the addresses a captured graph holds. The trace half works on the
``make_fx`` traces recompile.py makes (CPU by default, nothing launched
there: the kernels' CPU versions run where no trace enters); the
captured graphs themselves, what the card replays, are audited on the
card (``engine/graphs.audit_dot``, smoke phase 17b).

Static half (AST):

- **host syncs in a kernel module** — ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``.numpy()`` / ``np.asarray`` / ``torch.cuda.synchronize``
  / ``.synchronize()`` inside any function of a kernel module: inside a
  capture they break it (a sync on a capturing stream), and on the eager
  paths threaded through the same modules they serialize the pipeline.
  ``__init__`` bodies and module level are exempt (host-side setup).
- **the graph-address hazard** (in place of the JAX package's
  use-after-donation: the port donates nothing, a step writes the pool in
  place and a captured graph holds the pool's addresses). Two forms, in
  the engine's modules: a pool column rebound to a new tensor
  (``pool[name] = …``, ``pool.full[name] = …``) outside
  ``DevicePool.__init__`` and ``fresh_pool``; and, flow-sensitive over
  the dataflow CFG, in a class that holds captured graphs (it assigns
  ``self._graphs``), a write of ``self._dev_pool`` outside ``__init__``
  (where no graph exists yet) that some path carries
  to the function's normal exit without dropping the graphs
  (``self._drop_graphs()``, ``self._graphs.clear()``, or the
  ``dev_pool`` setter, which drops them).

Trace half (every family recompile.py traces, on its second trace):

- **host round trips** — ``aten._local_scalar_dense`` (``.item()``,
  ``bool()`` / ``int()`` of a tensor) and the ops whose output shape
  depends on the data (``nonzero``, ``masked_select``, the ``unique``
  ops, indexing by a bool tensor): each syncs, and breaks a capture.
- **the pool stays in place** — after one step every pool column is the
  same tensor (address, dtype, shape, strides); the shared pool fields'
  dtypes are equal across the 1v1, Glicko-2, team and role families.
- **kernel nodes** — each 1v1 step holds ``mm_torch::block_best`` once
  (D times sharded), the engine's quality-folding step one
  ``mm_torch::quality_accum``; ``node_report`` gives every family's
  counts.
- **padded-lane contamination** (the quality fold's shape) — masked
  lanes carry the ``+inf`` dist sentinel; ``0 × inf = NaN``, so a masked
  SUM is not a sanitizer, only a ``where`` gated on a validity mask is.
  Forward taint over the functionalized graph of
  ``cuda_kernels.quality_accum_reference`` (its in-place state update
  becomes the graph's output), descending into every nested graph.
- **ring** — the hops the sharded ring step recorded
  (``PoolMesh.ring_hops``) must use one consistent permutation forming a
  single cycle over the mesh.

Port of ``matchmaking_tpu/analysis/device_audit.py``.
"""

from __future__ import annotations

import ast
import operator

from matchmaking_tpu_torch.analysis import dataflow as df
from matchmaking_tpu_torch.analysis import recompile
from matchmaking_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    dotted_name,
    qualname_of,
)
from matchmaking_tpu_torch.analysis.recompile import KERNEL_MODULES

RULE = "device"

#: The engine's modules: the graph-address audit's scope.
ENGINE_PREFIX = "matchmaking_tpu_torch/engine/"

#: Dotted calls that sync with the host.
_HOST_SYNC_CALLS = {
    "np.asarray": "full-array host readback",
    "numpy.asarray": "full-array host readback",
    "torch.cuda.synchronize": "blocks on device completion",
}
#: Methods (called with no argument) that sync with the host.
_HOST_SYNC_METHODS = {
    "item": "host-syncs a device scalar (trace-time crash under jit)",
    "tolist": "host-syncs the whole array",
    "cpu": "copies the whole tensor to the host",
    "numpy": "reads the tensor on the host",
    "synchronize": "blocks on device completion",
}

#: Where a pool's columns are made, not rebound.
_POOL_BUILDERS = {("DevicePool", "__init__"), ("", "fresh_pool")}
#: Calls that drop an engine's captured graphs.
_DROPS = ("_drop_graphs", "_graphs.clear")


# ---- static: host syncs in kernel modules -----------------------------------

class _HostSyncScanner(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: list[Finding] = []
        self._stack: list[ast.AST] = []

    def _in_scope(self) -> bool:
        fns = [n for n in self._stack
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        return bool(fns) and fns[-1].name != "__init__"

    def _push(self, node):
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_ClassDef = _push
    visit_FunctionDef = _push
    visit_AsyncFunctionDef = _push

    def visit_Call(self, node: ast.Call) -> None:
        if self._in_scope():
            name = dotted_name(node.func)
            hint = None
            what = name
            for suffix, h in _HOST_SYNC_CALLS.items():
                if name == suffix or name.endswith("." + suffix):
                    hint = h
                    break
            if hint is None and isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if (meth in _HOST_SYNC_METHODS and not node.args
                        and not node.keywords):
                    hint = _HOST_SYNC_METHODS[meth]
                    what = f".{meth}()"
            if hint is not None:
                self.findings.append(Finding(
                    RULE, self.sf.path, node.lineno,
                    f"host-sync {what!r} in a kernel module: {hint} — "
                    f"kernel math must stay on device; host setup belongs "
                    f"in __init__",
                    qualname_of(self._stack)))
        self.generic_visit(node)


# ---- static: the graph-address hazard ---------------------------------------

def _is_pool_name(name: str) -> bool:
    """``pool``, ``x.pool``, ``x_pool``, and their ``.full``."""
    if name.endswith(".full"):
        name = name[:-len(".full")]
    leaf = name.rsplit(".", 1)[-1]
    return leaf == "pool" or leaf.endswith("_pool")


def _column_rebinds(sf: SourceFile) -> list[Finding]:
    out = []
    for cls, fn in df.iter_functions(sf.tree):
        if (cls, fn.name) in _POOL_BUILDERS:
            continue
        qual = f"{cls}.{fn.name}" if cls else fn.name
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                for t in (tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]):
                    if not isinstance(t, ast.Subscript):
                        continue
                    base = dotted_name(t.value)
                    if base and _is_pool_name(base):
                        out.append(Finding(
                            RULE, sf.path, node.lineno,
                            f"pool column {ast.unparse(t)!r} rebound to a "
                            f"new tensor: a captured graph holds the pool's "
                            f"addresses and replays the old column — write "
                            f"it in place (copy_, index_put_), or build a "
                            f"new pool and drop the graphs", qual))
    return out


def _writes_dev_pool(stmt: ast.AST) -> bool:
    if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        return False
    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
    for tgt in targets:
        for t in (tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]):
            if isinstance(t, ast.Attribute) and t.attr == "_dev_pool":
                return True
    return False


def _drops_graphs(stmt: ast.AST) -> bool:
    for expr in df.header_exprs(stmt):
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call) and dotted_name(sub.func).endswith(
                    _DROPS):
                return True
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            for t in (tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]):
                if isinstance(t, ast.Attribute) and t.attr == "dev_pool":
                    return True  # the setter drops them
    return False


class _GraphAddressAnalysis(df.Analysis):
    """State: ``"pending"`` → the lines of ``_dev_pool`` writes no drop of
    the graphs has followed yet (joined by union)."""

    def join(self, a, b):
        return a | b

    def transfer(self, node: df.Node, state, cfg):
        stmt = node.stmt
        if stmt is None:
            return state
        if _drops_graphs(stmt):
            state.pop("pending", None)
        if _writes_dev_pool(stmt):
            state["pending"] = state.get("pending", frozenset()) | {
                stmt.lineno}
        return state


def _graph_holders(tree: ast.Module) -> set[str]:
    """Classes that hold captured graphs (assign ``self._graphs``)."""
    out = set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and any(
                isinstance(t, ast.Attribute) and t.attr == "_graphs"
                and dotted_name(t.value) == "self"
                for sub in ast.walk(node) if isinstance(sub, ast.Assign)
                for t in sub.targets):
            out.add(node.name)
    return out


def _unmatched_pool_writes(sf: SourceFile) -> list[Finding]:
    out = []
    holders = _graph_holders(sf.tree)
    for cls, fn in df.iter_functions(sf.tree):
        if cls not in holders or fn.name == "__init__" or not any(
                _writes_dev_pool(n) for n in ast.walk(fn)):
            continue
        cfg = df.CFG(fn)
        states = df.solve(cfg, _GraphAddressAnalysis())
        qual = f"{cls}.{fn.name}" if cls else fn.name
        for line in sorted(states.get(cfg.exit.idx, {}).get("pending", ())):
            out.append(Finding(
                RULE, sf.path, line,
                f"'_dev_pool' replaced without dropping the captured "
                f"graphs on some path to the return: they hold the old "
                f"pool's addresses and would replay against it — assign "
                f"dev_pool (its setter drops them) or call _drop_graphs()",
                qual))
    return out


def check_static(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in sources:
        if sf.path in KERNEL_MODULES:
            v = _HostSyncScanner(sf)
            v.visit(sf.tree)
            findings.extend(v.findings)
        if sf.path.startswith(ENGINE_PREFIX):
            findings.extend(_column_rebinds(sf))
            findings.extend(_unmatched_pool_writes(sf))
    return findings


# ---- trace half ---------------------------------------------------------------

#: Ops whose output shape depends on the data (each syncs).
_DATA_SHAPED = {"nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
                "unique_consecutive", "unique_dim_consecutive"}


def _opname(node) -> str:
    return getattr(node.target, "_opname", "") if node.op == "call_function" \
        else ""


def _val_dtype(arg):
    val = getattr(arg, "meta", {}).get("val") if arg is not None else None
    return getattr(val, "dtype", None)


def _walk_graph(gm, visit) -> None:
    """Every call of ``gm`` and of the graphs nested in it."""
    for node in gm.graph.nodes:
        if node.op == "call_function":
            visit(node)
        elif node.op == "get_attr":
            sub = getattr(gm, node.target, None)
            if hasattr(sub, "graph"):
                _walk_graph(sub, visit)


def _check_callbacks(gm, family: str, ctx: str,
                     findings: list[Finding]) -> None:
    """Host round trips in a traced step (JAX's host-callback audit)."""
    import torch

    hits: set[str] = set()

    def visit(node):
        name = _opname(node)
        if name in ("_local_scalar_dense", "is_nonzero") \
                or name in _DATA_SHAPED:
            hits.add(name)
        elif name in ("index", "index_put", "index_put_"):
            idx = node.args[1] if len(node.args) > 1 else ()
            if any(_val_dtype(i) == torch.bool for i in idx or ()):
                hits.add(f"{name} by a bool tensor")

    _walk_graph(gm, visit)
    for name in sorted(hits):
        findings.append(Finding(
            RULE, ctx, 0,
            f"host round trip {name!r} inside captured step {family}: a "
            f"sync per window on the hot step (a capture breaks on it)",
            family))


def _pool_change_findings(changes, family: str, ctx: str) -> list[Finding]:
    out = []
    for name, want, got in changes:
        if got is not None and got[1] != want[1]:
            out.append(Finding(
                RULE, ctx, 0,
                f"dtype drift in {family}: pool field {name!r} enters "
                f"{want[1]} and leaves {got[1]} — an upcast rebinds the "
                f"column (a captured graph replays the old one) and "
                f"doubles its memory", family))
        else:
            out.append(Finding(
                RULE, ctx, 0,
                f"pool field {name!r} of {family} is not the same tensor "
                f"after the step (address, shape or strides changed, or "
                f"it went): a captured graph holds the old one", family))
    return out


def _check_pool_preserved(fn, family: str, ctx: str, pool, args,
                          findings: list[Finding]) -> dict | None:
    """Run ``fn(pool, *args)`` once; each of ``pool``'s columns must be
    the same tensor after it. Returns the pool's dtypes after the step,
    or None when the step raised (reported)."""
    before = {k: recompile._layout(v) for k, v in pool.items()}
    try:
        fn(pool, *args)
    except Exception as e:
        findings.append(Finding(
            RULE, ctx, 0,
            f"could not run {family}: {type(e).__name__}: {e}", family))
        return None
    findings.extend(_pool_change_findings(
        recompile.pool_changes(pool, before), family, ctx))
    return {k: v.dtype for k, v in pool.items()}


def _kernel_node_findings(t: recompile.Traced) -> list[Finding]:
    fam = t.family
    got = recompile.kernel_nodes(t.graph)
    out = []
    for kernel, want in (("block_best", fam.block_best),
                         ("quality_accum", fam.quality_accum)):
        if got[kernel] != want:
            out.append(Finding(
                RULE, fam.ctx, 0,
                f"{fam.name} holds {got[kernel]} mm_torch::{kernel} nodes, "
                f"not {want}: a kernel of the step runs outside its "
                f"operator (invisible to the trace) or twice", fam.name))
    return out


def node_report(traces: list[recompile.Traced]) -> dict:
    """Per traced family: its graph's nodes and kernel operator nodes."""
    return {t.family.name: ({"nodes": len(t.graph.graph.nodes),
                             **recompile.kernel_nodes(t.graph)}
                            if t.graph is not None else {"error": t.error})
            for t in traces}


def _family_dtype_findings(dtypes: dict[str, dict], ctx: str
                           ) -> list[Finding]:
    out = []
    labels = sorted(dtypes)
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            da, dtb = dtypes[a], dtypes[b]
            for k in sorted(set(da) & set(dtb)):
                if da[k] != dtb[k]:
                    out.append(Finding(
                        RULE, ctx, 0,
                        f"dtype drift BETWEEN kernel families: pool field "
                        f"{k!r} is {da[k]} in {a} but {dtb[k]} in {b} — "
                        f"engine swaps (breaker demotion, elastic "
                        f"placement) would reinterpret the checkpoint",
                        f"{a}~{b}"))
    return out


# ---- padded-lane taint --------------------------------------------------------

_CMP_OPS = {"lt", "le", "gt", "ge", "eq", "ne"}
_BOOL_OPS = {"logical_and", "logical_or", "logical_not", "logical_xor"}
_BITWISE_OPS = {"bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor"}
#: Index-consuming ops: taint flows from the OPERAND, never the indices
#: (a clamped index read returns a real pool value).
_GATHER_OPS = {"gather", "index", "index_select", "take", "argmax", "argmin"}


def _node_args(args) -> list:
    """The graph nodes among (nested) call arguments, in order."""
    import torch.fx

    out = []
    for a in args:
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(_node_args(a))
    return out


def _taint_graph(gm, taint: dict) -> list:
    """Forward sentinel taint over ``gm`` (placeholders already seeded in
    ``taint``); returns the taint of each of its outputs. A node's taint
    is a set, or a list of sets for a call that returns several values;
    the graphs nested in a call are walked with the call's operands."""
    import torch

    def t(x):
        v = taint.get(x, set())
        if isinstance(v, list):
            return set().union(*v) if v else set()
        return v

    for node in gm.graph.nodes:
        if node.op == "output":
            outs = node.args[0]
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            return [t(o) if hasattr(o, "op") else set() for o in outs]
        if node.op != "call_function":
            continue
        if node.target is operator.getitem:
            src = taint.get(node.args[0], set())
            taint[node] = (src[node.args[1]] if isinstance(src, list)
                           and node.args[1] < len(src) else t(node.args[0]))
            continue
        subs = [getattr(gm, a.target) for a in _node_args(node.args)
                if a.op == "get_attr"
                and hasattr(getattr(gm, a.target, None), "graph")]
        if subs:
            # A nested graph: its placeholders take the call's operands
            # (the trailing ones), its outputs are the call's.
            operands = [a for a in _node_args(node.args)
                        if a.op != "get_attr"]
            outs: list = []
            for sub in subs:
                ph = [n for n in sub.graph.nodes if n.op == "placeholder"]
                inner = {p: t(o) for p, o in zip(ph[::-1], operands[::-1])}
                outs = _taint_graph(sub, inner)
            taint[node] = outs
            continue
        name = _opname(node)
        ins = [t(a) for a in _node_args(node.args)]
        flat = set().union(*ins) if ins else set()
        if name in _CMP_OPS:
            out = {"mask"} if "sentinel" in flat else set()
        elif name in _BOOL_OPS or (
                name in _BITWISE_OPS and _val_dtype(node) == torch.bool):
            out = flat & {"mask"}
        elif name == "where":
            pred = t(node.args[0]) if hasattr(node.args[0], "op") else set()
            cases = [t(a) if hasattr(a, "op") else set()
                     for a in node.args[1:3]]
            if "mask" in pred:
                # A validity-gated select sanitizes when a branch is clean
                # (the masked lanes take the clean branch).
                out = ({"sentinel"}
                       if cases and all("sentinel" in c for c in cases)
                       else set())
            else:
                out = set().union(*cases) if cases else set()
        elif name in _GATHER_OPS:
            out = t(node.args[0])
        else:
            out = flat
        taint[node] = out
    return []


def check_padded_lanes(fn, args, sentinel_arg: int, family: str,
                       ctx: str = "matchmaking_tpu_torch/engine/kernels.py",
                       ) -> list[Finding]:
    """Forward sentinel taint over the functionalized graph of ``fn``.
    ``sentinel_arg`` is the index (into ``args``, all tensors) of the
    tensor carrying masked-lane sentinels. An output still
    sentinel-tainted means masked lanes reach an accumulator without a
    ``where`` sanitizer — ``0 × inf = NaN`` contamination.

    The walk descends into every nested graph, whatever its operator is
    called (JAX's walk descends only into operators named ``pjit``, and
    JAX 0.9 wraps ``jnp.where`` in one named ``jit``: the sanitizing
    select goes unseen and a clean accumulator is flagged)."""
    from torch.func import functionalize
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        gm = make_fx(functionalize(fn, remove="mutations_and_views"))(*args)
    except Exception as e:
        return [Finding(
            RULE, ctx, 0,
            f"could not trace {family} for the padded-lane audit: "
            f"{type(e).__name__}: {e}", family)]
    ph = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if sentinel_arg >= len(ph):
        return []
    outs = _taint_graph(gm, {ph[sentinel_arg]: {"sentinel"}})
    return [Finding(
        RULE, ctx, 0,
        f"padded-lane contamination in {family}: output #{i} is reachable "
        f"from the masked-lane sentinel input without a validity select — "
        f"0 × inf = NaN poisons the accumulator; sanitize with "
        f"torch.where(valid, x, 0) BEFORE any masked arithmetic", family)
        for i, o in enumerate(outs) if "sentinel" in o]


def _quality_fold_args():
    """``quality_accum_reference`` at the canonical geometry as a
    function of tensors (the state's six fields, the pool's three
    columns, the window's result), returning the state: (fn, args, the
    result's index)."""
    import torch

    from matchmaking_tpu_torch.engine import cuda_kernels
    from matchmaking_tpu_torch.engine.kernels import QualityAccumKernel
    from matchmaking_tpu_torch.engine.quality import QualitySpec

    spec = QualitySpec()
    q = QualityAccumKernel(
        capacity=64, widen_per_sec=5.0, max_threshold=400.0,
        rating_edges=spec.rating_edges, n_quality=spec.n_quality,
        wait_edges=spec.wait_edges)
    state = q.init_state("cpu")
    names = [name for name, _ in cuda_kernels.QUALITY_FIELDS]
    kw = dict(widen_per_sec=q.widen_per_sec, max_threshold=q.max_threshold,
              rating_edges=q.rating_edges, n_quality=q.n_quality,
              wait_edges=q.wait_edges)

    def fold(*ts):
        st = dict(zip(names, ts[:len(names)]))
        rating, enq, thr, out = ts[len(names):]
        cuda_kernels.quality_accum_reference(st, rating, enq, thr, out, 1.0,
                                             **kw)
        return tuple(st[n] for n in names)

    cols = [torch.zeros(64, dtype=torch.float32) for _ in range(3)]
    args = ([state[n].clone() for n in names] + cols
            + [torch.zeros((3, 16), dtype=torch.float32)])
    return fold, args, len(args) - 1


# ---- ring audit ---------------------------------------------------------------

def _check_ring(hops, n_shards: int, family: str, ctx: str,
                findings: list[Finding]) -> None:
    """The (source, destination) pairs of each recorded ring hop must be
    one permutation, forming a single ``n_shards``-cycle."""
    perms = [tuple(sorted(map(tuple, h))) for h in hops]
    if not perms:
        findings.append(Finding(
            RULE, ctx, 0,
            f"{family}: ring=True but no ring hop recorded — the ring "
            f"exchange silently fell back to something else", family))
        return
    if len(set(perms)) > 1:
        findings.append(Finding(
            RULE, ctx, 0,
            f"{family}: ring hops use INCONSISTENT permutations "
            f"({len(set(perms))} distinct) — every ring hop must rotate "
            f"the same direction or shards merge stale candidates",
            family))
    perm = perms[0]
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    ok = (sorted(srcs) == list(range(n_shards))
          and sorted(dsts) == list(range(n_shards)))
    if ok:
        nxt = dict(perm)
        seen = set()
        cur = 0
        for _ in range(n_shards):
            seen.add(cur)
            cur = nxt[cur]
        ok = len(seen) == n_shards and cur == 0
    if not ok:
        findings.append(Finding(
            RULE, ctx, 0,
            f"{family}: ring permutation {perm} is not a single "
            f"{n_shards}-cycle over the mesh — some shard's candidates "
            f"never reach every peer", family))


# ---- the audit driver ---------------------------------------------------------

def check_dynamic(device="cpu", traces: list[recompile.Traced] | None = None
                  ) -> list[Finding]:
    """Audit every family recompile.py traces (its warm-up call and its
    second trace), then the quality fold's padded lanes."""
    findings: list[Finding] = []
    dtypes: dict[str, dict] = {}
    for t in (traces if traces is not None
              else recompile.trace_families(device)):
        fam = t.family
        if t.error is not None:
            continue  # the recompile rule reports a trace that raised
        _check_callbacks(t.graph, fam.name, fam.ctx, findings)
        findings.extend(_pool_change_findings(t.pool_changes, fam.name,
                                              fam.ctx))
        findings.extend(_kernel_node_findings(t))
        if fam.dtype_label:
            dtypes[fam.dtype_label] = t.dtypes
        if fam.ring_mesh is not None:
            _check_ring(t.ring_hops, fam.ring_mesh.n_shards, fam.name,
                        fam.ctx, findings)
    findings.extend(_family_dtype_findings(
        dtypes, recompile.KERNEL_MODULES[0]))
    fold, args, out_arg = _quality_fold_args()
    findings.extend(check_padded_lanes(
        fold, args, out_arg, "cuda_kernels.quality_accum_reference",
        ctx=ENGINE_PREFIX + "cuda_kernels.py"))
    return findings

