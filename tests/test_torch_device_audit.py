"""The port's ``device`` rule (matchmaking_tpu_torch/analysis/device_audit.py).

- The twins of JAX's trace-time cases (``tests/test_matchlint.py``'s
  ``test_device_padded_lane_taint_catches_unmasked_accumulator``,
  ``..._dtype_drift_detected_via_eval_shape``,
  ``..._ring_audit_rejects_split_permutation``): the bad accumulator (a
  float-mask multiply of the +inf sentinel) is flagged and the good one
  (a ``where`` on the validity mask first) is clean; a step that upcasts a
  pool column to float16 is flagged, the identity is clean; two 2-cycles
  and inconsistent hops are rejected, the 4-cycle accepted. The real
  quality fold is clean, and the sharded ring step records the 4-cycle.
- The port's own: the graph-address rule (a pool column rebound to a new
  tensor; a ``_dev_pool`` write some path leaves without dropping the
  graphs), a step with ``.item()`` flagged by the trace half, and every
  real family clean.
"""

import pytest
import torch

from matchmaking_tpu_torch.analysis import device_audit, recompile
from matchmaking_tpu_torch.analysis.engine import analyze_source


def _device(findings):
    return [f for f in findings if f.rule == "device"]


def _bad_accum(state, out):
    dist = out[2]
    q_slot = out[0].to(torch.int32)
    valid = q_slot < 64
    rf = valid.to(torch.float32)
    return state + (rf * dist).sum()


def _good_accum(state, out):
    dist = out[2]
    q_slot = out[0].to(torch.int32)
    valid = q_slot < 64
    d = torch.where(valid, dist, 0.0)
    rf = valid.to(torch.float32)
    return state + (rf * d).sum()


def test_padded_lane_taint_catches_the_unmasked_accumulator():
    args = (torch.zeros(()), torch.zeros((3, 8)))
    bad = device_audit.check_padded_lanes(_bad_accum, args, 1, "bad_accum")
    assert len(bad) == 1 and "padded-lane contamination" in bad[0].message
    # Clean: the where on the validity mask comes before any masked
    # arithmetic. (JAX's walk, matchmaking_tpu/analysis/device_audit.py:411,
    # descends only into sub-jaxprs named "pjit"; JAX 0.9 names
    # jnp.where's wrapper "jit", so it flags this one. The port's walk
    # descends into every nested graph.)
    assert device_audit.check_padded_lanes(_good_accum, args, 1,
                                           "good_accum") == []


def test_padded_lane_taint_descends_into_nested_graphs():
    from torch.fx.experimental.proxy_tensor import make_fx

    inner = make_fx(lambda d, v: torch.where(v, d, 0.0))(
        torch.zeros(8), torch.zeros(8, dtype=torch.bool))

    class Nested(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = inner

        def forward(self, state, out):
            valid = out[0] < 64
            return state + self.inner(out[2], valid).sum()

    gm = torch.fx.symbolic_trace(Nested())
    ph = [n for n in gm.graph.nodes if n.op == "placeholder"]
    assert device_audit._taint_graph(gm, {ph[1]: {"sentinel"}}) == [set()]


def test_the_quality_fold_is_clean():
    fold, args, out_arg = device_audit._quality_fold_args()
    assert device_audit.check_padded_lanes(fold, args, out_arg,
                                           "quality_fold") == []


def test_a_float16_upcast_of_a_pool_column_is_dtype_drift():
    def upcast_step(pool, packed):
        pool["rating"] = pool["rating"].to(torch.float16)
        return packed

    out = []
    device_audit._check_pool_preserved(
        upcast_step, "fixture.step", "ctx",
        {"rating": torch.zeros(4, dtype=torch.float32)}, (torch.zeros(3),),
        out)
    assert len(out) == 1 and "dtype drift" in out[0].message

    def rebinding_step(pool, packed):
        pool["rating"] = pool["rating"] + 1.0
        return packed

    out = []
    device_audit._check_pool_preserved(
        rebinding_step, "fixture.rebind", "ctx",
        {"rating": torch.zeros(4)}, (torch.zeros(3),), out)
    assert len(out) == 1 and "not the same tensor" in out[0].message

    def identity_step(pool, packed):
        pool["rating"].add_(1.0)
        return packed

    clean = []
    device_audit._check_pool_preserved(
        identity_step, "fixture.id", "ctx", {"rating": torch.zeros(4)},
        (torch.zeros(3),), clean)
    assert clean == []


@pytest.mark.parametrize("hops,message", [
    ([((0, 1), (1, 0), (2, 3), (3, 2))] * 3, "not a single"),
    ([((0, 1), (1, 2), (2, 3), (3, 0)),
      ((0, 3), (1, 0), (2, 1), (3, 2)),
      ((0, 1), (1, 2), (2, 3), (3, 0))], "INCONSISTENT"),
    ([], "no ring hop"),
    ([((0, 1), (1, 2), (2, 3), (3, 0))] * 3, None),
])
def test_ring_audit_rejects_split_rings_and_accepts_the_4_cycle(hops,
                                                                message):
    out = []
    device_audit._check_ring(hops, 4, "fixture.ring", "ctx", out)
    if message is None:
        assert out == []
    else:
        assert len(out) == 1 and message in out[0].message


def test_the_sharded_ring_step_records_the_4_cycle():
    (t,) = [t for t in recompile.trace_families("cpu")
            if t.family.name == "sharded.search_step_packed(ring)"]
    assert t.ring_hops == (tuple((i, (i + 1) % 4) for i in range(4)),) * 3
    out = []
    device_audit._check_ring(t.ring_hops, 4, t.family.name, "ctx", out)
    assert out == []


def test_an_item_step_is_flagged_by_the_trace_half():
    def step(pool, packed):
        k = packed[0, 0].item()
        pool["rating"].add_(k)
        return packed

    res = recompile.run_family(recompile.Family(
        "fixture.item", "ctx", step,
        lambda v: ({"rating": torch.zeros(4)}, torch.full((2, 2), 1.0 + v))))
    out = []
    device_audit._check_callbacks(res.graph, "fixture.item", "ctx", out)
    assert len(out) == 1 and "_local_scalar_dense" in out[0].message
    # A real trace refuses the read; the symbolic one records it.
    assert res.mode == "symbolic" and recompile.drift_findings(res) == []

    def masked(pool, packed):
        return pool["rating"][packed[0] > 0]

    res = recompile.run_family(recompile.Family(
        "fixture.mask", "ctx", masked,
        lambda v: ({"rating": torch.zeros(2)}, torch.ones((2, 2)))))
    out = []
    device_audit._check_callbacks(res.graph, "fixture.mask", "ctx", out)
    assert len(out) == 1 and "by a bool tensor" in out[0].message


def test_every_real_family_is_clean_with_its_node_counts():
    traces = recompile.trace_families("cpu")
    assert device_audit.check_dynamic(traces=traces) == []
    report = device_audit.node_report(traces)
    for t in traces:
        assert report[t.family.name]["block_best"] == t.family.block_best
        assert report[t.family.name]["quality_accum"] == \
            t.family.quality_accum
        assert report[t.family.name]["nodes"] > 0


# ---- the graph-address rule --------------------------------------------------

_NEW_COLUMN = '''
class DevicePool(dict):
    def __init__(self, full):
        super().__init__()
        self["rating"] = full["rating"][:-1]


def fresh_pool(capacity):
    pool = DevicePool({})
    pool["rating"] = None
    return pool


def grow(pool, t):
    pool["rating"] = t.clone()
    pool.full["rating"][3] = 1.0
    pool["rating"][:2] = 0.0
    self_pool = pool
    self_pool.full["rd"] = t
'''


def test_a_pool_column_rebound_to_a_new_tensor_is_flagged():
    findings = _device(analyze_source(
        _NEW_COLUMN, path="matchmaking_tpu_torch/engine/fixture.py"))
    assert [(f.line, f.context) for f in findings] == [
        (15, "grow"), (19, "grow")], findings
    assert "rebound to a new tensor" in findings[0].message
    # Outside the engine's modules the rule does not look.
    assert _device(analyze_source(
        _NEW_COLUMN, path="matchmaking_tpu_torch/service/fixture.py")) == []


_DEV_POOL = '''
class Engine:
    def __init__(self):
        self._graphs = {}
        self._dev_pool = None

    @property
    def dev_pool(self):
        return self._dev_pool

    @dev_pool.setter
    def dev_pool(self, pool):
        self._dev_pool = pool
        self._drop_graphs()

    def _drop_graphs(self):
        if self._graphs is not None:
            self._graphs.clear()

    def revive(self, pool, fast):
        self._dev_pool = pool
        if fast:
            return
        self._drop_graphs()

    def rebuild(self, pool):
        self.dev_pool = pool

    def restore(self, pool):
        self._dev_pool = pool
        self._graphs.clear()
'''


def test_an_unmatched_dev_pool_write_is_flagged_on_its_path():
    findings = _device(analyze_source(
        _DEV_POOL, path="matchmaking_tpu_torch/engine/fixture.py"))
    assert [(f.line, f.context) for f in findings] == [
        (21, "Engine.revive")], findings
    assert "without dropping the captured graphs" in findings[0].message
    # A class that holds no graphs has none to drop (JAX's donation
    # fixture: the port reports nothing there).
    plain = _DEV_POOL.replace("self._graphs = {}", "self._other = {}")
    assert _device(analyze_source(
        plain, path="matchmaking_tpu_torch/engine/fixture.py")) == []


def test_the_donation_fixture_is_a_kept_difference():
    findings = analyze_source('''
class Engine:
    def step(self, packed):
        pool2, out = self.kernels.search_step_packed(self._dev_pool, packed)
        stale = self._dev_pool["rating"]
        self._dev_pool = pool2
        return out, stale
''', path="matchmaking_tpu_torch/engine/fixture.py")
    assert _device(findings) == []
