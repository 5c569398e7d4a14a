"""The port's interleaving model checker (matchmaking_tpu_torch/analysis/
modelcheck.py on testing/scheduler.py) held to the JAX package's.

- JAX's toy-world explorer scripts (``tests/test_modelcheck.py``'s counter
  world: exhaustive with and without partial-order reduction, and the
  minimization to the shortest failing schedule) give equal states, nodes,
  pruning counts, schedules, timelines and ``schedule_digest``s through
  both ``Explorer``s.
- ``run_modelcheck`` drives each package's own lease authority,
  replication sender, standby applier, in-process link and pool journal
  (wired as each ``_QueueRuntime.start_replication`` wires them): at JAX's
  single-queue scope and at its two-queue scope with crash and dup, the
  result dicts are equal, times aside; so is the replay of the stale-epoch
  schedule.
- Each of the four seeded mutants gives the same minimized counterexample
  (schedule, digest, violation, timeline) on both, and it replays; the
  port's mutation gate passes with the same per-mutant evidence as JAX's.
"""

import dataclasses

import pytest

from matchmaking_tpu.analysis import modelcheck as jax_mc
from matchmaking_tpu.testing import scheduler as jax_sched
from matchmaking_tpu_torch.analysis import modelcheck as port_mc
from matchmaking_tpu_torch.testing import scheduler as port_sched

pytestmark = pytest.mark.protocol


class _CounterWorld:
    """JAX's toy world: two counters ('a', 'b'), each incrementable to 3;
    violated when counter a reaches ``trip_at``."""

    ACTIONS = ("inc@a", "inc@b")

    def __init__(self, trip_at=None):
        self.vals = {"a": 0, "b": 0}
        self.trip_at = trip_at

    def enabled(self):
        return [k for k in self.ACTIONS
                if self.vals[k.partition("@")[2]] < 3]

    def step(self, key):
        slot = key.partition("@")[2]
        self.vals[slot] += 1
        return f"{slot} -> {self.vals[slot]}"

    def check(self):
        if self.trip_at is not None and self.vals["a"] >= self.trip_at:
            return f"counter a reached {self.vals['a']}"
        return None

    def digest(self):
        return (self.vals["a"], self.vals["b"])

    def slot(self, key):
        return key.partition("@")[2]

    def index(self, key):
        return self.ACTIONS.index(key)

    def close(self):
        pass


_TOY = {
    "exhaustive_por": (lambda: _CounterWorld(), dict(max_depth=6)),
    "exhaustive_full": (lambda: _CounterWorld(), dict(max_depth=6,
                                                      por=False)),
    "minimize": (lambda: _CounterWorld(trip_at=2), dict(max_depth=6)),
    "shallow": (lambda: _CounterWorld(trip_at=3), dict(max_depth=2)),
}


def _explore(sched, name):
    factory, kw = _TOY[name]
    res = sched.Explorer(factory, **kw).explore()
    out = {k: v for k, v in dataclasses.asdict(res).items()
           if k != "elapsed_s"}
    out["digest_of_schedule"] = sched.schedule_digest(
        res.schedule, {"toy": name}) if res.schedule else ""
    return out


@pytest.mark.parametrize("name", sorted(_TOY))
def test_toy_explorer_scripts_equal_on_both_explorers(name):
    theirs = _explore(jax_sched, name)
    assert _explore(port_sched, name) == theirs
    if name == "exhaustive_por":
        assert theirs["states"] == 16 and theirs["exhaustive"]
        assert theirs["pruned_por"] > 0
    if name == "minimize":
        assert theirs["schedule"] == ["inc@a", "inc@a"]


def test_schedule_digest_equal_and_scope_salted():
    for sched in (["inc@a", "inc@a"], ["admit@q0", "drop@q0"], []):
        for scope in ({"depth": 4}, {"depth": 5, "faults": ["drop"]}):
            assert (port_sched.schedule_digest(sched, scope)
                    == jax_sched.schedule_digest(sched, scope))
    assert (port_sched.schedule_digest(["x"], {"depth": 4})
            != port_sched.schedule_digest(["x"], {"depth": 5}))


def _timeless(rep):
    return {k: v for k, v in rep.items() if k != "modelcheck_elapsed_s"}


def _scopes(mc):
    return {
        "single_queue": mc.ModelCheckConfig(
            queues=1, depth=4, admits=2, settles=1,
            faults=("expire", "drop"), fault_budget=2),
        "two_queue_crash_dup": mc.ModelCheckConfig(
            queues=2, depth=4, faults=("expire", "crash", "drop", "dup"),
            fault_budget=2),
    }


@pytest.mark.parametrize("scope", ["single_queue", "two_queue_crash_dup"])
def test_modelcheck_results_equal_at_jax_scopes(scope):
    theirs = _timeless(jax_mc.run_modelcheck(_scopes(jax_mc)[scope]))
    mine = _timeless(port_mc.run_modelcheck(_scopes(port_mc)[scope]))
    assert mine == theirs
    assert mine["modelcheck_violations"] == 0
    assert mine["modelcheck_exhaustive"]
    assert mine["modelcheck_states_explored"] > 50


def test_stale_epoch_resume_replay_equal_and_refused():
    sched = ["settle@q0", "expire@q0", "takeover@q0", "admit@q0",
             "publish@q0"]
    theirs = _timeless(jax_mc.run_modelcheck(
        _scopes(jax_mc)["single_queue"], replay=sched))
    mine = _timeless(port_mc.run_modelcheck(
        _scopes(port_mc)["single_queue"], replay=sched))
    assert mine == theirs
    assert mine["modelcheck_violations"] == 0
    timeline = "\n".join(mine["modelcheck_timeline"])
    assert "admit refused: journal append fenced" in timeline
    assert "publish q0-t1 refused: epoch superseded" in timeline


@pytest.mark.parametrize("mutant", port_mc.MUTANTS)
def test_mutant_counterexample_equal_on_both_and_replays(mutant):
    assert port_mc.MUTANTS == jax_mc.MUTANTS
    reps = []
    for mc in (jax_mc, port_mc):
        cfg = dataclasses.replace(mc.mutation_gate_config(), mutation=mutant)
        rep = mc.run_modelcheck(cfg)
        rerun = mc.run_modelcheck(cfg, replay=rep["modelcheck_schedule"])
        assert rerun["modelcheck_violation"] == rep["modelcheck_violation"]
        assert (rerun["modelcheck_schedule_digest"]
                == rep["modelcheck_schedule_digest"])
        reps.append(_timeless(rep))
    theirs, mine = reps
    assert mine == theirs
    assert mine["modelcheck_violations"] == 1
    assert 1 <= len(mine["modelcheck_schedule"]) <= 5
    assert mine["modelcheck_timeline"][-1].startswith("VIOLATION")


def test_mutation_gate_passes_on_the_port_with_jax_evidence():
    mine = port_mc.run_mutation_gate()
    assert mine["mutation_gate_passed"]
    assert mine["mutation_gate_baseline_clean"]
    assert set(mine["mutation_gate_mutants"]) == set(port_mc.MUTANTS)
    for rec in mine["mutation_gate_mutants"].values():
        assert rec["caught"] and rec["replay_ok"]
    assert (mine["mutation_gate_mutants"]
            == jax_mc.run_mutation_gate()["mutation_gate_mutants"])


def test_counterexample_timeline_reads_as_a_causal_spine():
    cfg = dataclasses.replace(port_mc.mutation_gate_config(),
                              mutation="skip-append-fence")
    tl = port_mc.run_modelcheck(cfg)["modelcheck_timeline"]
    assert tl[0].startswith("step 1:")
    assert any("lease expired" in ln for ln in tl)
    assert any("took over" in ln for ln in tl)
    assert "ex-primary produced an externally visible effect" in tl[-1]
