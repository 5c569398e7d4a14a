"""The port's stage profilers (``scripts/torch_profile_step.py``,
``torch_profile_stages.py``, ``torch_profile_engine.py``) held to the JAX
package on the CPU, at a small size (P = 4,096, blocks of 512, 3,000
active, B = 64).

- The stage split: ``torch_profile_step.make_inputs`` builds the seeded
  inputs (``rng(7)``), and the same numpy arrays go through the JAX
  stages ``scripts/profile_step.py`` times (``ks._admit``,
  ``ks._candidates``, ``greedy_pair`` at 1/2/4/8 rounds, ``ks._evict``,
  ``ks._search_step_packed`` with and without filters; the candidate pass
  also through the Pallas kernel in interpret mode) and the port's
  (``admit``, ``KernelSet.candidates``, ``greedy_pair``, ``evict``,
  ``KernelSet.search_step_packed``): pools, slots and match counts
  equal, ELO values and distances bit for bit.
- ``profile()``'s own numbers (mean candidates a row, matches at each
  round count) equal JAX's on those inputs; ``prunecheck``'s dense and
  pruned steps are bit-identical on the CPU (``rng(0)``'s engine fill).
- Every script, in every mode, runs end to end as a subprocess with
  ``--device cpu`` and its lines parse; without ``--device cpu`` (no card
  here) each exits non-zero.
"""

import concurrent.futures
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchmaking_tpu.engine import kernels as K
from matchmaking_tpu.engine.pallas_kernels import (
    pack_batch_rows,
    pack_pool_rows,
    pallas_block_best,
)
from matchmaking_tpu_torch.engine.kernels import (
    admit,
    evict,
    greedy_pair,
    packed_now,
    pool_from_reference,
    pool_to_numpy,
    unpack_batch,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
P, BLK, ACTIVE, B, THR = 4096, 512, 3000, 64, 100.0
SMALL = ["--device", "cpu", "--capacity", str(P), "--pool-block", str(BLK),
         "--pool", str(ACTIVE)]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"mm_prof_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


step = _load("torch_profile_step")
stages = _load("torch_profile_stages")


@pytest.fixture(scope="module")
def split():
    """The seeded inputs, both kernel sets, and each side's view of them."""
    inp = step.make_inputs(P, B, ACTIVE, THR)
    jks = K.kernel_set(P, 8, BLK, False, 0.0, 400.0)
    tks = step.kernel_set(P, BLK)
    jpool = {k: jnp.asarray(v) for k, v in inp["arrays"].items()}
    jbatch = K.unpack_batch(jnp.asarray(inp["packed"]))
    packed = torch.from_numpy(inp["packed"])
    tbatch = unpack_batch(packed)
    jvals, jidxs = jax.jit(jks._candidates, static_argnames="skip_filters")(
        jbatch, jbatch["threshold"], jpool, jnp.float32(0.0))
    return {"inp": inp, "jks": jks, "tks": tks, "jpool": jpool,
            "jbatch": jbatch, "packed": packed, "tbatch": tbatch,
            "jvals": np.array(jvals), "jidxs": np.array(jidxs)}


def _tpool(split):
    return pool_from_reference(split["inp"]["arrays"], "cpu")


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same_pool(tpool, jpool):
    port = pool_to_numpy(tpool)
    assert port.keys() == set(jpool)
    for name, col in jpool.items():
        np.testing.assert_array_equal(port[name], np.asarray(col),
                                      err_msg=name)


def test_geometry_is_jaxs(split):
    jks, tks = split["jks"], split["tks"]
    assert (tks.capacity, tks.pool_block, tks.n_blocks, tks.pair_rounds) == (
        jks.capacity, jks.pool_block, jks.n_blocks, jks.pair_rounds)
    inp = split["inp"]
    assert int(inp["arrays"]["active"].sum()) == ACTIVE
    assert not inp["arrays"]["active"][inp["free"]].any()
    assert inp["matched"].shape == (2 * B,)


def test_admit_stage_equals_jax(split):
    tpool = _tpool(split)
    admit(tpool, split["tbatch"])
    _same_pool(tpool, split["jks"]._admit(split["jpool"], split["jbatch"]))


@pytest.mark.parametrize("skip_filters", [False, True],
                         ids=["cands", "cands_nofilter"])
def test_candidate_stage_equals_jax(split, skip_filters):
    jb = split["jbatch"]
    jvals, jidxs = jax.jit(split["jks"]._candidates,
                           static_argnames="skip_filters")(
        jb, jb["threshold"], split["jpool"], jnp.float32(0.0),
        skip_filters=skip_filters)
    tb = split["tbatch"]
    vals, idxs = split["tks"].candidates(tb, tb["threshold"], _tpool(split),
                                         packed_now(split["packed"]),
                                         skip_filters=skip_filters)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(jidxs))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(jvals))
    assert (np.asarray(jidxs) < P).sum() > B  # real candidate lists


def test_candidate_stage_equals_the_pallas_kernel(split):
    """The one ``pl.pallas_call``, in interpret mode as ``test_pallas.py``
    runs it, on the same inputs."""
    jks, jb = split["jks"], split["jbatch"]
    pv, pi = pallas_block_best(
        pack_pool_rows(split["jpool"]), pack_batch_rows(jb, jb["threshold"]),
        jnp.float32(0.0), super_blk=jks.pool_block, sub_blk=2048, b_tile=256,
        capacity=jks.capacity, glicko2=False, widen_per_sec=0.0,
        max_threshold=400.0, interpret=True)
    tb = split["tbatch"]
    vals, idxs = split["tks"].candidates(tb, tb["threshold"], _tpool(split),
                                         packed_now(split["packed"]))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(np.asarray(pv)))


@pytest.mark.parametrize("rounds", step.ROUNDS)
def test_pair_stage_equals_jax_at_each_round_count(split, rounds):
    jq, jc, jd = K.greedy_pair(jnp.asarray(split["jvals"]),
                               jnp.asarray(split["jidxs"]),
                               split["jbatch"]["slot"], P, rounds)
    tq, tc, td = greedy_pair(torch.from_numpy(split["jvals"]),
                             torch.from_numpy(split["jidxs"]),
                             split["tbatch"]["slot"], P, rounds)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(td.numpy()), _bits(np.asarray(jd)))
    assert int((tq < P).sum()) == int((np.asarray(jq) < P).sum()) > 0


def test_evict_stage_equals_jax(split):
    matched = split["inp"]["matched"]
    tpool = _tpool(split)
    evict(tpool, torch.from_numpy(matched))
    _same_pool(tpool, split["jks"]._evict(split["jpool"],
                                          jnp.asarray(matched)))


@pytest.mark.parametrize("skip_filters", [False, True],
                         ids=["full", "full_nofilter"])
def test_full_step_equals_jax_chained(split, skip_filters):
    """Three steps chained on one pool (the tool's ``full`` timing)."""
    jstep = jax.jit(split["jks"]._search_step_packed,
                    static_argnames="skip_filters")
    jpool, tpool = split["jpool"], _tpool(split)
    jpacked = jnp.asarray(split["inp"]["packed"])
    for _ in range(3):
        jpool, jout = jstep(jpool, jpacked, skip_filters=skip_filters)
        tout = split["tks"].search_step_packed(tpool, split["packed"],
                                               skip_filters=skip_filters)
        np.testing.assert_array_equal(_bits(tout.numpy()),
                                      _bits(np.asarray(jout)))
        _same_pool(tpool, jpool)


def test_profile_reports_jaxs_candidates_and_matches(split):
    lines = []
    res = step.profile(P, BLK, B, ACTIVE, iters=2, threshold=THR,
                       device="cpu", log=lines.append)
    jv, ji = jnp.asarray(split["jvals"]), jnp.asarray(split["jidxs"])
    assert res["mean_candidates"] == int(
        (split["jvals"] > -np.inf).sum(1).mean())
    for r in step.ROUNDS:
        jq, _, _ = K.greedy_pair(jv, ji, split["jbatch"]["slot"], P, r)
        assert res["matches"][r] == int((np.asarray(jq) < P).sum())
        assert f"matches at rounds={r}: {res['matches'][r]}/{B}" in lines
    assert set(res["stages"]) == {"admit", "cands", "cands_nofilter", "pair",
                                  "evict", "full", "full_nofilter",
                                  *(f"pair_r{r}" for r in step.ROUNDS)}
    assert res["candidate_check"] is None  # the card's check only


@pytest.mark.parametrize("w,chunk,path", [(5, 8, "span"),
                                           (2, 16, "fallback")])
def test_prunecheck_dense_equals_pruned_on_the_cpu(w, chunk, path):
    """Dense = pruned on the window's span path (every chunk's reach
    within W blocks) and on its dense fallback (a chunk reaches wider)."""
    args = stages.parse_args([*SMALL, "--mode", "prunecheck", "--window",
                              str(B), "--iters", "1", "--reps", "1",
                              "--prune-window-blocks", str(w),
                              "--prune-chunk", str(chunk)])
    res = stages.run(args)
    assert res["bit_identical"] and res["window_blocks"] == w
    assert res["path"] == path
    assert res["span_path_steps"] == (path == "span")
    assert set(res["ms"]) == {"dense", "pruned", "dense/nf", "pruned/nf"}


# ---- the scripts as an operator runs them ------------------------------------

#: (script, extra arguments) of every run; the key names the case.
RUNS = {
    "step": ("torch_profile_step.py", ["--window", str(B), "--iters", "2"]),
    **{f"stages_{m}": ("torch_profile_stages.py",
                       ["--mode", m, "--window", str(B), "--iters", "2",
                        "--reps", "1", "--depth", "2",
                        "--sweep-windows", "32,64", "--sweep-depths", "1,2",
                        "--prune-window-blocks", "2", "--prune-chunk", "16",
                        "--rescan-every", "3"])
       for m in ("device", "dispatch", "window", "sweep", "prunecheck",
                 "rescanstall")},
    "engine": ("torch_profile_engine.py", ["--window", str(B),
                                           "--windows", "3"]),
}
NO_CARD = ("torch_profile_step.py", "torch_profile_stages.py",
           "torch_profile_engine.py")


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def runs():
    """Every run, three at a time (each is mostly the interpreter's
    start; three keep the burst small beside the suite's parallel
    workers)."""
    jobs = {key: [os.path.join(SCRIPTS, script), *SMALL, *extra]
            for key, (script, extra) in RUNS.items()}
    jobs.update({f"nocard_{s}": [os.path.join(SCRIPTS, s)] for s in NO_CARD})
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {k: pool.submit(_run, a) for k, a in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


NUM = r"[0-9.,]+"
#: What each run's output must hold (regexes, each on a line of its own).
EXPECT = {
    "step": [r"^device: cpu ", r"^geometry: P=4096 blk=512 n_blocks=8 "
             r"B=64 rounds=8 active=3000$",
             r"^mean candidates/row: \d+$",
             *(rf"^matches at rounds={r}: \d+/64$" for r in step.ROUNDS),
             *(rf"^ *{n}: +{NUM} ms \(cpu wall\)$"
               for n in ("admit", "cands", "cands_nofilter", "pair",
                         "pair_r1", "pair_r8",
                         "evict", "full", "full_nofilter")),
             rf"^ +sum\(c\+p\+e\): +{NUM} ms \(cpu wall\)  \(full = {NUM}\)$",
             rf"^ +nofilter: +{NUM} ms \(cpu wall\)  \(a\+c\+p\+e; "
             rf"full_nofilter = {NUM}\)$"],
    "stages_device": [rf"^\[device {v} rep0\] 2 chained steps: {NUM} ms "
                      rf"total, {NUM} ms/step \(B=64, P=4096\)$"
                      for v in ("dense", "dense_nofilter")],
    "stages_dispatch": [rf"^\[dispatch depth={d} rep0\] h2d={NUM} ms "
                        rf"jit_call={NUM} ms sync_after={NUM} ms$"
                        for d in stages.DEPTHS],
    "stages_window": [rf"^\[B=64 d=2 rep0\] {NUM} m/s p50={NUM} ms "
                      rf"p99={NUM} ms$",
                      rf"^\[B=64 d=2 MEDIAN\] {NUM} m/s p50={NUM} p99={NUM}$"],
    "stages_sweep": [r"^window depth mps p50 p99$",
                     *(rf"^ +{w} +{d} +{NUM} +{NUM} +{NUM}$"
                       for w in (32, 64) for d in (1, 2))],
    "stages_prunecheck": [r"^\[prunecheck\] outputs bit-identical: True, "
                          r"pool bit-identical: True \(B=64, P=4096, "
                          r"blocks=8, W=2, chunk=16, matches=\d+, pruned "
                          r"steps 1, on the span path so far 0: the "
                          r"fallback path\)$",
                          *(rf"^\[prunecheck {n}\] ms/step min/med/max: "
                            rf"{NUM}/{NUM}/{NUM}$"
                            for n in ("dense", "pruned", "dense/nf",
                                      "pruned/nf"))],
    "stages_rescanstall": [rf"^\[rescanstall {d}\] {NUM} matches/s, window "
                           rf"p50 {NUM} ms, p99 {NUM} ms \(2 windows, "
                           rf"rescan every 3\)$" for d in ("overlap",
                                                           "drain")],
    "engine": [*(rf"^{re.escape(n)} +{NUM} ms/window$"
                 for n in ("make_columns", "dispatch(search_columns_async)",
                           "collect+finalize(flush)", "refill(restore)")),
               r"^matches/window: \d+$", r"^span_report: windows 3, ",
               *(rf"^{re.escape(n)} +{NUM} ms$"
                 for n in ("allocate_columns", "batch_arrays_cols",
                           "h2d (blocked)", "search_step call (dispatch only)",
                           "device exec (block)", "d2h"))],
}


@pytest.mark.parametrize("key", list(RUNS))
def test_each_mode_runs_on_the_cpu_and_its_lines_parse(runs, key):
    rc, out, err = runs[key]
    assert rc == 0, out + err
    text = out + err
    for pattern in EXPECT[key]:
        assert re.search(pattern, text, re.M), (pattern, text)


@pytest.mark.parametrize("script", NO_CARD)
def test_each_script_fails_without_a_card_unless_told_cpu(runs, script):
    rc, out, err = runs[f"nocard_{script}"]
    assert rc != 0
    assert "--device cpu" in err and "torch.cuda.is_available() is False" in err
    assert "ms" not in out
