"""The reference against a tiny run of the port on the CPU, and the
roofline's count against a hand count."""

import time

import numpy as np
import torch

from mmbench import compare, reference, roofline, traffic
from mmbench.harness import Loop
from tinycells import shrink

from matchmaking_tpu_torch.config import Config
from matchmaking_tpu_torch.engine.interface import make_engine
from matchmaking_tpu_torch.service.contract import RequestColumns


def test_the_reference_answers_as_the_port_on_a_window_and_a_rescan(
        glicko_root):
    from mmbench import manifest

    man = manifest.load(glicko_root)
    cfg, params = shrink(manifest.config_file(man, "glicko2", glicko_root),
                         manifest.traffic_file("w1024"))
    config = cfg["config"]
    c = Config.from_dict(config, backend="gpu")
    eng = make_engine(c, c.queues[0], device="cpu")
    tr = traffic.Traffic(params, seed=2**31 + 11, seconds=0.1, trace=False,
                         rescan_ticks=2, rescan_rows=64)
    drv = Loop(eng, tr, depth=2, rescan_every=0.0, rescan_rows=64,
                 columns=RequestColumns)
    drv.restore(tr.fill)
    drv.dispatch()                # a window of 64 arrivals
    drv.drain()
    time.sleep(0.05)
    drv.rescan()                  # a tick over the 64 longest waiting
    drv.drain()
    kinds = {ev[1]: ev[0] for ev in drv.log if ev[0] in ("dispatch", "rescan")}
    assert sorted(kinds.values()) == ["dispatch", "rescan"]
    assert all(len(drv.answers[t].id_a) > 0 for t in kinds)
    want, pools = compare.replay(drv.log, config)
    got = drv.answers
    n = compare.details(drv.log, got, want,
                        [ev[1] for ev in drv.log if ev[0] == "pool"], pools)
    assert n == dict.fromkeys(n, 0) and "answers_wrong" in n


def _hand_pool():
    """Eight slots in two blocks of four; slot 4 empty; slot 2 takes a
    threshold of its own (50): it may match nobody 60 or more away."""
    spec = reference.Spec(capacity=8, pool_block=4, buckets=(4,),
                          pair_rounds=8, depth=2, threshold=100.0, widen=0.0,
                          max_threshold=400.0, glicko2=False)
    ref = reference.Reference(spec)
    ref.t0 = 0.0
    ratings = [1000, 1060, 1090, 1200, 950, 1010, 2000, 1005]
    ref.rating[:] = torch.tensor(ratings, dtype=torch.float32)
    ref.thr[:] = torch.tensor([100, 100, 50, 100, 100, 100, 100, 100],
                              dtype=torch.float32)
    ref.active[:] = torch.tensor([1, 1, 1, 1, 0, 1, 1, 1], dtype=torch.bool)
    return ref


def test_the_roofline_count_is_the_hand_count():
    # Lane at slot 0 (1000): 1060 (60), 1010 (10), 1005 (5); not 1090
    # (90 > slot 2's 50), 1200, 2000, the empty slot 4 or itself: 3.
    # Lane at slot 5 (1010): 1000, 1060, 1005; not 1090 (80 > 50): 3.
    ref = _hand_pool()
    seen = []
    ref.on_work = lambda kind, pairs, lanes: seen.append((kind, pairs, lanes))
    ref.count_work = True
    out, _ = ref._step(torch.tensor([0, 5]), 0.0, gate=True)
    assert seen == [("rescan", 6, 2)]
    # The candidates are the best a block: lane 0 has 1 (block 0) and 7,
    # lane 5 has 0 and 7. Both propose 7 (5 away): the lower lane wins, and
    # lane 5's candidates are then both taken, so it stays unmatched (8).
    q, c, d = out.numpy()
    assert q.tolist() == [0, 8] and c.tolist() == [7, 8]
    assert d.tolist() == [5.0, float("inf")]
    ops, nbytes = roofline.step_work(6, 2, 8, 2, glicko2=False, widen=False)
    assert ops == 6 * roofline.OPS_PAIR_ELO == 36
    assert nbytes == 2 * 17 + 8 * 13 + 2 * 2 * 8
    t, bound = roofline.least_time(ops, nbytes)
    assert bound == "bytes" and t == nbytes / roofline.PEAK_BYTES_S
    ops, _ = roofline.step_work(6, 2, 8, 2, glicko2=True, widen=True)
    assert ops == 6 * (6 + 8) + (2 + 8) * 5


def test_the_block_geometry_is_the_engines():
    assert reference.pool_block_of(131072, 8192, 8) == 8192
    assert reference.pool_block_of(2048, 256, 8) == 256
    assert reference.pool_block_of(1024, 8192, 8) == 128
    assert reference.pool_block_of(1000, 8192, 8) == 125


def test_the_traffic_is_the_seeds():
    p = {"kind": "closed_loop_columnar", "refill": "net_consumed",
         "window": 8, "pool_waiting": 16, "warm_windows": 1,
         "trace_windows": 1, "bank_windows_per_s": 4,
         "rating": {"dist": "normal", "mean": 1500.0, "std": 300.0},
         "rating_deviation": {"dist": "uniform", "lo": 30.0, "hi": 350.0},
         "wait_s": {"dist": "uniform", "lo": 0.0, "hi": 20.0}}
    a = traffic.Traffic(p, 2**31 + 5, 1.0, False)
    b = traffic.Traffic(p, 2**31 + 5, 1.0, False)
    c = traffic.Traffic(p, 2**31 + 6, 1.0, False)
    assert np.array_equal(a.window(3).rating, b.window(3).rating)
    assert not np.array_equal(a.window(3).rating, c.window(3).rating)
    assert a.n_windows == 1 + 4
    # Past the bank the values come round again, under ids never used.
    again, first = a.window(a.n_windows), a.window(0)
    assert np.array_equal(again.rating, first.rating)
    assert a.bank_cycles == 1
    ids = np.concatenate([a.window(k).ids for k in range(3 * a.n_windows)]
                         + [a.refill(5).ids for _ in range(20)])
    assert len(set(ids.tolist())) == len(ids)
    assert a.window(3).ids.tolist() == c.window(3).ids.tolist()


def test_a_full_pool_refuses_as_the_engine_does():
    """A window that finds fewer free slots than players: the engine and
    the reference refuse the same players (``pool_full``)."""
    from mmbench import manifest

    man = manifest.load()
    cfg, params = shrink(manifest.config_file(man, "elo_1v1"),
                         manifest.traffic_file("w1024"))
    params = dict(params, pool_waiting=2040)
    config = cfg["config"]
    c = Config.from_dict(config, backend="gpu")
    eng = make_engine(c, c.queues[0], device="cpu")
    tr = traffic.Traffic(params, seed=9, seconds=0.1, trace=False)
    drv = Loop(eng, tr, depth=2, rescan_every=0.0, rescan_rows=64,
                 columns=RequestColumns)
    drv.restore(tr.fill)
    drv.dispatch()
    drv.drain()
    (tok,) = drv.answers
    assert len(drv.answers[tok].refused) == 64 - 8
    want, pools = compare.replay(drv.log, config)
    n = compare.details(drv.log, drv.answers, want,
                        [ev[1] for ev in drv.log if ev[0] == "pool"], pools)
    assert n == dict.fromkeys(n, 0)
