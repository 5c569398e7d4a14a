"""The port's ``entry()`` and ``dryrun_multichip`` (matchmaking_tpu_torch/
entry.py) against the JAX package's (``__graft_entry__.py``), on the CPU.

- ``entry(device="cpu")``'s step: its result and the pool it leaves equal
  the JAX ``entry()`` step's, bit for bit.
- ``dryrun_multichip(n, device="cpu")`` for n = 2 and 4 prints the line
  the JAX ``dryrun_multichip(n)`` prints over its virtual CPU devices.
- Asked for the card without ``devices``, the dry run takes n distinct
  visible cards and raises when fewer are visible; an explicit device
  list may repeat one.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from matchmaking_tpu_torch import entry


def test_entry_step_equals_the_jax_step_bit_for_bit():
    fn, (pool, packed) = jax_entry.entry()
    jpool, jout = jax.jit(fn)(pool, packed)
    tfn, (tpool, tpacked) = entry.entry(device="cpu")
    assert tuple(tpacked.shape) == (9, 64) and tpacked.device.type == "cpu"
    tout = tfn(tpool, tpacked)
    assert tuple(tout.shape) == (3, 64)
    assert np.array_equal(np.asarray(jout).view(np.int32),
                          tout.numpy().view(np.int32))
    assert int((tout[0] < 8192).sum()) > 0  # the window paired players
    for name in jpool:
        assert np.array_equal(np.asarray(jpool[name]), tpool[name].numpy()), \
            name


def test_example_packed_equals_the_jax_window():
    for args in ((8192, 64, [1500.0 + 7.0 * i for i in range(48)]),
                 (32, 16, [2500.0, 2504.0], 1.5)):
        assert np.array_equal(jax_entry._example_packed(*args),
                              entry.example_packed(*args))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_prints_the_jax_line(n, capsys):
    jax_entry.dryrun_multichip(n)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    entry.dryrun_multichip(n, device="cpu")
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want
    assert got.startswith(f"dryrun_multichip: devices={n} windows=5 ")


def test_dryrun_takes_an_explicit_device_list_with_repeats(capsys):
    entry.dryrun_multichip(2, devices=("cpu", "cpu"), device="cpu")
    assert capsys.readouterr().out.startswith(
        "dryrun_multichip: devices=2 windows=5 ")


@pytest.mark.skipif(torch.cuda.is_available() and
                    torch.cuda.device_count() >= 2,
                    reason="the machine has the cards this asks for")
def test_dryrun_on_the_card_needs_n_distinct_cards():
    with pytest.raises((ValueError, RuntimeError)):
        entry.dryrun_multichip(2)
