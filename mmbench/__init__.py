"""The benchmark of ``matchmaking_tpu_torch`` on an NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m mmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); each metric is read by ``metrics/<name>.py``.
Adding a cell, a configuration, a traffic mix or a metric adds files and
entries only: the harness finds each by its name.

What is measured is the port alone. Nothing here imports ``jax`` or the
JAX package, and the reference that decides ``correct``
(``reference.py``) imports nothing of the port either.
"""
