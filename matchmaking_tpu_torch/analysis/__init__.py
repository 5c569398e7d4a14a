"""matchlint for the port — its concurrency, lifecycle and protocol
analyzer, checking ``matchmaking_tpu_torch/`` and the port's own files
beside it (``tests/test_torch_*.py``, ``chip_smoke.py``,
``scripts/torch_*.py``).

Lexical rules (see each module's docstring for the contract):

- ``await-under-lock``  (locks.py)       suspension points inside
  ``async with <lock>`` bodies that aren't a sanctioned shape.
- ``guarded-by``        (locks.py)       mutation of ``# guarded-by:``
  declared attributes outside the declared lock's dominance.
- ``blocking-call``     (blocking.py)    event-loop stalls visible
  lexically in ``async def`` bodies (time.sleep, sync I/O, torch host
  syncs).
- ``determinism``       (determinism.py) unseeded RNGs (torch generators
  included) and wall-clock deadlines that break chaos-replay determinism.
- ``perf``              (perf.py)        O(pool)/O(matches) host scans
  inside hot-path-named functions.
- ``speculation``       (speculation.py) ``spec_commit`` without a live
  ``spec_validate``.

Flow-sensitive rules (on the dataflow.py CFG + fixed-point substrate —
``await``/calls are implicit exception edges):

- ``settlement``        (lifecycle.py)   exactly-once delivery
  settlement: credit leaks on exception paths, double-settles through
  helper calls, conditionally-settled windows; interprocedural contracts
  via ``# settles:`` / ``# settles-some:`` / ``# owns:`` annotations.
- ``lock-pairing``      (lifecycle.py)   balanced explicit
  ``acquire()``/``release()`` on every path.
- ``protocol``          (protocol.py)    fence-dominated epoch effects,
  monotone watermarks, the record-type vocabulary.
- ``stale-ignore``      (core.py)        active ignores that suppress
  nothing anymore.

Run ``python -m matchmaking_tpu_torch.analysis`` from the repo root;
``pytest -m lint tests/test_torch_matchlint.py`` runs the same gate as a
test node.  Suppress intentional findings inline with an ignore comment
naming the rule plus a reason (syntax in core.py), or accept them in
``analysis/baseline.json`` (``--write-baseline`` / ``--update-baseline``).
"""

from matchmaking_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    RULES,
    discover,
)
from matchmaking_tpu_torch.analysis.engine import (  # noqa: F401
    analyze_repo,
    analyze_source,
    main,
)
