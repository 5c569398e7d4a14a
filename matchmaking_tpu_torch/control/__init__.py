"""The control plane: the elastic placement controller and the online
autotuner.

Layout::

    state.py       placement state model + exactly-once migration
                   typestate + bounded decision audit log
    policy.py      PlacementPolicy seam + GreedyPolicy (burn → idle)
    simulate.py    deterministic seeded cluster simulation (the policy's
                   tests run without devices)
    arbiter.py     cross-queue (tier, deadline) dispatch arbiter for
                   queues bound to one device
    executor.py    the engine rebuild primitive (snapshot → build on the
                   target devices → restore → verify)
    controller.py  the live control loop + the /debug/placement snapshot
    autotune.py    the online knob autotuner: one serving knob a tick
                   within declared safe ranges, audited at /debug/autotune

Placement binds each queue to logical device ids; the app resolves them
through its device inventory (``MatchmakingApp(devices=...)``) when it
builds an engine.
"""

from matchmaking_tpu_torch.control.arbiter import DispatchArbiter
from matchmaking_tpu_torch.control.autotune import (
    AutoTuner,
    KnobDecision,
    KnobMove,
    QueueTune,
    TuneView,
)
from matchmaking_tpu_torch.control.controller import PlacementController
from matchmaking_tpu_torch.control.policy import (
    Action,
    GreedyPolicy,
    PlacementPolicy,
    QueueSignals,
    SignalView,
)
from matchmaking_tpu_torch.control.state import (
    PlacementDecision,
    PlacementError,
    PlacementState,
    QueuePlacement,
)

__all__ = [
    "Action",
    "AutoTuner",
    "DispatchArbiter",
    "KnobDecision",
    "KnobMove",
    "QueueTune",
    "TuneView",
    "GreedyPolicy",
    "PlacementController",
    "PlacementDecision",
    "PlacementError",
    "PlacementPolicy",
    "PlacementState",
    "QueuePlacement",
    "QueueSignals",
    "SignalView",
]
