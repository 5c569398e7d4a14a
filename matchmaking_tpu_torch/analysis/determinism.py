"""``determinism``: seeds and clocks that break replay.

The chaos runtime's whole value (utils/chaos.py) is that a fault soak
replays bit-identically: every decision is a pure function of message
identity, never of RNG call order or wall-clock jitter. Two patterns
silently reintroduce the flake class seeded replay eliminated:

- **Unseeded RNGs** — ``random.Random()``, ``np.random.default_rng()``
  with no seed, or the module-level global RNGs (``random.random()``,
  ``np.random.rand(...)``, ``random.seed()``): their draw order depends on
  event-loop scheduling, so accounting differs between identical runs.
  torch has the same two shapes: a ``torch.Generator`` that is never
  ``manual_seed``-ed, and the global generator — ``torch.manual_seed``
  (seeding process-wide state whose draw order is the schedule's) and
  ``torch.rand*``/``randperm``/``normal``/``bernoulli``/``multinomial``
  (or an in-place ``uniform_``/``normal_``/...) drawing without
  ``generator=``.  The port's sanctioned shape is an explicit, seeded
  generator handed to every draw (or numpy's seeded ``default_rng``).
  Scanned in the package AND in the port's tests, scripts and smoke (a
  test that draws from an
  unseeded RNG is flaky by construction).
- **Wall-clock deadlines** — ``deadline = time.time() + N`` or
  ``while time.time() < deadline``: wall clocks step (NTP) and make
  timeout behavior irreproducible; ``time.monotonic()`` is the tool
  (app.py's rescan deadline already uses it). ``time.time()`` for
  TIMESTAMPS (trace marks, enqueue times, TTLs) is correct and not
  flagged — only deadline arithmetic is. The overload subsystem's
  deadline PROPAGATION (service/overload.py) widened the surface, so
  the rule covers the new shapes too: subscript stores whose key names
  a deadline (``headers["x-deadline"] = time.time() + n`` — the header
  must be stamped through ``overload.stamp_deadline(headers, now, n)``,
  which takes the one wall-clock read as a parameter), ``deadline +=
  time.time()`` aug-assigns, and ``f(deadline=time.time() + n)`` keyword
  arguments. The continuous-telemetry sampler (utils/timeseries.py)
  added another schedule-shaped surface — next-snapshot /
  next-sample / scrape-due arithmetic — so the same name heuristic covers
  those tokens too: the sanctioned shapes are ``asyncio.sleep(interval)``
  cadence (no stored wake time at all) or ``time.monotonic()``;
  ``time.time()`` remains fine as snapshot DATA (the ring's timestamps).
  The tiered-QoS scheduler added ordering-key surfaces —
  EDF window-cut keys and tier ranks (``edf_key``/``cut_key``/
  ``sort_key``/``tier_key`` tokens): a cut key born from ``time.time()``
  makes window COMPOSITION depend on scheduler jitter, so keys must be
  pure functions of the message (the stamped ``x-deadline`` header via
  ``overload.deadline_of`` + the admission-cached ``delivery.tier``).
  The crash-durability journal (utils/journal.py) added the
  newest surface — journal-SEQUENCE arithmetic (``journal_seq`` /
  ``record_seq`` / ``snapshot_seq`` / ``anchor_seq`` tokens): recovery
  replays records in seq order and the crash-soak pins a bit-identical
  recovery transcript, so a seq or compaction anchor derived from
  ``time.time()`` would make replay order a function of wall-clock
  jitter. Seqs are plain counters; fsync-interval pacing uses
  ``time.monotonic()``.
"""

from __future__ import annotations

import ast

from matchmaking_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    dotted_name,
    in_package,
    qualname_of,
)

RULE = "determinism"

#: Module-global RNG draws (call order = schedule order = flaky).
_GLOBAL_RNG_CALLS = {
    "random.random", "random.randint", "random.randrange", "random.choice",
    "random.choices", "random.shuffle", "random.uniform", "random.sample",
    "random.seed", "random.gauss",
    "np.random.rand", "np.random.randn", "np.random.randint",
    "np.random.random", "np.random.uniform", "np.random.choice",
    "np.random.shuffle", "np.random.seed", "np.random.normal",
    "numpy.random.rand", "numpy.random.randn", "numpy.random.randint",
    "numpy.random.random", "numpy.random.uniform", "numpy.random.choice",
    "numpy.random.shuffle", "numpy.random.seed", "numpy.random.normal",
}
#: torch draws from the GLOBAL generator unless handed ``generator=``.
_TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
}
#: In-place tensor draws (any receiver), likewise global without
#: ``generator=``.
_TORCH_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "exponential_", "geometric_",
    "cauchy_", "log_normal_", "bernoulli_",
})
#: Seeding the process-wide torch generators: their draw order is the
#: schedule's, whatever the seed.
_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed",
                      "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                      "torch.random.manual_seed"}
_TORCH_GENERATOR = {"torch.Generator", "torch.random.Generator"}
#: Constructors that REQUIRE an explicit seed argument.
_SEED_REQUIRED = {"random.Random", "np.random.default_rng",
                  "numpy.random.default_rng", "random.SystemRandom"}


def _in_scope(sf: SourceFile) -> bool:
    return (in_package(sf) or sf.path.startswith(("tests/", "scripts/"))
            or sf.path == "chip_smoke.py")


def _contains_time_time(node: ast.AST) -> ast.Call | None:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and dotted_name(sub.func) == "time.time":
            return sub
    return None


#: Name substrings that mark a value as schedule-like: wall-clock
#: arithmetic INTO one of these is the replay hazard. "deadline" covers
#: the overload subsystem; the snapshot/sample/scrape tokens cover the
#: telemetry sampler's next-tick shapes; the edf/sort-key
#: tokens cover the tiered-QoS window-cut ordering — an EDF
#: key computed from ``time.time()`` would make window COMPOSITION a
#: function of scheduler jitter, so the sanctioned shapes are the stamped
#: ``x-deadline`` header (``overload.deadline_of``) and the cached
#: ``delivery.tier``, both pure functions of the message.
_CLOCKLIKE_TOKENS = ("deadline", "next_snapshot", "snapshot_due",
                     "next_sample", "sample_due", "next_scrape",
                     "scrape_due", "edf_key", "edf", "cut_key", "sort_key",
                     "tier_key", "tier_rank",
                     # Journal-sequence arithmetic: the
                     # write-ahead journal's replay order is its monotone
                     # record seq — a seq/anchor born from time.time()
                     # would make recovery replay order (and the
                     # crash-soak's bit-identical transcript) a function
                     # of wall-clock jitter. Seqs are counters; the one
                     # sanctioned clock in the journal is the fsync
                     # INTERVAL check, which already uses monotonic.
                     "journal_seq", "record_seq", "snapshot_seq",
                     "anchor_seq",
                     # Lease/epoch arithmetic: fencing decides
                     # which host may write, so a lease deadline, epoch,
                     # ack watermark, or lag figure born from time.time()
                     # would make FAILOVER (and the failover-soak's
                     # bit-identical transcript) a function of wall-clock
                     # jitter. The sanctioned clock for lease state is a
                     # caller-passed time.monotonic() value; epochs and
                     # ack seqs are counters.
                     "lease_deadline", "epoch", "ack_seq", "lag_ms",
                     # Event-spine arithmetic: the forensics
                     # spine's causal order IS its monotone counter seq —
                     # a spine/event/incident seq derived from time.time()
                     # deltas would make the incident-soak's bit-identical
                     # transcript (and every postmortem timeline) a
                     # function of wall-clock jitter. The sanctioned
                     # clocks on a spine row are DATA fields: mono_ns
                     # (monotonic, for gap annotation) and wall (display
                     # only) — neither may feed the seq.
                     "spine_seq", "event_seq", "incident_seq", "trigger_seq",
                     "mono_ns", "capture_due", "next_capture",
                     # Retry/backoff/heartbeat arithmetic: the
                     # socket transport's reconnect schedule, heartbeat
                     # liveness verdict, and RTT-budgeted lease validity
                     # decide WHEN a peer is declared dead and WHEN a
                     # primary must fence — born from time.time() they
                     # would make failover timing (and the soak's
                     # bit-identical transcript) a function of wall-clock
                     # jitter, and unseeded reconnect jitter would make
                     # two seeded runs dial on different schedules. The
                     # sanctioned shapes: seeded jitter via
                     # hash01(seed, "backoff", conn, attempt) and
                     # caller-passed time.monotonic() values.
                     # (retry_deadline / heartbeat_deadline are already
                     # caught by the "deadline" token above.)
                     "backoff", "next_heartbeat", "rtt_ms", "valid_until",
                     "retry_at", "next_dial")


def _clocklike(text: str) -> bool:
    low = text.lower()
    return any(tok in low for tok in _CLOCKLIKE_TOKENS)


def _name_contains_deadline(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return _clocklike(node.id)
    if isinstance(node, ast.Attribute):
        return _clocklike(node.attr)
    if isinstance(node, ast.Subscript):
        # headers["x-deadline"] = ... — the deadline-propagation header
        # store (service/overload.py) and any dict-carried deadline.
        key = node.slice
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            return _clocklike(key.value)
        return _name_contains_deadline(node.value)
    return False


def _seeded_receivers(tree: ast.AST) -> set[str]:
    """Dotted names ``X`` with an ``X.manual_seed(...)`` call anywhere in
    the file (a generator built in ``__init__`` may be seeded in
    another method)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "manual_seed"):
            name = dotted_name(node.func.value)
            if name:
                out.add(name)
    return out


class _Scanner(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: list[Finding] = []
        self._stack: list[ast.AST] = []
        self._seeded = _seeded_receivers(sf.tree)
        #: ids of ``torch.Generator(...)`` calls whose seeding is decided
        #: where they are bound or chained (not reported again).
        self._gen_seen: set[int] = set()

    def _ctx(self) -> str:
        return qualname_of(self._stack)

    def visit_ClassDef(self, node):
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = visit_ClassDef
    visit_AsyncFunctionDef = visit_ClassDef

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        if name in _GLOBAL_RNG_CALLS:
            self.findings.append(Finding(
                RULE, self.sf.path, node.lineno,
                f"module-global RNG draw {name!r}: call order depends on "
                f"scheduling — use a seeded instance (random.Random(seed) / "
                f"np.random.default_rng(seed)) or utils.chaos.hash01",
                self._ctx()))
        elif name in _SEED_REQUIRED and not node.args and not node.keywords:
            self.findings.append(Finding(
                RULE, self.sf.path, node.lineno,
                f"unseeded {name}(): seed it explicitly so runs replay "
                f"bit-identically",
                self._ctx()))
        elif name in _TORCH_GLOBAL_SEED:
            self.findings.append(Finding(
                RULE, self.sf.path, node.lineno,
                f"global torch seed {name}(): every later draw's order is "
                f"the schedule's — build a torch.Generator, manual_seed it, "
                f"and pass generator= to each draw",
                self._ctx()))
        elif ((name in _TORCH_DRAWS
               or (isinstance(node.func, ast.Attribute)
                   and node.func.attr in _TORCH_INPLACE_DRAWS))
              and not any(kw.arg == "generator" for kw in node.keywords)):
            what = name if name in _TORCH_DRAWS else f".{node.func.attr}()"
            self.findings.append(Finding(
                RULE, self.sf.path, node.lineno,
                f"torch draw {what!r} without generator=: it draws from the "
                f"global generator, whose order is the schedule's — pass a "
                f"seeded torch.Generator",
                self._ctx()))
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr == "manual_seed"
              and isinstance(node.func.value, ast.Call)
              and dotted_name(node.func.value.func) in _TORCH_GENERATOR):
            # torch.Generator(...).manual_seed(s): seeded where it is built.
            self._gen_seen.add(id(node.func.value))
        elif name in _TORCH_GENERATOR and id(node) not in self._gen_seen:
            self._unseeded_generator(node)
        for kw in node.keywords:
            # f(deadline=time.time() + n): the deadline is born from the
            # wall clock at the call site — pass `now` through and derive
            # inside (overload.stamp_deadline is the sanctioned shape).
            if (kw.arg is not None and _clocklike(kw.arg)
                    and _contains_time_time(kw.value) is not None):
                self.findings.append(Finding(
                    RULE, self.sf.path, node.lineno,
                    f"keyword {kw.arg}=... computed from time.time(): wall "
                    f"clocks step (NTP) — take `now` as a parameter "
                    f"(overload.stamp_deadline) or use time.monotonic()",
                    self._ctx()))
        self.generic_visit(node)

    def _unseeded_generator(self, node: ast.Call) -> None:
        self.findings.append(Finding(
            RULE, self.sf.path, node.lineno,
            "torch.Generator() never manual_seed-ed: its draws differ "
            "between identical runs — call .manual_seed(seed) on it",
            self._ctx()))

    def visit_Assign(self, node: ast.Assign) -> None:
        if (isinstance(node.value, ast.Call)
                and dotted_name(node.value.func) in _TORCH_GENERATOR):
            # g = torch.Generator(...): seeded if g.manual_seed(...) runs
            # anywhere in the file.
            self._gen_seen.add(id(node.value))
            names = [dotted_name(t) for t in node.targets]
            if not any(n and n in self._seeded for n in names):
                self._unseeded_generator(node.value)
        if any(_name_contains_deadline(t) for t in node.targets):
            tt = _contains_time_time(node.value)
            if tt is not None:
                self.findings.append(Finding(
                    RULE, self.sf.path, tt.lineno,
                    "deadline/schedule value computed from time.time(): wall "
                    "clocks step (NTP) — use time.monotonic()",
                    self._ctx()))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if (_name_contains_deadline(node.target)
                and _contains_time_time(node.value) is not None):
            self.findings.append(Finding(
                RULE, self.sf.path, node.lineno,
                "deadline/schedule value adjusted from time.time(): wall "
                "clocks step (NTP) — use time.monotonic()",
                self._ctx()))
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        sides = [node.left, *node.comparators]
        if (any(isinstance(s, ast.Call)
                and dotted_name(s.func) == "time.time" for s in sides)
                and any(_name_contains_deadline(s) for s in sides)):
            self.findings.append(Finding(
                RULE, self.sf.path, node.lineno,
                "deadline/schedule comparison against time.time(): use "
                "time.monotonic()",
                self._ctx()))
        self.generic_visit(node)


def check(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in sources:
        if not _in_scope(sf):
            continue
        v = _Scanner(sf)
        v.visit(sf.tree)
        findings.extend(v.findings)
    return findings
