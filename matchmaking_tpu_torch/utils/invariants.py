"""Online checking of the service's end-to-end invariants.

The window engines keep their own state consistent; what neither the
device nor the host mirror can see alone is a desynchronisation across
outcomes. The checker watches every outcome the service publishes:

- **no double match**: a player id is in at most one match until it is
  re-queued (a re-queue is the id showing up as queued again);
- **well-formed teams**: each team has the queue's team size, and no id is
  twice in one match.

The service builds one per queue when ``Config.debug_invariants`` is set
(one dict op per matched player) and feeds it every window's outcome,
columnar or object, and every rescan tick's; a violation raises
``InvariantViolation`` at the publish that breaks it.
"""

from __future__ import annotations


class InvariantViolation(AssertionError):
    pass


class InvariantChecker:
    def __init__(self, team_size: int = 1):
        self.team_size = team_size
        #: Ids consumed by a match and not re-queued since: id → match id.
        self._matched: dict[str, str] = {}

    def observe_queued(self, player_id: str) -> None:
        """A player (re-)entered the waiting pool: its hold is released."""
        self._matched.pop(player_id, None)

    def observe_match(self, match_id: str, teams) -> None:
        ids = [pid for team in teams for pid in team]
        if len(set(ids)) != len(ids):
            raise InvariantViolation(
                f"match {match_id}: player appears twice {sorted(ids)}")
        if self.team_size > 1:
            for team in teams:
                if len(team) != self.team_size:
                    raise InvariantViolation(
                        f"match {match_id}: team size {len(team)} != "
                        f"{self.team_size}")
        for pid in ids:
            prev = self._matched.get(pid)
            if prev is not None:
                raise InvariantViolation(
                    f"player {pid} in match {match_id} but already consumed "
                    f"by match {prev} (no re-queue observed in between)")
            self._matched[pid] = match_id

    def observe_outcome(self, outcome) -> None:
        """Feed a ``SearchOutcome`` or a ``ColumnarOutcome``."""
        if hasattr(outcome, "m_id_a"):  # columnar
            for a, b, mid in zip(outcome.m_id_a, outcome.m_id_b,
                                 outcome.m_match_id):
                self.observe_match(mid, ((a,), (b,)))
            for pid in outcome.q_ids:
                self.observe_queued(pid)
            return
        for match in outcome.matches:
            # A party's members all count toward the team size, and the
            # match consumes each of them.
            self.observe_match(
                match.match_id,
                tuple(tuple(pid for r in team for pid in r.all_ids())
                      for team in match.teams))
        for req in outcome.queued:
            for pid in req.all_ids():
                self.observe_queued(pid)
