"""Communicator group membership with timeouts (paper §3.1, verbatim policy).

    "A timer is started as soon as the first function joins the group
     communicator.  If all functions scheduled to join do not do so before
     the timer expires, then all functions exit with an error."

On the TPU cluster the same policy governs job formation (all hosts must
report before ``form_timeout``) and failure detection (a rank whose
heartbeat is older than ``heartbeat_timeout`` is declared dead, and the
communicator errors out — the elastic controller then rebuilds a smaller
group; see elastic.py).  The clock is injectable so the policy is
deterministic under test.

Elastic extensions: after a failure the controller calls :meth:`reform`
with the new group's ranks — the membership epoch bumps and failure
detection restricts to the *current* group, so spares with stale
heartbeats don't re-trigger.  A failed rank that comes back (:meth:`rejoin`
— the flap case) heart-beats as a spare until the next reform folds it in.

Example — form, lose a rank, reform the survivors::

    >>> clk = lambda: clk.t
    >>> clk.t = 0.0
    >>> m = Membership(expected=4, heartbeat_timeout=5.0, clock=clk)
    >>> for r in range(4):
    ...     m.join(r)
    >>> m.formed
    True
    >>> clk.t = 3.0
    >>> for r in (0, 1, 3):        # rank 2 goes silent
    ...     m.heartbeat(r)
    >>> clk.t = 7.0
    >>> m.dead_ranks(), m.survivors()
    ([2], [0, 1, 3])
    >>> m.reform([0, 1, 3])        # the controller regrouped
    >>> m.epoch, sorted(m.group()), m.dead_ranks()
    (1, [0, 1, 3], [])
    >>> m.rejoin(2)                # flap: rank 2 reports back as a spare
    >>> sorted(m.group()), m.survivors()
    ([0, 1, 3], [0, 1, 2, 3])
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class GroupError(RuntimeError):
    """A communicator failed to form or lost a member (paper semantics:
    the entire communicator exits with an error)."""


@dataclass
class Membership:
    """Group formation + failure detection for one communicator lineage.

    ``expected`` is the launch-time world size; ``epoch`` counts reforms
    (membership changes the elastic controller committed).  All timing
    policy flows from the injectable ``clock``."""

    expected: int
    form_timeout: float = 30.0
    heartbeat_timeout: float = 10.0
    clock: callable = time.monotonic
    epoch: int = 0

    _joined: dict[int, float] = field(default_factory=dict)
    _first_join: float | None = None
    _formed: bool = False
    _group: frozenset | None = None  # current communicator members

    def join(self, rank: int):
        """Rank ``rank`` reports for group formation.  Raises
        :class:`GroupError` when the formation window has already closed
        (the paper's all-or-nothing join timer)."""
        now = self.clock()
        if self._first_join is None:
            self._first_join = now
        if now - self._first_join > self.form_timeout and not self._formed:
            raise GroupError(
                f"group formation timed out after {self.form_timeout}s "
                f"({len(self._joined)}/{self.expected} joined)"
            )
        if not 0 <= rank < self.expected:
            raise GroupError(f"rank {rank} outside [0, {self.expected})")
        self._joined[rank] = now
        if len(self._joined) == self.expected:
            self._formed = True
            self._group = frozenset(range(self.expected))

    @property
    def formed(self) -> bool:
        return self._formed

    def check_formed(self):
        """Raise if the formation window has closed without a full group."""
        if self._formed:
            return
        if self._first_join is None:
            return
        if self.clock() - self._first_join > self.form_timeout:
            raise GroupError(
                f"group formation timed out "
                f"({len(self._joined)}/{self.expected} joined)"
            )

    def group(self) -> frozenset:
        """Ranks of the *current* communicator (post-reform subset of the
        launch world).  Empty before formation."""
        if self._group is None:
            return frozenset()
        return self._group

    def heartbeat(self, rank: int):
        """Record a liveness beat.  Spares (ranks outside the current group)
        may beat too — that is how a flapped rank stays eligible for the
        next rescale up."""
        if not self._formed:
            raise GroupError("heartbeat before group formed")
        self._joined[rank] = self.clock()

    def mark_failed(self, rank: int):
        """Declare ``rank`` dead immediately (transport-level failure
        evidence, e.g. :class:`~repro_torch.core.transport.RankFailure` — no need
        to wait out the heartbeat timeout)."""
        self._joined[rank] = float("-inf")

    def rejoin(self, rank: int):
        """A previously-failed rank reports back (membership flap).  It gets
        a fresh heartbeat and counts as a survivor again, but stays outside
        the current group until the next :meth:`reform` folds it in."""
        if not 0 <= rank < self.expected:
            raise GroupError(f"rank {rank} outside [0, {self.expected})")
        self._joined[rank] = self.clock()

    def reform(self, ranks):
        """Commit a membership change: the new communicator is ``ranks``
        (old rank ids).  Every member (re)joins now, the epoch bumps, and
        failure detection restricts to the new group."""
        now = self.clock()
        self._group = frozenset(int(r) for r in ranks)
        for r in self._group:
            self._joined[r] = now
        self._formed = True
        self.epoch += 1

    def dead_ranks(self) -> list[int]:
        """Current-group ranks whose last beat is older than
        ``heartbeat_timeout`` (never spares — their staleness is expected)."""
        if not self._formed:
            return []
        now = self.clock()
        group = self._group if self._group is not None else frozenset(self._joined)
        return [
            r for r in sorted(group)
            if now - self._joined.get(r, float("-inf")) > self.heartbeat_timeout
        ]

    def check_alive(self):
        """Raise :class:`GroupError` if any group member missed its
        heartbeat — the communicator aborts as a whole (paper semantics);
        the elastic controller catches this and heals."""
        dead = self.dead_ranks()
        if dead:
            raise GroupError(f"ranks {dead} missed heartbeats; communicator aborts")

    def survivors(self) -> list[int]:
        """Every rank with a fresh heartbeat — current group members *and*
        rejoined spares.  This is the set :func:`~repro_torch.core.algorithms.build_group`
        regroups over."""
        now = self.clock()  # one clock read: borderline ranks judged once
        return [
            r for r in sorted(self._joined)
            if now - self._joined[r] <= self.heartbeat_timeout
        ]
