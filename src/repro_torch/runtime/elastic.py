"""Elastic fault-tolerant runtime: detect → quiesce → regroup → reshard → resume.

The paper delegates fault tolerance to the membership timer (§3.1) plus
checkpoint/restart; the serverless elasticity literature (PAPERS.md:
"Exploiting Inherent Elasticity", "FaaS Is Not Enough") shows elasticity
only pays off when regroup/rescale is a first-class, cheap operation.  This
module is that operation for the trainer.  One heal is five phases:

1. **detect** — :meth:`Membership.check_alive` raises
   :class:`~repro_torch.runtime.membership.GroupError` on a missed heartbeat, or
   the transport raises :class:`~repro_torch.core.transport.RankFailure`
   mid-collective (which :meth:`ElasticController.step_or_heal` converts
   into a membership mark).
2. **quiesce** — the injected ``quiesce`` hook cancels in-flight
   communication: :meth:`CommScheduler.abort
   <repro.core.scheduler.CommScheduler.abort>` discards open buckets and
   ``RequestQueue.cancel_all`` aborts the stale generation's requests at
   the transport level (pending trace slots close, staged broker keys are
   discarded) — nothing deadlocks waiting on a dead rank.
3. **regroup** — :func:`~repro_torch.core.algorithms.build_group` lays the
   survivors out as the next group (pow2-floor with idle spares, full-size
   ring, or recursive-doubling-with-spares); the controller bumps its
   ``generation``, commits the change with :meth:`Membership.reform`, and
   the ``rebuild`` callback reconstructs mesh/communicators/step functions
   at the new size.
4. **reshard** — the ``restore`` callback reloads the latest committed
   checkpoint onto the new topology (``checkpoint/store.py`` re-device_puts
   every leaf, so resharding is the same code path) and returns the step to
   resume from.
5. **resume** — the training loop continues at the restored step; the
   decision of *whether* to regroup now or limp along degraded is priced by
   :func:`repro_torch.core.selector.rescale_plan`.

The controller is policy + protocol — mesh/step rebuilding is delegated to
callbacks so it is unit-testable without devices and reusable by the
training loop, the fault-injection tests, the recovery benchmark, **and the
serving runtime**: :class:`repro_torch.serving.engine.ContinuousBatchingEngine`
drives the same five phases with serving-flavoured callbacks — ``quiesce``
cancels the stale generation's decode collectives and snapshots the
**KV-page manifest** (:class:`repro_torch.serving.kv_cache.KVPageManifest`),
``rebuild`` re-maps the TP shards onto the regrouped world, and ``restore``
*replays* every live sequence from the manifest instead of reading a
checkpoint (the dead rank's head-shard KV pages are unrecoverable; token
histories are tiny, so re-prefilling them is the reshard).  ``restore``'s
return value is protocol-opaque: the trainer returns the resume step, the
serving engine the number of replayed sequences.

Example — a full heal driven by a fake clock (no devices needed)::

    >>> from repro_torch.runtime.membership import Membership
    >>> clk = lambda: clk.t
    >>> clk.t = 0.0
    >>> m = Membership(expected=8, heartbeat_timeout=5.0, clock=clk)
    >>> for r in range(8):
    ...     m.join(r)
    >>> clk.t = 3.0
    >>> for r in range(7):         # rank 7 dies silently
    ...     m.heartbeat(r)
    >>> clk.t = 7.0
    >>> calls = []
    >>> ctl = ElasticController(
    ...     membership=m,
    ...     rebuild=lambda dp: calls.append(("rebuild", dp)),
    ...     restore=lambda: calls.append(("restore",)) or 42,
    ...     quiesce=lambda: calls.append(("quiesce",)) or 3,
    ...     strategy="ring",       # keep all 7 survivors (non-pow2)
    ... )
    >>> ctl.step_or_heal(lambda: None)
    True
    >>> calls                      # quiesce BEFORE rebuild BEFORE restore
    [('quiesce',), ('rebuild', 7), ('restore',)]
    >>> h = ctl.history[0]
    >>> (h["dp"], h["step"], h["generation"], h["cancelled"])
    (7, 42, 1, 3)
    >>> m.epoch, sorted(m.group())
    (1, [0, 1, 2, 3, 4, 5, 6])
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..core.algorithms import GroupBuild, build_group
from ..core.transport import RankFailure
from .membership import GroupError, Membership


def pow2_floor(n: int) -> int:
    """Largest power of two <= ``n`` (0 for non-positive ``n``).

    >>> pow2_floor(7), pow2_floor(8), pow2_floor(0)
    (4, 8, 0)
    """
    return 1 << (n.bit_length() - 1) if n > 0 else 0


@dataclass
class ElasticController:
    """Drives the detect → quiesce → regroup → reshard → resume loop.

    Callbacks:

    * ``rebuild(new_size)`` — reconstruct mesh/communicators/step functions
      for the new data-parallel degree (``GroupBuild`` details — old-rank →
      new-rank map, spares — are on ``self.last_build``).
    * ``restore() -> step`` — reload the latest committed state onto the
      new topology (trainer: checkpoint restore; serving engine: KV-page
      manifest replay); returns the point to resume from.
    * ``quiesce() -> n_cancelled`` (optional) — cancel in-flight
      communication (typically ``scheduler.abort(generation)``); runs
      *before* rebuild so no stale request is ever waited on the new group.

    ``strategy`` picks the regroup layout (see
    :func:`~repro_torch.core.algorithms.build_group`): ``'pow2_floor'`` (default,
    fast paths + idle spares), ``'ring'`` / ``'recursive_doubling'`` (all
    survivors active, non-pow2 sizes), or ``'auto'``."""

    membership: Membership
    rebuild: Callable[[int], None]  # new degree -> rebuild mesh/step fns
    restore: Callable[[], int]  # reload ckpt onto new topology; returns step
    min_degree: int = 1
    strategy: str = "pow2_floor"
    quiesce: Callable[[], int] | None = None
    generation: int = 0
    history: list = field(default_factory=list)
    last_build: GroupBuild | None = None

    def plan_regroup(self) -> GroupBuild:
        """The group the next heal would build (no side effects).  Raises
        :class:`GroupError` below ``min_degree``."""
        survivors = self.membership.survivors()
        if not survivors:
            raise GroupError("no survivors; nothing to regroup")
        build = build_group(survivors, self.strategy)
        if build.size < self.min_degree:
            raise GroupError(
                f"only {len(survivors)} survivors ({build.size} active under "
                f"{build.strategy!r}); below min degree {self.min_degree}"
            )
        return build

    def _commit(self, build: GroupBuild, survivors: int) -> int:
        cancelled = self.quiesce() if self.quiesce is not None else 0
        self.generation += 1
        self.membership.reform(build.active)
        self.rebuild(build.size)
        step = self.restore()
        self.last_build = build
        self.history.append({
            "survivors": survivors,
            "dp": build.size,
            "step": step,
            "generation": self.generation,
            "cancelled": cancelled,
            "spares": build.spares,
            "strategy": build.strategy,
        })
        return step

    def heal(self) -> int:
        """Handle a failure end-to-end: quiesce, regroup the survivors,
        reshard from the checkpoint.  Returns the step to resume from."""
        build = self.plan_regroup()
        return self._commit(build, len(self.membership.survivors()))

    def rescale_up(self) -> int | None:
        """Opportunistic grow-back: if rejoined spares (membership flap) or
        idle pow2-floor spares allow a *larger* group than the current one,
        run the same quiesce → regroup → reshard protocol upward.  Returns
        the resume step, or None when no growth is available."""
        survivors = self.membership.survivors()
        if not survivors:
            return None
        build = build_group(survivors, self.strategy)
        if build.size <= len(self.membership.group()):
            return None
        return self._commit(build, len(survivors))

    def step_or_heal(self, do_step: Callable[[], None]) -> bool:
        """Run one step under failure protection; heal and report True when
        a failure was detected (heartbeat timeout before the step, or a
        :class:`~repro_torch.core.transport.RankFailure` escaping mid-step —
        transport evidence is committed to the membership first, so the
        regroup sees the failed rank as dead regardless of timers).

        Transport evidence is not only kill marks: a lease-based channel
        (:class:`~repro.core.rdma.LeaseTransport`) raises ``RankFailure``
        with ``reason="lease-expired"`` when a rank's lease lapses
        mid-collective, so a silent rank drives the same detect → quiesce
        → regroup path as a crashed one.  The evidence kind is recorded on
        the heal's history entry (``history[-1]["evidence"]``) for
        post-mortems."""
        try:
            self.membership.check_alive()
            do_step()
            return False
        except RankFailure as e:
            self.membership.mark_failed(e.rank)
            self.heal()
            self.history[-1]["evidence"] = getattr(e, "reason", "rank-failure")
            return True
        except GroupError:
            self.heal()
            self.history[-1]["evidence"] = "heartbeat"
            return True
