"""MPI-style nonblocking request layer (the half of MPI the blocking
collectives in :mod:`repro_torch.core.collectives` still lacked).

Port of :mod:`repro.core.requests`; the semantics are unchanged.

The paper models FMI's interface after MPI; rFaaS (arXiv 2106.13859) shows
request-style async messaging is what makes high-performance FaaS viable,
and FSD-Inference (arXiv 2403.15195) that serverless ML wins hinge on
overlapping communication with compute.  This module is the enabling
abstraction: every collective gets an ``i``-prefixed variant returning a
:class:`Request` —

    req = iallreduce(x, comm)          # issued, in flight
    ...  compute while the bytes move ...
    y = req.wait()                     # completed

``wait``/``test``/``waitall`` follow MPI semantics.  A collective-level
Request executes at issue time on the lockstep software channel and
``wait`` is the ordering point (see :func:`_issue`).  At the *transport* level
(``ppermute_start`` / :func:`isend`/:func:`irecv`) the split additionally
drives the instrumented trace's pending-slot accounting, so the modeled
overlap there is *observed*, not asserted.

Point-to-point (``isend``/``irecv``) is expressed SPMD-style: both sides of
the exchange name the full ``(src, dst)`` pair list (rank-dependent control
flow is masks, never python ``if`` — the repo-wide convention), and a
``tag`` matches the send to its receive through the transport mailbox:

    isend(x, t, pairs, tag=3)          # sender half: injects the message
    req = irecv(t, tag=3)              # receiver half: Request for the data
    y = req.wait()

:class:`RequestQueue` is the drain-side helper the
:class:`~repro.core.scheduler.CommScheduler` builds buckets on.

Cancellation and generations (the elastic-runtime quiesce protocol)
-------------------------------------------------------------------
Every request is stamped with the **generation** of the communicator that
issued it (:attr:`~repro_torch.core.communicator.Communicator.generation`).  When
membership changes, the elastic controller bumps the generation and calls
:meth:`RequestQueue.cancel_all` — in-flight requests from the old
generation are aborted at the transport level (pending trace slots close,
staged broker keys are discarded) instead of deadlocking on ranks that will
never answer.  Waiting a cancelled request raises :class:`CancelledError`;
``test`` reports it complete (MPI_Cancel semantics: cancellation *is* a
completion).  See ``docs/elasticity.md`` for the full protocol.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from ..analysis.sanitizer import get_active as _sanitizer
from .transport import Perm, Transport, TransportRequest


class CancelledError(RuntimeError):
    """Waited on a request that was cancelled (stale generation)."""


class Request:
    """Handle for one in-flight nonblocking operation.

    Carries the op metadata the scheduler and the cost model want
    (``op``, ``nbytes``, user ``tag``, ``generation``) plus one of:

    * an immediate ``result`` (ops that complete at issue);
    * a ``transport_req`` (:class:`TransportRequest`) whose ``wait`` closes
      the instrumented channel's pending slot;
    * a deferred ``thunk`` executed at completion time.

    ``finalize`` (if given) post-processes the raw completion value exactly
    once — e.g. unpadding a fused bucket back into leaves.

    Example — deferred completion, idempotent wait, cancellation::

        >>> r = Request("allreduce", nbytes=64, thunk=lambda: 42)
        >>> r.test()          # never blocks, never forces a thunk
        False
        >>> r.wait(), r.wait()  # completes exactly once
        (42, 42)
        >>> stale = Request("allreduce", thunk=lambda: 0, generation=3)
        >>> stale.cancel()
        True
        >>> stale.test()      # cancellation IS a completion (MPI_Cancel)
        True
        >>> stale.wait()  # doctest: +IGNORE_EXCEPTION_DETAIL
        Traceback (most recent call last):
            ...
        repro_torch.core.requests.CancelledError: allreduce request (generation 3) was cancelled
    """

    def __init__(self, op: str = "op", nbytes: int = 0, tag: Any = None, *,
                 result: Any = None,
                 transport_req: TransportRequest | None = None,
                 thunk: Callable[[], Any] | None = None,
                 finalize: Callable[[Any], Any] | None = None,
                 generation: int = 0):
        self.op = op
        self.nbytes = int(nbytes)
        self.tag = tag
        self.generation = int(generation)
        self.cancelled = False
        self._result = result
        self._treq = transport_req
        self._thunk = thunk
        self._finalize = finalize
        self._done = transport_req is None and thunk is None and finalize is None
        if not self._done and transport_req is None and thunk is None:
            # eager result whose finalize must still run at completion time
            self._thunk = lambda: result
        s = _sanitizer()
        if s is not None:
            s.on_request_created(self)

    def test(self) -> bool:
        """True iff the operation has completed (never blocks).  A cancelled
        request counts as completed."""
        if self.cancelled:
            return True
        if not self._done and self._treq is not None and self._treq.test():
            self._complete(self._treq._result)
        return self._done

    def wait(self):
        """Block until complete; returns the operation's result.  Idempotent
        — later calls return the same result.  Raises
        :class:`CancelledError` if the request was cancelled."""
        s = _sanitizer()
        if s is not None:
            s.on_wait(self)
        if self.cancelled:
            raise CancelledError(
                f"{self.op} request (generation {self.generation}) was cancelled"
            )
        if not self._done:
            if self._treq is not None:
                self._complete(self._treq.wait())
            else:
                thunk, self._thunk = self._thunk, None
                self._complete(thunk())
        return self._result

    def cancel(self) -> bool:
        """Abort the operation if still in flight: the transport request (if
        any) is cancelled — closing its trace slot and discarding staged
        broker keys — and the thunk/finalize are dropped unrun.  Returns
        True iff this call cancelled it (False: already completed)."""
        s = _sanitizer()
        if s is not None:
            s.on_cancel(self)
        if self._done:
            return False
        if self._treq is not None:
            self._treq.cancel()
        self._result = self._treq = self._thunk = self._finalize = None
        self._done = True
        self.cancelled = True
        state = getattr(self, "_fmi_san", None)
        if state is not None:  # cancellation IS a completion for the tracker
            state["done"] = True
        return True

    def _complete(self, value):
        if self._finalize is not None:
            fin, self._finalize = self._finalize, None
            value = fin(value)
        self._result, self._treq, self._thunk = value, None, None
        self._done = True
        state = getattr(self, "_fmi_san", None)
        if state is not None:  # retire the sanitizer's leak tracking
            state["done"] = True


def wait(req: Request):
    """Functional alias for :meth:`Request.wait` (MPI_Wait)."""
    return req.wait()


def test(req: Request) -> bool:
    """Functional alias for :meth:`Request.test` (MPI_Test)."""
    return req.test()


def waitall(reqs: Sequence[Request]) -> list:
    """Complete every request; results in *request* order (MPI_Waitall),
    regardless of the order completions actually happen in.

    Example::

        >>> a, b = Request("x", thunk=lambda: "a"), Request("x", thunk=lambda: "b")
        >>> _ = b.wait()            # completion order differs from issue order
        >>> waitall([a, b])         # results are positional anyway
        ['a', 'b']
    """
    return [r.wait() for r in reqs]


class RequestQueue:
    """FIFO of in-flight requests with MPI-flavoured drain helpers.

    The scheduler pushes one request per issued bucket and drains the queue
    at the end of the step; ``waitall`` preserves issue order so unpacking
    is deterministic.  On a membership change the elastic controller calls
    :meth:`cancel_all` instead of draining — stale-generation requests are
    aborted and dropped rather than waited on ranks that will never answer.

    Example::

        >>> q = RequestQueue()
        >>> for gen in (0, 0, 1):
        ...     _ = q.push(Request("allreduce", thunk=lambda: 1, generation=gen))
        >>> q.cancel_all(generation=0)   # quiesce: abort the old generation
        2
        >>> len(q), q.waitall()          # the generation-1 request survives
        (1, [1])
    """

    def __init__(self):
        self._reqs: list[Request] = []

    def push(self, req: Request) -> Request:
        self._reqs.append(req)
        return req

    def __len__(self) -> int:
        return len(self._reqs)

    def __iter__(self):
        return iter(self._reqs)

    @property
    def pending(self) -> int:
        """Number of queued requests that have not completed yet."""
        return sum(0 if r.test() else 1 for r in self._reqs)

    def waitall(self) -> list:
        """Drain the queue: complete everything, return results in issue
        order, and empty the queue."""
        out = waitall(self._reqs)
        self._reqs = []
        return out

    def cancel_all(self, generation: int | None = None) -> int:
        """Quiesce: cancel and drop every queued request stamped with
        ``generation`` or older (``None``: all of them).  Requests from newer
        generations stay queued.  Already-completed requests are dropped
        without counting.  Returns the number actually cancelled."""
        keep, n = [], 0
        for r in self._reqs:
            if generation is not None and r.generation > generation:
                keep.append(r)
                continue
            if r.cancel():
                n += 1
        self._reqs = keep
        return n


# ---------------------------------------------------------------------------
# Nonblocking collectives — issue now, Request completes later
# ---------------------------------------------------------------------------


def _issue(op: str, nbytes: int, run: Callable[[], Any],
           finalize: Callable[[Any], Any] | None = None,
           comm=None) -> Request:
    """The lockstep software channels move the bytes at issue time, so the
    collective executes here and the Request carries the finished value; ``wait`` is
    the synchronization point the caller orders the program around (and
    where ``finalize`` — e.g. bucket unpacking — runs)."""
    generation = comm.generation if comm is not None else 0
    req = Request(op, nbytes, result=run(), finalize=finalize,
                  generation=generation)
    s = _sanitizer()
    if s is not None and comm is not None:
        s.on_issue(req, f"{comm.name}@{comm.channel}", generation)
    return req


def _payload_bytes(x) -> int:
    size = 1
    for d in getattr(x, "shape", ()):  # 0-d arrays: empty shape -> 1
        size *= int(d)
    if hasattr(x, "element_size"):
        return size * x.element_size()
    return size * x.dtype.itemsize if hasattr(x, "dtype") else int(size)


def iallreduce(x, comm, op="add", algorithm="auto", objective="time",
               pipeline: int | None = None,
               finalize: Callable[[Any], Any] | None = None) -> Request:
    """Nonblocking allreduce of ``x`` over ``comm`` → :class:`Request`."""
    from . import collectives as C

    return _issue("allreduce", _payload_bytes(x),
                  lambda: C.allreduce(x, comm, op=op, algorithm=algorithm,
                                      objective=objective, pipeline=pipeline),
                  finalize=finalize, comm=comm)


def ireduce_scatter(x, comm, op="add", algorithm="auto",
                    pipeline: int | None = None,
                    finalize: Callable[[Any], Any] | None = None) -> Request:
    """Nonblocking reduce-scatter → Request for this rank's reduced chunk."""
    from . import collectives as C

    return _issue("reduce_scatter", _payload_bytes(x),
                  lambda: C.reduce_scatter(x, comm, op=op, algorithm=algorithm,
                                           pipeline=pipeline),
                  finalize=finalize, comm=comm)


def iallgather(chunk, comm, algorithm="auto",
               finalize: Callable[[Any], Any] | None = None) -> Request:
    """Nonblocking allgather → Request for the full concatenated buffer."""
    from . import collectives as C

    return _issue("allgather", _payload_bytes(chunk),
                  lambda: C.allgather(chunk, comm, algorithm=algorithm),
                  finalize=finalize, comm=comm)


# ---------------------------------------------------------------------------
# Point-to-point — SPMD pair-list convention, tag-matched via a mailbox
# ---------------------------------------------------------------------------

def _mailbox(t: Transport) -> dict:
    """Tag → in-flight :class:`TransportRequest`, stored on the transport
    itself so the mailbox's lifetime is the transport's (a global registry
    keyed by ``id(t)`` would leak unmatched sends and could hand a new
    transport a dead one's messages after id reuse)."""
    box = getattr(t, "_fmi_mailbox", None)
    if box is None:
        box = t._fmi_mailbox = {}
    return box


def isend(x, t: Transport, pairs: Perm, tag: Any = 0, *,
          generation: int = 0) -> Request:
    """Sender half of a nonblocking point-to-point exchange: inject ``x``
    along ``pairs`` on transport ``t``.  The matching :func:`irecv` (same
    transport, same ``tag``) yields the data.  The returned Request's
    ``wait`` is send-completion (buffer reusable) — it does NOT imply the
    receive finished.  ``generation`` stamps the request for the elastic
    quiesce protocol (:meth:`Communicator.isend` passes its own)."""
    box = _mailbox(t)
    if tag in box:
        raise ValueError(f"isend tag collision: {tag!r} already in flight")
    s = _sanitizer()
    if s is not None:
        s.on_isend(t, list(pairs), tag)
    # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
    box[tag] = t.ppermute_start(x, pairs)
    return Request("send", _payload_bytes(x), tag, result=None,
                   generation=generation)


def irecv(t: Transport, tag: Any = 0, *, generation: int = 0) -> Request:
    """Receiver half: Request completing with the payload a matching
    :func:`isend` injected under ``tag``.  Waiting the receive closes the
    channel's pending slot (the GET hop on mediated transports)."""
    box = _mailbox(t)
    try:
        treq = box.pop(tag)
    except KeyError:
        raise ValueError(
            f"irecv with no matching isend for tag {tag!r} (in flight: "
            f"{sorted(map(repr, box))})"
        ) from None
    s = _sanitizer()
    if s is not None:
        s.on_irecv(t, tag)
    return Request("recv", 0, tag, transport_req=treq,
                   generation=generation)


def abort_mailbox(t: Transport) -> int:
    """Transport-level quiesce: cancel every in-flight :func:`isend` whose
    :func:`irecv` has not claimed it (the sends a dead rank will never
    receive) and empty the mailbox.  Each cancel closes the channel's
    pending trace slot and, on mediated transports, discards the staged
    broker keys.  Returns the number of aborted sends.

    Example::

        >>> import torch
        >>> from repro_torch.core.transport import SimTransport
        >>> t = SimTransport(2, device="cpu")
        >>> _ = isend(torch.ones((2, 4)), t, [(0, 1), (1, 0)], tag=9)
        >>> abort_mailbox(t)
        1
        >>> t.trace.pending
        0
    """
    box = _mailbox(t)
    n = sum(1 for treq in box.values() if treq.cancel())
    box.clear()
    s = _sanitizer()
    if s is not None:
        s.on_mailbox_abort(t, n)
    return n
