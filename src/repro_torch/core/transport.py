"""Channel transports for FMI collectives, on PyTorch tensors.

Port of :mod:`repro.core.transport` (the JAX package).  The split between
*algorithms* (channel-agnostic, written once against :class:`Transport`)
and *channels* (the medium moving raw bytes) is unchanged; this module
carries the instrumented software channel:

* :class:`SimTransport` — executes all ranks in lockstep on stacked
  ``[P, ...]`` torch tensors that live on one device.  It supports
  arbitrary rank counts, counts rounds and per-rank bytes, and is the
  oracle the α-β cost models in :mod:`repro_torch.core.models` are held
  to (the counted rounds/bytes must match the model exactly).

Payloads stay on the transport's device; rank arithmetic stays on the host.
:meth:`SimTransport.rank` is a host ``numpy`` array, and the rank-dependent
starts of :meth:`~SimTransport.dynslice` / :meth:`~SimTransport.dynupdate`
are host integers, so no step reads a device value back just to compute an
index.  :meth:`SimTransport.where` moves a host condition to the payload's
device once per call.

The mesh channel (``JaxTransport``) and the mediated host-broker channel
(``HostTransport``) of the reference are not ported yet (ROADMAP Queue 1).

Nonblocking contract
--------------------
The single communication primitive is split MPI-style into an issue half
and a completion half: ``ppermute_start(x, perm)`` injects the message and
returns a :class:`TransportRequest`; ``request.wait()`` yields the received
payload.  Blocking ``ppermute`` is just ``ppermute_start(...).wait()``.

A message *started while earlier requests are still pending* is pipelined
behind them: it still counts toward ``rounds`` and bytes, but merges into
the open **serialized slot** — so ``trace.serial_rounds``/
``trace.slot_bytes()`` expose the critical-path schedule the α-β model
prices, while ``trace.rounds`` counts raw messages.

SPMD convention
---------------
Algorithms are written in SPMD style: one logical program per rank.  A
"logical array" has shape ``[*shape]``; ``SimTransport`` physically stores
``[P, *shape]`` (leading rank axis) and vectorizes every transport op over
it.  Rank-dependent control flow is expressed with :meth:`Transport.where`
masks and rank-indexed dynamic slices — never with python ``if`` on the
rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..analysis.sanitizer import get_active as _sanitizer
from ..devices import resolve_device, to_device

Perm = Sequence[tuple[int, int]]


class RankFailure(RuntimeError):
    """A transport operation touched a rank that has failed.

    Raised by the software channel when fault injection
    (:meth:`SimTransport.kill`) has marked a participant dead.  Carries the
    failed ``rank`` so the elastic runtime can mark it in
    :class:`~repro_torch.runtime.membership.Membership` and regroup, and a
    ``reason`` tag (``"rank-failure"``, ...) the elastic controller records
    as the evidence that drove the heal."""

    def __init__(self, rank: int, message: str | None = None,
                 reason: str = "rank-failure"):
        super().__init__(message or f"rank {rank} failed mid-collective")
        self.rank = rank
        self.reason = reason


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def ilog2(n: int) -> int:
    if not is_pow2(n):
        raise ValueError(f"expected a power of two, got {n}")
    return n.bit_length() - 1


class TransportRequest:
    """Handle for one in-flight ``ppermute`` (the transport half of the
    MPI-style nonblocking contract; :mod:`repro_torch.core.requests` builds
    the user-facing :class:`~repro_torch.core.requests.Request` on top).

    ``wait()`` returns the received payload and retires the request;
    ``test()`` reports completion without blocking.  On the lockstep
    software channel the data movement happens at issue time — what
    ``wait`` completes is the *trace accounting* (the pending slot is
    closed), which is exactly the part the α-β model prices.

    ``cancel()`` is the abort half of the elastic-runtime quiesce protocol:
    an in-flight request is retired *without* delivering its payload — the
    channel's ``on_cancel`` hook closes the trace's pending slot.  Waiting a
    cancelled request returns ``None``; the user-facing
    :class:`~repro_torch.core.requests.Request` raises instead."""

    def __init__(self, result, on_wait: Callable | None = None,
                 on_cancel: Callable | None = None):
        self._result = result
        self._on_wait = on_wait
        self._on_cancel = on_cancel
        self._done = on_wait is None
        self.cancelled = False

    def test(self) -> bool:
        return self._done

    def wait(self):
        if not self._done:
            on_wait, self._on_wait = self._on_wait, None
            self._result = on_wait(self._result)
            self._done = True
        return self._result

    def cancel(self) -> bool:
        """Abort the request if still in flight.  Returns True iff this call
        cancelled it (False: already completed — MPI_Cancel semantics)."""
        if self._done:
            if self.cancelled:
                s = _sanitizer()
                if s is not None:
                    s.on_transport_double_cancel(self)
            return False
        on_cancel = self._on_cancel
        self._on_wait = self._on_cancel = None
        self._result = None
        self._done = True
        self.cancelled = True
        if on_cancel is not None:
            on_cancel()
        s = _sanitizer()
        if s is not None:
            s.on_transport_cancel(self)
        return True


class Transport:
    """Abstract SPMD transport — the paper's 'channel' operating on raw memory."""

    size: int
    stacked: bool = False  # True: arrays carry a physical [P, ...] rank axis

    # -- identity ---------------------------------------------------------
    def rank(self):
        raise NotImplementedError

    # -- the single communication primitive --------------------------------
    def ppermute_start(self, x, perm: Perm) -> TransportRequest:
        """Issue one permutation message nonblockingly: rank ``dst`` will
        receive ``x`` from ``src`` for each ``(src, dst)``; ranks that
        receive nothing get zeros.  A message started while earlier requests
        are pending pipelines behind them (merges into the open serialized
        slot on instrumented channels)."""
        raise NotImplementedError

    def ppermute(self, x, perm: Perm):
        """Blocking permutation: issue + immediately complete (one fresh
        serialized slot per call on the instrumented channels)."""
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        return self.ppermute_start(x, perm).wait()

    # -- rank-masked helpers ---------------------------------------------
    def where(self, cond, a, b):
        raise NotImplementedError

    def dynslice(self, x, start, size: int, axis: int = 0):
        """Slice of ``size`` along logical ``axis`` from a possibly
        rank-dependent ``start``."""
        raise NotImplementedError

    def dynupdate(self, x, update, start, axis: int = 0):
        raise NotImplementedError

    def concat(self, parts, axis: int = 0):
        raise NotImplementedError

    def reshape(self, x, shape: tuple[int, ...]):
        raise NotImplementedError

    def zeros(self, shape: tuple[int, ...], dtype):
        raise NotImplementedError

    def ones(self, shape: tuple[int, ...], dtype):
        raise NotImplementedError

    # logical shape (without the stacked rank axis)
    def lshape(self, x) -> tuple[int, ...]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Instrumented software channel (testing + cost-model oracle)
# ---------------------------------------------------------------------------


@dataclass
class ChannelTrace:
    """What the α-β model needs: rounds and the max bytes any rank moved.

    ``rounds``/``per_round`` count every message; ``serial_rounds``/
    ``per_slot`` group messages into serialized slots.  Slot membership is
    decided by **pending-slot accounting**: a message *issued* while earlier
    requests are still pending rides in the open slot; a message issued
    with no requests in flight opens a fresh slot.  ``issue``/``complete``
    are the bookkeeping halves of ``ppermute_start``/``request.wait()``."""

    rounds: int = 0
    bytes_per_rank: int = 0  # max over ranks of bytes *sent* (α-β convention)
    total_bytes: int = 0
    per_round: list = field(default_factory=list)
    serial_rounds: int = 0
    per_slot: list = field(default_factory=list)  # [[bytes, ...], ...]
    pending: int = 0  # requests issued but not yet waited

    def record(self, nbytes: int, participants: int, overlap: bool = False):
        self.rounds += 1
        self.bytes_per_rank += nbytes
        self.total_bytes += nbytes * participants
        self.per_round.append((nbytes, participants))
        if overlap and self.per_slot:
            self.per_slot[-1].append(nbytes)
        else:
            self.serial_rounds += 1
            self.per_slot.append([nbytes])

    def issue(self, nbytes: int, participants: int):
        """Record a nonblockingly-issued message: it merges into the open
        slot iff some earlier request is still pending."""
        self.record(nbytes, participants, overlap=self.pending > 0)
        self.pending += 1

    def complete(self):
        """Retire one pending request (the ``wait`` half)."""
        if self.pending <= 0:
            raise RuntimeError("trace.complete() without a pending request")
        self.pending -= 1

    def slot_bytes(self) -> list:
        """Per serialized slot: total bytes the busiest rank pushed."""
        return [sum(slot) for slot in self.per_slot]

    def time(self, alpha: float, beta: float) -> float:
        """α-β critical-path time: one latency per serialized slot, link
        occupancy for every byte in the slot."""
        return sum(alpha + b * beta for b in self.slot_bytes())


class SimTransport(Transport):
    """All ranks in lockstep on stacked ``[P, *shape]`` tensors on
    ``device`` (``None``: the card, or raise when there is none; pass
    ``device="cpu"`` for the CPU).

    Fault injection: :meth:`kill` marks a rank failed (optionally after a
    number of further rounds, to land the failure mid-collective); any
    exchange whose pair list then touches the dead rank raises
    :class:`RankFailure`.  :meth:`revive` clears the mark — the membership
    flap (down-then-up) path of the elastic runtime.

    >>> t = SimTransport(2, device="cpu")
    >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    >>> t.ppermute(x, [(0, 1), (1, 0)]).tolist()
    [[3.0, 4.0], [1.0, 2.0]]
    >>> t.trace.rounds, t.trace.slot_bytes()
    (1, [8])
    """

    stacked = True

    def __init__(self, size: int, device: str | torch.device | None = None):
        self.size = int(size)
        self.device = resolve_device(device)
        self.trace = ChannelTrace()
        self._dead: set[int] = set()
        self._kill_at: dict[int, int] = {}  # rank -> rounds until failure
        # device copies of the (few, recurring) pair lists and rank masks
        self._on_device: dict = {}

    # fault injection -------------------------------------------------------
    def kill(self, rank: int, after_rounds: int = 0):
        """Mark ``rank`` failed.  ``after_rounds=k``: the next ``k`` calls to
        :meth:`ppermute_start` still succeed; the failure surfaces on the
        one after that (so a test can land it mid-allreduce)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside [0, {self.size})")
        if after_rounds <= 0:
            self._dead.add(rank)
        else:
            self._kill_at[rank] = int(after_rounds)

    def revive(self, rank: int):
        """Clear a failure mark (the rank came back — membership flap)."""
        self._dead.discard(rank)
        self._kill_at.pop(rank, None)

    @property
    def dead(self) -> frozenset:
        return frozenset(self._dead)

    def _check_failures(self, pairs: Perm):
        for r in list(self._kill_at):
            if self._kill_at[r] <= 0:  # grace rounds used up: now it dies
                del self._kill_at[r]
                self._dead.add(r)
            else:
                self._kill_at[r] -= 1
        if self._dead:
            for src, dst in pairs:
                if src in self._dead or dst in self._dead:
                    rank = src if src in self._dead else dst
                    raise RankFailure(rank)

    def rank(self):
        return np.arange(self.size)

    def ppermute_start(self, x, perm: Perm) -> TransportRequest:
        # Lockstep semantics: the data moves at issue time (every rank is
        # in this call); wait() closes the trace's pending slot.
        pairs = list(perm)
        self._check_failures(pairs)
        out = torch.zeros_like(x)
        per_msg = (x.numel() // self.size) * x.element_size()
        if pairs:
            src, dst = self._host_to(x.device, ("perm", tuple(pairs)),
                                     lambda: np.array(pairs, np.int64).T)
            out[dst] = x[src]
        self.trace.issue(per_msg if pairs else 0, len(pairs))
        return TransportRequest(out, on_wait=self._finish,
                                on_cancel=self.trace.complete)

    def _finish(self, out):
        self.trace.complete()
        return out

    def _host_to(self, device, key, make):
        """The device copy of a recurring host array, made once."""
        key = (device, key)
        t = self._on_device.get(key)
        if t is None:
            t = self._on_device[key] = to_device(make(), device)
        return t

    def where(self, cond, a, b):
        """Rank-masked select.  ``cond`` is host data (a scalar or a ``[P]``
        mask from :meth:`rank` arithmetic).  Two host operands give a host
        array (rank arithmetic such as slice starts stays on the host); a
        tensor operand gives a tensor on that operand's device."""
        cond = np.asarray(cond)
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return np.where(cond, a, b)
        ref = a if isinstance(a, torch.Tensor) else b
        a = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
        b = torch.as_tensor(b, dtype=ref.dtype, device=ref.device)
        if cond.ndim:
            # [P] -> [P, 1, 1, ...] to broadcast against [P, *shape]
            cond = cond.reshape((self.size,) + (1,) * (max(a.ndim, b.ndim) - 1))
        mask = self._host_to(ref.device, ("mask", cond.shape, cond.tobytes()),
                             lambda: cond.astype(bool))
        return torch.where(mask, a, b)

    def dynslice(self, x, start, size: int, axis: int = 0):
        start = np.broadcast_to(np.asarray(start), (self.size,))
        return torch.stack([x[i].narrow(axis, int(start[i]), size)
                            for i in range(self.size)])

    def dynupdate(self, x, update, start, axis: int = 0):
        start = np.broadcast_to(np.asarray(start), (self.size,))
        out = x.clone()
        n = update.shape[axis + 1]
        for i in range(self.size):
            out[i].narrow(axis, int(start[i]), n).copy_(update[i])
        return out

    def concat(self, parts, axis: int = 0):
        return torch.cat(list(parts), dim=axis + 1)

    def reshape(self, x, shape):
        return x.reshape((self.size,) + tuple(shape))

    def zeros(self, shape, dtype):
        return torch.zeros((self.size,) + tuple(shape), dtype=dtype,
                           device=self.device)

    def ones(self, shape, dtype):
        return torch.ones((self.size,) + tuple(shape), dtype=dtype,
                          device=self.device)

    def lshape(self, x):
        return tuple(x.shape[1:])


# ---------------------------------------------------------------------------
# Reduction operators (paper: "users can provide an arbitrary function
# object as a reduction operation")
# ---------------------------------------------------------------------------

OPS: dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "max": lambda a, b: torch.maximum(a, b) if isinstance(a, torch.Tensor) else np.maximum(a, b),
    "min": lambda a, b: torch.minimum(a, b) if isinstance(a, torch.Tensor) else np.minimum(a, b),
    "prod": lambda a, b: a * b,
}


def resolve_op(op) -> Callable:
    if callable(op):
        return op
    try:
        return OPS[op]
    except KeyError:
        raise ValueError(f"unknown reduction op {op!r}; known: {sorted(OPS)}") from None


__all__ = [
    "ChannelTrace",
    "Perm",
    "RankFailure",
    "SimTransport",
    "Transport",
    "TransportRequest",
    "ilog2",
    "is_pow2",
    "resolve_op",
]
