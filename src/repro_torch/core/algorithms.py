"""Channel-agnostic collective algorithms (paper §3.3, direct channels).

Port of :mod:`repro.core.algorithms`.  Every algorithm is written once
against :class:`repro_torch.core.transport.Transport` and runs on the
instrumented lockstep channel (:class:`SimTransport`, stacked torch tensors,
arbitrary rank counts — the test/cost oracle).

Implemented (matching the paper's direct-channel selection):

=================  ==========================================  ==============
operation          algorithm                                   rounds / bytes
=================  ==========================================  ==============
bcast              binomial tree                               ⌈log₂P⌉ · s
reduce             binomial tree (reversed)                    ⌈log₂P⌉ · s
allreduce          recursive doubling (latency-optimal)        log₂P · s
allreduce          ring reduce-scatter + allgather (bw-opt.)   2(P−1) · s/P
allreduce          Rabenseifner (halving RS + doubling AG)     2log₂P, 2s(P−1)/P
reduce_scatter     recursive halving / ring                    see models
allgather          recursive doubling / ring                   see models
scan               Hillis–Steele (depth-optimal, work-ineff.)  ⌈log₂P⌉ · s
alltoall           pairwise XOR exchange                       (P−1) · s/P
scatter            binomial halving tree                       log₂P, s(P−1)/P
gather             ring allgather (natural convention)          see models
barrier            1-element allreduce, no-op operator         log₂P · ε
=================  ==========================================  ==============

Byte/round counts are mirrored analytically in :mod:`repro_torch.core.models`;
property tests assert the SimTransport trace matches the model *exactly*.

Conventions: logical input per rank is ``x``; chunked ops view ``x`` as
``[P, chunk]``.  ``ring_reduce_scatter`` leaves rank ``r`` owning chunk
``(r+1) % P`` (inherent to the +1 ring direction); ``ring_allgather``
consumes that convention, so their composition is order-correct.
``halving_reduce_scatter`` / ``doubling_allgather`` use the natural
"rank r owns chunk r" convention.  Power-of-two rank counts take the fast
paths; non-powers-of-two are handled (fold-in/fold-out for recursive
doubling, plain binomial trees elsewhere) so the sim oracle covers any P.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from .transport import Perm, Transport, ilog2, is_pow2, resolve_op


def _ceil_log2(n: int) -> int:
    return max(0, (n - 1).bit_length())


# ---------------------------------------------------------------------------
# Group builds — how the elastic runtime rebuilds a communicator from
# survivors after a membership change (see runtime/elastic.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GroupBuild:
    """A regrouped communicator layout over the surviving ranks.

    ``active`` are the old rank ids that participate in the new group (new
    contiguous rank = position in ``active``; ``rank_map`` spells it out);
    ``spares`` are survivors left idling until the next rescale *up*.
    ``algorithm`` is the allreduce family the layout was built for."""

    strategy: str
    active: tuple[int, ...]
    spares: tuple[int, ...]
    rank_map: dict
    algorithm: str

    @property
    def size(self) -> int:
        return len(self.active)


def build_group(survivors: Sequence[int], strategy: str = "auto") -> GroupBuild:
    """Build the next-generation group from ``survivors``.

    Three strategies (the elastic controller's regroup step):

    * ``'pow2_floor'`` — largest power-of-two prefix of the survivors is
      active, the rest are spares.  Every collective keeps its pow2 fast
      path; the spares idle (and absorb the *next* failure for free).
    * ``'ring'`` — every survivor stays active; ring reduce-scatter /
      allgather handle any rank count, trading log-depth for zero waste.
    * ``'recursive_doubling'`` — every survivor stays active at a non-pow2
      size via the fold-in/fold-out spare protocol of
      :func:`allreduce_recursive_doubling`: the even ranks below ``2·extra``
      donate their contribution to a pow2 core and receive the result back —
      in-group spares rather than idle ones.
    * ``'auto'`` — ``recursive_doubling`` when the survivor count is a power
      of two (it is then plain recursive doubling), else ``'ring'`` (keeps
      all survivors without the two extra fold rounds).

    Example::

        >>> b = build_group([0, 1, 2, 4, 5, 6, 7], strategy="pow2_floor")
        >>> b.size, b.active, b.spares
        (4, (0, 1, 2, 4), (5, 6, 7))
        >>> b.rank_map[4]     # old rank 4 becomes new rank 3
        3
        >>> build_group([0, 1, 2, 4, 5, 6, 7], strategy="ring").size
        7
    """
    survivors = tuple(sorted(set(int(r) for r in survivors)))
    if not survivors:
        raise ValueError("cannot build a group from zero survivors")
    n = len(survivors)
    if strategy == "auto":
        strategy = "recursive_doubling" if is_pow2(n) else "ring"
    if strategy == "pow2_floor":
        k = 1 << (n.bit_length() - 1)
        active, spares = survivors[:k], survivors[k:]
        algorithm = "recursive_doubling"
    elif strategy in ("ring", "recursive_doubling"):
        active, spares = survivors, ()
        algorithm = strategy
    else:
        raise ValueError(
            f"unknown regroup strategy {strategy!r}; expected 'auto', "
            "'pow2_floor', 'ring', or 'recursive_doubling'"
        )
    rank_map = {old: new for new, old in enumerate(active)}
    return GroupBuild(strategy, active, spares, rank_map, algorithm)


# ---------------------------------------------------------------------------
# broadcast / reduce — binomial trees (any P)
# ---------------------------------------------------------------------------


def bcast_binomial(t: Transport, x, root: int = 0):
    P = t.size
    if P == 1:
        return x
    r = t.rank()
    vr = (r - root) % P
    nrounds = _ceil_log2(P)
    for k in reversed(range(nrounds)):
        dist = 1 << k
        pairs: Perm = []
        for vs in range(0, P, dist * 2):
            if vs + dist < P:
                pairs.append(((vs + root) % P, (vs + dist + root) % P))
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(x, pairs)
        is_recv = (vr % (dist * 2) == dist) & (vr < P)
        x = t.where(is_recv, recv, x)
    return x


def reduce_binomial(t: Transport, x, op="add", root: int = 0):
    """Result is valid on ``root`` only (other ranks hold partials)."""
    P = t.size
    if P == 1:
        return x
    opf = resolve_op(op)
    r = t.rank()
    vr = (r - root) % P
    nrounds = _ceil_log2(P)
    for k in range(nrounds):
        dist = 1 << k
        pairs: Perm = []
        for vs in range(dist, P, dist * 2):
            pairs.append(((vs + root) % P, (vs - dist + root) % P))
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(x, pairs)
        is_recv = (vr % (dist * 2) == 0) & (vr + dist < P)
        x = t.where(is_recv, opf(x, recv), x)
    return x


# ---------------------------------------------------------------------------
# allreduce — recursive doubling (with non-pow2 fold), ring, Rabenseifner
# ---------------------------------------------------------------------------


def allreduce_recursive_doubling(t: Transport, x, op="add"):
    P = t.size
    if P == 1:
        return x
    opf = resolve_op(op)
    r = t.rank()
    p2 = 1 << (P.bit_length() - 1)  # largest power of two <= P
    extra = P - p2

    if extra:
        # fold-in: even ranks < 2*extra donate to their odd neighbour
        pairs = [(e, e + 1) for e in range(0, 2 * extra, 2)]
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(x, pairs)
        is_fold_recv = (r < 2 * extra) & (r % 2 == 1)
        x = t.where(is_fold_recv, opf(x, recv), x)

    # participants: odd ranks < 2*extra and ranks >= 2*extra
    def real(n: int) -> int:  # participant index -> rank
        return 2 * n + 1 if n < extra else n + extra

    participates = (r >= 2 * extra) | (r % 2 == 1)
    # participant index of this rank (garbage for non-participants, masked out)
    nr = t.where(r < 2 * extra, (r - 1) // 2, r - extra)

    for k in range(ilog2(p2)):
        dist = 1 << k
        pairs = [(real(n), real(n ^ dist)) for n in range(p2)]
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(x, pairs)
        x = t.where(participates, opf(x, recv), x)
    del nr

    if extra:
        # fold-out: odd ranks < 2*extra return the result to even neighbours
        pairs = [(e + 1, e) for e in range(0, 2 * extra, 2)]
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(x, pairs)
        is_fold_out = (r < 2 * extra) & (r % 2 == 0)
        x = t.where(is_fold_out, recv, x)
    return x


def ring_reduce_scatter(t: Transport, x, op="add"):
    """``x``: logical ``[P*c]`` (or ``[P, c, ...]``). Returns rank ``r``'s
    reduced chunk ``[c, ...]`` under the ownership convention
    ``owner(chunk j) = (j - 1) % P`` i.e. rank r owns chunk ``(r+1) % P``."""
    P = t.size
    opf = resolve_op(op)
    chunks = _as_chunks(t, x)
    if P == 1:
        return _chunk_squeeze(t, chunks, 0)
    r = t.rank()
    ring: Perm = [(i, (i + 1) % P) for i in range(P)]
    for i in range(P - 1):
        send_idx = (r - i) % P
        recv_idx = (r - i - 1) % P
        send = t.dynslice(chunks, send_idx, 1, axis=0)
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(send, ring)
        cur = t.dynslice(chunks, recv_idx, 1, axis=0)
        chunks = t.dynupdate(chunks, opf(cur, recv), recv_idx, axis=0)
    own = (r + 1) % P
    return _chunk_squeeze(t, t.dynslice(chunks, own, 1, axis=0), None)


def ring_allgather(t: Transport, chunk, owned_index=None):
    """Inverse of :func:`ring_reduce_scatter`.  ``chunk``: ``[c, ...]`` owned
    under the ring convention (rank r holds chunk ``(r+1) % P`` by default).
    Returns the full logical ``[P, c, ...]`` chunk array on every rank."""
    P = t.size
    r = t.rank()
    if owned_index is None:
        owned_index = (r + 1) % P
    out = t.zeros((P,) + t.lshape(chunk), chunk.dtype)
    out = t.dynupdate(out, _expand0(t, chunk), owned_index, axis=0)
    if P == 1:
        return out
    ring: Perm = [(i, (i + 1) % P) for i in range(P)]
    for i in range(P - 1):
        send_idx = (owned_index - i) % P
        recv_idx = (owned_index - i - 1) % P
        send = t.dynslice(out, send_idx, 1, axis=0)
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(send, ring)
        out = t.dynupdate(out, recv, recv_idx, axis=0)
    return out


def allreduce_ring(t: Transport, x, op="add"):
    """Bandwidth-optimal ring allreduce (Patarasuk & Yuan): RS + AG."""
    chunk = ring_reduce_scatter(t, x, op)
    out = ring_allgather(t, chunk)
    return t.reshape(out, t.lshape(x))


# ---------------------------------------------------------------------------
# Chunk-streamed (pipelined) bandwidth-class algorithms
#
# Each reducing round's payload is split into ``depth`` contiguous segments;
# all segments are *issued* with ``ppermute_start`` before any is waited on,
# so segment j+1's send overlaps segment j's reduce — the serialized-round
# count stays at the unpipelined schedule length (the trace's pending-slot
# accounting merges the in-flight segments into one slot) while per-segment
# reduce latency leaves the critical path.  The arithmetic is the *same
# elementwise operations in the same order* as the unpipelined algorithm —
# results are bit-exact, which the sim-oracle tests assert.
# ---------------------------------------------------------------------------


def _segments(n: int, depth: int) -> list[tuple[int, int]]:
    """Split ``n`` elements into ``min(depth, n)`` contiguous (start, size)
    spans whose sizes differ by at most one."""
    depth = max(1, min(int(depth), int(n)))
    base, rem = divmod(int(n), depth)
    spans, lo = [], 0
    for j in range(depth):
        sz = base + (1 if j < rem else 0)
        spans.append((lo, sz))
        lo += sz
    return spans


def ring_reduce_scatter_pipelined(t: Transport, x, op="add", depth: int = 2):
    """:func:`ring_reduce_scatter` with each hop's chunk streamed in
    ``depth`` segments (same ownership convention, bit-identical result)."""
    P = t.size
    opf = resolve_op(op)
    chunks = _as_chunks(t, x)
    if P == 1:
        return _chunk_squeeze(t, chunks, 0)
    r = t.rank()
    c = t.lshape(chunks)[1]
    spans = _segments(c, depth)
    ring: Perm = [(i, (i + 1) % P) for i in range(P)]
    for i in range(P - 1):
        send_idx = (r - i) % P
        recv_idx = (r - i - 1) % P
        send = t.dynslice(chunks, send_idx, 1, axis=0)
        cur = t.dynslice(chunks, recv_idx, 1, axis=0)
        reqs = [
            # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
            t.ppermute_start(t.dynslice(send, lo, sz, axis=1), ring)
            for lo, sz in spans
        ]  # all segments in flight before the first reduce
        pieces = []
        for (lo, sz), req in zip(spans, reqs):
            cseg = t.dynslice(cur, lo, sz, axis=1)
            pieces.append(opf(cseg, req.wait()))
        chunks = t.dynupdate(chunks, t.concat(pieces, axis=1), recv_idx, axis=0)
    own = (r + 1) % P
    return _chunk_squeeze(t, t.dynslice(chunks, own, 1, axis=0), None)


def allreduce_ring_pipelined(t: Transport, x, op="add", depth: int = 2):
    """Pipelined ring allreduce: chunk-streamed RS + plain AG (the allgather
    has no reduce to overlap, so segmenting it would only add injections)."""
    chunk = ring_reduce_scatter_pipelined(t, x, op, depth=depth)
    out = ring_allgather(t, chunk)
    return t.reshape(out, t.lshape(x))


def halving_reduce_scatter_pipelined(t: Transport, x, op="add", depth: int = 2):
    """:func:`halving_reduce_scatter` with each halving step's window
    streamed in ``depth`` segments along the chunk axis (pow2 P)."""
    P = t.size
    opf = resolve_op(op)
    chunks = _as_chunks(t, x)
    if P == 1:
        return _chunk_squeeze(t, chunks, 0)
    if not is_pow2(P):
        raise ValueError("halving_reduce_scatter requires power-of-two ranks")
    r = t.rank()
    c = t.lshape(chunks)[1]
    spans = _segments(c, depth)
    window = chunks
    length = P
    while length > 1:
        half = length // 2
        dist = half
        pairs: Perm = [(i, i ^ dist) for i in range(P)]
        i_am_low = (r & dist) == 0
        send_start = t.where(i_am_low, half, 0)
        keep_start = t.where(i_am_low, 0, half)
        send = t.dynslice(window, send_start, half, axis=0)
        keep = t.dynslice(window, keep_start, half, axis=0)
        reqs = [
            # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
            t.ppermute_start(t.dynslice(send, lo, sz, axis=1), pairs)
            for lo, sz in spans
        ]  # all segments in flight before the first reduce
        pieces = []
        for (lo, sz), req in zip(spans, reqs):
            kseg = t.dynslice(keep, lo, sz, axis=1)
            pieces.append(opf(kseg, req.wait()))
        window = t.concat(pieces, axis=1)
        length = half
    return _chunk_squeeze(t, window, None)


def allreduce_rabenseifner_pipelined(t: Transport, x, op="add", depth: int = 2):
    """Pipelined Rabenseifner: chunk-streamed halving RS + plain doubling AG."""
    chunk = halving_reduce_scatter_pipelined(t, x, op, depth=depth)
    out = doubling_allgather(t, chunk)
    return t.reshape(out, t.lshape(x))


def halving_reduce_scatter(t: Transport, x, op="add"):
    """Recursive-halving reduce-scatter (pow2 P): rank r gets chunk r."""
    P = t.size
    opf = resolve_op(op)
    chunks = _as_chunks(t, x)
    if P == 1:
        return _chunk_squeeze(t, chunks, 0)
    if not is_pow2(P):
        raise ValueError("halving_reduce_scatter requires power-of-two ranks")
    r = t.rank()
    window = chunks  # [length, c, ...]
    length = P
    while length > 1:
        half = length // 2
        dist = half
        pairs: Perm = [(i, i ^ dist) for i in range(P)]
        i_am_low = (r & dist) == 0
        send_start = t.where(i_am_low, half, 0)
        keep_start = t.where(i_am_low, 0, half)
        send = t.dynslice(window, send_start, half, axis=0)
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(send, pairs)
        keep = t.dynslice(window, keep_start, half, axis=0)
        window = opf(keep, recv)
        length = half
    return _chunk_squeeze(t, window, None)


def doubling_allgather(t: Transport, chunk):
    """Recursive-doubling allgather (pow2 P): rank r contributes chunk r;
    returns ``[P, c, ...]`` on every rank."""
    P = t.size
    if P == 1:
        return _expand0(t, chunk)
    if not is_pow2(P):
        raise ValueError("doubling_allgather requires power-of-two ranks")
    r = t.rank()
    window = _expand0(t, chunk)  # [1, c, ...]
    for k in range(ilog2(P)):
        dist = 1 << k
        pairs: Perm = [(i, i ^ dist) for i in range(P)]
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(window, pairs)
        low = t.concat([window, recv], axis=0)
        high = t.concat([recv, window], axis=0)
        window = t.where((r & dist) == 0, low, high)
    return window


def allreduce_rabenseifner(t: Transport, x, op="add"):
    """Recursive-halving RS + recursive-doubling AG: 2·log₂P rounds,
    2·s·(P−1)/P bytes — bandwidth-optimal with log rounds (pow2 P)."""
    chunk = halving_reduce_scatter(t, x, op)
    out = doubling_allgather(t, chunk)
    return t.reshape(out, t.lshape(x))


# ---------------------------------------------------------------------------
# scan — Hillis–Steele (depth-optimal, work-inefficient; paper §3.3 notes the
# trade-off vs. work-efficient algorithms on channels with per-byte cost)
# ---------------------------------------------------------------------------


def scan_hillis_steele(t: Transport, x, op="add"):
    """Inclusive prefix ``scan`` across ranks, ⌈log₂P⌉ rounds, any P."""
    P = t.size
    if P == 1:
        return x
    opf = resolve_op(op)
    r = t.rank()
    for k in range(_ceil_log2(P)):
        dist = 1 << k
        pairs: Perm = [(i, i + dist) for i in range(P - dist)]
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(x, pairs)
        x = t.where(r >= dist, opf(recv, x), x)
    return x


# ---------------------------------------------------------------------------
# alltoall — pairwise XOR exchange (pow2), the MoE dispatch workhorse
# ---------------------------------------------------------------------------


def alltoall_pairwise(t: Transport, x):
    """``x``: logical ``[P, c, ...]``, slot ``j`` destined to rank ``j``.
    Returns ``[P, c, ...]`` where slot ``j`` came from rank ``j``."""
    P = t.size
    if P == 1:
        return x
    if not is_pow2(P):
        raise ValueError("alltoall_pairwise requires power-of-two ranks")
    r = t.rank()
    out = x
    for step in range(1, P):
        pairs: Perm = [(i, i ^ step) for i in range(P)]
        partner = r ^ step
        send = t.dynslice(x, partner, 1, axis=0)
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(send, pairs)
        out = t.dynupdate(out, recv, partner, axis=0)
    return out


# ---------------------------------------------------------------------------
# scatter / gather
# ---------------------------------------------------------------------------


def scatter_halving(t: Transport, x, root: int = 0):
    """Binomial halving scatter (pow2 P).  ``x``: logical ``[P, c, ...]``
    (valid at ``root``; ignored elsewhere).  Chunk ``j`` lands on rank
    ``(root + j) % P``; returns ``[c, ...]``."""
    P = t.size
    if P == 1:
        return _chunk_squeeze(t, x, 0)
    if not is_pow2(P):
        raise ValueError("scatter_halving requires power-of-two ranks")
    r = t.rank()
    vr = (r - root) % P
    window = x
    length = P
    while length > 1:
        half = length // 2
        dist = half
        pairs: Perm = []
        for vs in range(0, P, length):
            pairs.append(((vs + root) % P, (vs + dist + root) % P))
        send = t.dynslice(window, half, half, axis=0)  # upper half
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(send, pairs)
        lower = t.dynslice(window, 0, half, axis=0)
        is_recv = vr % length == dist
        window = t.where(is_recv, recv, lower)
        length = half
    return _chunk_squeeze(t, window, None)


def gather_ring(t: Transport, chunk):
    """Gather implemented as a ring allgather under the natural convention
    (shape-static; the root simply reads the result).  The sim/cost
    layer additionally models true binomial gather; see models.py."""
    return _gather_ring_natural(t, chunk)


def _gather_ring_natural(t: Transport, chunk):
    """Ring allgather under the natural convention (rank r owns chunk r)."""
    P = t.size
    r = t.rank()
    out = _zeros_full(t, chunk)
    out = t.dynupdate(out, _expand0(t, chunk), r, axis=0)
    if P == 1:
        return out
    ring: Perm = [(i, (i + 1) % P) for i in range(P)]
    for i in range(P - 1):
        send_idx = (r - i) % P
        recv_idx = (r - i - 1) % P
        send = t.dynslice(out, send_idx, 1, axis=0)
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        recv = t.ppermute(send, ring)
        out = t.dynupdate(out, recv, recv_idx, axis=0)
    return out


def allgather_natural_ring(t: Transport, chunk):
    """Ring allgather, natural convention: rank r contributes chunk r."""
    return _gather_ring_natural(t, chunk)


# ---------------------------------------------------------------------------
# barrier — 1-element allreduce with the no-op operator (paper §3.3)
# ---------------------------------------------------------------------------


def barrier(t: Transport):
    one = t.ones((1,), torch.int32)
    return allreduce_recursive_doubling(t, one, op=lambda a, b: a)  # no-op reduce


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _as_chunks(t: Transport, x):
    """View logical ``x`` as ``[P, c, ...]``; requires divisibility (callers
    in collectives.py pad)."""
    shape = t.lshape(x)
    if len(shape) >= 2 and shape[0] == t.size:
        return x
    n = shape[0]
    if n % t.size:
        raise ValueError(f"size {n} not divisible by ranks {t.size}; pad first")
    return t.reshape(x, (t.size, n // t.size) + tuple(shape[1:]))


def _chunk_squeeze(t: Transport, window, idx):
    """[1, c, ...] -> [c, ...] (or take static idx first)."""
    if idx is not None:
        window = t.dynslice(window, idx, 1, axis=0)
    shape = t.lshape(window)
    return t.reshape(window, tuple(shape[1:]))


def _expand0(t: Transport, chunk):
    return t.reshape(chunk, (1,) + t.lshape(chunk))


def _zeros_full(t: Transport, chunk):
    return t.zeros((t.size,) + t.lshape(chunk), chunk.dtype)


# Registry: op -> {algo_name -> callable}.  The selector and the cost model
# key off these names.
ALGORITHMS: dict[str, dict[str, Callable]] = {
    "allreduce": {
        "recursive_doubling": allreduce_recursive_doubling,
        "ring": allreduce_ring,
        "rabenseifner": allreduce_rabenseifner,
    },
    "reduce_scatter": {
        "ring": ring_reduce_scatter,
        "recursive_halving": halving_reduce_scatter,
    },
    "allgather": {
        "ring": allgather_natural_ring,
        "recursive_doubling": doubling_allgather,
    },
    "bcast": {"binomial": bcast_binomial},
    "reduce": {"binomial": reduce_binomial},
    "scan": {"hillis_steele": scan_hillis_steele},
    "alltoall": {"pairwise": alltoall_pairwise},
    "scatter": {"binomial_halving": scatter_halving},
    "gather": {"ring": gather_ring},
    "barrier": {"recursive_doubling": barrier},
}

# Chunk-streamed variants, keyed like ALGORITHMS; callables take an extra
# ``depth`` kwarg.  The selector picks the depth from the α-β model
# (models.best_pipeline_depth); collectives.py dispatches here when the
# chosen candidate has depth > 1.
PIPELINED: dict[str, dict[str, Callable]] = {
    "allreduce": {
        "ring": allreduce_ring_pipelined,
        "rabenseifner": allreduce_rabenseifner_pipelined,
    },
    "reduce_scatter": {
        "ring": ring_reduce_scatter_pipelined,
        "recursive_halving": halving_reduce_scatter_pipelined,
    },
}
