"""Public collective API over a communicator's transport.

Port of :mod:`repro.core.collectives` for the stacked software channel.
Every function takes a :class:`~repro_torch.core.communicator.Communicator`
and an ``algorithm``:

* ``'auto'``    — model-driven selection (paper §5) from the communicator's
  channel α-β/price models (payload size and rank count are known on the
  host before anything runs);
* a named algorithm — explicit choice from
  :data:`repro_torch.core.algorithms.ALGORITHMS` (the paper's direct
  channel).

The provider-managed ``'xla'`` algorithm of the reference and the
bucketed schedule of ``allreduce_tree`` are not ported yet (ROADMAP
Queue 1, item 4).

Shape handling: latency-class algorithms (recursive doubling, binomial,
scan) run on the payload as-is; bandwidth-class chunked algorithms (ring,
Rabenseifner, halving/doubling) ravel + zero-pad the payload to a multiple
of the communicator size, and un-pad on the way out.  Payloads are stacked
``[P, ...]`` tensors; the rank axis is preserved throughout.

Pipelining: under ``algorithm='auto'`` the selector also chooses a chunk
pipelining depth for the bandwidth-class algorithms (round k+1's send
overlaps round k's reduce); pass ``pipeline=<depth>`` to force it.
"""

from __future__ import annotations

import math

import torch

from ..analysis.sanitizer import get_active as _sanitizer
from ..devices import true_div
from . import algorithms as A
from .communicator import Communicator
from .selector import select
from .transport import is_pow2 as _is_pow2

CHUNKED_ALLREDUCE = {"ring", "rabenseifner"}

_UNPORTED = "not ported yet (ROADMAP Queue 1, item 4)"


def _nbytes(x) -> int:
    return int(math.prod(x.shape)) * x.element_size()


def _observe(op: str, x, comm: Communicator) -> None:
    """CommSanitizer hook: append this collective to every rank's op ladder
    (one call covers all ranks — the software channels are lockstep)."""
    s = _sanitizer()
    if s is not None:
        s.on_collective(f"{comm.name}@{comm.channel}", op,
                        _nbytes(x) if x is not None else 0, comm.size)


def _transport(comm: Communicator):
    t = comm.transport()
    if not t.stacked:
        raise NotImplementedError(f"unstacked transports are {_UNPORTED}")
    return t


def _resolve(
    op_name: str, x, comm: Communicator, algorithm: str, objective: str,
    t=None,
) -> tuple[str, int]:
    """(algorithm, pipeline depth) for this call — model-driven when 'auto'.

    Explicit names pass through at depth 1; 'auto' asks the selector, which
    prices every (algorithm, depth) candidate on the communicator's channel
    with the α-β(+γ) model and returns the argmin.  ``x`` physically
    carries all P ranks, so the per-rank payload the model prices is 1/P of
    it."""
    if algorithm == "xla":
        raise NotImplementedError(f"algorithm 'xla' is {_UNPORTED}")
    if algorithm != "auto":
        return algorithm, 1
    nbytes = _nbytes(x)
    if t is not None and t.stacked:
        nbytes = max(1, nbytes // t.size)
    cand = select(
        op_name,
        nbytes,
        comm.size,
        channels=(comm.channel,),
        objective=objective,
    )
    return cand.algorithm, cand.depth


def _pad_flat(x, P: int, t):
    """Ravel + zero-pad each rank's payload to a multiple of ``P`` along the
    trailing axes (the rank axis is preserved).  Returns (flat, n)."""
    flat = x.reshape(t.size, -1)
    n = flat.shape[1]
    pad = (-n) % P
    if pad:
        flat = torch.cat([flat, flat.new_zeros((t.size, pad))], dim=1)
    return flat, n


def _unpad(out, n: int, shape, t):
    """Inverse of :func:`_pad_flat` for a full-size result."""
    return out.reshape(t.size, -1)[:, :n].reshape(shape)


# ---------------------------------------------------------------------------


def allreduce(x, comm: Communicator, op="add", algorithm="auto", objective="time",
              pipeline: int | None = None):
    """``pipeline``: chunk-streaming depth for the bandwidth-class
    algorithms; None lets the selector pick it from the α-β model (only
    meaningful with ``algorithm='auto'`` or ring/rabenseifner)."""
    _observe("allreduce", x, comm)
    if comm.size == 1:
        return x
    t = _transport(comm)
    algorithm, depth = _resolve("allreduce", x, comm, algorithm, objective, t)
    if pipeline is not None:
        depth = int(pipeline)
    if algorithm in CHUNKED_ALLREDUCE:
        flat, n = _pad_flat(x, comm.size, t)
        if depth > 1:
            out = A.PIPELINED["allreduce"][algorithm](t, flat, op, depth=depth)
        else:
            out = A.ALGORITHMS["allreduce"][algorithm](t, flat, op)
        return _unpad(out, n, x.shape, t)
    return A.ALGORITHMS["allreduce"][algorithm](t, x, op)


def reduce_scatter(x, comm: Communicator, op="add", algorithm="auto",
                   pipeline: int | None = None):
    """Returns this rank's reduced chunk of ``x`` raveled: shape
    ``[ceil(x.size/P)]`` per rank under the natural convention (rank r owns
    chunk r)."""
    _observe("reduce_scatter", x, comm)
    if comm.size == 1:
        return x.reshape(-1)
    t = _transport(comm)
    algorithm, depth = _resolve("reduce_scatter", x, comm, algorithm, "time", t)
    if pipeline is not None:
        depth = int(pipeline)
    flat, n = _pad_flat(x, comm.size, t)
    if algorithm == "recursive_halving":
        if depth > 1:
            return A.halving_reduce_scatter_pipelined(t, flat, op, depth=depth)
        return A.halving_reduce_scatter(t, flat, op)
    if algorithm == "ring":
        if depth > 1:
            chunk = A.ring_reduce_scatter_pipelined(t, flat, op, depth=depth)
        else:
            chunk = A.ring_reduce_scatter(t, flat, op)
        # normalize ring convention (rank r owns chunk (r+1)%P) -> natural
        P = comm.size
        perm = [(i, (i + 1) % P) for i in range(P)]
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        return t.ppermute(chunk, perm)
    raise ValueError(f"unknown reduce_scatter algorithm {algorithm!r}")


def allgather(chunk, comm: Communicator, algorithm="auto"):
    """Natural convention: rank r contributes chunk r; returns the stacked
    ``[P, P * chunk_size]`` concatenation over ranks (flat at ``P = 1``,
    as in the reference)."""
    _observe("allgather", chunk, comm)
    if comm.size == 1:
        return chunk.reshape(-1)
    if algorithm == "auto":
        # doubling is pow2-only; ring handles any rank count
        algorithm = "recursive_doubling" if _is_pow2(comm.size) else "ring"
    if algorithm == "xla":
        raise NotImplementedError(f"algorithm 'xla' is {_UNPORTED}")
    t = _transport(comm)
    fn = (
        A.doubling_allgather
        if algorithm == "recursive_doubling"
        else A.allgather_natural_ring
    )
    out = fn(t, chunk.reshape(t.size, -1))
    return out.reshape(t.size, -1)


def alltoall(x, comm: Communicator, algorithm="auto"):
    """``x``: logical ``[P, c, ...]`` per rank (physical ``[P, P, c, ...]``);
    slot j goes to rank j, returns slot j from rank j."""
    _observe("alltoall", x, comm)
    if comm.size == 1:
        return x
    if algorithm == "auto":
        algorithm = "pairwise"
    if algorithm == "xla":
        raise NotImplementedError(f"algorithm 'xla' is {_UNPORTED}")
    t = _transport(comm)
    if t.lshape(x)[0] != comm.size:
        raise ValueError(f"leading dim {t.lshape(x)[0]} != comm size {comm.size}")
    return A.alltoall_pairwise(t, x)


def bcast(x, comm: Communicator, root=0, algorithm="binomial"):
    _observe("bcast", x, comm)
    if comm.size == 1:
        return x
    t = _transport(comm)
    return A.bcast_binomial(t, x, root=root)


def reduce(x, comm: Communicator, op="add", root=0, algorithm="binomial"):
    _observe("reduce", x, comm)
    if comm.size == 1:
        return x
    t = _transport(comm)
    return A.reduce_binomial(t, x, op=op, root=root)


def scan(x, comm: Communicator, op="add"):
    """Inclusive prefix scan across ranks (Hillis–Steele, ⌈log₂P⌉ rounds)."""
    _observe("scan", x, comm)
    if comm.size == 1:
        return x
    t = _transport(comm)
    return A.scan_hillis_steele(t, x, op=op)


def barrier(comm: Communicator):
    """A barrier is also the sanitizer's synchronization point: every
    rank's hashed collective ladder is compared here (and reset)."""
    s = _sanitizer()
    if s is not None:
        s.on_collective(f"{comm.name}@{comm.channel}", "barrier", 0,
                        comm.size)
        s.barrier_check(f"{comm.name}@{comm.channel}", comm.size)
    if comm.size == 1:
        return torch.ones((1,), dtype=torch.int32)
    t = _transport(comm)
    return A.barrier(t)


# ---------------------------------------------------------------------------
# Trees — gradient-sync entry point used by training
# ---------------------------------------------------------------------------


def _leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def allreduce_tree(tree, comm: Communicator, op="add", algorithm="auto",
                   objective="time", mean: bool = False,
                   pipeline: int | None = None,
                   schedule: str = "blocking"):
    """Allreduce a tree (nested dicts/lists) of stacked ``[P, ...]``
    tensors, e.g. per-rank gradients.

    ``schedule='blocking'``: leaves are grouped by dtype, raveled per rank
    and fused into one ``[P, n]`` payload per dtype, reduced with one
    collective each, then split back (leaf order within a dtype is the
    tree's order).  ``mean=True`` divides by the communicator size
    (data-parallel gradient averaging).  ``schedule='bucketed'`` (the
    ``CommScheduler``) is not ported yet (ROADMAP Queue 1, item 4)."""
    if comm.size == 1:
        return tree
    if schedule == "bucketed":
        raise NotImplementedError(
            f"schedule='bucketed' (CommScheduler) is {_UNPORTED}")
    if schedule != "blocking":
        raise ValueError(f"unknown schedule {schedule!r}; "
                         "expected 'blocking' or 'bucketed'")
    leaves: list = []
    _leaves(tree, leaves)
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    out = list(leaves)
    P = comm.size
    for dtype, idxs in by_dtype.items():
        parts = [leaves[i].reshape(P, -1) for i in idxs]
        # a dtype's only leaf is already the fused payload: no copy
        flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        del parts
        red = allreduce(flat, comm, op=op, algorithm=algorithm,
                        objective=objective, pipeline=pipeline)
        del flat
        if mean:
            red = true_div(red, P)
        off = 0
        for i in idxs:
            n = math.prod(leaves[i].shape) // P
            out[i] = red[:, off:off + n].reshape(leaves[i].shape)
            off += n
    return _rebuild(tree, iter(out))
