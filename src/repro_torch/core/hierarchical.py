"""Hierarchical multi-channel collectives (paper §1: "hierarchical and
multi-protocol communication"; §3.3: per-channel algorithm specialization).

On a multi-pod mesh the data-parallel world spans two channels with very
different α-β parameters: intra-pod ICI (~50 GB/s/link, ~1 µs) and cross-pod
DCN (~6 GB/s/chip, ~10 µs).  A flat algorithm pays DCN β on every hop; the
two-level algorithm moves only ``1/P_inner`` of the payload across DCN:

    phase 1: reduce_scatter over the inner (ICI) communicator
    phase 2: allreduce of the owned chunk over the outer (DCN) communicator
    phase 3: allgather over the inner (ICI) communicator

Cost:  2·s·(P_i−1)/P_i · β_ici  +  (s/P_i)·f(P_o) · β_dcn   (+ α terms),
vs. flat ring over the combined axes:  2·s·(P−1)/P · β_dcn-dominated.

``hierarchical_allreduce`` composes the generic algorithms from
:mod:`repro_torch.core.algorithms`, so it runs on every ported channel (the sim channel today).
The matching cost model is :func:`hierarchical_time`; the selector uses it
to emit the two-level ``"<inner>+<outer>"`` composite candidates for every
ordered pair of registered channels (see :mod:`repro_torch.core.channels` and
``selector.explain``), mirroring the paper's multi-protocol choice between
e.g. Redis-within-rack + S3-across-region.  Channel names resolve through
:data:`repro_torch.core.models.CHANNELS`, which the registry keeps in sync — a
newly registered channel becomes a composite leg with no change here.
"""

from __future__ import annotations

from . import algorithms as A
from . import collectives as C
from .communicator import Communicator
from .models import CHANNELS, collective_time, collective_time_ext
from .transport import Transport


def hierarchical_allreduce(
    x,
    inner: Communicator,
    outer: Communicator,
    op="add",
    inner_rs: str = "recursive_halving",
    outer_ar: str = "recursive_doubling",
    inner_ag: str = "recursive_doubling",
):
    """Two-level allreduce: RS(inner/ici) → AR(outer/dcn) → AG(inner/ici)."""
    if inner.size == 1:
        return C.allreduce(x, outer, op=op, algorithm=outer_ar)
    if outer.size == 1:
        return C.allreduce(x, inner, op=op, algorithm="auto")
    shape = x.shape
    chunk = C.reduce_scatter(x, inner, op=op, algorithm=inner_rs)
    chunk = C.allreduce(chunk, outer, op=op, algorithm=outer_ar)
    full = C.allgather(chunk, inner, algorithm=inner_ag)
    n = 1
    for d in shape:
        n *= int(d)
    return full[:n].reshape(shape)


def hierarchical_allreduce_sim(t_inner: Transport, t_outer_factory, x, op="add"):
    """Sim-channel counterpart for tests/round-counting.

    ``t_outer_factory(chunks)`` must run the outer phase on the per-inner-rank
    chunks; see tests for the stacked-layout contract.
    """
    chunk = A.halving_reduce_scatter(t_inner, x, op)
    chunk = t_outer_factory(chunk)
    out = A.doubling_allgather(t_inner, chunk)
    return out


def hierarchical_time(
    nbytes: float,
    inner_P: int,
    outer_P: int,
    inner_channel: str = "ici",
    outer_channel: str = "dcn",
    inner_rs: str = "recursive_halving",
    outer_ar: str = "recursive_doubling",
    inner_ag: str = "recursive_doubling",
    gamma: float = 0.0,
) -> float:
    """α-β model of the two-level allreduce (selector candidate).

    ``gamma`` adds the exposed reduce-compute term per reducing round; the
    selector passes ``models.GAMMA_REDUCE`` so composites are priced on the
    same basis as the flat candidates they compete with (``gamma=0`` keeps
    the pure wire model)."""
    t = 0.0
    if inner_P > 1:
        t += collective_time_ext("reduce_scatter", inner_rs, nbytes, inner_P,
                                 CHANNELS[inner_channel], gamma=gamma)
    chunk_bytes = nbytes / max(inner_P, 1)
    if outer_P > 1:
        t += collective_time_ext("allreduce", outer_ar, chunk_bytes, outer_P,
                                 CHANNELS[outer_channel], gamma=gamma)
    if inner_P > 1:
        t += collective_time_ext("allgather", inner_ag, nbytes, inner_P,
                                 CHANNELS[inner_channel], gamma=gamma)
    return t


def flat_time(
    nbytes: float, inner_P: int, outer_P: int, algo: str = "ring",
    bottleneck_channel: str = "dcn",
) -> float:
    """Flat allreduce over the combined axes, paced by the slow channel."""
    P = inner_P * outer_P
    return collective_time("allreduce", algo, nbytes, P, CHANNELS[bottleneck_channel])
