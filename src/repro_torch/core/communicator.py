"""MPI-style communicators over named group axes (paper §3.5).

Port of :mod:`repro.core.communicator`.  A :class:`Communicator` is the FMI
unit of group communication: an ordered group of N ranks with ids
``[0, N)``, bound to one or more **named axes** (rank = row-major index
over the axes) plus the **channel** whose α-β/price model governs
algorithm selection, and the **device** its software-channel transports
hold payloads on (``None``: CUDA, see :func:`repro_torch.devices.resolve_device`).

Mirroring the paper's interface::

    comm = Communicator(axes=("data",), sizes=(16,))
    grads = comm.allreduce(grads, op="add", algorithm="auto")

Sub-communicators (paper: "an application can create multiple communicators
with different numbers of peers or lifetimes") are created with
:meth:`Communicator.sub` — e.g. the per-pod and cross-pod communicators of a
hierarchical allreduce.

Generations (elastic runtime): every communicator carries a ``generation``
counter.  Requests issued through it are stamped with that generation; on a
membership change the elastic controller builds the next-generation group
with :meth:`Communicator.regroup` and cancels the stale generation's
in-flight requests (see :mod:`repro_torch.core.requests` and
``docs/elasticity.md``)::

    comm = Communicator(axes=("data",), sizes=(8,), channel="sim")
    comm2 = comm.regroup(sizes=(6,))      # 2 ranks lost -> generation 1
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

from ..analysis.sanitizer import ensure_active as _ensure_sanitizer
from ..analysis.sanitizer import get_active as _sanitizer
from .transport import Transport


@dataclass(frozen=True)
class Communicator:
    axes: tuple[str, ...]
    sizes: tuple[int, ...]
    channel: str = "ici"
    name: str = "world"
    generation: int = 0  # bumped by regroup(); stamps issued requests
    #: Activate the process-wide :class:`~repro_torch.analysis.sanitizer.
    #: CommSanitizer` when this group is built (equivalent to running under
    #: ``FMI_SANITIZE=1``); excluded from equality so sanitized and plain
    #: communicators over the same group compare equal.
    sanitize: bool = field(default=False, compare=False)
    #: Device of the tensors a software-channel transport built for this
    #: group holds (``None``: CUDA, raising when there is none).
    device: str | None = field(default=None, compare=False)

    def __post_init__(self):
        if len(self.axes) != len(self.sizes):
            raise ValueError("axes/sizes mismatch")
        if self.sanitize:
            _ensure_sanitizer()

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def transport(self, **kwargs) -> Transport:
        """This communicator's channel transport, instantiated through the
        channel registry on this communicator's device."""
        from .channels import get_channel

        kwargs.setdefault("device", self.device)
        return get_channel(self.channel).make_transport(
            axes=self.axes, sizes=self.sizes, **kwargs
        )

    def explain(self, op: str, nbytes: float,
                channels: tuple[str, ...] | None = None) -> str:
        """Selector candidate table for ``op`` at ``nbytes`` on this group
        (defaults to every transport-capable registered channel)."""
        from .selector import explain as _explain

        return _explain(op, nbytes, self.size, channels=channels)

    def serve_plan(self, d_model: int, n_layers: int, vocab_size: int,
                   batch: int, prompt_len: int, **kwargs):
        """Price one TP decode step and one prefill step of a server
        sharded over this group on this channel — see
        :func:`repro_torch.core.selector.serve_plan` (the serving analogue of
        :meth:`explain`)."""
        from .selector import serve_plan as _serve_plan

        return _serve_plan(d_model, n_layers, vocab_size, self.size, batch,
                           prompt_len, channels=(self.channel,), **kwargs)

    def regroup(self, sizes: tuple[int, ...] | None = None,
                axes: tuple[str, ...] | None = None) -> "Communicator":
        """The next-generation communicator after a membership change:
        same channel, (possibly) new group shape, ``generation + 1``.
        Requests issued through the old object remain stamped with the old
        generation, so ``RequestQueue.cancel_all(old.generation)`` aborts
        exactly the stale in-flight traffic."""
        nxt = replace(
            self,
            axes=self.axes if axes is None else tuple(axes),
            sizes=self.sizes if sizes is None else tuple(sizes),
            generation=self.generation + 1,
        )
        s = _sanitizer()
        if s is not None:
            s.on_regroup(f"{nxt.name}@{nxt.channel}", nxt.generation)
        return nxt

    def sub(self, *axes: str) -> "Communicator":
        """Sub-communicator over a subset of this communicator's axes."""
        idx = {a: i for i, a in enumerate(self.axes)}
        for a in axes:
            if a not in idx:
                raise ValueError(f"axis {a!r} not in {self.axes}")
        sizes = tuple(self.sizes[idx[a]] for a in axes)
        return replace(self, axes=tuple(axes), sizes=sizes, name="+".join(axes))

    # ------------------------------------------------------------------
    # MPI-flavoured methods (thin wrappers over repro_torch.core.collectives)
    # ------------------------------------------------------------------
    def allreduce(self, x, op="add", algorithm="auto", objective="time"):
        from . import collectives as C

        return C.allreduce(x, self, op=op, algorithm=algorithm, objective=objective)

    def reduce_scatter(self, x, op="add", algorithm="auto"):
        from . import collectives as C

        return C.reduce_scatter(x, self, op=op, algorithm=algorithm)

    def allgather(self, chunk, algorithm="auto"):
        from . import collectives as C

        return C.allgather(chunk, self, algorithm=algorithm)

    def alltoall(self, x, algorithm="auto"):
        from . import collectives as C

        return C.alltoall(x, self, algorithm=algorithm)

    def bcast(self, x, root=0, algorithm="binomial"):
        from . import collectives as C

        return C.bcast(x, self, root=root, algorithm=algorithm)

    def reduce(self, x, op="add", root=0, algorithm="binomial"):
        from . import collectives as C

        return C.reduce(x, self, op=op, root=root, algorithm=algorithm)

    def scan(self, x, op="add"):
        from . import collectives as C

        return C.scan(x, self, op=op)

    def barrier(self):
        from . import collectives as C

        return C.barrier(self)

    # ------------------------------------------------------------------
    # Nonblocking requests (MPI_I*-flavoured; see repro_torch.core.requests)
    # ------------------------------------------------------------------
    def iallreduce(self, x, op="add", algorithm="auto", objective="time"):
        from . import requests as R

        return R.iallreduce(x, self, op=op, algorithm=algorithm,
                            objective=objective)

    def ireduce_scatter(self, x, op="add", algorithm="auto"):
        from . import requests as R

        return R.ireduce_scatter(x, self, op=op, algorithm=algorithm)

    def iallgather(self, chunk, algorithm="auto"):
        from . import requests as R

        return R.iallgather(chunk, self, algorithm=algorithm)

    def isend(self, x, transport, pairs, tag=0):
        """Sender half of a tag-matched p2p exchange on ``transport`` (one
        transport instance must be shared by the matching :meth:`irecv` —
        the mailbox lives on it).  The request is stamped with this
        communicator's generation."""
        from . import requests as R

        return R.isend(x, transport, pairs, tag=tag,
                       generation=self.generation)

    def irecv(self, transport, tag=0):
        from . import requests as R

        return R.irecv(transport, tag=tag, generation=self.generation)
