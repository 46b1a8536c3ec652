"""Pluggable channel registry (the paper's §3.2 channel abstraction, open).

The paper's central design decision is that collective *algorithms* are
written once against a transport interface while *channels* — the medium
moving raw bytes — are interchangeable and chosen per call by a cost model.
The seed hard-coded the channel set in two places (``models.CHANNELS`` for
specs, ``selector.py`` for the names it would consider).  This module
promotes the set to a first-class registry: a **channel** is

    Transport factory  +  α-β time model (ChannelSpec)  +  price model,

registered by name.  The selector enumerates ``registry`` entries, the
communicator instantiates transports through it, and a user can register a
new channel (e.g. a remote-DMA or NVMe-staged channel) without touching the
selector — see ``docs/channel-selection.md`` for a worked example::

    from repro_torch.core import channels
    from repro_torch.core.models import ChannelSpec

    channels.register_channel(
        ChannelSpec("nvme", alpha=80e-6, beta=1 / 3e9, kind="mediated",
                    push=False, hops=2),
        transport_factory=lambda size, **kw: MyNvmeTransport(size),
    )

Built-in entries (port of :mod:`repro.core.channels`; the registry keeps
every reference name so that ``algorithm="auto"`` prices the same
candidates in both packages):

===========  ========  =====================================================
name         kind      transport
===========  ========  =====================================================
sim          direct    :class:`~repro_torch.core.transport.SimTransport`
                       (instrumented lockstep oracle on the communicator's
                       device)
ici dcn      direct    not ported yet: the factory raises
                       ``NotImplementedError`` (ROADMAP Queue 1, item 1)
xla          provider  not ported yet (ROADMAP Queue 1, item 4)
host         mediated  not ported yet (ROADMAP Queue 1, item 1)
rdma flow    direct    not ported yet (ROADMAP Queue 1, item 3)
s3 dynamodb  mediated  none — model-only AWS channels (paper Table 2);
redis direct           priced by :mod:`repro_torch.core.pricing`
===========  ========  =====================================================
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

from .models import CHANNELS as _SPECS
from .models import (
    STORAGE_CHANNELS,
    ChannelSpec,
    collective_time,
    collective_time_ext,
)
from .transport import SimTransport, Transport

__all__ = [
    "Channel",
    "STORAGE_CHANNELS",
    "register",
    "register_channel",
    "unregister",
    "get_channel",
    "names",
    "default_channels",
]


@dataclass(frozen=True)
class Channel:
    """One registry entry: spec (α-β), transport factory, price hook."""

    spec: ChannelSpec
    # factory(size=..., axes=..., sizes=...) -> Transport; None for
    # model-only channels (AWS paper channels) and provider channels (xla).
    transport_factory: Callable[..., Transport] | None = None
    # price(op, nbytes, P, algo, mem_gib, time_s) -> ExchangeCost; None uses
    # pricing.collective_cost with this channel's spec.
    price_fn: Callable | None = None
    # private channels are resolvable by name but excluded from
    # default_channels() — for owner-scoped registrations (e.g. a serving
    # engine's instrumented transport) that must not leak into unrelated
    # algorithm='auto' selections.
    private: bool = False

    @property
    def name(self) -> str:
        return self.spec.name

    def make_transport(self, *, axes=None, sizes=None, size: int | None = None,
                       **kwargs) -> Transport:
        """Instantiate this channel's transport for a communicator group.

        Mesh-bound channels consume ``axes``/``sizes``; software channels
        only need the flat ``size`` (derived from ``sizes`` if absent)."""
        if self.transport_factory is None:
            raise ValueError(
                f"channel {self.name!r} is model-only (kind={self.spec.kind}); "
                "it has no transport factory"
            )
        if size is None and sizes is not None:
            size = int(math.prod(sizes))
        return self.transport_factory(axes=axes, sizes=sizes, size=size, **kwargs)

    def time(self, op: str, algo: str, nbytes: float, P: int,
             depth: int = 1) -> float:
        """Serialized α-β(+γ) time of one collective on this channel."""
        return collective_time_ext(op, algo, nbytes, P, self.spec, depth=depth)

    def wire_time(self, op: str, algo: str, nbytes: float, P: int) -> float:
        """Pure wire time (no reduce term) — what the trace oracle checks."""
        return collective_time(op, algo, nbytes, P, self.spec)

    def price(self, op: str, nbytes: float, P: int, algo: str | None = None,
              mem_gib: float = 2.0, time_s: float | None = None):
        from .pricing import collective_cost

        if self.price_fn is not None:
            return self.price_fn(op, nbytes, P, algo, mem_gib, time_s)
        return collective_cost(op, nbytes, P, self.name, algo=algo,
                               mem_gib=mem_gib, spec=self.spec, time_s=time_s)


_REGISTRY: dict[str, Channel] = {}


def register(channel: Channel, overwrite: bool = False) -> Channel:
    """Add a channel to the registry; the selector sees it immediately."""
    if channel.name in _REGISTRY and not overwrite:
        raise ValueError(f"channel {channel.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[channel.name] = channel
    # keep the spec table in sync so model-level code (hierarchical_time,
    # pricing fallbacks) resolves registered names too
    _SPECS[channel.name] = channel.spec
    return channel


def register_channel(spec: ChannelSpec,
                     transport_factory: Callable[..., Transport] | None = None,
                     price_fn: Callable | None = None,
                     overwrite: bool = False,
                     private: bool = False) -> Channel:
    """Convenience wrapper: build the :class:`Channel` and register it."""
    return register(Channel(spec, transport_factory, price_fn, private),
                    overwrite=overwrite)


def unregister(name: str) -> None:
    """Remove a user-registered channel (and its spec-table entry, so no
    model-level code keeps resolving a dead name).  For a built-in name —
    including one shadowed via ``overwrite=True`` — the pristine default is
    restored instead: the paper tables must survive a stray unregister."""
    if name in _BUILTIN_CHANNELS:
        _REGISTRY[name] = _BUILTIN_CHANNELS[name]
        _SPECS[name] = _BUILTIN_CHANNELS[name].spec
        return
    _REGISTRY.pop(name, None)
    _SPECS.pop(name, None)


def get_channel(name: str) -> Channel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown channel {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def default_channels() -> tuple[str, ...]:
    """The channels the selector considers when the caller names none: every
    registered channel that can actually move bytes here (has a transport),
    minus provider channels — xla shares ici's wire, so enumerating it by
    default would only duplicate every ici row — and minus ``private``
    registrations (owner-scoped transports, e.g. a serving engine's)."""
    return tuple(
        n for n in sorted(_REGISTRY)
        if _REGISTRY[n].transport_factory is not None
        and _REGISTRY[n].spec.kind != "provider"
        and not _REGISTRY[n].private
    )


# ---------------------------------------------------------------------------
# Built-in registrations
# ---------------------------------------------------------------------------


def _unported(name: str, item: int) -> Callable[..., Transport]:
    """Factory for a channel whose transport is not ported yet.  The channel
    stays registered (``default_channels()`` and the selector's candidate
    set match the reference), but building its transport raises."""

    def factory(**_):
        raise NotImplementedError(
            f"channel {name!r}: transport not ported yet "
            f"(ROADMAP Queue 1, item {item})")

    return factory


def _sim_factory(size=None, device=None, **_):
    from ..devices import resolve_device

    if not size:
        raise ValueError("sim channel needs size=")
    # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
    return SimTransport(size, device=resolve_device(device))


for _name, _factory in (
    ("ici", _unported("ici", 1)),
    ("dcn", _unported("dcn", 1)),
    # provider-managed collectives; a communicator bound to "xla" keeps a
    # transport factory, as in the reference
    ("xla", _unported("xla", 4)),
    ("sim", _sim_factory),
    ("host", _unported("host", 1)),
    # lease-based one-sided RDMA: hops=1, near-α-only — the selector's
    # latency-bound pick until the bandwidth crossover
    ("rdma", _unported("rdma", 3)),
    ("s3", None),
    ("dynamodb", None),
    ("redis", None),
    ("direct", None),
):
    register(Channel(_SPECS[_name], _factory))

# Flow-level simulation backend: resolvable by name but private, so it never
# competes with "sim" in algorithm='auto' selections (their specs are
# identical; enumerating both would only duplicate every sim row).
register(Channel(_SPECS["flow"], _unported("flow", 3), private=True))

# pristine snapshot for unregister() to restore built-ins from
_BUILTIN_CHANNELS: dict[str, Channel] = dict(_REGISTRY)
